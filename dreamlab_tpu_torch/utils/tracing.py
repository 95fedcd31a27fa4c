"""Spans and counters of the serving path, kept in memory: a flight recorder
an operator reads after the fact (``GET /api/trace``).

- ``span(name, **attrs)`` times a block: its name, start and end, the
  thread, its own id and its parent's. The parent is the innermost span
  open in the same context: a thread's, or an asyncio task's (the current
  span is a ``contextvars`` variable, so the event loop's interleaved
  requests each keep their own). Attributes can be set while it is open
  (``s.attrs["rows"] = n``); ``start=`` backdates it to an earlier reading
  of ``now()``.
- ``record(name, t0, t1, **attrs)`` records a span whose start and end were
  read on different threads (a job's wait in the pool's queue).
- ``count(name, n=1)`` adds to a cumulative counter.
- ``spans()`` and ``counters()`` read them; ``chrome_events(n)`` gives the
  newest n spans as Chrome trace events (``ph: "X"``, µs), which Perfetto
  and ``chrome://tracing`` load.

Times are ``time.monotonic_ns()`` (``now``): a span compares directly with
anything else read on the monotonic clock, a device trace mapped onto it
included. Spans go into a ring of ``CAPACITY`` entries; the oldest fall out.
Counters are totals since the process started, which outlive the ring.

While ``annotate(True)`` is in effect (the server's profiler routes set it
between start and stop) each span also opens a
``torch.profiler.record_function`` range of its name, so the host phases
appear in the profiler's trace beside the operators and kernels, on its
clock. No span name contains "Launch", which names CUDA launch calls in a
profiler's events.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

CAPACITY = 65536
now = time.monotonic_ns

_annotate = False
_ring: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("dreamlab_span", default=None)
_local = threading.local()  # .thread: (ident, name) of the thread


class Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "t1", "tid", "thread", "_token",
                 "_range")

    def __init__(self, name: str, attrs: dict, start: Optional[int] = None):
        self.name, self.attrs, self.id = name, attrs, next(_ids)
        self.parent = self.t1 = self._range = None
        self.t0 = start
        try:
            self.tid, self.thread = _local.thread
        except AttributeError:  # the thread's first span
            t = threading.current_thread()
            self.tid, self.thread = _local.thread = (t.ident, t.name)

    def __enter__(self) -> "Span":
        parent = _current.get()
        self.parent = None if parent is None else parent.id
        self._token = _current.set(self)
        if _annotate:
            self._range = _open_range(self.name)
        if self.t0 is None:
            self.t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _current.reset(self._token)
        _ring.append(self)
        return False

    def ms(self) -> Optional[float]:
        """Its milliseconds once closed."""
        return None if self.t1 is None else (self.t1 - self.t0) / 1e6

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0 / 1e9, "t1": self.t1 / 1e9,
                "thread": self.thread, "tid": self.tid, "id": self.id,
                "parent": self.parent, "attrs": dict(self.attrs)}


def _open_range(name: str):
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def span(name: str, *, start: Optional[int] = None, **attrs) -> Span:
    return Span(name, attrs, start)


def current() -> Optional[Span]:
    """The innermost open span of this thread or task, if any."""
    return _current.get()


def record(name: str, t0: Optional[int], t1: int, **attrs) -> None:
    if t0 is not None:
        s = Span(name, attrs, t0)
        s.t1 = t1
        _ring.append(s)


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def spans(n: Optional[int] = None) -> List[dict]:
    """The recorded spans, oldest first (each appended when it closed), as
    dicts with times in seconds; the newest ``n`` with ``n``."""
    ring = list(_ring)
    if n is not None:
        ring = ring[-n:] if n > 0 else []
    return [s.as_dict() for s in ring]


def _plain(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return str(v)


def chrome_events(n: int = 1000) -> List[dict]:
    pid = os.getpid()
    return [{"name": s["name"], "ph": "X", "ts": s["t0"] * 1e6, "dur": (s["t1"] - s["t0"]) * 1e6,
             "pid": pid, "tid": s["tid"],
             "args": {"id": s["id"], "parent": s["parent"], "thread": s["thread"],
                      **{k: _plain(v) for k, v in s["attrs"].items()}}}
            for s in spans(n)]


def annotate(flag: bool) -> None:
    """Open a profiler range with every span from now on (or stop)."""
    global _annotate
    _annotate = bool(flag)


def reset() -> None:
    """Forget every span and counter."""
    _ring.clear()
    with _counters_lock:
        _counters.clear()
