"""The benchmark's one traffic generator: a mix file's parameters and a seed
in, the requests of a run out.

A mix file (``traffic/<name>.json``) holds parameters only:

- ``loop``: ``"open"`` (arrivals on a schedule, whatever the server does)
  or ``"closed"`` (``clients`` callers, each sending ``burst`` concurrent
  requests and waiting for all of them before the next burst);
- ``rate_per_s`` (open loop): the offered rate, with ``arrivals``
  ``"poisson"``: Poisson-like, the gaps of a run are the quantiles of the
  exponential distribution at that rate, so every seed gets the same number
  of arrivals and the same multiset of gaps (the seed changes their order,
  not the work);
- ``size`` ("WxH"), ``steps``, ``guidance``: every request's shape;
- ``prompt_words``: [least, most] words a prompt has;
- ``max_batch``, ``batch_window_ms``: the pool's coalescing settings the
  cell serves under;
- ``profile_s``: the length of the profiled slice of a traced run;
- ``check``: how many finished requests the correctness check takes.

Imports only the standard library and numpy: the load generator's process
uses it without torch.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent

# request seeds stay in the server's accepted range (0 .. 2**31 - 1)
_SEED_SPAN = 2**31 - 1


def load(name: str) -> dict:
    """The mix file ``traffic/<name>.json``."""
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def stream(seed: int, label: str) -> np.random.Generator:
    """A numpy generator for one purpose of a run, from the run's seed (any
    non-negative integer, 64 bits and more) and a label."""
    words = [ord(c) for c in label]
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, *words]))


@dataclasses.dataclass
class Request:
    index: int
    due_s: float  # seconds after the window opens; closed loop: the burst's slot
    prompt: str
    seed: int
    client: int = 0  # closed loop: the caller that sends it
    burst: int = 0  # closed loop: the caller's burst number

    def body(self, mix: dict) -> dict:
        return {"prompt": self.prompt, "size": mix["size"], "num_inference_steps": mix["steps"],
                "guidance_scale": mix.get("guidance", 1.0), "seed": self.seed}


def open_loop_gaps(arrivals: str, rate: float, seconds: float,
                   rng: np.random.Generator) -> np.ndarray:
    """The gaps before each arrival of an open-loop window: n = rate x seconds
    arrivals, Poisson-like, at the exponential distribution's quantiles
    (i + 0.5) / n, scaled so that the last arrival falls inside the window,
    in the seed's order."""
    n = max(1, int(round(rate * seconds)))
    if arrivals != "poisson":
        raise ValueError(f"unknown arrivals {arrivals!r}")
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds * (1.0 - 0.5 / n) / gaps.sum()
    return rng.permutation(gaps)


def prompts(words: List[str], count: int, lo: int, hi: int, rng: np.random.Generator) -> List[str]:
    lens = rng.integers(lo, hi + 1, size=count)
    return [" ".join(words[i] for i in rng.integers(0, len(words), size=k)) for k in lens]


def request_seeds(count: int, rng: np.random.Generator) -> List[int]:
    """Distinct request seeds (the served image's identity within a run)."""
    out = rng.choice(_SEED_SPAN, size=count, replace=False)
    return [int(s) for s in out]


def schedule(mix: dict, seed: int, seconds: float, words: List[str],
             rate: Optional[float] = None) -> List[Request]:
    """The requests of one run. Open loop: every arrival of the window, with
    its due time. Closed loop: enough requests for any window (a caller
    takes its next burst from its own list), due times filled in by the
    caller as it sends."""
    rng = stream(seed, "traffic")
    lo, hi = mix["prompt_words"]
    if mix["loop"] == "open":
        gaps = open_loop_gaps(mix["arrivals"], rate or mix["rate_per_s"], seconds, rng)
        due = np.cumsum(gaps)
        n = len(due)
        texts = prompts(words, n, lo, hi, rng)
        seeds = request_seeds(n, rng)
        return [Request(i, float(due[i]), texts[i], seeds[i]) for i in range(n)]
    if mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    clients, burst = mix["clients"], mix["burst"]
    # a burst every 20 ms at most: an upper bound on what a window can send
    bursts = int(math.ceil(seconds / 0.02)) + 2
    # one prompt a burst, consecutive seeds from a base of its own
    bases = rng.choice(_SEED_SPAN // burst, size=clients * bursts, replace=False) * burst
    out = []
    for c in range(clients):
        for b in range(bursts):
            text = prompts(words, 1, lo, hi, rng)[0]
            base = int(bases[c * bursts + b])
            for r in range(burst):
                out.append(Request(len(out), 0.0, text, base + r, client=c, burst=b))
    return out
