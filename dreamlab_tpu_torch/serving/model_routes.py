"""Model management API: the ``/api/*`` routes (port of
``dreamlab_tpu/serving/model_routes.py``).

``/api/models/status``, ``/api/modes``, ``/api/modes/switch`` (queued),
``/api/modes/reload``, ``/api/vram`` and ``/api/hbm`` (the card's memory,
the JAX server's schema), ``/api/styles``, ``/api/models/load`` and
``/api/models/unload`` (501 unless ``DREAMLAB_MODE_CACHE`` > 1, then 409
where the cache or the card has no room or the mode is active) and the
profiler routes, which trace with ``torch.profiler`` and write a Chrome
trace into the directory on stop. Pool, preload and evict calls and the
profiler's start, stop and export run off the event loop. ``/api/trace`` is the
port's own: the span recorder's counters and newest spans
(``utils/tracing.py``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging

from ..utils import tracing
from . import http as web

logger = logging.getLogger(__name__)


def _state(request: web.Request):
    from .app import STATE_KEY

    return request.app[STATE_KEY]


def _json_error(cls, detail: str):
    return cls(text=json.dumps({"detail": detail}), content_type="application/json")


def _require_mode_system(state):
    if state.pool is None or state.mode_config is None:
        raise _json_error(web.HTTPServiceUnavailable, "mode system not enabled")


def _registry(state):
    if state.registry is not None:
        return state.registry
    from ..engine.model_registry import get_model_registry

    return get_model_registry(state.device)


async def models_status(request: web.Request) -> web.Response:
    state = _state(request)
    return web.json_response({
        "backend": state.backend,
        "current_mode": state.pool.current_mode if state.pool else None,
        "queue": state.pool.get_status() if state.pool else None,
        "memory": _registry(state).get_hbm_stats(),
    })


async def list_modes(request: web.Request) -> web.Response:
    state = _state(request)
    _require_mode_system(state)
    d = state.mode_config.to_dict()
    d["current_mode"] = state.pool.current_mode
    d["warm_modes"] = state.pool.get_status().get("warm_modes", [])
    return web.json_response(d)


def _mode_field(body, state, *, known: bool = True) -> str:
    mode = body.get("mode")
    if not mode:
        raise _json_error(web.HTTPBadRequest, "field 'mode' required")
    if known and not state.mode_config.has_mode(mode):
        raise _json_error(web.HTTPNotFound, f"unknown mode {mode!r}")
    return mode


async def switch_mode(request: web.Request) -> web.Response:
    state = _state(request)
    _require_mode_system(state)
    body = await request.json()
    mode = _mode_field(body, state)
    fut = state.pool.switch_mode(mode)
    wait = float(body.get("wait_seconds", 0) or 0)
    if wait > 0:
        # shielded: a wait timeout or a client disconnect must not cancel the
        # queued switch; it still applies, as with wait_seconds=0
        await asyncio.wait_for(asyncio.shield(asyncio.wrap_future(fut)), timeout=wait)
        return web.json_response({"status": "switched", "mode": mode})
    return web.json_response({"status": "queued", "mode": mode})


async def reload_modes(request: web.Request) -> web.Response:
    state = _state(request)
    _require_mode_system(state)
    state.mode_config.reload()
    return web.json_response({
        "status": "reloaded",
        "modes": state.mode_config.mode_names(),
    })


async def hbm_stats(request: web.Request) -> web.Response:
    return web.json_response(_registry(_state(request)).get_hbm_stats())


async def list_styles(request: web.Request) -> web.Response:
    """The style LoRA registry (``engine/styles.py`` over styles.yaml), for the UI."""
    from ..engine.styles import get_style_registry

    return web.json_response({
        "styles": [
            {
                "name": s.name,
                "levels": len(s.strengths),
                "required_cross_attention_dim": s.required_cross_attention_dim,
            }
            for s in get_style_registry().values()
        ]
    })


def _cache_enabled(state) -> bool:
    return (state.pool is not None and state.mode_config is not None
            and state.pool.mode_cache_size > 1)


async def load_model(request: web.Request) -> web.Response:
    """POST /api/models/load {mode}: warm a mode into the cache (with
    ``DREAMLAB_MODE_CACHE`` > 1; 501 otherwise, the reserved contract)."""
    state = _state(request)
    if not _cache_enabled(state):
        return await not_implemented(request)
    mode = _mode_field(await request.json(), state)
    loaded = await asyncio.get_running_loop().run_in_executor(
        None, state.pool.preload_modes, [mode]
    )
    already = (
        mode == state.pool.current_mode
        or mode in state.pool.get_status()["warm_modes"]
    )
    if not loaded and not already:
        return web.json_response(
            {"detail": f"could not load {mode!r} (cache full or HBM tight)"}, status=409,
        )
    return web.json_response({
        "status": "loaded" if loaded else "already_resident", "mode": mode,
    })


async def unload_model(request: web.Request) -> web.Response:
    """POST /api/models/unload {mode}: evict a warm (non-active) mode."""
    state = _state(request)
    if not _cache_enabled(state):
        return await not_implemented(request)
    mode = _mode_field(await request.json(), state, known=False)
    if mode == state.pool.current_mode:
        return web.json_response(
            {"detail": f"mode {mode!r} is active; switch away first"}, status=409,
        )
    try:
        evicted = await asyncio.get_running_loop().run_in_executor(
            None, state.pool.evict_mode, mode
        )
    except ValueError as e:
        return web.json_response({"detail": str(e)}, status=409)
    if not evicted:
        raise _json_error(web.HTTPNotFound, f"mode {mode!r} is not resident")
    return web.json_response({"status": "unloaded", "mode": mode})


async def not_implemented(request: web.Request) -> web.Response:
    return web.json_response(
        {"detail": "not implemented; use /api/modes/switch"}, status=501
    )


async def trace_spans(request: web.Request) -> web.Response:
    """GET /api/trace[?n=]: the recorder's counters and its newest ``n``
    spans (default 1000) as Chrome trace events."""
    try:
        n = int(request.query.get("n", "1000"))
    except ValueError:
        n = -1
    if n < 0:
        raise _json_error(web.HTTPBadRequest, "n must be a whole number, 0 or more")
    return web.json_response({"counters": tracing.counters(),
                              "spans": tracing.chrome_events(n)})


# ---------------------------------------------------------------------------
# profiling: a torch.profiler trace of the host and the card, written as a
# Chrome trace (trace.json) into the directory when it stops. It records
# every thread's operators, and each span of the recorder as a range of its
# name. The profiler starts and stops with no launch section in flight
# (``pipeline.quiesced``): a stop beside another thread's graph replay can
# hang the process. Start, stop and export run on the profiler's own
# thread, one and the same for all three, whatever the profiler keeps per
# thread. The stop and the export take seconds on the card; the loop serves
# on meanwhile only where the profiler lets go of the GIL, which its stop
# on the card mostly does not. Only that
# thread changes ``_PROFILE`` once a route has handed it the work (``busy``
# until it is done). The spans ``profiler.start``, ``profiler.stop`` (each
# with its wait for the launch sections) and ``profiler.export`` time them.
# ---------------------------------------------------------------------------

_PROFILE = {"dir": None, "prof": None, "stopped": False, "busy": False}
_PROFILER_THREAD = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                         thread_name_prefix="profiler")


def _all_threads():
    """Kineto's setting that records the ranges and operators of every
    thread (by default only the starting thread's); None where this torch
    lacks it, and then the trace holds the card's activity and the profiler
    thread's own operators."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


async def _on_profiler_thread(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(_PROFILER_THREAD, fn, *args)


def _start(prof) -> None:
    from ..pipeline import quiesced

    try:
        with tracing.span("profiler.start"), quiesced():
            prof.start()
        _PROFILE.update(prof=prof, stopped=False)
        tracing.annotate(True)
    except Exception:
        _PROFILE["dir"] = None
        raise
    finally:
        _PROFILE["busy"] = False


async def profiler_start(request: web.Request) -> web.Response:
    import os
    import tempfile
    import time as _time

    import torch
    from torch.profiler import ProfilerActivity, profile

    # the body is read BEFORE the running check: no await between check and
    # set, so two concurrent starts cannot both pass
    try:
        body = await request.json()
    except Exception:
        body = {}
    if _PROFILE["dir"] is not None:
        return web.json_response(
            {"detail": f"trace already running: {_PROFILE['dir']}"}, status=409
        )
    trace_dir = body.get("dir") or os.path.join(
        tempfile.gettempdir(), f"dreamlab-trace-{int(_time.time())}"
    )
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _PROFILE.update(dir=trace_dir, busy=True)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities, experimental_config=_all_threads())
    except Exception as e:
        _PROFILE.update(dir=None, busy=False)
        return web.json_response({"detail": f"start_trace failed: {e}"}, status=500)
    try:
        await _on_profiler_thread(_start, prof)
    except Exception as e:
        return web.json_response({"detail": f"start_trace failed: {e}"}, status=500)
    return web.json_response({"status": "tracing", "dir": trace_dir})


def _stop_and_export() -> str:
    """The trace's directory once stopped and written; the marker stays on a
    failure, so that a retry remains possible."""
    import os

    from ..pipeline import quiesced

    try:
        if not _PROFILE["stopped"]:
            tracing.annotate(False)
            with tracing.span("profiler.stop"), quiesced():
                _PROFILE["prof"].stop()
            _PROFILE["stopped"] = True
        trace_dir = _PROFILE["dir"]
        with tracing.span("profiler.export"):
            _PROFILE["prof"].export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        _PROFILE.update(dir=None, prof=None)
        return trace_dir
    finally:
        _PROFILE["busy"] = False


async def profiler_stop(request: web.Request) -> web.Response:
    if _PROFILE["busy"]:
        return web.json_response({"detail": "trace start or stop in progress"}, status=409)
    if _PROFILE["dir"] is None:
        return web.json_response({"detail": "no trace running"}, status=409)
    _PROFILE["busy"] = True
    try:
        trace_dir = await _on_profiler_thread(_stop_and_export)
    except Exception as e:
        return web.json_response({"detail": f"stop_trace failed: {e}"}, status=500)
    return web.json_response({"status": "stopped", "dir": trace_dir})


def register_model_routes(app: web.Application):
    app.router.add_get("/api/models/status", models_status)
    app.router.add_get("/api/modes", list_modes)
    app.router.add_post("/api/modes/switch", switch_mode)
    app.router.add_post("/api/modes/reload", reload_modes)
    app.router.add_get("/api/vram", hbm_stats)  # name kept for compat
    app.router.add_get("/api/hbm", hbm_stats)
    app.router.add_post("/api/models/load", load_model)
    app.router.add_post("/api/models/unload", unload_model)
    app.router.add_get("/api/styles", list_styles)
    app.router.add_post("/api/profiler/start", profiler_start)
    app.router.add_post("/api/profiler/stop", profiler_stop)
    app.router.add_get("/api/trace", trace_spans)
