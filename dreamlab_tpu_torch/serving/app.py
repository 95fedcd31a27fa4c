"""REST server on the standard library, serving the port's pool on the card
(port of ``dreamlab_tpu/serving/app.py``).

The same routes and contracts as the JAX server: ``/generate``,
``/generate/stream`` (SSE), ``/superres``, ``/v1/superres``,
``/v1/img2img``, ``/v1/inpaint``, ``/v1/controlnet``, ``/health``,
``/storage/*``, plus ``/api/*`` (model_routes), ``/sdapi/v1/*`` and
``/v1/images/generations`` (compat_endpoints), ``/v1/comfy/*``
(comfy_routes) and, with ``YUME_ENABLED=1``, ``/dreams/*``
(``yume/dream_endpoints.py``, a dream worker bound at startup to the
pool's worker or the legacy service's first); the same ``X-Seed`` /
``X-Mode`` / ``X-SuperRes`` / ``X-SR-*`` / ``X-ControlNet*`` /
``X-LCM-Image-Key`` / ``X-Strength`` / ``X-Meta-*`` headers, status codes,
JSON bodies and SSE events. Two serving
paths coexist: the mode system (``WorkerPool`` + modes.yaml + registry +
file watcher + SIGHUP) and the legacy env-configured ``PipelineService``.

Where it differs from the JAX server:

- HTTP comes from ``serving/http.py`` (no aiohttp), request validation from
  ``serving/schemas.py`` (no pydantic), and images are decoded by the port's
  PNG reader with PIL's arithmetic (``utils/image_ops.py``: the hint's
  Lanczos resize, the mask's RGB -> L), PIL only for other formats;
- workers are ``create_cuda_worker`` workers on ``device`` (None: the CUDA
  device; "cpu" runs the plain versions). Without a GPU and without
  ``device="cpu"`` the startup fails and says why: there is no CPU
  fallback;
- ``DREAMLAB_MESH="data=D,model=M"`` runs D*M ranks, one per GPU of this
  host (``MeshServing``): this process is rank 0 and serves HTTP, and
  starts ranks 1..D*M-1, which replay its calls
  (``parallel/multihost_router.py``); every mode build and disposal is
  broadcast, so each rank holds the same workers. The model group runs on
  NCCL, requests travel over gloo. A layout with more ranks than visible
  GPUs is refused at startup, naming the counts; ``device="cpu"``
  (``DREAMLAB_DEVICE=cpu``) runs gloo ranks on the CPU. The JAX server
  drives every chip of the mesh from one process;
- there is no compile cache to enable: each process captures its CUDA
  graphs anew.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import itertools
import json
import logging
import os
import signal
from dataclasses import dataclass
from typing import Optional

from ..engine.base import GenSpec
from ..engine.worker_pool import CustomJob, GenerationJob, QueueFullError
from ..utils import tracing
from . import http as web
from .request_logger import make_request_logger_middleware
from .schemas import GenerateRequest, ValidationError

logger = logging.getLogger(__name__)

STATE_KEY = "dreamlab_state"


@dataclass
class ServerConfig:
    """Env-derived settings (the JAX server's names and defaults)."""

    modes_config: Optional[str] = None
    model_path: Optional[str] = None
    num_workers: int = 1
    queue_max: int = 64
    port: int = 8000
    default_size: str = "512x512"
    default_steps: int = 4
    default_guidance: float = 1.0
    request_timeout: float = 120.0
    sr_model_path: Optional[str] = None
    sr_num_workers: int = 1
    sr_queue_max: int = 32
    sr_timeout: float = 120.0
    sr_max_pixels: Optional[int] = None
    ui_dist: Optional[str] = None
    yume_enabled: bool = False
    comfy_enabled: bool = False
    warmup: bool = True
    # multi-device layout (DREAMLAB_MESH: "data=D,model=M"), one rank per GPU
    mesh_spec: Optional[str] = None
    # modes to pre-warm into the cache at startup (DREAMLAB_PRELOAD_MODES:
    # comma list or "all"); needs DREAMLAB_MODE_CACHE > 1
    preload_modes: Optional[str] = None

    @classmethod
    def from_env(cls) -> "ServerConfig":
        env = os.environ

        def get(name, default, cast=str):
            v = env.get(name)
            return cast(v) if v not in (None, "") else default

        model_root = env.get("MODEL_ROOT", "")
        model = env.get("MODEL", "")
        model_path = os.path.join(model_root, model) if model else (model_root or None)
        modes = env.get("MODES_CONFIG") or (
            "modes.yaml" if os.path.exists("modes.yaml") else None
        )
        ui_dist = env.get("UI_DIST")
        if not ui_dist:
            candidate = os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))), "ui", "dist",
            )
            ui_dist = candidate if os.path.isdir(candidate) else None
        return cls(
            modes_config=modes,
            model_path=model_path,
            num_workers=get("NUM_WORKERS", 1, int),
            queue_max=get("QUEUE_MAX", 64, int),
            port=get("PORT", 8000, int),
            default_size=get("DEFAULT_SIZE", "512x512"),
            default_steps=get("DEFAULT_STEPS", 4, int),
            default_guidance=get("DEFAULT_GUIDANCE", 1.0, float),
            request_timeout=get("DEFAULT_TIMEOUT", 120.0, float),
            sr_model_path=env.get("SR_MODEL_PATH"),
            sr_num_workers=get("SR_NUM_WORKERS", 1, int),
            sr_queue_max=get("SR_QUEUE_MAX", 32, int),
            sr_timeout=get("SR_TIMEOUT", 120.0, float),
            sr_max_pixels=get("SR_MAX_PIXELS", None, int),
            ui_dist=ui_dist,
            yume_enabled=env.get("YUME_ENABLED", "0") in ("1", "true", "True"),
            comfy_enabled=env.get("COMFYUI_ENABLED", "0") in ("1", "true", "True"),
            warmup=env.get("WARMUP", "1") not in ("0", "false", "False"),
            mesh_spec=env.get("DREAMLAB_MESH") or None,
            preload_modes=env.get("DREAMLAB_PRELOAD_MODES") or None,
        )


@dataclass
class ServerState:
    config: ServerConfig
    pool: Optional[object] = None  # WorkerPool (mode system)
    legacy: Optional[object] = None  # PipelineService
    sr: Optional[object] = None  # SuperResService
    storage: Optional[object] = None
    mode_config: Optional[object] = None
    registry: Optional[object] = None
    watcher: Optional[object] = None
    device: Optional[str] = None  # None: the CUDA device
    dream_worker: Optional[object] = None  # yume.DreamWorker (YUME_ENABLED)
    mesh: Optional["MeshServing"] = None  # DREAMLAB_MESH's ranks

    @property
    def backend(self) -> str:
        return "mode" if self.pool is not None else "legacy"


def _json_error(cls, detail: str):
    return cls(text=json.dumps({"detail": detail}), content_type="application/json")


# ---------------------------------------------------------------------------
# middlewares
# ---------------------------------------------------------------------------


async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response(status=204)
    else:
        resp = await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, PUT, DELETE, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type, Authorization"
    resp.headers["Access-Control-Expose-Headers"] = "*"
    return resp


async def error_middleware(request: web.Request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except asyncio.TimeoutError:
        return web.json_response({"detail": "request timed out"}, status=504)
    except QueueFullError as e:
        return web.json_response({"detail": str(e)}, status=429)
    except ValidationError as e:
        return web.json_response({"detail": e.errors()}, status=422)
    except ValueError as e:
        return web.json_response({"detail": str(e)}, status=400)
    except Exception:
        logger.exception("unhandled error on %s %s", request.method, request.path)
        return web.json_response({"detail": "internal server error"}, status=500)


# ---------------------------------------------------------------------------
# core handlers
# ---------------------------------------------------------------------------


async def _await_future(fut, timeout: float):
    """Await a concurrent Future; a client disconnect (which cancels the
    handler) or a timeout cancels it, so a job still in the queue is skipped
    instead of spending card time (the pool checks
    set_running_or_notify_cancel before running a job)."""
    try:
        return await asyncio.wait_for(asyncio.wrap_future(fut), timeout=timeout)
    except (asyncio.CancelledError, asyncio.TimeoutError):
        fut.cancel()  # no-op once running; drops jobs still in the queue
        raise


def _decode_hint_image(data: bytes, size: str):
    """Hint bytes -> RGB uint8 array at the output size, as PIL's
    ``convert("RGB")`` and ``resize(..., LANCZOS)`` give it, on host tensors."""
    import torch

    from ..engine.base import parse_size
    from ..utils import image_ops
    from .superres_service import decode_rgb

    width, height = parse_size(size)
    img = decode_rgb(data)
    if img.shape[:2] != (height, width):
        img = image_ops.resize_lanczos(torch.from_numpy(img), (width, height)).numpy()
    return img


def _spec_from_request(req: GenerateRequest, state: ServerState) -> GenSpec:
    control = None
    if req.control_image:
        b64 = req.control_image
        if b64.startswith("data:"):  # data URL -> strip the header
            b64 = b64.split(",", 1)[-1]
        try:
            raw = base64.b64decode(b64, validate=True)
        except Exception as e:
            raise ValueError(f"control_image is not valid base64: {e}") from e
        control = _decode_hint_image(raw, req.size)
    return GenSpec(
        prompt=req.prompt,
        size=req.size,
        num_inference_steps=req.num_inference_steps,
        guidance_scale=req.guidance_scale,
        seed=req.seed,
        negative_prompt=req.negative_prompt,
        style=req.style_lora.style if req.style_lora else None,
        style_level=req.style_lora.level if req.style_lora else 0,
        aesthetic_score=(
            req.aesthetic_score if req.aesthetic_score is not None else 6.0
        ),
        control_image=control,
        controlnet_scale=req.controlnet_scale,
    )


def _apply_mode_defaults(req: GenerateRequest, mode) -> None:
    """Fill the fields the client did not set from the mode's defaults.

    ``model_fields_set`` holds the names the CLIENT provided: a field absent
    from it fell back to the schema default and may take the mode's."""
    set_fields = req.model_fields_set
    if "size" not in set_fields and mode.default_size():
        req.size = mode.default_size()
    if "num_inference_steps" not in set_fields and mode.default_steps():
        req.num_inference_steps = int(mode.default_steps())
    if "guidance_scale" not in set_fields and mode.default_guidance() is not None:
        req.guidance_scale = float(mode.default_guidance())


async def run_generate(state: ServerState, req: GenerateRequest, progress_cb=None):
    """Shared generation flow -> (image_bytes, media type, headers dict)."""
    cfg = state.config

    tenant_mode = None
    if req.mode is not None:
        if state.pool is None:
            raise _json_error(web.HTTPBadRequest, "mode system not enabled")
        if not state.mode_config.has_mode(req.mode):
            raise _json_error(web.HTTPNotFound, f"unknown mode {req.mode!r}")
        if getattr(state.pool, "multi_tenant", False):
            # DREAMLAB_MODE_CACHE > 1: serve from the mode's warm resident
            # worker; the active mode (and every other client's traffic) is
            # untouched. The mode is pinned even when it is the active one
            # now: a queued switch ahead of this job must not re-route it.
            tenant_mode = req.mode
        elif state.pool.current_mode != req.mode:
            fut = state.pool.switch_mode(req.mode)
            await _await_future(fut, timeout=30.0)

    if state.pool is not None and state.mode_config is not None:
        served = tenant_mode or state.pool.current_mode
        if served and state.mode_config.has_mode(served):
            _apply_mode_defaults(req, state.mode_config.get_mode(served))

    spec = _spec_from_request(req, state)
    spec.mode = tenant_mode
    if progress_cb is not None:
        spec.progress_cb = progress_cb

    if state.pool is None and state.legacy is None:
        raise _json_error(web.HTTPServiceUnavailable, "no generation backend loaded")
    job = GenerationJob(spec) if state.pool is not None else None
    request_span = tracing.current()
    if job is not None and request_span is not None:
        request_span.attrs["job"] = job.job_id
    # from the submit to the result back on the event loop
    with tracing.span("http.await", job=None if job is None else job.job_id):
        if job is not None:
            fut = state.pool.submit_job(job)
        else:
            try:
                fut = state.legacy.submit(spec)
            except Exception as e:
                if "Full" in type(e).__name__ or "full" in str(e):
                    raise QueueFullError("queue full") from e
                raise
        png, seed = await _await_future(fut, timeout=cfg.request_timeout)

    headers = {
        "X-Seed": str(seed),
        "X-Mode": (tenant_mode or state.pool.current_mode) if state.pool else "legacy",
        "X-SuperRes": "0",
    }
    if spec.control_image is not None:
        headers["X-ControlNet"] = "1"
        if spec.controlnet_scale is not None:
            applied_scale = spec.controlnet_scale
        elif tenant_mode is not None:
            # the tenant worker's default is its mode's controlnet.scale; a
            # modes.yaml reload may have removed the mode meanwhile, and the
            # finished image must not fail over a header
            try:
                cn = getattr(state.mode_config.get_mode(tenant_mode), "controlnet", None)
            except KeyError:
                cn = None
            applied_scale = cn.scale if cn else 1.0
        else:
            applied_scale = getattr(
                state.pool.worker if state.pool else None, "controlnet_scale", 1.0,
            )
        headers["X-ControlNet-Scale"] = str(applied_scale)
    media_type = "image/png"
    data = png

    if req.superres and state.sr is not None:
        sr_fut = state.sr.submit(
            png, magnitude=req.superres_magnitude,
            out_format=req.superres_format, quality=req.superres_quality,
        )
        data, passes = await _await_future(sr_fut, timeout=cfg.sr_timeout)
        headers.update({
            "X-SuperRes": "1",
            "X-SR-Passes": str(passes),
            "X-SR-Scale-Per-Pass": str(state.sr.cfg.upscale),
            "X-SR-Model": state.sr.model_desc,
        })
        if req.superres_format in ("jpeg", "jpg"):
            media_type = "image/jpeg"

    if state.storage is not None:
        key = state.storage.new_key()
        state.storage.put(
            key, data,
            metadata={
                "prompt": req.prompt[:256], "seed": str(seed),
                "size": req.size, "steps": str(req.num_inference_steps),
            },
            content_type=media_type,
        )
        headers["X-LCM-Image-Key"] = key

    return data, media_type, headers


async def generate_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    req = GenerateRequest.model_validate(await request.json())
    data, media_type, headers = await run_generate(state, req)
    return web.Response(body=data, content_type=media_type, headers=headers)


def _sse(event: str, payload: dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(payload)}\n\n".encode()


async def generate_stream_handler(request: web.Request) -> web.StreamResponse:
    """Server-sent events: one ``progress`` event per step (from the thread
    that waits on the replay's per-step events), then one ``result`` event
    with the base64 image and the metadata /generate sends as headers. Same
    request schema as /generate."""
    state: ServerState = request.app[STATE_KEY]
    req = GenerateRequest.model_validate(await request.json())
    total = req.num_inference_steps

    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Access-Control-Allow-Origin": "*",
    })
    await resp.prepare(request)

    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    def on_step(step: int, timestep: int) -> None:
        # runs on the pool's thread; marshal into the event loop
        loop.call_soon_threadsafe(
            q.put_nowait, ("progress", {
                "step": step, "timestep": timestep, "total_steps": total,
            })
        )

    gen = asyncio.ensure_future(run_generate(state, req, progress_cb=on_step))
    try:
        while True:
            get = asyncio.ensure_future(q.get())
            done, _ = await asyncio.wait({gen, get}, return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                event, payload = get.result()
                await resp.write(_sse(event, payload))
                continue
            get.cancel()
            break
        # flush the progress events that raced with completion
        while not q.empty():
            event, payload = q.get_nowait()
            await resp.write(_sse(event, payload))
        data, media_type, headers = await gen
        await resp.write(_sse("result", {
            "image_b64": base64.b64encode(data).decode(),
            "media_type": media_type,
            "seed": int(headers["X-Seed"]),
            "mode": headers.get("X-Mode"),
            "image_key": headers.get("X-LCM-Image-Key"),
        }))
    except (asyncio.CancelledError, ConnectionResetError):
        gen.cancel()
        raise
    except web.HTTPException as e:
        await resp.write(_sse("error", {"status": e.status, "detail": e.text or e.reason}))
    except Exception as e:  # the status line is already sent: report in the stream
        await resp.write(_sse("error", {"status": 500, "detail": str(e)}))
    await resp.write_eof()
    return resp


def _upload(post, name: str = "file"):
    upload = post.get(name)
    if upload is None or not hasattr(upload, "file"):
        raise _json_error(web.HTTPBadRequest, f"multipart field {name!r} required")
    return upload


async def superres_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    if state.sr is None:
        raise _json_error(web.HTTPServiceUnavailable, "superres not enabled")
    post = await request.post()
    data = _upload(post).file.read()
    magnitude = int(post.get("magnitude", 1))
    out_format = str(post.get("out_format", "png")).lower()
    quality = int(post.get("quality", 90))
    if not 1 <= magnitude <= 3:
        raise _json_error(web.HTTPBadRequest, "magnitude must be 1-3")
    try:
        fut = state.sr.submit(data, magnitude=magnitude, out_format=out_format,
                              quality=quality)
    except Exception as e:
        raise QueueFullError("SR queue full") from e
    out, passes = await _await_future(fut, timeout=state.config.sr_timeout)
    return web.Response(
        body=out,
        content_type="image/jpeg" if out_format in ("jpeg", "jpg") else "image/png",
        headers={
            "X-SR-Passes": str(passes),
            "X-SR-Scale-Per-Pass": str(state.sr.cfg.upscale),
            "X-SR-Model": state.sr.model_desc,
        },
    )


def _prompt(post) -> str:
    prompt = str(post.get("prompt", "") or "")
    if not prompt:
        raise _json_error(web.HTTPBadRequest, "field 'prompt' required")
    return prompt


async def img2img_handler(request: web.Request) -> web.Response:
    """POST /v1/img2img and /v1/inpaint (multipart): file, prompt, strength,
    steps, guidance, seed, negative_prompt, aesthetic_score, optional mask
    -> PNG + X-Seed, X-Mode, X-Strength. Mode system only."""
    from .superres_service import decode_l, decode_rgb

    state: ServerState = request.app[STATE_KEY]
    if state.pool is None:
        raise _json_error(web.HTTPServiceUnavailable, "img2img requires the mode system")
    post = await request.post()
    upload = _upload(post)
    prompt = _prompt(post)
    image = decode_rgb(upload.file.read())
    mask = None
    mask_upload = post.get("mask")
    if mask_upload is not None and hasattr(mask_upload, "file"):
        mask = decode_l(mask_upload.file.read())
    strength = float(post.get("strength", 0.5))
    aesthetic = float(post.get("aesthetic_score", 6.0))
    seed_raw = post.get("seed")
    spec = GenSpec(
        prompt=prompt,
        num_inference_steps=int(post.get("steps", 4)),
        guidance_scale=float(post.get("guidance", 1.0)),
        seed=int(seed_raw) if seed_raw not in (None, "") else None,
        negative_prompt=str(post.get("negative_prompt") or "") or None,
        aesthetic_score=aesthetic,
    )
    fut = state.pool.submit_job(CustomJob(
        lambda worker: worker.run_img2img(spec, image, strength=strength, mask=mask)
    ))
    png, seed = await _await_future(fut, timeout=state.config.request_timeout)
    return web.Response(
        body=png, content_type="image/png",
        headers={"X-Seed": str(seed),
                 "X-Mode": state.pool.current_mode or "",
                 "X-Strength": str(strength)},
    )


async def controlnet_handler(request: web.Request) -> web.Response:
    """POST /v1/controlnet (multipart): file (the hint), prompt, size, steps,
    guidance, seed, negative_prompt, scale -> PNG + X-Seed / X-ControlNet
    headers; /generate's ``control_image`` as a multipart upload. The
    active mode must declare a ``controlnet:``."""
    state: ServerState = request.app[STATE_KEY]
    if state.pool is None:
        raise _json_error(web.HTTPServiceUnavailable, "controlnet requires the mode system")
    post = await request.post()
    upload = _upload(post)
    prompt = _prompt(post)
    size = str(post.get("size", state.config.default_size))
    hint = _decode_hint_image(upload.file.read(), size)
    seed_raw = post.get("seed")
    scale_raw = post.get("scale")
    spec = GenSpec(
        prompt=prompt,
        size=size,
        num_inference_steps=int(post.get("steps", state.config.default_steps)),
        guidance_scale=float(post.get("guidance", state.config.default_guidance)),
        seed=int(seed_raw) if seed_raw not in (None, "") else None,
        negative_prompt=str(post.get("negative_prompt") or "") or None,
        control_image=hint,
        controlnet_scale=float(scale_raw) if scale_raw not in (None, "") else None,
    )
    fut = state.pool.submit_job(GenerationJob(spec))
    png, seed = await _await_future(fut, timeout=state.config.request_timeout)
    return web.Response(
        body=png, content_type="image/png",
        headers={
            "X-Seed": str(seed),
            "X-Mode": state.pool.current_mode or "",
            "X-ControlNet": "1",
            "X-ControlNet-Scale": str(
                spec.controlnet_scale if spec.controlnet_scale is not None
                else getattr(state.pool.worker, "controlnet_scale", 1.0)
            ),
        },
    )


async def health_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    return web.json_response({"status": "ok", "backend": state.backend})


async def storage_get_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    if state.storage is None:
        raise _json_error(web.HTTPServiceUnavailable, "storage disabled")
    item = state.storage.get(request.match_info["key"])
    if item is None:
        raise _json_error(web.HTTPNotFound, "not found")
    return web.Response(
        body=item.data, content_type=item.content_type,
        headers={f"X-Meta-{k}": v for k, v in item.metadata.items()},
    )


async def storage_put_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    if state.storage is None:
        raise _json_error(web.HTTPServiceUnavailable, "storage disabled")
    data = await request.read()
    key = request.match_info["key"]
    state.storage.put(
        key, data, content_type=request.content_type or "application/octet-stream"
    )
    return web.json_response({"key": key, "bytes": len(data)})


async def storage_health_handler(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE_KEY]
    if state.storage is None:
        return web.json_response({"provider": "disabled", "ok": False})
    return web.json_response(state.storage.health())


# ---------------------------------------------------------------------------
# lifespan
# ---------------------------------------------------------------------------


def _preload_names(cfg: ServerConfig, mode_config) -> list:
    if cfg.preload_modes.strip() == "all":
        return mode_config.mode_names()
    return [n.strip() for n in cfg.preload_modes.split(",") if n.strip()]


def build_components(state: ServerState) -> None:
    """Build what ``create_app`` was not given: storage, the SR service and
    the generation backend (the mode system when modes.yaml exists, else the
    legacy service of ``MODEL``), on ``state.device``."""
    import threading

    from ..engine.model_registry import get_model_registry
    from ..persistence import make_storage_provider_from_env
    from ..pipeline import resolve_device
    from .superres_service import SuperResService

    cfg = state.config
    device = resolve_device(state.device)  # no GPU and no device="cpu": refuse

    if state.storage is None:
        state.storage = make_storage_provider_from_env()

    if state.sr is None:
        state.sr = SuperResService(
            model_path=cfg.sr_model_path,
            num_workers=cfg.sr_num_workers,
            queue_max=cfg.sr_queue_max,
            max_pixels=cfg.sr_max_pixels,
            device=device,
        )

    if state.pool is not None or state.legacy is not None:
        return
    from ..engine.worker_factory import create_cuda_worker

    if cfg.mesh_spec and not (cfg.modes_config and os.path.exists(cfg.modes_config)):
        raise ValueError(f"DREAMLAB_MESH={cfg.mesh_spec!r} serves the mode system: it needs "
                         "a modes.yaml (MODES_CONFIG)")
    if cfg.modes_config and os.path.exists(cfg.modes_config):
        from ..engine.mode_config import ModeConfigManager
        from ..engine.worker_pool import WorkerPool

        def factory(worker_id, model_path, *, loras=None, embeddings=None,
                    controlnet=None, refiner=None):
            return create_cuda_worker(worker_id, model_path, device=device, loras=loras,
                                      embeddings=embeddings, controlnet=controlnet,
                                      refiner=refiner)

        if cfg.mesh_spec:
            state.mesh = MeshServing(mesh_layout(cfg, device), device)
            factory = state.mesh.factory

        state.mode_config = ModeConfigManager(cfg.modes_config)
        if state.registry is None:
            state.registry = get_model_registry(device)
        state.pool = WorkerPool(
            queue_max=cfg.queue_max, mode_config=state.mode_config,
            registry=state.registry, worker_factory=factory,
        )
        if cfg.preload_modes:
            # queued behind the default load; the server binds meanwhile
            names = _preload_names(cfg, state.mode_config)
            threading.Thread(target=lambda: state.pool.preload_modes(names),
                             name="mode-preloader", daemon=True).start()
    elif cfg.model_path:
        import torch

        from .legacy_service import PipelineService

        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        warm = tuple(map(int, cfg.default_size.split("x"))) if cfg.warmup else None

        def legacy_factory(i):
            dev = f"cuda:{i}" if device.type == "cuda" else device
            return create_cuda_worker(i, cfg.model_path, warmup_size=warm, device=dev)

        state.legacy = PipelineService(
            legacy_factory, num_workers=min(cfg.num_workers, cards),
            queue_max=cfg.queue_max,
        )
    else:
        logger.warning(
            "no modes.yaml and no MODEL env: serving without a generation "
            "backend (health/storage/SR only)"
        )


async def _startup(app: web.Application):
    state: ServerState = app[STATE_KEY]
    cfg = state.config
    loop = asyncio.get_running_loop()
    await loop.run_in_executor(None, build_components, state)

    # config hot-reload: file watcher + SIGHUP
    if state.pool is not None and cfg.modes_config:
        from ..engine.file_watcher import start_config_watcher

        def reload_config():
            state.mode_config.reload()

        state.watcher = start_config_watcher(cfg.modes_config, reload_config)
        try:
            loop.add_signal_handler(signal.SIGHUP, reload_config)
        except (NotImplementedError, RuntimeError, ValueError):
            pass

    if cfg.yume_enabled:
        from ..yume.dream_init import initialize_dream_system

        worker = None
        if state.pool is not None:
            worker = state.pool.worker
        elif state.legacy is not None and state.legacy.workers:
            worker = state.legacy.workers[0]
        if worker is not None:
            state.dream_worker = await initialize_dream_system(worker, device=state.device)

    if cfg.comfy_enabled:
        from .startup_hooks import start_jobs_reaper

        start_jobs_reaper()


async def _cleanup(app: web.Application):
    state: ServerState = app[STATE_KEY]
    if state.watcher is not None:
        state.watcher.stop()
    if state.dream_worker is not None:
        await state.dream_worker.stop_dreaming()
    for svc in (state.pool, state.legacy, state.sr):
        if svc is not None:
            try:
                svc.shutdown()
            except Exception:
                logger.exception("shutdown error")
    if state.mesh is not None:
        state.mesh.close()
    if state.storage is not None:
        state.storage.close()


# ---------------------------------------------------------------------------
# app factory
# ---------------------------------------------------------------------------


def mesh_layout(cfg: ServerConfig, device=None) -> Optional[dict]:
    """``DREAMLAB_MESH``'s axes, or None without one. On the card a layout
    needs one GPU per rank: one with more ranks than this host's visible
    GPUs is refused, naming the counts (two ranks never share a GPU)."""
    if not cfg.mesh_spec:
        return None
    import torch

    from ..parallel.sharding import parse_mesh_spec

    axes = parse_mesh_spec(cfg.mesh_spec)
    ranks = axes["data"] * axes["model"]
    if torch.device(device or "cuda").type == "cuda":
        gpus = torch.cuda.device_count()
        if ranks > gpus:
            raise ValueError(f"DREAMLAB_MESH={cfg.mesh_spec!r} needs {ranks} ranks, one per "
                             f"GPU, and this host shows {gpus} GPU(s)")
    return axes


MESH_TIMEOUT_S = 600.0  # a collective inside a call, a rank's start, a stop


class MeshServing:
    """``DREAMLAB_MESH`` on this host: this process is rank 0 (it serves
    HTTP); ranks 1..N-1 are started here, one per further device, run
    ``serve_mesh_follower`` and replay rank 0's calls. The pool's worker
    factory is ``factory``: each build is broadcast, so every rank builds
    the same worker, its pipelines wrapped in ``RouterPipeline``s. A rank
    that exits while serving stops every other one."""

    def __init__(self, axes: dict, device):
        import torch

        from ..parallel import multihost

        n = axes["data"] * axes["model"]
        cuda = torch.device(device).type == "cuda"
        devices = [f"cuda:{r}" for r in range(n)] if cuda else ["cpu"] * n
        backend = "cpu:gloo,cuda:nccl" if cuda else "gloo"
        store = multihost.rendezvous(n, MESH_TIMEOUT_S)
        self.ranks = multihost.start_ranks(
            f"{__name__}:serve_mesh_follower", range(1, n), n, store.port, backend=backend,
            devices=devices, timeout=MESH_TIMEOUT_S, args={"axes": axes, "devices": devices})
        try:
            multihost.init_process(f"127.0.0.1:{store.port}", n, 0, backend=backend,
                                   device=devices[0], timeout=MESH_TIMEOUT_S, store=store)
            self.router = _mesh_router(axes, devices[0])
        except Exception:
            self.ranks.kill()
            raise
        self.ranks.watch()
        self._ids = itertools.count(1)
        logger.info("serving over a %dx%d (data, model) mesh: %d ranks on %s over %s",
                    axes["data"], axes["model"], n, devices, backend)

    def factory(self, worker_id, model_path, *, loras=None, embeddings=None,
                controlnet=None, refiner=None):
        """The pool's worker factory: the build runs on every rank."""
        as_dict = lambda c: None if c is None else dataclasses.asdict(c)
        spec = {"model": model_path, "loras": [as_dict(c) for c in loras or ()],
                "embeddings": [as_dict(c) for c in embeddings or ()],
                "controlnet": as_dict(controlnet), "refiner": as_dict(refiner)}
        return self.router.build(f"w{next(self._ids)}", spec)

    def close(self) -> None:
        """Release the followers, wait for them, leave the run."""
        import torch.distributed as dist

        self.router.broadcast_message(None)
        self.ranks.close(MESH_TIMEOUT_S)
        dist.destroy_process_group()


def _mesh_router(axes: dict, device: str):
    """This rank's mesh and router, its builder building the pool's workers
    on this rank's device."""
    import functools

    import torch

    from ..parallel.multihost_router import MultihostRouter
    from ..parallel.sharding import make_mesh

    mesh = make_mesh(model=axes["model"], device_type=torch.device(device).type)
    # the followers wait on rank 0's next call for as long as the server idles
    router = MultihostRouter(timeout=365 * 86400.0)
    router.builder = functools.partial(_build_mesh_worker, mesh=mesh, device=device,
                                       tensor_parallel=axes["model"] > 1)
    return router


def _build_mesh_worker(router, pipe_id: str, spec: dict, *, mesh, device, tensor_parallel):
    """One rank's worker of a build message: ``create_cuda_worker`` on the
    rank's device and mesh, its pipelines registered with the router."""
    from ..engine import mode_config as mc
    from ..engine.worker_factory import create_cuda_worker
    from ..parallel.multihost_router import RouterPipeline

    of = lambda cls, d: None if d is None else cls(**d)
    worker = create_cuda_worker(
        0, spec["model"], device=device, mesh=mesh, tensor_parallel=tensor_parallel,
        loras=[of(mc.LoRAConfig, d) for d in spec["loras"]],
        embeddings=[of(mc.EmbeddingConfig, d) for d in spec["embeddings"]],
        controlnet=of(mc.ControlNetConfig, spec["controlnet"]),
        refiner=of(mc.RefinerConfig, spec["refiner"]))
    worker.pipeline = RouterPipeline(worker.pipeline, router, pipe_id)
    if worker.refiner is not None:
        worker.refiner = RouterPipeline(worker.refiner, router, f"{pipe_id}/refiner")
    return worker


def serve_mesh_follower(axes: dict, devices: list) -> int:
    """A follower rank of ``MeshServing`` (started by rank 0): build what
    rank 0 builds, run what it runs, until it stops the run."""
    import torch.distributed as dist

    router = _mesh_router(axes, devices[dist.get_rank()])
    served = router.serve_follower()
    logger.info("mesh follower rank %d served %d messages", router.rank, served)
    return 0


def create_app(
    config: Optional[ServerConfig] = None,
    *,
    pool=None,
    legacy=None,
    sr=None,
    storage=None,
    mode_config=None,
    registry=None,
    skip_startup: bool = False,
    device=None,
) -> web.Application:
    """Build the server. Components are injectable for tests; the rest is
    built at startup on ``device`` (None: the CUDA device)."""
    cfg = config or ServerConfig.from_env()
    mesh_layout(cfg, device)  # a layout the devices cannot hold: refused here
    state = ServerState(
        config=cfg, pool=pool, legacy=legacy, sr=sr, storage=storage,
        mode_config=mode_config, registry=registry, device=device,
    )

    app = web.Application(
        middlewares=[
            make_request_logger_middleware(),
            cors_middleware,
            error_middleware,
        ],
        client_max_size=64 << 20,
    )
    app[STATE_KEY] = state

    app.router.add_post("/generate", generate_handler)
    app.router.add_post("/generate/stream", generate_stream_handler)
    app.router.add_post("/superres", superres_handler)
    app.router.add_post("/v1/superres", superres_handler)
    app.router.add_post("/v1/img2img", img2img_handler)
    app.router.add_post("/v1/inpaint", img2img_handler)
    app.router.add_post("/v1/controlnet", controlnet_handler)
    app.router.add_get("/health", health_handler)
    app.router.add_get("/storage/health", storage_health_handler)
    app.router.add_get("/storage/{key:.+}", storage_get_handler)
    app.router.add_put("/storage/{key:.+}", storage_put_handler)

    from .compat_endpoints import register_compat_routes
    from .model_routes import register_model_routes

    register_model_routes(app)
    register_compat_routes(app)

    if cfg.comfy_enabled:
        from .comfy_routes import register_comfy_routes

        register_comfy_routes(app)
    if cfg.yume_enabled:
        from ..yume.dream_endpoints import register_dream_routes

        register_dream_routes(app)

    if cfg.ui_dist and os.path.isdir(cfg.ui_dist):
        index_path = os.path.join(cfg.ui_dist, "index.html")

        async def index(request: web.Request) -> web.Response:
            return web.file_response(index_path)

        if os.path.exists(index_path):
            app.router.add_get("/", index)
        app.router.add_static("/", cfg.ui_dist)

    if not skip_startup:
        app.on_startup.append(_startup)
        app.on_cleanup.append(_cleanup)
    return app


def main():  # pragma: no cover - process entry point
    from .logging_config import configure_logging

    configure_logging()
    cfg = ServerConfig.from_env()
    app = create_app(cfg)
    web.run_app(app, port=cfg.port)


if __name__ == "__main__":  # pragma: no cover
    main()
