"""Third-party API compatibility: AUTOMATIC1111 and OpenAI Images (port of
``dreamlab_tpu/serving/compat_endpoints.py``).

- GET  /sdapi/v1/sd-models    the "models" (modes)
- GET  /sdapi/v1/options      a minimal options blob
- GET  /sdapi/v1/samplers     only "LCM"
- POST /sdapi/v1/txt2img      the generate flow per image; seed -1 means
                              random, else image i takes (seed + i) mod
                              (2^31 - 1); base64 images in JSON
- POST /v1/images/generations OpenAI style; b64_json responses only
"""

from __future__ import annotations

import base64
import json
import time

from . import http as web
from .schemas import A1111Txt2ImgRequest, GenerateRequest, OpenAIImagesRequest


def _state(request: web.Request):
    from .app import STATE_KEY

    return request.app[STATE_KEY]


async def sd_models(request: web.Request) -> web.Response:
    state = _state(request)
    if state.mode_config is not None:
        models = [
            {
                "title": name,
                "model_name": name,
                "filename": state.mode_config.get_mode(name).model,
                "hash": None, "sha256": None,
            }
            for name in state.mode_config.mode_names()
        ]
    else:
        models = [{
            "title": "default", "model_name": "default",
            "filename": state.config.model_path or "",
            "hash": None, "sha256": None,
        }]
    return web.json_response(models)


async def sd_options(request: web.Request) -> web.Response:
    state = _state(request)
    current = state.pool.current_mode if state.pool else "default"
    return web.json_response({
        "sd_model_checkpoint": current,
        "samples_format": "png",
    })


async def sd_samplers(request: web.Request) -> web.Response:
    return web.json_response([
        {"name": "LCM", "aliases": ["lcm"], "options": {}}
    ])


async def sd_txt2img(request: web.Request) -> web.Response:
    from .app import run_generate

    state = _state(request)
    req = A1111Txt2ImgRequest.model_validate(await request.json())
    images = []
    seed_used = None
    for i in range(req.batch_size):
        gen = GenerateRequest(
            prompt=req.prompt,
            negative_prompt=req.negative_prompt,
            size=f"{req.width}x{req.height}",
            num_inference_steps=req.steps,
            guidance_scale=req.cfg_scale,
            seed=None if req.seed < 0 else (req.seed + i) % (2**31 - 1),
        )
        data, _, headers = await run_generate(state, gen)
        images.append(base64.b64encode(data).decode())
        if seed_used is None:
            seed_used = int(headers.get("X-Seed", -1))
    return web.json_response({
        "images": images,
        "parameters": req.model_dump(),
        "info": json.dumps({
            "seed": seed_used, "steps": req.steps, "cfg_scale": req.cfg_scale,
            "width": req.width, "height": req.height, "sampler_name": "LCM",
        }),
    })


async def openai_images(request: web.Request) -> web.Response:
    from .app import run_generate

    state = _state(request)
    req = OpenAIImagesRequest.model_validate(await request.json())
    if req.response_format not in ("b64_json",):
        raise web.HTTPBadRequest(text=json.dumps({"detail": "only b64_json is supported"}),
                                 content_type="application/json")
    data_items = []
    for _ in range(req.n):
        gen = GenerateRequest(prompt=req.prompt, size=req.size.replace("×", "x"))
        data, _, _ = await run_generate(state, gen)
        data_items.append({"b64_json": base64.b64encode(data).decode()})
    return web.json_response({"created": int(time.time()), "data": data_items})


def register_compat_routes(app: web.Application):
    app.router.add_get("/sdapi/v1/sd-models", sd_models)
    app.router.add_get("/sdapi/v1/options", sd_options)
    app.router.add_get("/sdapi/v1/samplers", sd_samplers)
    app.router.add_post("/sdapi/v1/txt2img", sd_txt2img)
    app.router.add_post("/v1/images/generations", openai_images)
