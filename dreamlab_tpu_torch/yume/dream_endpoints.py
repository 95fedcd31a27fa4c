"""Dream session routes, ``/dreams/*`` (port of
``dreamlab_tpu/yume/dream_endpoints.py`` onto ``serving/http.py``'s router).

POST /dreams/start, POST /dreams/stop, GET /dreams/status, /dreams/top,
/dreams/recent, /dreams/stats, and GET /dreams/image/{candidate_id} for
rendered candidates; the JAX server's status codes and bodies: 503 without
a dream worker, 400 without a prompt, 409 on a second start, 404 for an
image never rendered.
"""

from __future__ import annotations

import json

from ..serving import http as web
from .dream_worker import get_dream_worker


def _dream(request: web.Request):
    worker = get_dream_worker()
    if worker is None:
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"detail": "yume not initialized"}),
            content_type="application/json",
        )
    return worker


async def start_session(request: web.Request) -> web.Response:
    dream = _dream(request)
    body = await request.json()
    prompt = body.get("prompt")
    if not prompt:
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "field 'prompt' required"}),
            content_type="application/json",
        )
    try:
        info = await dream.start_dreaming(
            prompt,
            duration_s=body.get("duration_s"),
            strategy=body.get("strategy", "temperature"),
            temperature=float(body.get("temperature", 0.7)),
        )
    except RuntimeError as e:
        raise web.HTTPConflict(
            text=json.dumps({"detail": str(e)}), content_type="application/json"
        )
    return web.json_response(info)


async def stop_session(request: web.Request) -> web.Response:
    dream = _dream(request)
    return web.json_response(await dream.stop_dreaming())


async def status(request: web.Request) -> web.Response:
    return web.json_response(_dream(request).get_status())


async def top(request: web.Request) -> web.Response:
    n = int(request.query.get("n", 10))
    return web.json_response({"top": _dream(request).get_top_dreams(n)})


async def recent(request: web.Request) -> web.Response:
    n = int(request.query.get("n", 20))
    return web.json_response({"recent": _dream(request).get_recent(n)})


async def stats(request: web.Request) -> web.Response:
    st = _dream(request).get_status()
    return web.json_response(st["stats"] | {"session_id": st["session_id"]})


async def image(request: web.Request) -> web.Response:
    png = _dream(request).get_rendered_png(request.match_info["candidate_id"])
    if png is None:
        raise web.HTTPNotFound(
            text=json.dumps({"detail": "no rendered image"}),
            content_type="application/json",
        )
    return web.Response(body=png, content_type="image/png")


def register_dream_routes(app: web.Application):
    app.router.add_post("/dreams/start", start_session)
    app.router.add_post("/dreams/stop", stop_session)
    app.router.add_get("/dreams/status", status)
    app.router.add_get("/dreams/top", top)
    app.router.add_get("/dreams/recent", recent)
    app.router.add_get("/dreams/stats", stats)
    app.router.add_get("/dreams/image/{candidate_id}", image)
