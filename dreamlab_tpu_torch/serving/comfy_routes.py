"""ComfyUI delegation routes: POST /v1/comfy/jobs, GET /v1/comfy/jobs/{id},
GET /v1/comfy/view (port of ``dreamlab_tpu/serving/comfy_routes.py``).

A multipart submit (workflowId, params JSON, optional image) spawns a
daemon thread that uploads the image, submits the patched graph, and tracks
node-by-node progress (fraction capped at 0.95 until terminal).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import uuid

from . import http as web

from ..invokers.comfy_client import ComfyUIInvoker
from ..invokers.jobs import jobs_get, jobs_put, jobs_update, jobs_update_path
from ..invokers.workflow_store import WorkflowStore

logger = logging.getLogger(__name__)

PROGRESS_CAP = 0.95


def _store() -> WorkflowStore:
    return WorkflowStore(os.environ.get("COMFY_WORKFLOWS_DIR", "workflows"))


def _invoker() -> ComfyUIInvoker:
    return ComfyUIInvoker(os.environ.get("COMFYUI_URL", "http://127.0.0.1:8188"))


def _run_job(job_id: str, workflow_id: str, params: dict, image: bytes | None):
    invoker = _invoker()
    store = _store()
    try:
        image_name = None
        if image:
            image_name = invoker.upload_image(image, f"{job_id}.png")
            jobs_update_path(job_id, "progress.stage", "uploaded")
        graph = store.make_prompt(workflow_id, params, image_name)
        total_nodes = max(len(graph), 1)
        seen = set()

        def on_node(node):
            if node is None:
                jobs_update_path(job_id, "progress.fraction", PROGRESS_CAP)
                return
            seen.add(node)
            frac = min(len(seen) / total_nodes, PROGRESS_CAP)
            jobs_update_path(job_id, "progress.fraction", frac)
            jobs_update_path(job_id, "progress.node", node)

        jobs_update(job_id, status="running")
        result = invoker.run(graph, on_node=on_node)
        outputs = [ref.as_query() for ref in result.outputs]
        jobs_update(
            job_id, status="done", outputs=outputs,
            prompt_id=result.prompt_id,
        )
        jobs_update_path(job_id, "progress.fraction", 1.0)
    except Exception as e:
        logger.exception("comfy job %s failed", job_id)
        jobs_update(job_id, status="error", error=str(e))


async def start_job(request: web.Request) -> web.Response:
    post = await request.post()
    workflow_id = post.get("workflowId")
    if not workflow_id:
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "workflowId required"}),
            content_type="application/json",
        )
    try:
        params = json.loads(post.get("params", "{}") or "{}")
    except json.JSONDecodeError:
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "params must be JSON"}),
            content_type="application/json",
        )
    profile = post.get("profile")
    if profile:
        from ..invokers.profiles import resolve_profile

        try:
            params = resolve_profile(str(profile), params)
        except KeyError as e:
            raise web.HTTPBadRequest(
                text=json.dumps({"detail": str(e)}),
                content_type="application/json",
            )
    image = None
    upload = post.get("image")
    if upload is not None and hasattr(upload, "file"):
        image = upload.file.read()

    job_id = uuid.uuid4().hex
    jobs_put(job_id, {
        "status": "pending",
        "workflow_id": workflow_id,
        "params": params,
        "progress": {"fraction": 0.0},
    })
    threading.Thread(
        target=_run_job, args=(job_id, workflow_id, params, image),
        name=f"comfy-{job_id[:8]}", daemon=True,
    ).start()
    return web.json_response({"jobId": job_id, "status": "pending"})


async def get_job(request: web.Request) -> web.Response:
    job = jobs_get(request.match_info["job_id"])
    if job is None:
        raise web.HTTPNotFound(
            text=json.dumps({"detail": "unknown job"}),
            content_type="application/json",
        )
    return web.json_response(job)


async def view_output(request: web.Request) -> web.Response:
    """Proxy a ComfyUI output image so the browser never needs direct
    network reach to the ComfyUI instance (its URL is server-side config)."""
    from ..invokers.comfy_client import ComfyFileRef

    q = request.query
    if not q.get("filename"):
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "filename required"}),
            content_type="application/json",
        )
    ref = ComfyFileRef(
        filename=q["filename"],
        subfolder=q.get("subfolder", ""),
        type=q.get("type", "output"),
    )
    try:
        data = await asyncio.get_running_loop().run_in_executor(
            None, _invoker().fetch_image, ref
        )
    except Exception as e:
        raise web.HTTPBadGateway(
            text=json.dumps({"detail": f"comfy fetch failed: {e}"}),
            content_type="application/json",
        )
    return web.Response(body=data, content_type="image/png")


def register_comfy_routes(app: web.Application):
    app.router.add_post("/v1/comfy/jobs", start_job)
    app.router.add_get("/v1/comfy/jobs/{job_id}", get_job)
    app.router.add_get("/v1/comfy/view", view_output)
