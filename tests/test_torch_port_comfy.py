"""The port's ComfyUI delegation (``dreamlab_tpu_torch.invokers`` and the
``/v1/comfy/*`` routes) on ``tests/test_comfy_integration.py``'s cases,
against the same in-process fake ComfyUI (aiohttp, a test-only
dependency), the port's server on a real socket: the client on
``urllib.request`` with its own multipart upload, per-node progress over
the websocket and the history polling it falls back to without the
``websocket`` package; the routes' job records equal to the JAX server's
for the same submission."""

import json
import sys
import time


from dreamlab_tpu.invokers import jobs as jax_jobs
from dreamlab_tpu.serving import app as japp
from dreamlab_tpu_torch.invokers import jobs as J
from dreamlab_tpu_torch.invokers.comfy_client import ComfyFileRef, ComfyInvokeResult, ComfyUIInvoker
from dreamlab_tpu_torch.serving import app as tapp
from dreamlab_tpu_torch.serving import comfy_routes as cr
from dreamlab_tpu_torch.serving.http import ServerThread
from tests.test_comfy_integration import fake_comfy_url, fake_comfy_ws_url  # noqa: F401
from tests.test_torch_port_server import Pair, as_form, fetch

GRAPH = {
    "1": {"class_type": "LoadImage", "inputs": {"image": "x.png"}},
    "2": {"class_type": "KSampler",
          "inputs": {"steps": 20, "cfg": 7.0, "seed": 1, "denoise": 1.0}},
}


def test_invoker_end_to_end(fake_comfy_url):  # noqa: F811
    url, srv = fake_comfy_url
    inv = ComfyUIInvoker(url, timeout=5)
    assert inv.upload_image(b"\x89PNGdata", "test.png") == "test.png"
    assert srv.uploads["test.png"] == b"\x89PNGdata"
    graph = {"1": {"class_type": "KSampler", "inputs": {"steps": 4}}}
    result = inv.run(graph, timeout=10)
    assert result.prompt_id in srv.prompts and srv.prompts[result.prompt_id] == graph
    assert [r.filename for r in result.outputs] == ["out.png"]
    assert inv.fetch_image(result.outputs[0]).startswith(b"\x89PNG")


def test_invoker_ws_node_progress(fake_comfy_ws_url):  # noqa: F811
    url, _ = fake_comfy_ws_url
    inv = ComfyUIInvoker(url, timeout=5)
    graph = {"1": {"class_type": "LoadImage", "inputs": {}},
             "2": {"class_type": "KSampler", "inputs": {}},
             "3": {"class_type": "SaveImage", "inputs": {}}}
    events = []
    result = inv.run(graph, on_node=events.append, timeout=10)
    assert events == ["1", "2", "3", None]  # others' and non-executing events filtered
    assert result.outputs[0].filename == "out.png"


def test_without_the_websocket_package_the_run_polls_the_history(fake_comfy_ws_url,  # noqa: F811
                                                                   monkeypatch):
    url, _ = fake_comfy_ws_url
    monkeypatch.setitem(sys.modules, "websocket", None)  # the import fails
    events = []
    inv = ComfyUIInvoker(url, timeout=5)
    result = inv.run({"1": {"class_type": "KSampler", "inputs": {}}}, on_node=events.append,
                     timeout=10)
    assert events == [] and result.outputs[0].filename == "out.png"


def _poll(get, job_id):
    deadline = time.time() + 10
    while time.time() < deadline:
        job = get(f"/v1/comfy/jobs/{job_id}").json()
        if job["status"] in ("done", "error"):
            return job
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish")


def test_comfy_routes_end_to_end_as_the_jax_servers(fake_comfy_url, tmp_path,  # noqa: F811
                                                     monkeypatch):
    url, srv = fake_comfy_url
    monkeypatch.setenv("COMFYUI_URL", url)
    monkeypatch.setenv("COMFY_WORKFLOWS_DIR", str(tmp_path))
    (tmp_path / "basic.json").write_text(json.dumps(GRAPH))
    J.jobs_clear()
    jax_jobs.jobs_clear()
    cfg = dict(comfy_enabled=True)
    pair = Pair(japp.create_app(japp.ServerConfig(**cfg), skip_startup=True),
                tapp.create_app(tapp.ServerConfig(**cfg), skip_startup=True))
    try:
        form = as_form({"workflowId": "basic", "params": json.dumps({"steps": 2, "seed": 9}),
                        "profile": "subtle-refine"},
                       {"image": ("up.png", b"\x89imgdata", "image/png")})
        finals = []
        for call in (pair.jax, pair.port):
            reply = call("POST", "/v1/comfy/jobs", *form)
            assert reply.status == 200 and reply.json()["status"] == "pending"
            job_id = reply.json()["jobId"]
            get = (lambda path: pair.jax("GET", path)) if call == pair.jax else \
                (lambda path: pair.port("GET", path))
            final = _poll(get, job_id)
            assert final["status"] == "done", final
            sent = list(srv.prompts.values())[-1]
            assert sent["2"]["inputs"]["steps"] == 2  # explicit wins
            assert sent["2"]["inputs"]["denoise"] == 0.35  # from the profile
            assert sent["1"]["inputs"]["image"] == f"{job_id}.png"
            assert srv.uploads[f"{job_id}.png"] == b"\x89imgdata"
            finals.append({k: v for k, v in final.items()
                           if k not in ("created_at", "heartbeat_at", "prompt_id")})
        assert finals[0] == finals[1]
        assert finals[1]["outputs"][0]["filename"] == "out.png"
        assert finals[1]["progress"]["fraction"] == 1.0
        for path, form in (("/v1/comfy/jobs", as_form({"params": "{}"})),
                           ("/v1/comfy/jobs", as_form({"workflowId": "basic", "params": "{"})),
                           ("/v1/comfy/jobs", as_form({"workflowId": "basic",
                                                       "profile": "nope"}))):
            j, p = pair.both("POST", path, *form)
            assert (j.status, j.json()) == (p.status, p.json()) and p.status == 400
        j, p = pair.both("GET", "/v1/comfy/jobs/nope")
        assert (j.status, j.json()) == (p.status, p.json()) and p.status == 404
    finally:
        pair.close()


def test_route_progress_cap_and_heartbeat(monkeypatch, tmp_path):
    """_run_job with a scripted invoker: the fraction caps at 0.95 until the
    job is done, and every node event refreshes the heartbeat."""
    monkeypatch.setenv("COMFY_WORKFLOWS_DIR", str(tmp_path))
    (tmp_path / "one.json").write_text(json.dumps({
        "1": {"class_type": "KSampler", "inputs": {"steps": 4}},
    }))
    J.jobs_clear()
    job_id = "jid1"
    J.jobs_put(job_id, {"status": "pending", "progress": {"fraction": 0.0}})
    observed = {"fractions": [], "heartbeats": []}

    class ScriptedInvoker:
        def run(self, graph, on_node=None, timeout=900.0):
            J._JOBS[job_id]["heartbeat_at"] = 0.0
            on_node("1")
            observed["fractions"].append(J.jobs_get(job_id)["progress"]["fraction"])
            observed["heartbeats"].append(J.jobs_get(job_id)["heartbeat_at"])
            on_node(None)
            observed["fractions"].append(J.jobs_get(job_id)["progress"]["fraction"])
            return ComfyInvokeResult("pid-x", [ComfyFileRef("out.png")])

    monkeypatch.setattr(cr, "_invoker", lambda: ScriptedInvoker())
    cr._run_job(job_id, "one", {}, None)
    assert observed["fractions"] == [0.95, 0.95]
    assert observed["heartbeats"][0] > 0.0
    final = J.jobs_get(job_id)
    assert final["status"] == "done" and final["progress"]["fraction"] == 1.0


def test_reaper_stale_and_hard_transitions():
    J.jobs_clear()
    now = time.time()
    J.jobs_put("fresh", {"status": "running"})
    J.jobs_put("stalled", {"status": "running"})
    J._JOBS["stalled"]["heartbeat_at"] = now - J.STALE_AFTER_S - 1
    J.jobs_put("ancient", {"status": "pending"})
    J._JOBS["ancient"]["created_at"] = now - J.HARD_TIMEOUT_S - 1
    J.jobs_put("finished", {"status": "done"})
    J._JOBS["finished"]["heartbeat_at"] = 0.0
    assert J.reap_stale_jobs() == 2
    assert J.jobs_get("fresh")["status"] == "running"
    assert J.jobs_get("stalled")["status"] == "error" and "stale" in J.jobs_get("stalled")["error"]
    assert J.jobs_get("ancient")["status"] == "error"
    assert "hard timeout" in J.jobs_get("ancient")["error"]
    assert J.jobs_get("finished")["status"] == "done"
    J.jobs_put("rescued", {"status": "running"})
    J._JOBS["rescued"]["heartbeat_at"] = now - J.STALE_AFTER_S - 1
    J.jobs_update_path("rescued", "progress.node", "5")
    assert J.reap_stale_jobs() == 0
    assert J.jobs_get("rescued")["status"] == "running"


def test_comfy_view_proxy(fake_comfy_url, monkeypatch):  # noqa: F811
    url, _ = fake_comfy_url
    monkeypatch.setenv("COMFYUI_URL", url)
    server = ServerThread(tapp.create_app(tapp.ServerConfig(comfy_enabled=True),
                                          skip_startup=True)).start()
    try:
        reply = fetch(server.port, "GET", "/v1/comfy/view?filename=out.png&type=output")
        assert reply.status == 200 and reply.body.startswith(b"\x89PNG")
        assert fetch(server.port, "GET", "/v1/comfy/view").status == 400
        monkeypatch.setenv("COMFYUI_URL", "http://127.0.0.1:1")  # nothing listens there
        assert fetch(server.port, "GET", "/v1/comfy/view?filename=out.png").status == 502
    finally:
        server.stop()


def test_the_jobs_reaper_thread_starts_once():
    from dreamlab_tpu_torch.serving import startup_hooks

    t = startup_hooks.start_jobs_reaper(interval=0.05)
    assert startup_hooks.start_jobs_reaper() is t and t.is_alive()
    startup_hooks.stop_jobs_reaper()
    t.join(timeout=2)
    assert not t.is_alive()


def test_comfy_routes_are_registered_only_when_enabled():
    server = ServerThread(tapp.create_app(tapp.ServerConfig(), skip_startup=True)).start()
    try:
        assert fetch(server.port, "GET", "/v1/comfy/jobs/x").status == 404
        assert fetch(server.port, "GET", "/health").status == 200
    finally:
        server.stop()
