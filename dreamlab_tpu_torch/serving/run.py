"""Entry point: ``python -m dreamlab_tpu_torch.serving.run`` (port of
``dreamlab_tpu/serving/run.py``).

Serves on the card: the card is checked first (``utils/verify_cuda.py``)
and a process without one exits with the reason before it binds, unless
``DREAMLAB_DEVICE=cpu`` asks for the plain versions on the CPU.

``--reload`` (or RELOAD=1) runs the server under a supervisor that restarts
it whenever a source file changes: it scans ``dreamlab_tpu_torch/`` (and
``ui/dist`` when present) for ``.py``/``.js``/``.html``/``.css``/``.yaml``
mtime changes once a second, SIGTERMs the child and starts it again.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

_WATCH_EXTS = (".py", ".js", ".html", ".css", ".yaml", ".yml")


def _snapshot(roots):
    state = {}
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
            for f in filenames:
                if f.endswith(_WATCH_EXTS):
                    p = os.path.join(dirpath, f)
                    try:
                        state[p] = os.stat(p).st_mtime
                    except OSError:
                        pass
    return state


def _supervise(cmd=None, roots=None, poll_s: float = 1.0) -> int:
    """Run the server as a child; restart it when watched sources change.

    ``cmd``/``roots``/``poll_s`` exist for tests; the defaults serve this
    package and watch it and ui/dist.
    """
    if roots is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        roots = [pkg_root]
        ui_dist = os.path.join(os.path.dirname(pkg_root), "ui", "dist")
        if os.path.isdir(ui_dist):
            roots.append(ui_dist)
    if cmd is None:
        cmd = [sys.executable, "-m", "dreamlab_tpu_torch.serving.run"]
    env = dict(os.environ)
    env.pop("RELOAD", None)  # the child serves; only the parent watches

    while True:
        child = subprocess.Popen(cmd, env=env)
        state = _snapshot(roots)
        try:
            while True:
                rc = child.poll()
                if rc is not None:
                    # the child died on its own: a crash loop is surfaced,
                    # not hidden behind silent restarts
                    return rc
                time.sleep(poll_s)
                new = _snapshot(roots)
                if new != state:
                    changed = [p for p in set(new) | set(state) if new.get(p) != state.get(p)]
                    print(f"[reload] change detected ({changed[0]}...), restarting server",
                          file=sys.stderr)
                    break
        except KeyboardInterrupt:
            child.terminate()
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
            return 0
        child.send_signal(signal.SIGTERM)
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()


def serve(device=None) -> None:
    """Check the card (unless ``device`` is "cpu"), then serve until stopped."""
    from . import http
    from .app import ServerConfig, create_app, refuse_unported
    from .logging_config import configure_logging

    configure_logging()
    cfg = ServerConfig.from_env()
    refuse_unported(cfg)
    if device != "cpu":
        from ..utils.verify_cuda import verify_cuda

        if not verify_cuda():
            raise SystemExit("no usable CUDA device: the server runs on the card "
                             "(DREAMLAB_DEVICE=cpu runs the plain versions on the CPU)")
    http.run_app(create_app(cfg, device=device), port=cfg.port)


def main():
    argv = sys.argv[1:]
    if "--reload" in argv or os.environ.get("RELOAD") == "1":
        raise SystemExit(_supervise())
    serve(os.environ.get("DREAMLAB_DEVICE") or None)


if __name__ == "__main__":
    main()
