"""Request/response logging middleware (port of
``dreamlab_tpu/serving/request_logger.py``): logs
``[REQ] METHOD path?query`` with an allowlisted+redacted header set and a
summarized body (JSON compacted to a cap, multipart size-only), then
``[RESP] METHOD path -> status (N ms)``. Env-tunable: LOG_REQUESTS,
LOG_BODY_MAX, LOG_PATH_PREFIXES, LOG_PATH_DENYLIST.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterable, Optional

from . import http as web

logger = logging.getLogger("dreamlab.requests")

_REDACT = {"authorization", "cookie", "x-api-key"}
_ALLOW = {"content-type", "content-length", "user-agent", "accept", "host"}


class RequestLoggerConfig:
    def __init__(
        self,
        enabled: Optional[bool] = None,
        body_max: Optional[int] = None,
        path_prefixes: Optional[Iterable[str]] = None,
        path_denylist: Optional[Iterable[str]] = None,
    ):
        env = os.environ
        self.enabled = (
            enabled if enabled is not None
            else env.get("LOG_REQUESTS", "1") not in ("0", "false", "False")
        )
        self.body_max = body_max if body_max is not None else int(env.get("LOG_BODY_MAX", "512"))
        raw_prefixes = env.get("LOG_PATH_PREFIXES", "")
        self.path_prefixes = list(
            path_prefixes if path_prefixes is not None
            else [p for p in raw_prefixes.split(",") if p]
        )
        raw_deny = env.get("LOG_PATH_DENYLIST", "/health")
        self.path_denylist = list(
            path_denylist if path_denylist is not None
            else [p for p in raw_deny.split(",") if p]
        )

    def should_log(self, path: str) -> bool:
        if not self.enabled:
            return False
        if any(path.startswith(p) for p in self.path_denylist):
            return False
        if self.path_prefixes:
            return any(path.startswith(p) for p in self.path_prefixes)
        return True


def _headers_summary(headers) -> str:
    out = []
    for k, v in headers.items():
        kl = k.lower()
        if kl in _REDACT:
            out.append(f"{k}=<redacted>")
        elif kl in _ALLOW:
            out.append(f"{k}={v}")
    return " ".join(out)


def _body_summary(body: bytes, content_type: str, cap: int) -> str:
    if not body:
        return ""
    if "multipart" in content_type:
        return f"<multipart {len(body)} bytes>"
    if "json" in content_type:
        try:
            compact = json.dumps(json.loads(body), separators=(",", ":"))
            return compact[:cap] + ("…" if len(compact) > cap else "")
        except (ValueError, UnicodeDecodeError):
            pass
    return f"<{len(body)} bytes>"


def make_request_logger_middleware(config: Optional[RequestLoggerConfig] = None):
    cfg = config or RequestLoggerConfig()

    async def middleware(request: web.Request, handler):
        if not cfg.should_log(request.path):
            return await handler(request)
        t0 = time.time()
        content_type = request.content_type or ""
        if "multipart" in content_type:
            # a multipart body is described by its size only
            body_desc = f"<multipart {request.content_length or 0} bytes>"
        else:
            body = b""
            if request.can_read_body and request.content_length and request.content_length < 10 << 20:
                body = await request.read()
            body_desc = _body_summary(body, content_type, cfg.body_max)
        q = f"?{request.query_string}" if request.query_string else ""
        logger.info(
            "[REQ] %s %s%s %s %s",
            request.method, request.path, q,
            _headers_summary(request.headers), body_desc,
        )
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        except Exception:
            status = 500
            raise
        finally:
            logger.info(
                "[RESP] %s %s -> %s (%d ms)",
                request.method, request.path, status,
                int(1e3 * (time.time() - t0)),
            )

    return middleware
