"""ComfyUI HTTP/WS client (port of ``dreamlab_tpu/invokers/comfy_client.py``).

Upload an input image, submit a prompt graph, follow per-node progress over
the websocket ('executing' events until node=None), fall back to history
polling, and extract output image refs. The JAX client speaks HTTP through
``requests``; this one through ``urllib.request``, with the multipart
upload written by hand. The websocket client (the ``websocket-client``
package) is imported when a run opens its socket; where it is absent the
run polls the history instead, as the JAX client does when its socket
fails.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import urllib.parse
import urllib.request
import uuid
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ComfyFileRef:
    filename: str
    subfolder: str = ""
    type: str = "output"

    def as_query(self) -> Dict[str, str]:
        return {
            "filename": self.filename,
            "subfolder": self.subfolder,
            "type": self.type,
        }


@dataclasses.dataclass
class ComfyInvokeResult:
    prompt_id: str
    outputs: List[ComfyFileRef]


def multipart_body(fields: Dict[str, str], files: Dict[str, tuple]) -> tuple:
    """(body bytes, content type) of a ``multipart/form-data`` form: text
    ``fields`` and ``files`` as name -> (filename, bytes, content type)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                     .encode() + str(value).encode() + b"\r\n")
    for name, (filename, data, ctype) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                     f'filename="{filename}"\r\nContent-Type: {ctype}\r\n\r\n'.encode()
                     + bytes(data) + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class ComfyUIInvoker:
    def __init__(self, base_url: str = "http://127.0.0.1:8188",
                 client_id: Optional[str] = None, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.client_id = client_id or uuid.uuid4().hex
        self.timeout = timeout

    def _request(self, path: str, *, data: Optional[bytes] = None,
                 content_type: Optional[str] = None) -> bytes:
        """The body of a GET (no ``data``) or POST; a status >= 400 raises
        ``urllib.error.HTTPError``."""
        req = urllib.request.Request(f"{self.base_url}{path}", data=data,
                                     method="GET" if data is None else "POST")
        if content_type:
            req.add_header("Content-Type", content_type)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    # ------------------------------------------------------------------
    def upload_image(self, data: bytes, filename: str) -> str:
        body, ctype = multipart_body({"overwrite": "true"},
                                     {"image": (filename, data, "image/png")})
        return json.loads(self._request("/upload/image", data=body,
                                        content_type=ctype)).get("name", filename)

    def submit_prompt(self, graph: Dict) -> str:
        body = json.dumps({"prompt": graph, "client_id": self.client_id}).encode()
        return json.loads(self._request("/prompt", data=body,
                                        content_type="application/json"))["prompt_id"]

    # ------------------------------------------------------------------
    def open_ws(self):
        import websocket

        ws = websocket.WebSocket()
        ws.connect(
            f"{self.base_url.replace('http', 'ws', 1)}/ws?clientId={self.client_id}",
            timeout=self.timeout,
        )
        return ws

    def wait_with_node_progress(
        self,
        prompt_id: str,
        on_node: Optional[Callable[[Optional[str]], None]] = None,
        timeout: float = 900.0,
    ) -> bool:
        """Track 'executing' events until node=None for our prompt."""
        deadline = time.time() + timeout
        try:
            ws = self.open_ws()
        except Exception:
            logger.warning("comfy ws unavailable; falling back to polling")
            return self.wait_for_history(prompt_id, timeout=timeout)
        try:
            while time.time() < deadline:
                try:
                    raw = ws.recv()
                except Exception:
                    break
                if not isinstance(raw, str):
                    continue
                msg = json.loads(raw)
                if msg.get("type") != "executing":
                    continue
                data = msg.get("data", {})
                if data.get("prompt_id") != prompt_id:
                    continue
                node = data.get("node")
                if on_node:
                    on_node(node)
                if node is None:
                    return True
            return self.wait_for_history(prompt_id, timeout=max(deadline - time.time(), 1))
        finally:
            try:
                ws.close()
            except Exception:
                pass

    def wait_for_history(self, prompt_id: str, timeout: float = 900.0,
                         poll: float = 1.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.get_history(prompt_id):
                return True
            time.sleep(poll)
        return False

    # ------------------------------------------------------------------
    def get_history(self, prompt_id: str) -> Optional[Dict]:
        return json.loads(self._request(f"/history/{prompt_id}")).get(prompt_id)

    def extract_outputs(self, history: Dict) -> List[ComfyFileRef]:
        refs: List[ComfyFileRef] = []
        for node_out in (history.get("outputs") or {}).values():
            for img in node_out.get("images", []):
                refs.append(ComfyFileRef(
                    filename=img.get("filename", ""),
                    subfolder=img.get("subfolder", ""),
                    type=img.get("type", "output"),
                ))
        return refs

    def fetch_image(self, ref: ComfyFileRef) -> bytes:
        return self._request("/view?" + urllib.parse.urlencode(ref.as_query()))

    def run(self, graph: Dict, on_node=None, timeout: float = 900.0) -> ComfyInvokeResult:
        prompt_id = self.submit_prompt(graph)
        self.wait_with_node_progress(prompt_id, on_node=on_node, timeout=timeout)
        hist = self.get_history(prompt_id) or {}
        return ComfyInvokeResult(
            prompt_id=prompt_id, outputs=self.extract_outputs(hist)
        )
