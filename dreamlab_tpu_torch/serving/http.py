"""The part of aiohttp's server that the serving app uses, on the standard
library (``asyncio.start_server``).

The JAX package's server is written on aiohttp; the port keeps its handlers'
shape (``request.json()``, ``request.post()``, ``Response``,
``json_response``, ``StreamResponse``, HTTP exceptions, middlewares) on this
module instead, so that it needs no package beyond the standard library:

- HTTP/1.1 with keep-alive (HTTP/1.0 closes unless asked to keep alive),
  ``Content-Length`` and chunked request bodies, ``Expect: 100-continue``;
- a body cap (``client_max_size``, 64 MiB in the app) answered with 413;
- a router of literal segments, ``{name}`` and ``{name:regex}`` patterns,
  tried in the order they were added (a literal route added first wins over
  a pattern that also matches), then the static directory; a path that
  matches no route is 404, one whose routes take other methods 405;
- middlewares, outermost first, each ``await middleware(request, handler)``;
- static files with a traversal guard (outside the root: 404, a
  directory: 403).

A request's body is read before its handler runs. While the handler runs
the connection is watched: a client that closes it cancels the handler's
task, so a handler awaiting a queued job can cancel that job. Data that a
client pipelines meanwhile is kept for the next request. A client that
only half-closes its side counts as gone.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import logging
import mimetypes
import os
import re
import threading
import urllib.parse
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from ..utils import tracing

logger = logging.getLogger(__name__)

_REASONS = {
    100: "Continue", 200: "OK", 204: "No Content", 400: "Bad Request",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Request Entity Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}
_MAX_HEAD = 64 << 10  # request line and headers
_READ = 1 << 16


class Headers(dict):
    """A case-insensitive ``str -> str`` mapping that keeps each key's
    first spelling (one value per name)."""

    def __init__(self, items=()):
        super().__init__()
        self._names: Dict[str, str] = {}
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v

    def __setitem__(self, key, value):
        low = key.lower()
        name = self._names.setdefault(low, key)
        super().__setitem__(name, str(value))

    def __getitem__(self, key):
        return super().__getitem__(self._names[key.lower()])

    def __delitem__(self, key):
        super().__delitem__(self._names.pop(key.lower()))

    def __contains__(self, key):
        return isinstance(key, str) and key.lower() in self._names

    def get(self, key, default=None):
        return self[key] if key in self else default

    def pop(self, key, *default):
        if key in self:
            value = self[key]
            del self[key]
            return value
        if default:
            return default[0]
        raise KeyError(key)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, other=(), **kw):
        for k, v in (other.items() if hasattr(other, "items") else other):
            self[k] = v
        for k, v in kw.items():
            self[k] = v


# ---------------------------------------------------------------------------
# responses and HTTP exceptions
# ---------------------------------------------------------------------------


class StreamResponse:
    """A response whose body is written in chunks after ``prepare``
    (``Transfer-Encoding: chunked``); headers set after ``prepare`` are not
    sent."""

    def __init__(self, *, status: int = 200, headers=None):
        self.status = status
        self.headers = Headers(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self._head_only = False
        self.prepared = False

    async def prepare(self, request: "Request") -> None:
        if self.prepared:
            return
        self._writer = request._writer
        self._head_only = request.method == "HEAD"
        self.headers.pop("Content-Length", None)
        self.headers["Transfer-Encoding"] = "chunked"
        request._conn.keep_alive(request, self)
        self._writer.write(_head(self.status, self.headers))
        self.prepared = True
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not self.prepared:
            raise RuntimeError("write() before prepare()")
        if data and not self._head_only:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), bytes(data)))
            await self._writer.drain()

    async def write_eof(self) -> None:
        if self._writer is not None and not self._head_only:
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()
        self._writer = None


class Response(StreamResponse):
    """A response with its whole body (``body`` bytes or ``text``)."""

    def __init__(self, *, body: bytes = b"", text: Optional[str] = None, status: int = 200,
                 content_type: Optional[str] = None, headers=None):
        super().__init__(status=status, headers=headers)
        if text is not None:
            body = text.encode("utf-8")
            content_type = (content_type or "text/plain") + "; charset=utf-8"
        self.body = bytes(body)
        if content_type:
            self.headers["Content-Type"] = content_type
        elif self.body and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "").split(";")[0].strip()


def json_response(data, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, content_type="application/json",
                    headers=headers)


class HTTPException(Response, Exception):
    """A response raised as an exception: its status, and a body that is
    ``text`` (JSON where ``content_type`` says so) or "<status>: <reason>"."""

    status_code = 500

    def __init__(self, *, text: Optional[str] = None,
                 content_type: Optional[str] = None, headers=None):
        if text is None:
            text = f"{self.status_code}: {_REASONS.get(self.status_code, '')}"
            content_type = "text/plain"
        Response.__init__(self, text=text, status=self.status_code,
                          content_type=content_type, headers=headers)
        Exception.__init__(self, text)
        self.text = text
        self.reason = _REASONS.get(self.status_code, "")


def _http_error(code: int, name: str):
    return type(name, (HTTPException,), {"status_code": code})


HTTPBadRequest = _http_error(400, "HTTPBadRequest")
HTTPForbidden = _http_error(403, "HTTPForbidden")
HTTPNotFound = _http_error(404, "HTTPNotFound")
HTTPMethodNotAllowed = _http_error(405, "HTTPMethodNotAllowed")
HTTPConflict = _http_error(409, "HTTPConflict")
HTTPRequestEntityTooLarge = _http_error(413, "HTTPRequestEntityTooLarge")
HTTPBadGateway = _http_error(502, "HTTPBadGateway")
HTTPServiceUnavailable = _http_error(503, "HTTPServiceUnavailable")


def _head(status: int, headers: Headers) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1", errors="replace")


# ---------------------------------------------------------------------------
# requests and form bodies
# ---------------------------------------------------------------------------


class FileField:
    """A multipart part that carried a filename (aiohttp's ``FileField``)."""

    def __init__(self, name: str, filename: str, data: bytes, content_type: str, headers):
        import io

        self.name, self.filename, self.content_type = name, filename, content_type
        self.headers = headers
        self.file = io.BytesIO(data)


def _params(value: str) -> Tuple[str, Dict[str, str]]:
    """'type/sub; a=1; b="x"' -> ('type/sub', {'a': '1', 'b': 'x'})."""
    parts = value.split(";")
    out = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            v = v.strip()
            if len(v) >= 2 and v[0] == v[-1] == '"':
                v = v[1:-1].replace('\\"', '"')
            out[k.strip().lower()] = v
    return parts[0].strip().lower(), out


def parse_multipart(body: bytes, boundary: str) -> List[Tuple[str, object]]:
    """``multipart/form-data`` -> [(name, str or FileField)] in order."""
    delim = b"--" + boundary.encode("latin-1")
    out = []
    for part in body.split(delim)[1:]:
        if part.startswith(b"--"):
            break
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, sep, data = part.partition(b"\r\n\r\n")
        if not sep:
            raise ValueError("malformed multipart body")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        headers = Headers()
        for line in head.decode("utf-8", errors="replace").split("\r\n"):
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip()] = v.strip()
        _, disp = _params(headers.get("Content-Disposition", ""))
        name = disp.get("name", "")
        ctype, cparams = _params(headers.get("Content-Type", "text/plain"))
        if "filename" in disp:
            out.append((name, FileField(name, disp["filename"], data,
                                        headers.get("Content-Type", "application/octet-stream"),
                                        headers)))
        else:
            out.append((name, data.decode(cparams.get("charset", "utf-8"))))
    return out


class Request:
    """One request: its line, headers and whole body, and the route's
    ``match_info``."""

    def __init__(self, app: "Application", method: str, target: str, version: str,
                 headers: Headers, body: bytes, writer, conn):
        self.app = app
        self.method = method
        self.version = version
        self.headers = headers
        self._body = body
        self._writer = writer
        self._conn = conn
        self._post = None
        raw_path, _, self.query_string = target.partition("?")
        # percent-decoded, dot segments kept (as aiohttp's server does): a
        # route matches the path as sent, and the static guard refuses ".."
        # out of its root
        self.path = urllib.parse.unquote(raw_path)
        self.query = dict(urllib.parse.parse_qsl(self.query_string, keep_blank_values=True))
        self.match_info: Dict[str, str] = {}
        self.received_ns: Optional[int] = None  # tracing.now() once its head was read
        self.content_type, self._ct_params = _params(
            headers.get("Content-Type", "application/octet-stream"))
        self.charset = self._ct_params.get("charset")

    @property
    def content_length(self) -> Optional[int]:
        cl = self.headers.get("Content-Length")
        return int(cl) if cl is not None else (len(self._body) if self._body else None)

    @property
    def can_read_body(self) -> bool:
        return bool(self._body)

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode(self.charset or "utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def post(self) -> Dict[str, object]:
        """The form body: ``multipart/form-data`` (parts with a filename as
        ``FileField``) or ``application/x-www-form-urlencoded``; the first
        value of each name. Other bodies give an empty form."""
        if self._post is None:
            form: Dict[str, object] = {}
            if self.content_type == "multipart/form-data":
                boundary = self._ct_params.get("boundary")
                if not boundary:
                    raise ValueError("multipart body without a boundary")
                pairs = parse_multipart(self._body, boundary)
            elif self.content_type == "application/x-www-form-urlencoded":
                pairs = urllib.parse.parse_qsl(self._body.decode(self.charset or "utf-8"),
                                               keep_blank_values=True)
            else:
                pairs = []
            for k, v in pairs:
                form.setdefault(k, v)
            self._post = form
        return self._post


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

Handler = Callable[[Request], Awaitable[StreamResponse]]


class _Route:
    def __init__(self, method: str, path: str, handler: Handler):
        self.method, self.path, self.handler = method, path, handler
        self.regex = re.compile("^" + _pattern(path) + "$")


def _pattern(path: str) -> str:
    out, pos = [], 0
    for m in re.finditer(r"\{(\w+)(?::((?:[^{}]|\{[^{}]*\})+))?\}", path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return "".join(out)


class Router:
    def __init__(self):
        self.routes: List[_Route] = []
        self.static: Optional[Tuple[str, str]] = None  # (prefix, directory)

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.append(_Route(method.upper(), path, handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_put(self, path: str, handler: Handler) -> None:
        self.add_route("PUT", path, handler)

    def add_static(self, prefix: str, directory: str) -> None:
        self.static = (prefix.rstrip("/"), os.path.realpath(directory))

    def resolve(self, request: Request) -> Handler:
        """The handler of the request's path and method (HEAD takes GET's),
        or one that raises 404 or 405."""
        allowed = set()
        method = "GET" if request.method == "HEAD" else request.method
        for route in self.routes:
            m = route.regex.match(request.path)
            if m is None:
                continue
            if route.method != method:
                allowed.add(route.method)
                continue
            request.match_info = {k: v for k, v in m.groupdict().items()}
            return route.handler
        if self.static is not None:
            prefix, directory = self.static
            if request.path.startswith(prefix + "/"):
                if method == "GET":
                    request.match_info = {"filename": request.path[len(prefix) + 1:]}
                    return lambda req: _static_file(directory, req.match_info["filename"])
                allowed |= {"GET", "HEAD"}
        if allowed:
            allow = ",".join(sorted(allowed | ({"HEAD"} if "GET" in allowed else set())))

            async def not_allowed(_request):
                raise HTTPMethodNotAllowed(headers={"Allow": allow})

            return not_allowed

        async def not_found(_request):
            raise HTTPNotFound()

        return not_found


async def _static_file(directory: str, filename: str) -> Response:
    path = os.path.realpath(os.path.join(directory, filename))
    if os.path.commonpath([path, directory]) != directory:
        raise HTTPNotFound()
    if os.path.isdir(path):
        raise HTTPForbidden()
    return file_response(path)


def file_response(path: str) -> Response:
    """A file's bytes with the type its name says; a missing file is an
    empty 404 response (returned, not raised, as aiohttp's FileResponse
    does, so the middlewares still see it)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
        return Response(status=404, content_type="application/octet-stream")
    ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
    return Response(body=data, content_type=ctype)


class Application(dict):
    """Routes, middlewares (outermost first), the body cap and the startup
    and cleanup hooks (``async def hook(app)``); app-wide state in its
    mapping."""

    def __init__(self, *, middlewares=(), client_max_size: int = 1 << 20):
        super().__init__()
        self.router = Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.on_startup: List[Callable] = []
        self.on_cleanup: List[Callable] = []

    async def handle(self, request: Request) -> StreamResponse:
        handler = self.router.resolve(request)
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return await handler(request)


def _bind(mw, handler):
    async def call(request):
        return await mw(request, handler)
    return call


# ---------------------------------------------------------------------------
# the connection loop
# ---------------------------------------------------------------------------


class _Disconnected(Exception):
    pass


class _Connection:
    def __init__(self, app: Application, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.app, self.reader, self.writer = app, reader, writer
        self.buf = bytearray()
        self.eof = False
        self.close_after = False

    async def _fill(self) -> None:
        if self.eof:
            raise _Disconnected()
        data = await self.reader.read(_READ)
        if not data:
            self.eof = True
            raise _Disconnected()
        self.buf += data

    async def _read_until(self, sep: bytes, limit: int) -> bytes:
        while True:
            i = self.buf.find(sep)
            if i >= 0:
                out = bytes(self.buf[:i])
                del self.buf[:i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise ValueError("header section too large")
            await self._fill()

    async def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            await self._fill()
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    def keep_alive(self, request: Request, response: StreamResponse) -> None:
        """Decide whether the connection outlives this response and say so."""
        conn = request.headers.get("Connection", "").lower()
        if request.version == "HTTP/1.0":
            close = conn != "keep-alive"
        else:
            close = conn == "close"
        self.close_after = self.close_after or close
        if self.close_after:
            response.headers["Connection"] = "close"
        elif request.version == "HTTP/1.0":
            response.headers["Connection"] = "keep-alive"
        response.headers.setdefault("Date", email.utils.formatdate(usegmt=True))
        response.headers.setdefault("Server", "dreamlab-torch")

    async def _send(self, request: Optional[Request], response: StreamResponse) -> None:
        if response.prepared:
            return
        body = getattr(response, "body", b"")
        response.headers["Content-Length"] = str(len(body))
        if request is not None:
            self.keep_alive(request, response)
        else:
            self.close_after = True
            response.headers["Connection"] = "close"
        self.writer.write(_head(response.status, response.headers))
        if body and not (request is not None and request.method == "HEAD"):
            self.writer.write(body)
        await self.writer.drain()

    async def _read_request(self) -> Optional[Request]:
        """The next request, or None when the client is done. Raises an
        HTTPException for a request to refuse before its handler."""
        try:
            while self.buf[:2] == b"\r\n":  # stray line breaks between requests
                del self.buf[:2]
            head = await self._read_until(b"\r\n\r\n", _MAX_HEAD)
            received = tracing.now()
        except _Disconnected:
            return None
        except ValueError:
            self.close_after = True
            raise _http_error(431, "HTTPHeaderTooLarge")()
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            self.close_after = True
            raise HTTPBadRequest(text="malformed request line", content_type="text/plain")
        headers = Headers()
        for line in lines[1:]:
            k, sep, v = line.partition(":")
            if not sep:
                self.close_after = True
                raise HTTPBadRequest(text="malformed header", content_type="text/plain")
            headers[k.strip()] = v.strip()
        cap = self.app.client_max_size
        if headers.get("Transfer-Encoding", "").lower() == "chunked":
            self._continue(headers)
            body = await self._read_chunked(cap)
        else:
            n = int(headers.get("Content-Length", "0") or 0)
            if n > cap:
                self.close_after = True
                raise self._too_large(n)
            self._continue(headers)
            body = await self._read_exact(n) if n else b""
        request = Request(self.app, method.upper(), target, version, headers, body,
                          self.writer, self)
        request.received_ns = received
        return request

    def _continue(self, headers: Headers) -> None:
        if headers.get("Expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")

    def _too_large(self, size: int) -> HTTPException:
        return HTTPRequestEntityTooLarge(
            text=f"Maximum request body size {self.app.client_max_size} exceeded, "
                 f"actual body size {size}", content_type="text/plain")

    async def _read_chunked(self, cap: int) -> bytes:
        body = bytearray()
        while True:
            size = int((await self._read_until(b"\r\n", _MAX_HEAD)).split(b";")[0], 16)
            if size == 0:
                while await self._read_until(b"\r\n", _MAX_HEAD):  # trailers
                    pass
                return bytes(body)
            if len(body) + size > cap:
                self.close_after = True
                raise self._too_large(len(body) + size)
            body += await self._read_exact(size)
            await self._read_exact(2)

    async def _run_handler(self, request: Request) -> Optional[StreamResponse]:
        """The handler's response; None if the client went away, which
        cancels the handler. Pipelined bytes read meanwhile are kept."""
        task = asyncio.ensure_future(self.app.handle(request))
        watch = None
        try:
            while True:
                if watch is None and not self.eof and len(self.buf) <= self.app.client_max_size:
                    watch = asyncio.ensure_future(self.reader.read(_READ))
                waiting = {task} if watch is None else {task, watch}
                done, _ = await asyncio.wait(waiting, return_when=asyncio.FIRST_COMPLETED)
                if watch in done:
                    try:
                        data = watch.result()
                    except (ConnectionError, OSError):
                        data = b""
                    watch = None
                    if data:
                        self.buf += data
                        continue
                    self.eof = True
                    task.cancel()
                    try:
                        await task
                    except BaseException:  # the handler's own end, whatever it is
                        pass
                    return None
                if task in done:
                    return task.result()
        finally:
            if watch is not None:  # end the watch before the next read
                watch.cancel()
                try:
                    data = await watch
                except (asyncio.CancelledError, ConnectionError, OSError):
                    data = None
                if data:
                    self.buf += data
                elif data == b"":
                    self.eof = True

    async def _linger(self, seconds: float = 2.0) -> None:
        """After refusing a request whose body is still arriving: close our
        side and discard what comes for a while, so the client reads the
        refusal instead of a reset."""
        try:
            if self.writer.can_write_eof():
                self.writer.write_eof()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + seconds
            while not self.eof and loop.time() < deadline:
                data = await asyncio.wait_for(self.reader.read(_READ),
                                              max(deadline - loop.time(), 0.01))
                self.eof = not data
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    async def serve(self) -> None:
        try:
            while not self.close_after:
                try:
                    request = await self._read_request()
                except HTTPException as e:
                    await self._send(None, e)
                    await self._linger()
                    break
                except (_Disconnected, ConnectionError):
                    break
                if request is None:
                    break
                # from its head read to its response's last byte written
                with tracing.span("http.request", start=request.received_ns,
                                  path=request.path) as served:
                    try:
                        response = await self._run_handler(request)
                    except HTTPException as e:
                        response = e
                    except (ConnectionError, _Disconnected):
                        break
                    except Exception:
                        logger.exception("unhandled error on %s %s", request.method,
                                         request.path)
                        response = Response(text="500 Internal Server Error", status=500)
                    if response is None:
                        break  # the client went away
                    served.attrs["status"] = response.status
                    if response.prepared:
                        if getattr(response, "_writer", None) is not None:
                            await response.write_eof()
                    else:
                        await self._send(request, response)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                self.writer.close()
            except Exception:
                pass


class Server:
    """An application served on ``host:port`` in the running event loop
    (``port`` 0: any free port; ``self.port`` says which)."""

    def __init__(self, app: Application, host: str = "0.0.0.0", port: int = 8000):
        self.app, self.host, self.port = app, host, port
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)
        self._server = await asyncio.start_server(self._client, self.host, self.port,
                                                  limit=_READ)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _client(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await _Connection(self.app, reader, writer).serve()
        finally:
            self._conns.discard(task)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None
        for hook in self.app.on_cleanup:
            await hook(self.app)


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8000) -> None:
    """Serve until interrupted (SIGINT or SIGTERM), then run the cleanup hooks."""
    import signal

    async def main():
        server = Server(app, host, port)
        await server.start()
        logger.info("serving on http://%s:%d", host, server.port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await stop.wait()
        finally:
            await server.stop()

    asyncio.run(main())


class ServerThread:
    """An application served from an event loop on a thread of its own:
    ``start()`` returns once it listens (``self.port``), ``stop()`` closes it
    and runs the cleanup hooks. For tests and in-process drivers."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0):
        self.server = Server(app, host, port)
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, name="http-server",
                                        daemon=True)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> "ServerThread":
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(), self.loop).result(timeout=600)
        return self

    def stop(self) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(timeout=60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=10)
            self.loop.close()
