"""Minimal Redis (RESP2) client over raw sockets — no redis-py dependency
(copy of ``dreamlab_tpu/utils/resp.py``).

Implements exactly the command surface the framework uses: blob storage
(SET/GET/DEL/EXPIRE/TTL), Yume's dream store (HSET/HGETALL/ZADD/ZREVRANGE/
ZCARD/ZSCORE), and health (PING/INFO/DBSIZE). Thread-safe via a per-client
lock; one connection, auto-reconnect on failure.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

Value = Union[str, bytes, int, float]


class RespError(Exception):
    pass


class RespClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, timeout: float = 5.0, password: Optional[str] = None):
        self.host, self.port, self.db = host, port, db
        self.timeout = timeout
        self.password = password
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    # ------------------------------------------------------------------
    def _connect(self):
        s = socket.create_connection((self.host, self.port), timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._buf = b""
        if self.password:
            self._do_command(b"AUTH", self.password)
        if self.db:
            self._do_command(b"SELECT", self.db)

    def close(self):
        with self._lock:
            if self._sock:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    # ------------------------------------------------------------------
    @staticmethod
    def _encode(args: Tuple[Value, ...]) -> bytes:
        parts = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, bytes):
                b = a
            elif isinstance(a, str):
                b = a.encode()
            elif isinstance(a, bool):
                b = b"1" if a else b"0"
            elif isinstance(a, int):
                b = str(a).encode()
            elif isinstance(a, float):
                b = repr(a).encode()
            else:
                raise TypeError(f"unsupported arg type {type(a)}")
            parts.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(parts)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        tag, rest = line[:1], line[1:]
        if tag == b"+":
            return rest
        if tag == b"-":
            raise RespError(rest.decode())
        if tag == b":":
            return int(rest)
        if tag == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if tag == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply() for _ in range(n)]
        raise RespError(f"bad RESP tag {tag!r}")

    def _do_command(self, *args: Value):
        self._sock.sendall(self._encode(args))
        return self._read_reply()

    def command(self, *args: Value):
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    return self._do_command(*args)
                except (OSError, ConnectionError):
                    if self._sock:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt:
                        raise

    # ------------------------------------------------------------------
    # convenience wrappers
    # ------------------------------------------------------------------

    def ping(self) -> bool:
        return self.command(b"PING") == b"PONG"

    def set(self, key: Value, value: Value, ex: Optional[int] = None):
        if ex:
            return self.command(b"SET", key, value, b"EX", int(ex))
        return self.command(b"SET", key, value)

    def get(self, key: Value) -> Optional[bytes]:
        return self.command(b"GET", key)

    def delete(self, *keys: Value) -> int:
        return self.command(b"DEL", *keys)

    def exists(self, key: Value) -> bool:
        return bool(self.command(b"EXISTS", key))

    def expire(self, key: Value, seconds: int) -> bool:
        return bool(self.command(b"EXPIRE", key, int(seconds)))

    def hset(self, key: Value, mapping: Dict[Value, Value]) -> int:
        args: List[Value] = [b"HSET", key]
        for k, v in mapping.items():
            args.extend((k, v))
        return self.command(*args)

    def hgetall(self, key: Value) -> Dict[bytes, bytes]:
        flat = self.command(b"HGETALL", key) or []
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    def zadd(self, key: Value, mapping: Dict[Value, float]) -> int:
        args: List[Value] = [b"ZADD", key]
        for member, score in mapping.items():
            args.extend((score, member))
        return self.command(*args)

    def zrevrange(self, key: Value, start: int, stop: int,
                  withscores: bool = False):
        args: List[Value] = [b"ZREVRANGE", key, start, stop]
        if withscores:
            args.append(b"WITHSCORES")
        out = self.command(*args) or []
        if not withscores:
            return out
        return [(out[i], float(out[i + 1])) for i in range(0, len(out), 2)]

    def zcard(self, key: Value) -> int:
        return self.command(b"ZCARD", key)

    def dbsize(self) -> int:
        return self.command(b"DBSIZE")

    def flushdb(self):
        return self.command(b"FLUSHDB")
