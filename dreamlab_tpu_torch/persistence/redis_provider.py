"""Redis blob store over the built-in RESP client.

Copy of ``dreamlab_tpu/persistence/redis_provider.py``
(value at ``key``, metadata hash at ``key:meta``, TTL on both, health with
server info), over the port's copy of the RESP client.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..utils.resp import RespClient, RespError
from .storage_provider import StorageItem, StorageProvider

logger = logging.getLogger(__name__)


class RedisStorageProvider(StorageProvider):
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        db: int = 0,
        password: Optional[str] = None,
        default_ttl: Optional[float] = 3600.0,
        client: Optional[RespClient] = None,
    ):
        self.client = client or RespClient(host, port, db=db, password=password)
        self.default_ttl = default_ttl
        self.client.ping()  # fail fast if unreachable

    @staticmethod
    def _meta_key(key: str) -> str:
        return key + ":meta"

    def put(self, key, data, metadata=None, *, content_type="application/octet-stream", ttl=None):
        ttl = self.default_ttl if ttl is None else ttl
        ex = int(ttl) if ttl else None
        self.client.set(key, bytes(data), ex=ex)
        meta = {"content_type": content_type, "created_at": repr(time.time())}
        for k, v in (metadata or {}).items():
            meta[f"m:{k}"] = str(v)
        self.client.hset(self._meta_key(key), meta)
        if ex:
            self.client.expire(self._meta_key(key), ex)
        return key

    def get(self, key):
        data = self.client.get(key)
        if data is None:
            return None
        raw = self.client.hgetall(self._meta_key(key))
        meta = {}
        content_type = "application/octet-stream"
        created = 0.0
        for k, v in raw.items():
            ks, vs = k.decode(), v.decode()
            if ks == "content_type":
                content_type = vs
            elif ks == "created_at":
                try:
                    created = float(vs)
                except ValueError:
                    pass
            elif ks.startswith("m:"):
                meta[ks[2:]] = vs
        return StorageItem(
            key=key, data=data, metadata=meta,
            content_type=content_type, created_at=created,
        )

    def delete(self, key):
        return self.client.delete(key, self._meta_key(key)) > 0

    def health(self):
        try:
            ok = self.client.ping()
            return {
                "provider": "redis",
                "ok": ok,
                "entries": self.client.dbsize(),
            }
        except (OSError, RespError) as e:
            return {"provider": "redis", "ok": False, "error": str(e)}

    def close(self):
        self.client.close()
