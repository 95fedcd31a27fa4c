"""Blob storage contract + in-memory provider + env factory.

Copy of ``dreamlab_tpu/persistence/storage_provider.py``:
``put/get/delete/health/close`` over (key, bytes, metadata) with TTL; keys
are ``prefix:uuid4``; provider selected by ``STORAGE_PROVIDER`` env
(MEMORY | REDIS | FILESYSTEM | DISABLED → None).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import os
import threading
import time
import uuid
from typing import Dict, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class StorageItem:
    key: str
    data: bytes
    metadata: Dict[str, str]
    content_type: str = "application/octet-stream"
    created_at: float = dataclasses.field(default_factory=time.time)


class StorageProvider(abc.ABC):
    """Pluggable blob store for generated images."""

    key_prefix = "lcm"

    def new_key(self) -> str:
        return f"{self.key_prefix}:{uuid.uuid4().hex}"

    @abc.abstractmethod
    def put(
        self,
        key: str,
        data: bytes,
        metadata: Optional[Dict[str, str]] = None,
        *,
        content_type: str = "application/octet-stream",
        ttl: Optional[float] = None,
    ) -> str:
        ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[StorageItem]:
        ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool:
        ...

    @abc.abstractmethod
    def health(self) -> Dict:
        ...

    def close(self):
        pass


class InMemoryStorageProvider(StorageProvider):
    """Bounded in-memory store: TTL + drop-oldest eviction."""

    def __init__(self, max_items: int = 256, default_ttl: Optional[float] = 3600.0):
        self._lock = threading.Lock()
        self._items: Dict[str, StorageItem] = {}
        self._expiry: Dict[str, float] = {}
        self.max_items = max_items
        self.default_ttl = default_ttl

    def _evict_locked(self):
        now = time.time()
        expired = [k for k, t in self._expiry.items() if t <= now]
        for k in expired:
            self._items.pop(k, None)
            self._expiry.pop(k, None)
        while len(self._items) > self.max_items:
            oldest = min(self._items.values(), key=lambda it: it.created_at)
            self._items.pop(oldest.key, None)
            self._expiry.pop(oldest.key, None)

    def put(self, key, data, metadata=None, *, content_type="application/octet-stream", ttl=None):
        with self._lock:
            self._items[key] = StorageItem(
                key=key, data=bytes(data), metadata=dict(metadata or {}),
                content_type=content_type,
            )
            ttl = self.default_ttl if ttl is None else ttl
            if ttl:
                self._expiry[key] = time.time() + ttl
            self._evict_locked()
        return key

    def get(self, key):
        with self._lock:
            exp = self._expiry.get(key)
            if exp is not None and exp <= time.time():
                self._items.pop(key, None)
                self._expiry.pop(key, None)
                return None
            return self._items.get(key)

    def delete(self, key):
        with self._lock:
            self._expiry.pop(key, None)
            return self._items.pop(key, None) is not None

    def health(self):
        with self._lock:
            return {
                "provider": "memory",
                "ok": True,
                "entries": len(self._items),
                "bytes": sum(len(i.data) for i in self._items.values()),
            }


def make_storage_provider_from_env() -> Optional[StorageProvider]:
    """STORAGE_PROVIDER = MEMORY | REDIS | FILESYSTEM | DISABLED."""
    kind = os.environ.get("STORAGE_PROVIDER", "MEMORY").upper()
    if kind in ("DISABLED", "NONE", ""):
        return None
    if kind == "MEMORY":
        return InMemoryStorageProvider(
            max_items=int(os.environ.get("STORAGE_MAX_ITEMS", "256")),
            default_ttl=float(os.environ.get("STORAGE_TTL_SECONDS", "3600")),
        )
    if kind == "FILESYSTEM":
        from .filesystem_provider import FilesystemStorageProvider

        return FilesystemStorageProvider(
            root=os.environ.get("FS_STORAGE_ROOT", "/tmp/dreamlab-storage"),
            default_ttl=float(os.environ.get("STORAGE_TTL_SECONDS", "3600")),
        )
    if kind == "REDIS":
        from .redis_provider import RedisStorageProvider

        try:
            return RedisStorageProvider(
                host=os.environ.get("REDIS_HOST", "127.0.0.1"),
                port=int(os.environ.get("REDIS_PORT", "6379")),
                default_ttl=float(os.environ.get("STORAGE_TTL_SECONDS", "3600")),
            )
        except Exception:
            logger.exception("redis storage unavailable; falling back to memory")
            return InMemoryStorageProvider()
    raise ValueError(f"unknown STORAGE_PROVIDER {kind!r}")
