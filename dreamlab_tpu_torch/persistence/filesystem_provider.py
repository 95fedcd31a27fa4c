"""Filesystem blob store: sharded dirs, atomic writes, TTL cleanup thread.

Copy of ``dreamlab_tpu/persistence/filesystem_provider.py``:
2-hex-char shard directories, ``.bin`` + ``.meta.json`` sidecars, tmpfile +
``os.replace`` atomicity, hourly TTL sweep, health with entry/byte counts.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
import time
from typing import Optional

from .storage_provider import StorageItem, StorageProvider

logger = logging.getLogger(__name__)


class FilesystemStorageProvider(StorageProvider):
    def __init__(
        self,
        root: str,
        default_ttl: Optional[float] = 3600.0,
        cleanup_interval: float = 3600.0,
    ):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.default_ttl = default_ttl
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._cleanup_interval = cleanup_interval
        self._cleaner = threading.Thread(
            target=self._cleanup_loop, name="fs-storage-cleanup", daemon=True
        )
        self._cleaner.start()

    # ------------------------------------------------------------------
    def _paths(self, key: str):
        digest = hashlib.sha1(key.encode()).hexdigest()
        shard = os.path.join(self.root, digest[:2])
        return shard, os.path.join(shard, digest + ".bin"), os.path.join(
            shard, digest + ".meta.json"
        )

    def put(self, key, data, metadata=None, *, content_type="application/octet-stream", ttl=None):
        shard, bin_path, meta_path = self._paths(key)
        os.makedirs(shard, exist_ok=True)
        ttl = self.default_ttl if ttl is None else ttl
        meta = {
            "key": key,
            "metadata": dict(metadata or {}),
            "content_type": content_type,
            "created_at": time.time(),
            "expires_at": (time.time() + ttl) if ttl else None,
        }
        for path, payload in ((bin_path, data), (meta_path, json.dumps(meta).encode())):
            fd, tmp = tempfile.mkstemp(dir=shard)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return key

    def get(self, key):
        _, bin_path, meta_path = self._paths(key)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        exp = meta.get("expires_at")
        if exp and exp <= time.time():
            self.delete(key)
            return None
        try:
            with open(bin_path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        return StorageItem(
            key=key, data=data, metadata=meta.get("metadata", {}),
            content_type=meta.get("content_type", "application/octet-stream"),
            created_at=meta.get("created_at", 0.0),
        )

    def delete(self, key):
        _, bin_path, meta_path = self._paths(key)
        found = False
        for p in (bin_path, meta_path):
            try:
                os.unlink(p)
                found = True
            except OSError:
                pass
        return found

    # ------------------------------------------------------------------
    def _cleanup_loop(self):
        while not self._stop.wait(self._cleanup_interval):
            try:
                self.cleanup_expired()
            except Exception:
                logger.exception("fs storage cleanup failed")

    def cleanup_expired(self) -> int:
        removed = 0
        now = time.time()
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            if not os.path.isdir(sdir):
                continue
            for name in os.listdir(sdir):
                if not name.endswith(".meta.json"):
                    continue
                meta_path = os.path.join(sdir, name)
                try:
                    with open(meta_path) as f:
                        meta = json.load(f)
                    exp = meta.get("expires_at")
                    if exp and exp <= now:
                        os.unlink(meta_path)
                        bin_path = meta_path[: -len(".meta.json")] + ".bin"
                        try:
                            os.unlink(bin_path)
                        except OSError:
                            pass
                        removed += 1
                except (OSError, json.JSONDecodeError):
                    continue
        if removed:
            logger.info("fs storage: removed %d expired entries", removed)
        return removed

    def health(self):
        entries = 0
        total = 0
        try:
            for shard in os.listdir(self.root):
                sdir = os.path.join(self.root, shard)
                if not os.path.isdir(sdir):
                    continue
                for name in os.listdir(sdir):
                    if name.endswith(".bin"):
                        entries += 1
                        total += os.path.getsize(os.path.join(sdir, name))
            return {"provider": "filesystem", "ok": True, "root": self.root,
                    "entries": entries, "bytes": total}
        except OSError as e:
            return {"provider": "filesystem", "ok": False, "error": str(e)}

    def close(self):
        self._stop.set()
