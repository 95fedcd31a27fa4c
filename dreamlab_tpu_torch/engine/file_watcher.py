"""Config file watcher: a polling mtime observer with debounce (copy of
``dreamlab_tpu/engine/file_watcher.py``).

A dependency-free polling thread (1 s interval, 1 s debounce) that calls
``on_change`` when the file's mtime moves, e.g. to hot-reload ``modes.yaml``
(``ModeConfigManager.reload``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class ConfigFileWatcher:
    def __init__(
        self,
        path: str,
        on_change: Callable[[], None],
        *,
        poll_interval: float = 1.0,
        debounce: float = 1.0,
    ):
        self.path = os.path.abspath(path)
        self.on_change = on_change
        self.poll_interval = poll_interval
        self.debounce = debounce
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_mtime = self._mtime()
        self._last_fire = 0.0

    def _mtime(self) -> float:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return 0.0

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            m = self._mtime()
            if m and m != self._last_mtime:
                self._last_mtime = m
                now = time.time()
                if now - self._last_fire < self.debounce:
                    continue
                self._last_fire = now
                logger.info("config change detected: %s", self.path)
                try:
                    self.on_change()
                except Exception:
                    logger.exception("config reload callback failed")

    def start(self):
        if self._thread and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="config-watcher", daemon=True
        )
        self._thread.start()
        logger.info("watching %s", self.path)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None


_watcher: Optional[ConfigFileWatcher] = None
_watcher_lock = threading.Lock()


def start_config_watcher(path: str, on_change: Callable[[], None], **kw) -> ConfigFileWatcher:
    global _watcher
    with _watcher_lock:
        if _watcher is not None:
            _watcher.stop()
        _watcher = ConfigFileWatcher(path, on_change, **kw)
        _watcher.start()
        return _watcher


def stop_config_watcher():
    global _watcher
    with _watcher_lock:
        if _watcher is not None:
            _watcher.stop()
            _watcher = None
