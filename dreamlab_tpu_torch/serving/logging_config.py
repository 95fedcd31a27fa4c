"""dictConfig logging setup (port of ``dreamlab_tpu/serving/logging_config.py``;
``LOG_LEVEL``, default INFO)."""

from __future__ import annotations

import logging.config
import os


def configure_logging(level: str | None = None):
    level = (level or os.environ.get("LOG_LEVEL", "INFO")).upper()
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "default": {
                "format": "%(asctime)s %(levelname)s %(name)s: %(message)s",
            },
        },
        "handlers": {
            "console": {
                "class": "logging.StreamHandler",
                "formatter": "default",
                "stream": "ext://sys.stdout",
            },
        },
        "loggers": {
            "dreamlab_tpu_torch": {"level": level},
            "dreamlab.requests": {"level": level},
        },
        "root": {"level": level, "handlers": ["console"]},
    })
