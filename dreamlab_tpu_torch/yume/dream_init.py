"""Yume wiring: Redis + scorer + generation worker -> DreamWorker (port of
``dreamlab_tpu/yume/dream_init.py``).

The same ladder: a native CLIP scorer from a local ``YUME_CLIP_MODEL``
directory (``loader.load_clip_model`` on the card), then transformers'
``CLIPModel`` by that name (imported only here, and only when the first rung
failed: a hub name means a download), then the aesthetic heuristic. Redis
unreachable -> the dreams stay in memory.
"""

from __future__ import annotations

import asyncio
import logging
import os

from .dream_worker import DreamWorker, set_dream_worker
from .scoring import AestheticScorer, CLIPScorer, HFCLIPAdapter

logger = logging.getLogger(__name__)


def _try_redis():
    from ..utils.resp import RespClient

    host = os.environ.get("REDIS_HOST", "127.0.0.1")
    port = int(os.environ.get("REDIS_PORT", "6379"))
    try:
        client = RespClient(host, port)
        client.ping()
        logger.info("yume: redis connected at %s:%d", host, port)
        return client
    except Exception as e:
        logger.warning("yume: redis unavailable (%s); dreams stay in-memory", e)
        return None


def _try_clip_scorer(device=None):
    """Native CLIP (a local HF CLIPModel directory, on ``device``) ->
    transformers CLIPModel -> aesthetic heuristic."""
    model_name = os.environ.get("YUME_CLIP_MODEL", "openai/clip-vit-base-patch32")
    if os.path.isdir(model_name):
        try:
            from ..loader import load_clip_model

            native = load_clip_model(model_name, device=device)
            logger.info("yume: native CLIP scorer loaded (%s)", model_name)
            return CLIPScorer(native)
        except Exception as e:
            logger.warning("yume: native CLIP load failed (%s)", e)
    try:
        from transformers import CLIPModel, CLIPProcessor

        model = CLIPModel.from_pretrained(model_name)
        processor = CLIPProcessor.from_pretrained(model_name)
        logger.info("yume: CLIP scorer loaded (%s)", model_name)
        return CLIPScorer(HFCLIPAdapter(model, processor, device))
    except Exception as e:
        logger.warning("yume: CLIP unavailable (%s); using aesthetic heuristic", e)
        return AestheticScorer()


async def initialize_dream_system(worker, *, scorer=None, redis=None,
                                  device=None) -> DreamWorker:
    """A DreamWorker over ``worker``, its scorer on ``device`` (None: the
    CUDA device), made the process's (``get_dream_worker``). Loading the
    scorer and connecting to Redis run in the executor: the loop serves
    HTTP meanwhile."""
    loop = asyncio.get_running_loop()
    if scorer is None:
        scorer = await loop.run_in_executor(None, _try_clip_scorer, device)
    if redis is None:
        redis = await loop.run_in_executor(None, _try_redis)
    dream = DreamWorker(worker, scorer=scorer, redis=redis)
    set_dream_worker(dream)
    return dream
