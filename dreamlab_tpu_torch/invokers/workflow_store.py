"""ComfyUI workflow (prompt-graph) store + parameter patching.

Copy of ``dreamlab_tpu/invokers/workflow_store.py``: load
and cache prompt-graph JSON files, then patch node inputs (image / steps /
cfg / denoise / seed / prompt) for a run — link-aware: when a target input
holds a ``[node_id, output_idx]`` link, the patch walks to the upstream node.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import threading
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WorkflowSpec:
    workflow_id: str
    path: str
    graph: Dict[str, Any]
    # node-class → input-name hints for patching
    description: str = ""


class WorkflowStore:
    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._cache: Dict[str, WorkflowSpec] = {}

    def list_workflows(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(self.root)
            if f.endswith(".json")
        )

    def get(self, workflow_id: str) -> WorkflowSpec:
        with self._lock:
            if workflow_id in self._cache:
                return self._cache[workflow_id]
        path = os.path.join(self.root, workflow_id + ".json")
        if not os.path.exists(path):
            raise KeyError(f"unknown workflow {workflow_id!r}")
        with open(path) as f:
            graph = json.load(f)
        spec = WorkflowSpec(workflow_id=workflow_id, path=path, graph=graph)
        with self._lock:
            self._cache[workflow_id] = spec
        return spec

    # ------------------------------------------------------------------
    @staticmethod
    def _is_link(v) -> bool:
        return (
            isinstance(v, list) and len(v) == 2
            and isinstance(v[0], (str, int)) and isinstance(v[1], int)
        )

    def make_prompt(
        self,
        workflow_id: str,
        params: Optional[Dict[str, Any]] = None,
        image_name: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Deep-copy the graph and patch node inputs.

        params keys: prompt, negative_prompt, steps, cfg, denoise, seed.
        image_name patches every LoadImage node.
        """
        graph = copy.deepcopy(self.get(workflow_id).graph)
        params = params or {}

        def set_input(node: Dict, key: str, value):
            inputs = node.setdefault("inputs", {})
            cur = inputs.get(key)
            if self._is_link(cur):
                # patch the upstream node's matching input instead
                up = graph.get(str(cur[0]))
                if up is not None:
                    set_input(up, key, value)
                    return
            inputs[key] = value

        for node in graph.values():
            if not isinstance(node, dict):
                continue
            ctype = node.get("class_type", "")
            inputs = node.get("inputs", {})
            if ctype == "LoadImage" and image_name is not None:
                inputs["image"] = image_name
            if ctype == "KSampler" or "Sampler" in ctype:
                for key, pkey in (
                    ("steps", "steps"), ("cfg", "cfg"),
                    ("denoise", "denoise"), ("seed", "seed"),
                ):
                    if pkey in params and params[pkey] is not None:
                        set_input(node, key, params[pkey])
            if ctype == "CLIPTextEncode":
                # positive vs negative by conventional node title
                title = (node.get("_meta") or {}).get("title", "").lower()
                if "negative" in title and params.get("negative_prompt") is not None:
                    set_input(node, "text", params["negative_prompt"])
                elif "negative" not in title and params.get("prompt") is not None:
                    set_input(node, "text", params["prompt"])
        return graph
