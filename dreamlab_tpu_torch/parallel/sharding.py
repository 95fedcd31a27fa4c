"""Device mesh and sharding rules on ``torch.distributed`` (port of
``dreamlab_tpu/parallel/sharding.py``): data-parallel serving and the
tensor-parallel UNet.

JAX gets both from annotations: a ``Mesh`` over every chip of one process,
``NamedSharding`` trees, and GSPMD inserting the all-reduces. The port runs
one process (rank) per device, so the same two axes are written out:

- **data axis**: a request batch is staged whole on every rank, each data
  rank keeps its contiguous rows (``data_rows``) and runs the full model on
  them, and the results are gathered back over the data group in rank order
  (``gather_rows``, host tensors). A batch the axis does not divide runs
  whole on every rank, as JAX replicates it.
- **model axis**: Megatron-style head parallelism inside each transformer
  block (``unet_tp_placements``, ``shard_params``): a model rank holds its
  heads' q/k/v rows (of every slot of a packed ``qkv`` / ``kv`` leaf) and
  the matching input columns of the attention and feed-forward
  out-projections, and ``ModelGroup.all_reduce`` sums their partial
  products (``models/unet.py``).

Rank r sits at (r // model, r % model) of the ("data", "model") mesh, where
JAX's row-major reshape puts device r.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")


def make_mesh(n_devices: Optional[int] = None, *, data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the initialised world (``n_devices``
    ranks; None: all of them). Raises where data * model is not the world."""
    world = dist.get_world_size()
    n = n_devices or world
    if data is None:
        data = n // model
    if data * model != n or n != world:
        raise ValueError(f"mesh {data}x{model} does not cover the {world} ranks of the world")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def parse_mesh_spec(spec: str) -> dict:
    """'data=8' or 'data=4,model=2' -> {'data': 4, 'model': 2}.

    The serving config exposes this as ``DREAMLAB_MESH`` so a deployment
    declares its device layout."""
    out = {"data": 1, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in out:
            raise ValueError(f"unknown mesh axis {k!r} (use data/model)")
        out[k] = int(v)
    if out["data"] < 1 or out["model"] < 1:
        raise ValueError(f"invalid mesh spec {spec!r}")
    return out


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.shape[AXES.index(axis)]


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------


def data_rows(bsz: int, mesh: DeviceMesh) -> slice:
    """This data rank's contiguous rows of a ``bsz``-row batch; every row
    where the axis does not divide the batch (JAX's ``replicated``)."""
    n = axis_size(mesh, "data")
    if n == 1 or bsz % n:
        return slice(0, bsz)
    r = mesh.get_local_rank("data")
    per = bsz // n
    return slice(r * per, (r + 1) * per)


def gather_rows(x: np.ndarray, mesh: DeviceMesh) -> np.ndarray:
    """The data ranks' row blocks of a host array, concatenated in rank
    order on every rank (an all-gather of host tensors over the data group)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, "data"))]
    dist.all_gather(parts, t, group=mesh.get_group("data"))
    return torch.cat(parts).numpy()


# ---------------------------------------------------------------------------
# the model axis: tensor parallelism for the UNet
# ---------------------------------------------------------------------------

# a leaf's placement: the dim a rank slices (SPLIT_SLOTS: the output rows of
# each slot of a packed [S, out, in] weight or [S, out] bias)
REPLICATE, SPLIT_OUT, SPLIT_IN, SPLIT_SLOTS = None, 0, 1, 1

_COL = re.compile(r"(^|\.)attn[12]\.[qkv]\.[wb]$")  # q/k/v [out, in]: split the output rows
_PACKED = re.compile(r"(^|\.)(attn1\.qkv|attn2\.kv)\.[wb]$")  # packed q/k/v
_ROW = re.compile(r"(^|\.)(attn[12]\.out|ff_out)\.w$")  # out-projections: split the inputs
_SITE = re.compile(r"^(down\.(\d+)|mid|up\.(\d+))\..*\.attn[12]\.")


def _placement_for_path(path: str) -> Optional[int]:
    """The Megatron pattern of ``_tp_spec_for_path`` on the port's ``[out, in]``
    leaves: q/k/v weights and biases split their output features (dim 0,
    head-parallel attention); the attention and feed-forward out-projections
    split their input features (dim 1), their biases are added once after
    the all-reduce. GEGLU in-projections stay whole: their output is split
    in half for the gate, which does not align with feature shards. Convs,
    norms and embeddings stay whole: channel-sharded convs would all-gather
    at every GroupNorm. The packed ``attn1.qkv`` / ``attn2.kv`` leaves
    split the output features of every slot (dim 1 of ``[S, out, in]`` and
    of ``[S, out]``, JAX's ``P(None, None, "model")`` on ``[in, S, out]``),
    so each rank's q/k/v slices stay local after the packed GEMM."""
    if _PACKED.search(path):
        return SPLIT_SLOTS
    if _COL.search(path):
        return SPLIT_OUT
    if _ROW.search(path):
        return SPLIT_IN
    return REPLICATE


def _site_heads(path: str, cfg) -> int:
    """The attention heads of the transformer site a leaf belongs to."""
    m = _SITE.match(path)
    if m.group(2) is not None:
        return cfg.num_attention_heads[int(m.group(2))]
    if m.group(3) is not None:
        return cfg.num_attention_heads[cfg.num_blocks - 1 - int(m.group(3))]
    return cfg.num_attention_heads[-1]


def _placements(tree, model: int, cfg=None, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _placements(v, model, cfg, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placements(v, model, cfg, f"{prefix}{i}.") for i, v in enumerate(tree)]
    path = prefix.rstrip(".")
    p = _placement_for_path(path)
    if p is None or tree.shape[p] % model:
        return REPLICATE  # equal slices only
    # head-parallel attention needs whole heads on every rank: a site whose
    # heads the model axis does not divide stays replicated (GSPMD would
    # still split its features)
    if cfg is not None and "attn" in path and _site_heads(path, cfg) % model:
        return REPLICATE
    return p


def unet_tp_placements(unet_params, mesh: DeviceMesh, cfg=None):
    """A tree of the UNet tree's shape: each leaf's placement, the dim a
    model rank slices (``SPLIT_OUT`` = 0, ``SPLIT_IN`` = ``SPLIT_SLOTS`` =
    1) or ``REPLICATE`` (None). A dim the model axis does not divide stays
    whole; with the UNet's config, so do attention sites whose heads it
    does not divide."""
    return _placements(unet_params, axis_size(mesh, "model"), cfg)


def shard_leaf(t: torch.Tensor, placement: Optional[int], mesh: DeviceMesh) -> torch.Tensor:
    """This model rank's slice of a whole leaf (the leaf itself where it is
    replicated): contiguous, its own storage."""
    if placement is None:
        return t
    n = axis_size(mesh, "model")
    return t.chunk(n, dim=placement)[mesh.get_local_rank("model")].contiguous().clone()


def shard_params(params, placements, mesh: DeviceMesh):
    """Each leaf of ``params`` sliced for this model rank by ``placements``."""
    if isinstance(params, dict):
        return {k: shard_params(v, placements[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, p, mesh) for v, p in zip(params, placements)]
    return shard_leaf(params, placements, mesh)


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The tensor-parallel context the UNet's forward takes: the model
    group, its size, and whether its collectives run on the device (NCCL:
    in place, capturable in a CUDA graph) or on the host (gloo: a card
    tensor is summed through a host copy)."""

    group: dist.ProcessGroup
    size: int
    rank: int  # this rank's index in the group: its slice of a split leaf
    on_device: bool

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "ModelGroup":
        group = mesh.get_group("model")
        return cls(group=group, size=axis_size(mesh, "model"),
                   rank=mesh.get_local_rank("model"),
                   on_device="nccl" in str(dist.get_backend(group)))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place; returns it."""
        if t.device.type == "cpu" or self.on_device:
            dist.all_reduce(t, group=self.group)
            return t
        host = t.cpu()
        dist.all_reduce(host, group=self.group)
        return t.copy_(host)
