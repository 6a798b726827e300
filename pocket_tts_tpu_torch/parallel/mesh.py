"""Multi-rank layout: the (dp, tp) mesh and the sharding rules
(port of pocket_tts_tpu/parallel/mesh.py).

JAX runs one controller over N devices and GSPMD inserts the collectives.
PyTorch has no such mode, so the port runs one process per rank (Megatron's
form): each rank holds plain local tensors, its slice of every tp-sharded
leaf and the whole of every replicated one, and the model calls the
collectives itself (parallel/collectives.py). The rules are the JAX
package's:

  - dp shards the batch of concurrent streams: every per-stream leaf
    carries the batch in dim 0;
  - tp shards the weights Megatron-style: attention heads (the packed qkv
    `in_proj` [3, E, E] by its head-major output axis, `out_proj` by its
    input columns) and the feed-forward (`linear1` by rows, `linear2` by
    columns); the KV caches [B, C, H, d] follow their heads.

Ranks are laid out row-major over (dp, tp): the tp ranks of one dp row are
contiguous, as jax's make_mesh reshapes its device list. Unlike GSPMD, which
splits a head across devices when tp does not divide the head count, the
port needs whole heads on each rank and raises.
"""

from __future__ import annotations

import collections
import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from pocket_tts_tpu_torch.models.weights import _map_tree

logger = logging.getLogger(__name__)


@dataclass(eq=False)
class Mesh:
    """This rank's view of a (dp, tp) mesh: its coordinates, its device, the
    process groups of its dp column and tp row, and `counts`, the number of
    collective calls by "op:axis" (parallel/collectives.py counts them)."""

    dp: int
    tp: int
    rank: int = 0
    dp_rank: int = 0
    tp_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: str = ""
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None
    counts: collections.Counter = field(default_factory=collections.Counter)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def mesh_grid(dp: int, tp: int) -> list[list[int]]:
    """Ranks of a (dp, tp) mesh as a [dp][tp] grid: rank d * tp + t sits at
    (d, t); a row holds one dp index's tp group, a column one tp index's dp
    group."""
    return [[d * tp + t for t in range(tp)] for d in range(dp)]


def backend_for(device_type: str, world_size: int) -> str:
    """The process-group backend for `world_size` ranks on `device_type`:
    NCCL when each rank has a card of its own, gloo when ranks share a card
    (NCCL refuses two ranks on one device) or run on the CPU."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_mesh(dp: int = 1, tp: int = 1, device_type: str = "cuda") -> Mesh:
    """This rank's Mesh over the process group that is up, which must hold
    exactly dp * tp ranks (parallel/launch.launch starts one). dp shards
    streams; tp shards attention heads and the feed-forward."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized() or dist.get_world_size() != dp * tp:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"make_mesh(dp={dp}, tp={tp}) needs a process group of {dp * tp} ranks; {have} are up "
                           "(start them with pocket_tts_tpu_torch.parallel.launch)")
    mesh = DeviceMesh(device_type, mesh_grid(dp, tp), mesh_dim_names=("dp", "tp"))
    d, t = mesh.get_coordinate()
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    backend = dist.get_backend()
    logger.info("mesh dp=%d tp=%d: rank %d at (%d, %d) on %s, backend %s", dp, tp, dist.get_rank(), d, t, device,
                backend)
    return Mesh(dp, tp, dist.get_rank(), d, t, device, backend, mesh.get_group("dp"), mesh.get_group("tp"))


def param_spec_for_path(path: Sequence, leaf: torch.Tensor) -> Optional[int]:
    """The axis of a params leaf that is split over tp, or None (the leaf is
    whole on every rank); `path` is the leaf's keys from the tree's root
    (pocket_tts_tpu/parallel/mesh.py:37-67):

    in_proj.weight [3, E, E] -> axis 1, the head-major output axis (real
      attention-head partitioning: q, k, v, RoPE, the cache and softmax all
      run on each rank's own heads); its int8 scale [3, F] -> axis 1;
    linear1.weight [ffn, d] -> axis 0 (its int8 scale [ffn] with it);
    linear2.weight [d, ffn], out_proj.weight [E, E] -> axis 1, the
      contraction (the output is reduced over tp); their 1-D int8 scales,
      along the unsharded output axis, stay whole."""
    keys = set(path)
    if "in_proj" in keys:
        return 1 if leaf.ndim in (2, 3) else None
    if "linear1" in keys:
        return 0
    if "linear2" in keys or "out_proj" in keys:
        return None if leaf.ndim == 1 else 1
    return None


def _split(mesh: Mesh, path, leaf: torch.Tensor, axis: int) -> torch.Tensor:
    n, rem = divmod(leaf.shape[axis], mesh.tp)
    if rem:
        raise ValueError(f"{'.'.join(map(str, path))} {tuple(leaf.shape)}: axis {axis} does not split over tp={mesh.tp}")
    return leaf.narrow(axis, mesh.tp_rank * n, n)


def shard_leaf(mesh: Mesh, path, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's part of a whole params leaf (or of an optimizer moment of
    one), on the mesh's device, contiguous and owned."""
    axis = param_spec_for_path(path, leaf)
    part = leaf if axis is None or mesh.tp == 1 else _split(mesh, path, leaf, axis)
    return part.to(mesh.device).clone(memory_format=torch.contiguous_format)


def gather_leaf(mesh: Mesh, path, leaf: torch.Tensor) -> torch.Tensor:
    """The whole leaf from this rank's part (the inverse of shard_leaf,
    bit-exact): an all_gather over tp along the split axis."""
    from pocket_tts_tpu_torch.parallel.collectives import all_gather_tp

    axis = param_spec_for_path(path, leaf)
    if axis is None or mesh.tp == 1:
        return leaf.clone()
    return torch.cat(all_gather_tp(mesh, leaf), dim=axis)


def _map_leaves(tree, fn):
    return _map_tree(tree, lambda path, leaf: fn(path, leaf) if isinstance(leaf, torch.Tensor) else leaf)


def shard_params(mesh: Mesh, params: dict) -> dict:
    """This rank's params: every leaf sliced by param_spec_for_path (float
    and int8 {"q", "s"} leaves alike) and moved to the mesh's device."""
    return _map_leaves(params, lambda path, leaf: shard_leaf(mesh, path, leaf))


def gather_params(mesh: Mesh, params: dict) -> dict:
    """The whole params tree from this rank's shards (every rank takes part
    and gets the whole tree): the inverse of shard_params, bit-exact."""
    return _map_leaves(params, lambda path, leaf: gather_leaf(mesh, path, leaf))


def state_sharding_spec(batch_size: int, dp: int = 1, tp: int = 1):
    """Spec callable for per-stream state (pocket_tts_tpu/parallel/mesh.py:70-89):
    leaf -> a tuple of axis names per dim, as jax's PartitionSpec. A leaf
    whose dim 0 is the batch shards it over dp; the 4-D leaves are the KV
    caches, slot-major [B, slots, H, d] for both attention kinds, whose head
    axis shards over tp. Other leaves are whole: ().

    A batch that dp does not divide (a B=1 voice row on a dp > 1 mesh) is
    whole on every rank, as in JAX. A head count that tp does not divide
    raises ValueError, where JAX replicates the cache and GSPMD splits the
    heads' math: the port's ranks each run whole heads."""

    def spec(leaf) -> tuple:
        if not (hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == batch_size):
            return ()
        dp_ax = "dp" if batch_size % max(dp, 1) == 0 else None
        if leaf.ndim == 4:
            if leaf.shape[2] % max(tp, 1):
                raise ValueError(f"a KV cache of {leaf.shape[2]} heads does not split over tp={tp}: the port "
                                 "needs whole heads on each rank (JAX would replicate it)")
            return (dp_ax, None, "tp", None)
        return (dp_ax,) + (None,) * (leaf.ndim - 1)

    return spec


def dp_range(mesh: Optional[Mesh], batch_size: int) -> tuple[int, int]:
    """The streams [lo, hi) of a batch that this rank holds: its dp slice
    when dp divides the batch, else all of them."""
    if mesh is None or mesh.dp == 1 or batch_size % mesh.dp:
        return 0, batch_size
    n = batch_size // mesh.dp
    return mesh.dp_rank * n, (mesh.dp_rank + 1) * n


def shard_batch_tree(mesh: Mesh, tree, batch_size: int):
    """This rank's dp slice of a per-stream state, carry or input tree
    (pocket_tts_tpu/parallel/mesh.py:92-100), on the mesh's device: every
    leaf whose dim 0 is the batch keeps the streams of dp_range (all of
    them where dp does not divide the batch, as state_sharding_spec says).
    A host list of `batch_size` ints (the port keeps stream positions on
    the host) is cut like a [B] leaf. The tp axis of the KV caches is not
    cut here: a model built on the mesh makes caches of this rank's heads
    (CausalKVAttention, WindowedRingAttention). A tensor that several
    leaves share (the FlowLM layers' one slot_pos) stays shared."""
    lo, hi = dp_range(mesh, batch_size)
    placed: dict[int, torch.Tensor] = {}

    def place(leaf):
        if isinstance(leaf, torch.Tensor):
            if id(leaf) not in placed:
                part = leaf[lo:hi] if leaf.ndim >= 1 and leaf.shape[0] == batch_size else leaf
                placed[id(leaf)] = part.to(mesh.device).clone(memory_format=torch.contiguous_format)
            return placed[id(leaf)]
        if isinstance(leaf, dict):
            return {k: place(v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            if len(leaf) == batch_size and all(isinstance(x, int) for x in leaf):
                return leaf[lo:hi]
            return [place(v) for v in leaf]
        return leaf

    return place(tree)
