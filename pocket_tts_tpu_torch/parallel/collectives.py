"""The collectives GSPMD inserts for the JAX package, made explicit.

Megatron's two operators bracket each tensor-parallel region (an attention
block's heads, a feed-forward's hidden units):

  - `copy_to_tp` goes before `in_proj` and `linear1`: identity forward, an
    all_reduce of the gradient backward (each rank's partial input gradient
    from its own heads or hidden units);
  - `reduce_from_tp` goes after `out_proj` and `linear2`, on the float32
    accumulator (ops/linear.linear): an all_reduce forward, identity
    backward.

Then the int8 KV row maximum over tp (a row's scale spans every head), the
gradient mean over dp, and the all_gathers of whole leaves over tp and of
per-stream results over dp. Every function takes the rank's Mesh, or None
for no mesh, and calls no collective where its axis has one rank. Each call
adds one to `mesh.counts["<op>:<axis>"]`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pocket_tts_tpu_torch.parallel.mesh import Mesh


def tp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


def dp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.dp > 1


def _all_reduce(mesh: Mesh, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced in place over the mesh axis `axis`."""
    mesh.counts[f"all_reduce_{'max' if op == dist.ReduceOp.MAX else 'sum'}:{axis}"] += 1
    dist.all_reduce(x, op=op, group=mesh.tp_group if axis == "tp" else mesh.dp_group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(ctx.mesh, grad.contiguous().clone(), "tp"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(mesh, x.contiguous().clone(), "tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Entry of a tensor-parallel region: x as it is; its gradient summed
    over tp."""
    return _CopyToTP.apply(x, mesh) if tp_active(mesh) else x


def reduce_from_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Exit of a tensor-parallel region: the sum of every tp rank's partial
    x (each rank gets the same values); its gradient as it is."""
    return _ReduceFromTP.apply(x, mesh) if tp_active(mesh) else x


def max_over_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of x over tp (no gradient)."""
    return _all_reduce(mesh, x.contiguous().clone(), "tp", dist.ReduceOp.MAX) if tp_active(mesh) else x


def mean_over_dp(mesh: Optional[Mesh], tensors: list[torch.Tensor]) -> None:
    """Replace each tensor (of one device and dtype) by its mean over dp, in
    one all_reduce of their concatenation."""
    if not dp_active(mesh) or not tensors:
        return
    flat = _all_reduce(mesh, torch.cat([t.reshape(-1) for t in tensors]), "dp")
    flat /= mesh.dp
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather_tp(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Every tp rank's x, in tp order."""
    mesh.counts["all_gather:tp"] += 1
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.tp_group)
    return parts


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh gets here."""
    mesh.counts["barrier:world"] += 1
    dist.barrier()


def all_gather_dp(mesh: Optional[Mesh], obj) -> list:
    """Every dp rank's obj (host values: numpy arrays, ints), in dp order."""
    if not dp_active(mesh):
        return [obj]
    mesh.counts["all_gather:dp"] += 1
    out = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.dp_group)
    return out
