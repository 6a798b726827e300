"""Dense layers on torch-layout weights [out, in]
(port of pocket_tts_tpu/ops/linear.py).

Mixed precision follows the JAX package exactly: a lower-precision weight
pulls the activation down to its dtype, the products accumulate in float32,
and the result returns in the activation's dtype. The products are computed
as float32 matmuls of the rounded operands: a bf16 x bf16 product is exact
in float32, so this equals a bf16 matmul with float32 accumulation on both
the CPU and the card (with TF32 off, PyTorch's default for matmuls).

An int8 weight-only leaf {"q": int8 [out, in], "s": float32 [out]}
(models/weights.quantize_int8) multiplies bf16 activations by the raw codes
and applies the per-output scale to the float32 accumulator.

A row-parallel layer under tensor parallelism (`out_proj`, `linear2`: each
rank holds some input columns) passes its `mesh`: the sum over tp runs on
the float32 accumulator before the int8 scale and the cast to the
activation's dtype, where GSPMD reduces the JAX package's float32
dot_general output. Reducing the rounded partials would not match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.parallel.collectives import reduce_from_tp


def linear(x: torch.Tensor, weight, bias: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """y = x @ W^T + b with W in torch layout [out, in] (or an int8 leaf);
    `mesh` (a row-parallel shard's): the float32 accumulator is summed over
    its tp ranks."""
    out_dtype = x.dtype
    if isinstance(weight, dict):
        y = F.linear(x.to(torch.bfloat16).float(), weight["q"].float())
        if mesh is not None:
            y = reduce_from_tp(mesh, y)
        y = y * weight["s"]
    else:
        y = F.linear(x.to(weight.dtype).float(), weight.float())
        if mesh is not None:
            y = reduce_from_tp(mesh, y)
    y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def qkv_proj(x: torch.Tensor, weight) -> torch.Tensor:
    """Packed QKV projection, weight [3, E, E] (q rows, then k, then v) or
    its int8 leaf -> [B, T, 3, E]."""
    if isinstance(weight, dict):
        w = {"q": weight["q"].reshape(-1, weight["q"].shape[-1]), "s": weight["s"].reshape(-1)}
    else:
        w = weight.reshape(-1, weight.shape[-1])
    y = linear(x, w)
    return y.reshape(*y.shape[:-1], 3, -1)
