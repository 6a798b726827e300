"""Normalization primitives (port of pocket_tts_tpu/ops/norms.py).

Parity-critical constants of the checkpoint: transformer LayerNorms use
eps=1e-5, flow-MLP LayerNorms eps=1e-6, and the timestep embedders end in an
RMSNorm that divides a mean-subtracted sum of squares by N-1 (ddof=1).
Statistics are computed in float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis: (x - mean) * rsqrt(var + eps) * w + b."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm_ddof1(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x * alpha * rsqrt(eps + var_1(x)) with the unbiased (N-1) variance."""
    xf = x.float()
    n = x.shape[-1]
    centered = xf - xf.mean(dim=-1, keepdim=True)
    var = (centered * centered).sum(dim=-1, keepdim=True) / (n - 1)
    return (xf * (alpha.float() * torch.rsqrt(eps + var))).to(x.dtype)
