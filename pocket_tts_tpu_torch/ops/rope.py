"""Rotary position embeddings, interleaved-pair convention, float32
(port of pocket_tts_tpu/ops/rope.py; reference:
pocket_tts_mlx/modules/rope.py:9-42)."""

from __future__ import annotations

import math

import torch


def rope_angles(
    positions: torch.Tensor, head_dim: int, max_period: float = 10_000.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, T, 1, D/2] for integer positions [B, T]."""
    ds = torch.arange(head_dim // 2, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2.0 / head_dim))
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    rope_cache: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k ([B, T, H, D]) by rope_cache = (cos, sin) from
    rope_angles(); pairs (2i, 2i+1) rotate by angle i, computed in float32
    and cast back to the input dtype."""
    cos, sin = rope_cache

    def rotate(x: torch.Tensor) -> torch.Tensor:
        xs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
        xr, xi = xs[..., 0].float(), xs[..., 1].float()
        out = torch.stack(
            [(xr * cos - xi * sin).to(x.dtype), (xr * sin + xi * cos).to(x.dtype)], dim=-1
        )
        return out.reshape(x.shape)

    return rotate(q), rotate(k)
