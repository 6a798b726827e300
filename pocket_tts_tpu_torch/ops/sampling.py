"""Flow-matching sampling: noise draw + low-step Euler ODE integration
(port of pocket_tts_tpu/ops/sampling.py; reference:
pocket_tts_mlx/models/flow_lm.py:18-28).

The noise comes from an explicit torch.Generator. It cannot reproduce the
JAX package's threefry stream, so parity tests hand both the same noise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pocket_tts_tpu_torch.utils.transfer import host_to_device


def lsd_decode(
    v_t: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    x_0: torch.Tensor,
    num_steps: int = 1,
) -> torch.Tensor:
    """Integrate dx = v(s, t, x) dt from noise x_0 with `num_steps` Euler steps."""
    current = x_0
    B = x_0.shape[0]
    for i in range(num_steps):
        s = torch.full((B, 1), i / num_steps, dtype=torch.float32, device=x_0.device)
        t = torch.full((B, 1), (i + 1) / num_steps, dtype=torch.float32, device=x_0.device)
        current = current + v_t(s, t, current) / num_steps
    return current


def sample_noise(
    gen: torch.Generator,
    shape: tuple[int, ...],
    temp: float,
    noise_clamp: Optional[float] = None,
    device="cpu",
) -> torch.Tensor:
    """N(0, temp) float32 noise with optional symmetric clamping, drawn from a
    CPU generator (one stream whatever the device) and queued to `device`
    without a host sync."""
    noise = torch.randn(shape, generator=gen, dtype=torch.float32) * (float(temp) ** 0.5)
    if noise_clamp is not None:
        noise = noise.clamp(-noise_clamp, noise_clamp)
    return host_to_device(noise, device)
