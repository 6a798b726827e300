"""Streaming 1D convolutions over explicit state dicts
(port of pocket_tts_tpu/ops/conv.py; reference:
pocket_tts_mlx/modules/conv.py:74-200).

Feeding a signal chunk by chunk gives the same output as one whole-sequence
call. Activations are [B, C, T]; Conv1d weights are torch layout
(out, in/groups, k) and ConvTranspose1d weights torch layout
(in, out/groups, k) — the JAX package flips and transposes the latter at
load time, the port keeps the checkpoint's layout.

Mixed precision follows the JAX package: the activation is cast to the
weight dtype, products accumulate in float32 (computed as a float32
convolution of the rounded operands), and the result returns in the
activation dtype or `out_dtype`; the bias is added after that cast.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.attention import _uniform

Params = dict
State = dict


def conv1d(x, weight, bias=None, stride=1, dilation=1, groups=1, out_dtype=None) -> torch.Tensor:
    """VALID 1D convolution with a torch-layout weight."""
    out_dtype = out_dtype or x.dtype
    y = F.conv1d(
        x.to(weight.dtype).float(), weight.float(), stride=stride, dilation=dilation, groups=groups
    ).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[None, :, None]
    return y


def conv_transpose1d(x, weight, bias=None, stride=1, groups=1) -> torch.Tensor:
    """Full (untrimmed) transposed convolution: output length (T-1)*S + K."""
    out_dtype = x.dtype
    y = F.conv_transpose1d(
        x.to(weight.dtype).float(), weight.float(), stride=stride, groups=groups
    ).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[None, :, None]
    return y


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int, padding_total: int = 0) -> int:
    """End padding so the conv consumes the signal in whole frames
    (reference: pocket_tts_mlx/modules/conv.py:12-17)."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return int(ideal_length - length)


def pad_for_conv1d(x: torch.Tensor, kernel_size: int, stride: int, padding_total: int = 0) -> torch.Tensor:
    """Zero-pad the end of [B, C, T] for whole-frame convolution."""
    extra = get_extra_padding_for_conv1d(x.shape[-1], kernel_size, stride, padding_total)
    if extra > 0:
        x = F.pad(x, (0, extra))
    return x


@dataclass(frozen=True)
class StreamingConv1d:
    """Causal streaming Conv1d: carries the trailing (effective_kernel -
    stride) input columns between chunks; pad_mode='replicate' left-pads the
    first chunk with its own first sample."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "constant"

    @property
    def overlap(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1 - self.stride

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        fan_in = self.in_channels // self.groups * self.kernel_size
        shape = (self.out_channels, self.in_channels // self.groups, self.kernel_size)
        params = {"weight": _uniform(gen, shape, 1.0 / math.sqrt(fan_in), dtype)}
        if self.bias:
            params["bias"] = torch.zeros(self.out_channels, dtype=dtype)
        return params

    def init_state(self, batch_size: int, dtype=torch.float32, device="cpu") -> State:
        state: State = {
            "previous": torch.zeros(batch_size, self.in_channels, self.overlap, dtype=dtype, device=device)
        }
        if self.pad_mode == "replicate":
            state["first"] = torch.ones(batch_size, dtype=torch.bool, device=device)
        return state

    def __call__(self, params: Params, x: torch.Tensor, state: State, out_dtype=None):
        """Streaming step on a chunk [B, C, T]; T must be a multiple of stride."""
        T = x.shape[-1]
        if T <= 0 or T % self.stride:
            raise ValueError("chunk length must be a positive multiple of stride")
        overlap = self.overlap
        if overlap:
            previous = state["previous"]
            if self.pad_mode == "replicate":
                previous = torch.where(
                    state["first"][:, None, None], x[:, :, :1].to(previous.dtype), previous
                )
            x = torch.cat([previous.to(x.dtype), x], dim=-1)
        y = conv1d(
            x, params["weight"], params.get("bias"), self.stride, self.dilation, self.groups, out_dtype
        )
        new_state = dict(state)
        if overlap:
            new_state["previous"] = x[:, :, -overlap:].to(state["previous"].dtype)
            if self.pad_mode == "replicate":
                new_state["first"] = torch.zeros_like(state["first"])
        return y, new_state

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Non-streaming call: left-pad by the overlap (zeros, or the edge
        value for pad_mode='replicate')."""
        if self.overlap:
            x = F.pad(x, (self.overlap, 0), mode="replicate" if self.pad_mode == "replicate" else "constant")
        return conv1d(x, params["weight"], params.get("bias"), self.stride, self.dilation, self.groups)


@dataclass(frozen=True)
class StreamingConvTranspose1d:
    """Streaming ConvTranspose1d with overlap-add: each chunk emits T*stride
    samples; the trailing (kernel - stride) partial columns are carried
    (bias-subtracted) into the next chunk's head."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    groups: int = 1
    bias: bool = True

    @property
    def overlap(self) -> int:
        return self.kernel_size - self.stride

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        fan_in = self.in_channels // self.groups * self.kernel_size
        shape = (self.in_channels, self.out_channels // self.groups, self.kernel_size)
        params = {"weight": _uniform(gen, shape, 1.0 / math.sqrt(fan_in), dtype)}
        if self.bias:
            params["bias"] = torch.zeros(self.out_channels, dtype=dtype)
        return params

    def init_state(self, batch_size: int, dtype=torch.float32, device="cpu") -> State:
        return {"partial": torch.zeros(batch_size, self.out_channels, self.overlap, dtype=dtype, device=device)}

    def __call__(self, params: Params, x: torch.Tensor, state: State):
        bias = params.get("bias")
        y = conv_transpose1d(x, params["weight"], bias, self.stride, self.groups)
        overlap = self.overlap
        if overlap == 0:
            return y, state
        y = torch.cat([y[:, :, :overlap] + state["partial"].to(y.dtype), y[:, :, overlap:]], dim=-1)
        new_partial = y[:, :, -overlap:]
        if bias is not None:
            new_partial = new_partial - bias.to(y.dtype)[None, :, None]
        return y[:, :, :-overlap], {"partial": new_partial.to(state["partial"].dtype)}
