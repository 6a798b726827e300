"""SEANet encoder and decoder, the Mimi codec's front and back ends
(port of pocket_tts_tpu/models/seanet.py; reference:
pocket_tts_mlx/modules/seanet.py:9-170).

Parameters sit under the checkpoint's `model.{i}` / `block.{i}` indices,
with ELU activations in parameterless slots. The decoder streams (explicit
conv state); the encoder (voice cloning) runs once over a whole prompt.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.conv import StreamingConv1d, StreamingConvTranspose1d

Params = dict
State = dict


@dataclass(frozen=True)
class SEANetResnetBlock:
    """ELU + conv (+ ELU + conv) with a residual connection."""

    dim: int
    kernel_sizes: tuple[int, ...] = (3, 1)
    dilations: tuple[int, ...] = (1, 1)
    pad_mode: str = "constant"
    compress: int = 2

    @property
    def block(self) -> tuple:
        hidden = self.dim // self.compress
        layers: list = []
        n = len(self.kernel_sizes)
        for i, (kernel_size, dilation) in enumerate(zip(self.kernel_sizes, self.dilations)):
            in_chs = self.dim if i == 0 else hidden
            out_chs = self.dim if i == n - 1 else hidden
            layers.append(None)  # ELU
            layers.append(
                StreamingConv1d(in_chs, out_chs, kernel_size=kernel_size, dilation=dilation, pad_mode=self.pad_mode)
            )
        return tuple(layers)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {"block": [{} if l is None else {"conv": l.init_params(gen, dtype)} for l in self.block]}

    def init_state(self, batch_size: int, dtype=torch.float32, device="cpu") -> State:
        return {"block": [{} if l is None else l.init_state(batch_size, dtype, device) for l in self.block]}

    def __call__(self, params: Params, x: torch.Tensor, state: State):
        v = x
        new_states = []
        for layer, l_params, l_state in zip(self.block, params["block"], state["block"]):
            if layer is None:
                v = F.elu(v)
                new_states.append(l_state)
            else:
                v, s = layer(l_params["conv"], v, l_state)
                new_states.append(s)
        return x + v, {"block": new_states}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Non-streaming call over a whole sequence."""
        v = x
        for layer, l_params in zip(self.block, params["block"]):
            v = F.elu(v) if layer is None else layer.forward(l_params["conv"], v)
        return x + v


def _key(layer) -> str:
    return "convtr" if isinstance(layer, StreamingConvTranspose1d) else "conv"


def _init_chain_params(layers, gen, dtype) -> Params:
    out = []
    for layer in layers:
        if layer is None:
            out.append({})
        elif isinstance(layer, SEANetResnetBlock):
            out.append(layer.init_params(gen, dtype))
        else:
            out.append({_key(layer): layer.init_params(gen, dtype)})
    return {"model": out}


def _forward_chain(layers, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The stateless form of the JAX package's `_iterate`: every layer over
    the whole sequence."""
    for layer, l_params in zip(layers, params["model"]):
        if layer is None:
            x = F.elu(x)
        elif isinstance(layer, SEANetResnetBlock):
            x = layer.forward(l_params, x)
        else:
            x = layer.forward(l_params[_key(layer)], x)
    return x


@dataclass(frozen=True)
class SEANetEncoder:
    """Waveform [B, 1, T] -> features [B, dimension, T / hop]."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 3
    ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    compress: int = 2

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    @property
    def model(self) -> tuple:
        layers: list = [StreamingConv1d(self.channels, self.n_filters, self.kernel_size, pad_mode=self.pad_mode)]
        mult = 1
        for ratio in reversed(self.ratios):
            for j in range(self.n_residual_layers):
                layers.append(
                    SEANetResnetBlock(
                        mult * self.n_filters,
                        kernel_sizes=(self.residual_kernel_size, 1),
                        dilations=(self.dilation_base**j, 1),
                        pad_mode=self.pad_mode,
                        compress=self.compress,
                    )
                )
            layers.append(None)  # ELU
            layers.append(
                StreamingConv1d(
                    mult * self.n_filters, mult * self.n_filters * 2, kernel_size=ratio * 2, stride=ratio,
                    pad_mode=self.pad_mode,
                )
            )
            mult *= 2
        layers.append(None)  # ELU
        layers.append(
            StreamingConv1d(mult * self.n_filters, self.dimension, self.last_kernel_size, pad_mode=self.pad_mode)
        )
        return tuple(layers)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return _init_chain_params(self.model, gen, dtype)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return _forward_chain(self.model, params, x)


@dataclass(frozen=True)
class SEANetDecoder:
    """Features [B, dimension, T] -> waveform [B, 1, T*hop] (float32)."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 3
    ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    compress: int = 2

    @property
    def model(self) -> tuple:
        mult = 2 ** len(self.ratios)
        layers: list = [
            StreamingConv1d(self.dimension, mult * self.n_filters, self.kernel_size, pad_mode=self.pad_mode)
        ]
        for ratio in self.ratios:
            layers.append(None)  # ELU
            layers.append(
                StreamingConvTranspose1d(
                    mult * self.n_filters, mult * self.n_filters // 2, kernel_size=ratio * 2, stride=ratio
                )
            )
            for j in range(self.n_residual_layers):
                layers.append(
                    SEANetResnetBlock(
                        mult * self.n_filters // 2,
                        kernel_sizes=(self.residual_kernel_size, 1),
                        dilations=(self.dilation_base**j, 1),
                        pad_mode=self.pad_mode,
                        compress=self.compress,
                    )
                )
            mult //= 2
        layers.append(None)  # ELU
        layers.append(
            StreamingConv1d(self.n_filters, self.channels, self.last_kernel_size, pad_mode=self.pad_mode)
        )
        return tuple(layers)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return _init_chain_params(self.model, gen, dtype)

    def init_state(self, batch_size: int, dtype=torch.float32, device="cpu") -> State:
        return {"model": [{} if l is None else l.init_state(batch_size, dtype, device) for l in self.model]}

    def __call__(self, params: Params, z: torch.Tensor, state: State):
        """Streaming decode; the last (waveform-emitting) conv returns
        float32 whatever the feature dtype."""
        layers = self.model
        last = len(layers) - 1
        x = z
        new_states = []
        for i, (layer, l_params, l_state) in enumerate(zip(layers, params["model"], state["model"])):
            if layer is None:
                x = F.elu(x)
                new_states.append(l_state)
            elif isinstance(layer, SEANetResnetBlock):
                x, s = layer(l_params, x, l_state)
                new_states.append(s)
            elif i == last and isinstance(layer, StreamingConv1d):
                x, s = layer(l_params["conv"], x, l_state, out_dtype=torch.float32)
                new_states.append(s)
            else:
                x, s = layer(l_params[_key(layer)], x, l_state)
                new_states.append(s)
        return x, {"model": new_states}
