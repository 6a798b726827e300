"""Transformer stacks shared by the FlowLM backbone and the Mimi codec
(port of pocket_tts_tpu/ops/transformer.py; reference:
pocket_tts_mlx/modules/mimi_transformer.py:17-171).

Pre-LN (eps=1e-5) blocks with exact-erf GELU feed-forward, optional
LayerScale, and either full-history causal attention ("flow_lm") or the
windowed ring ("mimi"). Parameters and streaming state are plain dicts of
tensors with the JAX package's tree layout; the KV caches update in place.
`forward` is the non-streaming call over a whole sequence (mimi kind: the
encoder of voice cloning; flow_lm kind: causal, the training path).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.attention import CausalKVAttention, WindowedRingAttention, _uniform
from pocket_tts_tpu_torch.ops.linear import linear
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.rope import rope_angles

Params = dict
State = dict


def _ln_params(dim: int, dtype) -> Params:
    return {"weight": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)}


@dataclass(frozen=True)
class StreamingTransformerLayer:
    """Pre-LN attention + feed-forward block with optional LayerScale."""

    d_model: int
    num_heads: int
    dim_feedforward: int
    context: int | None
    max_period: float
    layer_scale: float | None = None
    attention_kind: str = "mimi"

    @property
    def self_attn(self):
        if self.attention_kind == "mimi":
            return WindowedRingAttention(self.d_model, self.num_heads, self.context, self.max_period)
        return CausalKVAttention(self.d_model, self.num_heads, self.max_period)

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        params = {
            "self_attn": self.self_attn.init_params(gen, dtype),
            "norm1": _ln_params(self.d_model, dtype),
            "norm2": _ln_params(self.d_model, dtype),
            "linear1": {
                "weight": _uniform(
                    gen, (self.dim_feedforward, self.d_model), 1 / math.sqrt(self.d_model), dtype
                )
            },
            "linear2": {
                "weight": _uniform(
                    gen, (self.d_model, self.dim_feedforward),
                    1 / math.sqrt(self.dim_feedforward), dtype,
                )
            },
        }
        if self.layer_scale is not None:
            for name in ("layer_scale_1", "layer_scale_2"):
                params[name] = {"scale": torch.full((self.d_model,), self.layer_scale, dtype=dtype)}
        return params

    def _scaled(self, params: Params, name: str, update: torch.Tensor) -> torch.Tensor:
        if self.layer_scale is None:
            return update
        return params[name]["scale"].to(update.dtype) * update

    def _ff(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, params["norm2"]["weight"], params["norm2"]["bias"], eps=1e-5)
        h = F.gelu(linear(h, params["linear1"]["weight"]))
        h = linear(h, params["linear2"]["weight"])
        return x + self._scaled(params, "layer_scale_2", h)

    def __call__(self, params, x, state, positions, rope_cache, widx=None, pos0=None, read_limit=None):
        h = layer_norm(x, params["norm1"]["weight"], params["norm1"]["bias"], eps=1e-5)
        if self.attention_kind == "flow_lm":
            update = self.self_attn(params["self_attn"], h, state, positions, widx, rope_cache, read_limit)
        else:
            update = self.self_attn(params["self_attn"], h, state, positions, pos0, rope_cache)
        x = x + self._scaled(params, "layer_scale_1", update)
        return self._ff(params, x)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Non-streaming (whole-sequence) call: windowed attention at mimi
        kind, causal at flow_lm kind; no state."""
        h = layer_norm(x, params["norm1"]["weight"], params["norm1"]["bias"], eps=1e-5)
        x = x + self._scaled(params, "layer_scale_1", self.self_attn.forward(params["self_attn"], h))
        return self._ff(params, x)


@dataclass(frozen=True)
class StreamingTransformer:
    """Stack of streaming transformer layers sharing the RoPE period."""

    d_model: int
    num_heads: int
    num_layers: int
    dim_feedforward: int
    context: int | None = None
    max_period: float = 10_000.0
    layer_scale: float | None = None
    kind: str = "mimi"

    @property
    def layer(self) -> StreamingTransformerLayer:
        return StreamingTransformerLayer(
            d_model=self.d_model,
            num_heads=self.num_heads,
            dim_feedforward=self.dim_feedforward,
            context=self.context,
            max_period=self.max_period,
            layer_scale=self.layer_scale,
            attention_kind=self.kind,
        )

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return {"layers": [self.layer.init_params(gen, dtype) for _ in range(self.num_layers)]}

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        attn = self.layer.self_attn
        state: State = {
            "layers": [
                attn.init_state(batch_size, capacity, dtype, device) for _ in range(self.num_layers)
            ]
        }
        if self.kind == "flow_lm":
            state["widx"] = 0  # one host-side write index for the whole stack
        return state

    def __call__(self, params, x, state, positions, pos0=None,
                 read_limit: int | None = None) -> torch.Tensor:
        """Run the stack on x [B, T, E] at positions [B, T], updating `state`
        in place (flow_lm: appends at state["widx"], which advances by T;
        read_limit bounds the cache rows each layer's attention reads)."""
        rope_cache = rope_angles(positions.clamp(min=0), self.d_model // self.num_heads, self.max_period)
        layer = self.layer
        widx = state.get("widx")
        for l_params, l_state in zip(params["layers"], state["layers"]):
            x = layer(l_params, x, l_state, positions, rope_cache, widx=widx, pos0=pos0, read_limit=read_limit)
        if widx is not None:
            state["widx"] = widx + x.shape[1]
        return x

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The stack over a whole sequence [B, T, E], no state (see
        StreamingTransformerLayer.forward)."""
        layer = self.layer
        for l_params in params["layers"]:
            x = layer.forward(l_params, x)
        return x


@dataclass(frozen=True)
class ProjectedTransformer:
    """Transformer with input/output projections on [B, C, T]
    (reference: pocket_tts_mlx/modules/mimi_transformer.py:123-171)."""

    input_dimension: int
    output_dimensions: tuple[int, ...]
    d_model: int
    num_heads: int
    num_layers: int
    layer_scale: float
    context: int
    max_period: float
    dim_feedforward: int

    @property
    def transformer(self) -> StreamingTransformer:
        return StreamingTransformer(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_layers=self.num_layers,
            dim_feedforward=self.dim_feedforward,
            context=self.context,
            max_period=self.max_period,
            layer_scale=self.layer_scale,
            kind="mimi",
        )

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        params: Params = {"transformer": self.transformer.init_params(gen, dtype)}
        if self.d_model != self.input_dimension:
            params["input_proj"] = {
                "weight": _uniform(
                    gen, (self.d_model, self.input_dimension),
                    1 / math.sqrt(self.input_dimension), dtype,
                )
            }
        params["output_projs"] = [
            {}
            if dim == self.d_model
            else {"weight": _uniform(gen, (dim, self.d_model), 1 / math.sqrt(self.d_model), dtype)}
            for dim in self.output_dimensions
        ]
        return params

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        return self.transformer.init_state(batch_size, capacity, dtype, device)

    @staticmethod
    def _project_in(params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)  # [B, C, T] -> [B, T, C]
        if "input_proj" in params:
            h = linear(h, params["input_proj"]["weight"])
        return h

    @staticmethod
    def _project_out(params: Params, z: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return tuple(
            (linear(z, proj["weight"]) if "weight" in proj else z).transpose(1, 2)
            for proj in params["output_projs"]
        )

    def __call__(self, params, x, state, positions, pos0) -> tuple[torch.Tensor, ...]:
        z = self.transformer(params["transformer"], self._project_in(params, x), state, positions, pos0=pos0)
        return self._project_out(params, z)

    def forward(self, params: Params, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Non-streaming call over a whole sequence [B, C, T]."""
        z = self.transformer.forward(params["transformer"], self._project_in(params, x))
        return self._project_out(params, z)
