"""AdaLN flow-matching MLP head, the velocity network of FlowLM
(port of pocket_tts_tpu/ops/adaln.py; reference:
pocket_tts_mlx/modules/mlp.py:53-168).

Two sinusoidal timestep embedders (for the ODE interval ends s and t)
averaged, a conditioning projection, `depth` AdaLN residual blocks with
shift/scale/gate modulation and a 2-way-modulated final projection.
LayerNorms use eps=1e-6; the embedders end in the ddof=1 RMSNorm.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.attention import _uniform
from pocket_tts_tpu_torch.ops.linear import linear
from pocket_tts_tpu_torch.ops.norms import layer_norm, rms_norm_ddof1

Params = dict


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale) + shift


def _linear_params(gen: torch.Generator, out_dim: int, in_dim: int, dtype) -> Params:
    s = 1.0 / math.sqrt(in_dim)
    return {"weight": _uniform(gen, (out_dim, in_dim), s, dtype), "bias": _uniform(gen, (out_dim,), s, dtype)}


@dataclass(frozen=True)
class TimestepEmbedder:
    """Sinusoidal frequency embedding -> Linear -> SiLU -> Linear -> RMSNorm."""

    hidden_size: int
    frequency_embedding_size: int = 256
    max_period: int = 10_000

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return {
            "mlp": [
                _linear_params(gen, self.hidden_size, self.frequency_embedding_size, dtype),
                {},  # SiLU slot, keeps checkpoint indices mlp.{0,2,3}
                _linear_params(gen, self.hidden_size, self.hidden_size, dtype),
                {"alpha": torch.ones(self.hidden_size, dtype=dtype)},
            ]
        }

    def __call__(self, params: Params, t: torch.Tensor) -> torch.Tensor:
        """t: [B, 1] -> [B, hidden]."""
        half = self.frequency_embedding_size // 2
        freqs = torch.exp(
            -math.log(self.max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t.float() * freqs[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        x = F.silu(linear(emb, params["mlp"][0]["weight"], params["mlp"][0]["bias"]))
        x = linear(x, params["mlp"][2]["weight"], params["mlp"][2]["bias"])
        return rms_norm_ddof1(x, params["mlp"][3]["alpha"], eps=1e-5)


@dataclass(frozen=True)
class SimpleMLPAdaLN:
    """The conditioned velocity field v(x; s, t, cond) integrated by lsd_decode."""

    in_channels: int
    model_channels: int
    out_channels: int
    cond_channels: int
    num_res_blocks: int
    num_time_conds: int = 2

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        mc = self.model_channels
        embedder = TimestepEmbedder(mc)

        def res_block():
            return {
                "in_ln": {"weight": torch.ones(mc, dtype=dtype), "bias": torch.zeros(mc, dtype=dtype)},
                "mlp": [_linear_params(gen, mc, mc, dtype), {}, _linear_params(gen, mc, mc, dtype)],
                "adaLN_modulation": [{}, _linear_params(gen, 3 * mc, mc, dtype)],
            }

        return {
            "time_embed": [embedder.init_params(gen, dtype) for _ in range(self.num_time_conds)],
            "cond_embed": _linear_params(gen, mc, self.cond_channels, dtype),
            "input_proj": _linear_params(gen, mc, self.in_channels, dtype),
            "final_layer": {
                "linear": _linear_params(gen, self.out_channels, mc, dtype),
                "adaLN_modulation": [{}, _linear_params(gen, 2 * mc, mc, dtype)],
            },
            "res_blocks": [res_block() for _ in range(self.num_res_blocks)],
        }

    def time_conditioning(self, params: Params, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Mean of the s and t timestep embeddings -> [B, model_channels]."""
        embedder = TimestepEmbedder(self.model_channels)
        ts = [s, t]
        return sum(embedder(params["time_embed"][i], ts[i]) for i in range(self.num_time_conds)) / (
            self.num_time_conds
        )

    def __call__(self, params: Params, c, s, t, x) -> torch.Tensor:
        """c [B, cond], s and t [B, 1], x [B, in] -> velocity [B, out]."""
        x = linear(x, params["input_proj"]["weight"], params["input_proj"]["bias"])
        y = self.time_conditioning(params, s, t) + linear(
            c, params["cond_embed"]["weight"], params["cond_embed"]["bias"]
        )
        sy = F.silu(y)
        for blk in params["res_blocks"]:
            mod = blk["adaLN_modulation"][1]
            shift, scale, gate = linear(sy, mod["weight"], mod["bias"]).chunk(3, dim=-1)
            h = modulate(layer_norm(x, blk["in_ln"]["weight"], blk["in_ln"]["bias"], eps=1e-6), shift, scale)
            h = F.silu(linear(h, blk["mlp"][0]["weight"], blk["mlp"][0]["bias"]))
            x = x + gate * linear(h, blk["mlp"][2]["weight"], blk["mlp"][2]["bias"])
        final = params["final_layer"]
        mod = final["adaLN_modulation"][1]
        shift, scale = linear(sy, mod["weight"], mod["bias"]).chunk(2, dim=-1)
        x = modulate(layer_norm(x, eps=1e-6), shift, scale)
        return linear(x, final["linear"]["weight"], final["linear"]["bias"])
