"""Streaming attention over static-capacity caches
(port of pocket_tts_tpu/ops/attention.py).

- CausalKVAttention (FlowLM backbone): a slot-major `[B, C, H, d]` KV cache
  with a batch-common write index `widx` and per-slot absolute positions
  `slot_pos` ([B, C], -1 = invalid). A query at position p attends to the
  slots whose position lies in [0, p]. Appends write the cache IN PLACE at
  `widx`, clamped like the JAX package's dynamic_update_slice, so a state
  that must survive a decode is cloned first (models/tts_model.ModelState).
- WindowedRingAttention (Mimi codec): a shift-append ring kept ordered
  oldest -> newest; slot positions are arithmetic, and long chunks attend in
  128-query blocks over a (context + 128)-wide key band.

Numerics mirror the JAX package: scores, softmax and accumulation in
float32, q cast to the cache dtype before the score product, softmax
weights cast to the cache dtype before the PV product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pocket_tts_tpu_torch.ops.linear import linear, qkv_proj
from pocket_tts_tpu_torch.ops.rope import apply_rope

Params = dict
State = dict

_NEG_INF = -1e9


def _split_qkv(projected: torch.Tensor, num_heads: int):
    """[B, T, 3, F] -> three [B, T, H, d] (F is head-major)."""
    B, T, _, F = projected.shape
    packed = projected.reshape(B, T, 3, num_heads, F // num_heads)
    return packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]


def sdpa_slots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax(q k^T / sqrt(d)) v over a slot-major cache.

    q [B, T, H, d]; k, v [B, S, H, d] (cache dtype); valid bool broadcastable
    to [B, H, T, S]. Returns [B, T, H, d] in q's dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.to(k.dtype).float(), k.float()) * (1.0 / math.sqrt(d))
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound).to(dtype)


def _init_proj_params(gen: torch.Generator, embed_dim: int, dtype) -> Params:
    s = 1.0 / math.sqrt(embed_dim)
    return {
        "in_proj": {"weight": _uniform(gen, (3, embed_dim, embed_dim), s, dtype)},
        "out_proj": {"weight": _uniform(gen, (embed_dim, embed_dim), s, dtype)},
    }


@dataclass(frozen=True)
class CausalKVAttention:
    """Full-history causal attention with the slot-indexed KV cache."""

    embed_dim: int
    num_heads: int
    max_period: float = 10_000.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return _init_proj_params(gen, self.embed_dim, dtype)

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        shape = (batch_size, capacity, self.num_heads, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((batch_size, capacity), -1, dtype=torch.int32, device=device),
        }

    def __call__(
        self,
        params: Params,
        x: torch.Tensor,  # [B, T, E]
        state: State,
        positions: torch.Tensor,  # int32 [B, T]: absolute positions, -1 = padding
        widx: int,
        rope_cache: tuple,
    ) -> torch.Tensor:
        """Append this call's T rows at widx (in place) and attend."""
        B, T, _ = x.shape
        q, k, v = _split_qkv(qkv_proj(x, params["in_proj"]["weight"]), self.num_heads)
        q, k = apply_rope(q, k, rope_cache)
        C = state["k"].shape[1]
        w = min(max(int(widx), 0), C - T)  # dynamic_update_slice clamps its start
        state["k"][:, w : w + T] = k.to(state["k"].dtype)
        state["v"][:, w : w + T] = v.to(state["v"].dtype)
        state["slot_pos"][:, w : w + T] = positions.to(torch.int32)
        sp = state["slot_pos"]
        valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= positions[:, :, None])  # [B, T, C]
        out = sdpa_slots(q, state["k"], state["v"], valid[:, None])
        return linear(out.reshape(B, T, self.embed_dim), params["out_proj"]["weight"])


@dataclass(frozen=True)
class WindowedRingAttention:
    """Sliding-window causal attention over a shift-append ring buffer.

    Window predicate (reference: pocket_tts_mlx/modules/attention.py:244-254):
    (pos_k >= 0) & (delta >= 0) & (delta < context)."""

    embed_dim: int
    num_heads: int
    context: int
    max_period: float = 10_000.0

    _QBLOCK = 128  # query-block length of the banded form

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return _init_proj_params(gen, self.embed_dim, dtype)

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        shape = (batch_size, capacity, self.num_heads, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }

    def __call__(
        self,
        params: Params,
        x: torch.Tensor,  # [B, T, E]
        state: State,
        positions: torch.Tensor,  # int32 [B, T]
        pos0: int,  # absolute position of x's first row (batch-common)
        rope_cache: tuple,
    ) -> torch.Tensor:
        B, T, _ = x.shape
        capacity = state["k"].shape[1]
        if capacity < self.context + T:
            raise ValueError("ring must retain a full window plus the new chunk")
        q, k, v = _split_qkv(qkv_proj(x, params["in_proj"]["weight"]), self.num_heads)
        q, k = apply_rope(q, k, rope_cache)
        # Slot j then holds absolute position (pos0 + T) - capacity + j.
        state["k"] = torch.cat([state["k"][:, T:], k.to(state["k"].dtype)], dim=1)
        state["v"] = torch.cat([state["v"][:, T:], v.to(state["v"].dtype)], dim=1)
        out = self._banded_sdpa(q, state["k"], state["v"], pos0, positions)
        return linear(out.reshape(B, T, self.embed_dim), params["out_proj"]["weight"])

    def _valid(self, slot_pos: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        delta = qpos[:, :, None] - slot_pos[None, None, :]  # [B, Tq, W]
        return ((slot_pos[None, None, :] >= 0) & (delta >= 0) & (delta < self.context))[:, None]

    def _banded_sdpa(self, q, k_cache, v_cache, pos0: int, positions):
        """Windowed attention; chunks of whole 128-query blocks read only a
        (context + 127)-wide key band per block. Masked entries underflow to
        exactly 0 in the float32 softmax, so the banded form equals the
        dense one."""
        T = q.shape[1]
        capacity = k_cache.shape[1]
        Q = self._QBLOCK
        W = ((self.context - 1 + Q) + 127) // 128 * 128
        base = pos0 + T - capacity  # absolute position held by slot 0
        ar = torch.arange(capacity, dtype=torch.int32, device=q.device)
        if T % Q or W >= capacity:
            return sdpa_slots(q, k_cache, v_cache, self._valid(base + ar, positions))
        outs = []
        for i in range(T // Q):
            s = max(0, min(capacity - W, capacity - T + (i + 1) * Q - W))
            outs.append(
                sdpa_slots(
                    q[:, i * Q : (i + 1) * Q],
                    k_cache[:, s : s + W],
                    v_cache[:, s : s + W],
                    self._valid(base + s + ar[:W], positions[:, i * Q : (i + 1) * Q]),
                )
            )
        return torch.cat(outs, dim=1)
