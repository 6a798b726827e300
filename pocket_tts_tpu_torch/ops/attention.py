"""Streaming attention over static-capacity caches
(port of pocket_tts_tpu/ops/attention.py).

- CausalKVAttention (FlowLM backbone): a slot-major `[B, C, H, d]` KV cache
  with a batch-common write index `widx` and per-slot absolute positions
  `slot_pos` ([B, C], -1 = invalid). A query at position p attends to the
  slots whose position lies in [0, p]. Appends write the cache IN PLACE at
  `widx`, clamped like the JAX package's dynamic_update_slice, so a state
  that must survive a decode is cloned first (models/tts_model.ModelState).
  An int8 cache (batch serving) stores symmetric int8 rows with one float32
  scale per row (`k_scale` / `v_scale`, [B, C]). Batch decode steps (T == 1,
  B > 1, or any B on a mesh, where a rank may hold one stream of a batch)
  attend through ops/batch_attention.batch_decode_attention over the full
  cache, reading its first `read_limit` rows (on the card where the kernel
  takes the head size: batch_attention.kernel_takes); every other call
  (prefill, T > 1, B == 1 off a mesh) runs the dense `sdpa_slots`. Its `forward`
  is the cache-free causal form over a whole sequence (training).
- WindowedRingAttention (Mimi codec): a shift-append ring kept ordered
  oldest -> newest; slot positions are arithmetic, and long chunks attend in
  128-query blocks over a (context + 128)-wide key band. Its `forward` is
  the non-streaming form over a whole sequence (the Mimi encoder of voice
  cloning).

Numerics mirror the JAX package: scores, softmax and accumulation in
float32, q cast to the cache dtype before the score product, softmax
weights cast to the cache dtype before the PV product.

On a mesh (`mesh`, parallel/mesh.py) each rank runs the H / tp heads whose
q, k and v rows of `in_proj` it holds, keeps their caches ([B, C, H / tp,
d]), and sums `out_proj`'s partial outputs over tp (parallel/collectives.py).
An int8 row's scale is the absmax over all H heads: the local maximum, then
a maximum over tp, as GSPMD reduces the JAX package's max over the head
axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pocket_tts_tpu_torch.ops import batch_attention
from pocket_tts_tpu_torch.ops.linear import linear, qkv_proj
from pocket_tts_tpu_torch.ops.rope import apply_rope, rope_angles
from pocket_tts_tpu_torch.parallel.collectives import copy_to_tp, max_over_tp, tp_active
from pocket_tts_tpu_torch.parallel.mesh import Mesh

Params = dict
State = dict

_NEG_INF = -1e9


def _split_qkv(projected: torch.Tensor, num_heads: int):
    """[B, T, 3, F] -> three [B, T, H, d] (F is head-major)."""
    B, T, _, F = projected.shape
    packed = projected.reshape(B, T, 3, num_heads, F // num_heads)
    return packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]


def sdpa_slots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
               k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Masked softmax(q k^T / sqrt(d)) v over a slot-major cache.

    q [B, T, H, d]; k, v [B, S, H, d] (cache dtype); valid bool broadcastable
    to [B, H, T, S]. Returns [B, T, H, d] in q's dtype. With an int8 cache,
    k_scale / v_scale [B, S] are the per-row dequantisation scales: the
    products take the int8 rows as bf16, the K scale multiplies the scores
    and the V scale the softmax weights, as _sdpa_slots of the JAX package."""
    if (k.dtype == torch.int8) != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 KV rows need k_scale and v_scale, and only they do")
    d = q.shape[-1]
    cd = torch.bfloat16 if k.dtype == torch.int8 else k.dtype
    scores = torch.einsum("bthd,bshd->bhts", q.to(cd).float(), k.to(cd).float())
    if k_scale is not None:
        scores = scores * (k_scale * (1.0 / math.sqrt(d)))[:, None, None, :]
    else:
        scores = scores * (1.0 / math.sqrt(d))
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        weights = weights * v_scale[:, None, None, :]
    out = torch.einsum("bhts,bshd->bthd", weights.to(cd).float(), v.to(cd).float())
    return out.to(q.dtype)


def quantize_kv_rows(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation of [B, T, H, d] K/V rows: one
    absmax scale per row over its H*d values (1 for an all-zero row), codes
    rounded half to even and clipped to +-127 -> (int8 codes, float32 [B, T]).
    `amax` [B, T] gives the rows' absmax where x holds only some of a row's
    heads (a tp rank's)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=(2, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scale[:, :, None, None]), -127, 127).to(torch.int8)
    return codes, scale


def _row_writer(widx, C: int, T: int):
    """write(dst, rows): rows [B, T, ...] into dst [B, C, ...] at cache row
    widx, clamped to [0, C - T] as dynamic_update_slice clamps its start.
    widx is a host int (a slice write) or a one-element integer tensor on
    dst's device, read and clamped there, so that a captured CUDA graph
    writes where each replay's index says."""
    if isinstance(widx, torch.Tensor):
        rows = widx.reshape(1).long().clamp(0, C - T) + torch.arange(T, device=widx.device)

        def write(dst: torch.Tensor, src: torch.Tensor) -> None:
            dst.index_copy_(1, rows, src)
    else:
        w = min(max(int(widx), 0), C - T)

        def write(dst: torch.Tensor, src: torch.Tensor) -> None:
            dst[:, w : w + T] = src
    return write


def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound).to(dtype)


def _init_proj_params(gen: torch.Generator, embed_dim: int, dtype) -> Params:
    s = 1.0 / math.sqrt(embed_dim)
    return {
        "in_proj": {"weight": _uniform(gen, (3, embed_dim, embed_dim), s, dtype)},
        "out_proj": {"weight": _uniform(gen, (embed_dim, embed_dim), s, dtype)},
    }


def _local_heads(num_heads: int, mesh: Mesh | None) -> int:
    return num_heads // mesh.tp if mesh is not None else num_heads


def _project_qkv(params: Params, x: torch.Tensor, num_heads: int, mesh: Mesh | None):
    """q, k, v [B, T, H_local, d] of this rank's heads."""
    return _split_qkv(qkv_proj(copy_to_tp(mesh, x), params["in_proj"]["weight"]), _local_heads(num_heads, mesh))


def _project_out(params: Params, out: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """out_proj of the heads' outputs [B, T, H_local, d], summed over tp."""
    B, T = out.shape[:2]
    return linear(out.reshape(B, T, -1), params["out_proj"]["weight"], mesh=mesh)


@dataclass(frozen=True)
class CausalKVAttention:
    """Full-history causal attention with the slot-indexed KV cache."""

    embed_dim: int
    num_heads: int
    max_period: float = 10_000.0
    mesh: Mesh | None = None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return _init_proj_params(gen, self.embed_dim, dtype)

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        """dtype=torch.int8 gives the int8 cache with its per-row scales; on
        a mesh the caches hold this rank's heads."""
        shape = (batch_size, capacity, _local_heads(self.num_heads, self.mesh), self.head_dim)
        state = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((batch_size, capacity), -1, dtype=torch.int32, device=device),
        }
        if dtype == torch.int8:
            state["k_scale"] = torch.zeros((batch_size, capacity), dtype=torch.float32, device=device)
            state["v_scale"] = torch.zeros((batch_size, capacity), dtype=torch.float32, device=device)
        return state

    def __call__(
        self,
        params: Params,
        x: torch.Tensor,  # [B, T, E]
        state: State,
        positions: torch.Tensor,  # int32 [B, T]: absolute positions, -1 = padding
        widx,  # int, or an integer tensor of one element on the cache's device
        rope_cache: tuple,
        read_limit: int | None = None,
    ) -> torch.Tensor:
        """Append this call's T rows at widx (in place) and attend.

        read_limit bounds the cache rows attention reads to the first
        R = max(8, min(read_limit, C)); the caller guarantees that every
        valid row, this call's included, lies below it."""
        B, T, _ = x.shape
        q, k, v = _project_qkv(params, x, self.num_heads, self.mesh)
        q, k = apply_rope(q, k, rope_cache)
        C = state["k"].shape[1]
        write = _row_writer(widx, C, T)
        int8_kv = state["k"].dtype == torch.int8
        if int8_kv:
            amax = (None, None)
            if tp_active(self.mesh):  # k's and v's row maxima over every head, in one collective
                amax = max_over_tp(self.mesh, torch.stack([t.float().abs().amax(dim=(2, 3)) for t in (k, v)]))
            k_codes, k_scale = quantize_kv_rows(k, amax[0])
            v_codes, v_scale = quantize_kv_rows(v, amax[1])
            write(state["k"], k_codes)
            write(state["v"], v_codes)
            write(state["k_scale"], k_scale)
            write(state["v_scale"], v_scale)
        else:
            write(state["k"], k.to(state["k"].dtype))
            write(state["v"], v.to(state["v"].dtype))
        write(state["slot_pos"], positions.to(torch.int32))
        R = C if read_limit is None else max(8, min(int(read_limit), C))
        sp = state["slot_pos"][:, :R]
        ks = state["k_scale"][:, :R] if int8_kv else None
        vs = state["v_scale"][:, :R] if int8_kv else None
        batch_step = T == 1 and (B > 1 or self.mesh is not None)
        if batch_step and batch_attention.kernel_takes(self.head_dim, state["k"].device):
            # The full cache buffers go in; the kernel reads rows [:R] only.
            out = batch_attention.batch_decode_attention(
                q.transpose(1, 2), state["k"], state["v"], sp, positions[:, 0], ks, vs,
                read_rows=R,
            ).transpose(1, 2)
        else:
            valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= positions[:, :, None])  # [B, T, R]
            out = sdpa_slots(q, state["k"][:, :R], state["v"][:, :R], valid[:, None], ks, vs)
        return _project_out(params, out, self.mesh)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Cache-free causal attention over a whole sequence [B, T, E] (the
        training path; decoding uses the cached __call__): RoPE at positions
        0..T-1, query i attends to keys j <= i."""
        B, T, _ = x.shape
        q, k, v = _project_qkv(params, x, self.num_heads, self.mesh)
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None, :].expand(B, T)
        q, k = apply_rope(q, k, rope_angles(positions, self.head_dim, self.max_period))
        idx = torch.arange(T, device=x.device)
        out = sdpa_slots(q, k, v, (idx[None, :] <= idx[:, None])[None, None])
        return _project_out(params, out, self.mesh)


@dataclass(frozen=True)
class WindowedRingAttention:
    """Sliding-window causal attention over a shift-append ring buffer.

    Window predicate (reference: pocket_tts_mlx/modules/attention.py:244-254):
    (pos_k >= 0) & (delta >= 0) & (delta < context)."""

    embed_dim: int
    num_heads: int
    context: int
    max_period: float = 10_000.0
    mesh: Mesh | None = None

    _QBLOCK = 128  # query-block length of the banded form

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return _init_proj_params(gen, self.embed_dim, dtype)

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        shape = (batch_size, capacity, _local_heads(self.num_heads, self.mesh), self.head_dim)
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
        pos0,  # absolute position of x's first row: an int (batch-common) or int32 [B]
        rope_cache: tuple,
    ) -> torch.Tensor:
        B, T, _ = x.shape
        capacity = state["k"].shape[1]
        if capacity < self.context + T:
            raise ValueError("ring must retain a full window plus the new chunk")
        q, k, v = _project_qkv(params, x, self.num_heads, self.mesh)
        q, k = apply_rope(q, k, rope_cache)
        # Slot j then holds absolute position (pos0 + T) - capacity + j.
        state["k"] = torch.cat([state["k"][:, T:], k.to(state["k"].dtype)], dim=1)
        state["v"] = torch.cat([state["v"][:, T:], v.to(state["v"].dtype)], dim=1)
        out = self._banded_sdpa(q, state["k"], state["v"], pos0, positions)
        return _project_out(params, out, self.mesh)

    def _valid(self, slot_pos: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        """slot_pos [B, W], qpos [B, Tq] -> mask [B, 1, Tq, W]."""
        delta = qpos[:, :, None] - slot_pos[:, None, :]  # [B, Tq, W]
        return ((slot_pos[:, None, :] >= 0) & (delta >= 0) & (delta < self.context))[:, None]

    def _banded_sdpa(self, q, k_cache, v_cache, pos0, positions):
        """Windowed attention; chunks of whole 128-query blocks read only a
        (context + 127)-wide key band per block. Masked entries underflow to
        exactly 0 in the float32 softmax, so the banded form equals the
        dense one."""
        T = q.shape[1]
        capacity = k_cache.shape[1]
        Q = self._QBLOCK
        W = ((self.context - 1 + Q) + 127) // 128 * 128
        if not isinstance(pos0, torch.Tensor):  # one position for the whole batch
            pos0 = torch.full((q.shape[0],), pos0, dtype=torch.int32, device=q.device)
        # Slot j of stream b holds absolute position (pos0[b] + T) - capacity + j.
        ar = torch.arange(capacity, dtype=torch.int32, device=q.device)
        slot_pos = (pos0.to(torch.int32) + (T - capacity))[:, None] + ar[None, :]
        if T % Q or W >= capacity:
            return sdpa_slots(q, k_cache, v_cache, self._valid(slot_pos, positions))
        outs = []
        for i in range(T // Q):
            s = max(0, min(capacity - W, capacity - T + (i + 1) * Q - W))
            outs.append(
                sdpa_slots(
                    q[:, i * Q : (i + 1) * Q],
                    k_cache[:, s : s + W],
                    v_cache[:, s : s + W],
                    self._valid(slot_pos[:, s : s + W], positions[:, i * Q : (i + 1) * Q]),
                )
            )
        return torch.cat(outs, dim=1)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Non-streaming windowed attention over a whole sequence [B, T, E]:
        RoPE at positions 0..T-1, query i attends to keys j with
        0 <= i - j < context (reference: pocket_tts_mlx/modules/attention.py:210-213)."""
        B, T, _ = x.shape
        q, k, v = _project_qkv(params, x, self.num_heads, self.mesh)
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None, :].expand(B, T)
        q, k = apply_rope(q, k, rope_angles(positions, self.head_dim, self.max_period))
        idx = torch.arange(T, device=x.device)
        delta = idx[:, None] - idx[None, :]
        out = sdpa_slots(q, k, v, ((delta >= 0) & (delta < self.context))[None, None])
        return _project_out(params, out, self.mesh)
