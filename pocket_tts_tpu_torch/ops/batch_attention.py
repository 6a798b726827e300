"""Batch decode attention (T == 1, B > 1) as a hand-written CUDA kernel.

Replaces pocket_tts_tpu/ops/batch_attention.py:batch_decode_attention (the
Pallas kernel `_kernel`). Contract, per stream b and head h:

  - one query q[b, h] over the slot-major cache k, v [B, C, H, d], rows
    [0, R) only (R = read_rows, C by default);
  - row r is valid when 0 <= slot_pos[b, r] <= qpos[b];
  - softmax(q k^T / sqrt(d)) v in float32 over the valid rows, with the
    roundings of ops/attention.sdpa_slots: q and the softmax weights in bf16
    for bf16 and int8 caches, int8 rows taken as bf16, the per-row K scale on
    the scores and the V scale on the weights;
  - a stream with no valid row outputs 0.

What bounds it on the H100: the K and V rows it reads, 2*B*R*H*d bytes per
call (bf16 at B=64, R=512, H*d=1024: 134 MB, 40 us at 3.35 TB/s; int8 half
that plus the scales). csrc/batch_attention.cu streams each head's rows with
16-byte loads over a (R/128, H, B) grid in two passes (scores, then the
weighted V sum with the softmax combined across splits) and a small combine;
it reads the full cache buffer bounded by read_rows, never a sliced copy,
and skips invalid rows.

`batch_decode_attention` launches the kernel for CUDA tensors (or raises)
and runs `batch_decode_attention_reference`, the plain PyTorch version, for
CPU tensors. `batch_decode_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from pocket_tts_tpu_torch.ops.attention import sdpa_slots

_SPLIT_ROWS = 128  # rows per split of the kernel (kRows in csrc/batch_attention.cu)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def batch_decode_attention_reference(q, k, v, slot_pos, qpos, k_scale=None, v_scale=None, *, read_rows=None):
    """Plain PyTorch version of batch_decode_attention (same contract)."""
    R = _read_rows(k, slot_pos, read_rows)
    valid = (slot_pos >= 0) & (slot_pos <= qpos[:, None])  # [B, R]
    out = sdpa_slots(q.transpose(1, 2), k[:, :R], v[:, :R], valid[:, None, None, :], k_scale, v_scale)
    out = torch.where(valid.any(dim=1)[:, None, None, None], out, torch.zeros_like(out))
    return out.transpose(1, 2)


def _read_rows(k, slot_pos, read_rows) -> int:
    B, C = k.shape[:2]
    R = C if read_rows is None else int(read_rows)
    if not 0 < R <= C or tuple(slot_pos.shape) != (B, R):
        raise ValueError(f"read_rows {R} must lie in (0, C={C}] with slot_pos [B, R]; got {tuple(slot_pos.shape)}")
    return R


def _check_rows(name: str, t: torch.Tensor, dtype, shape) -> None:
    """A [B, R] CUDA tensor whose rows are contiguous (a [:, :R] view of a
    [B, C] tensor is fine)."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a CUDA {dtype} tensor {tuple(shape)} with contiguous rows, "
                         f"got {t.device} {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def batch_decode_attention(q, k, v, slot_pos, qpos, k_scale=None, v_scale=None, *, read_rows=None):
    """softmax(q k^T / sqrt(d) + mask) v over the first read_rows cache rows
    -> [B, H, 1, d] in q's dtype.

    q [B, H, 1, d] (post-RoPE); k, v [B, C, H, d] float32, bf16 or int8, the
    FULL cache buffers; slot_pos [B, R] int32; qpos [B] int32; k_scale,
    v_scale [B, R] float32 for an int8 cache, else None."""
    B, C, H, d = k.shape
    R = _read_rows(k, slot_pos, read_rows)
    if tuple(q.shape) != (B, H, 1, d) or tuple(v.shape) != tuple(k.shape) or v.dtype != k.dtype:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit [B, H, 1, d] "
                         "and [B, C, H, d] caches of one dtype")
    if (k.dtype == torch.int8) != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 KV rows need k_scale and v_scale, and only they do")
    if not k.is_cuda:
        return batch_decode_attention_reference(q, k, v, slot_pos, qpos, k_scale, v_scale, read_rows=R)
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    if not q.is_cuda:
        raise ValueError(f"q: expected a CUDA tensor, got device {q.device}")
    if d != 64 or R % _SPLIT_ROWS or k.dtype not in _KINDS:
        raise ValueError(f"the CUDA batch attention takes head_dim 64, read_rows a multiple of {_SPLIT_ROWS} and "
                         f"float32, bf16 or int8 caches; got d={d} R={R} {k.dtype}")
    _cuda.check_cuda_tensor("k", k, k.dtype, (B, C, H, d))
    _cuda.check_cuda_tensor("v", v, k.dtype, (B, C, H, d))
    _cuda.check_cuda_tensor("qpos", qpos, torch.int32, (B,))
    _check_rows("slot_pos", slot_pos, torch.int32, (B, R))
    sc_stride, ks_ptr, vs_ptr = 0, None, None
    if k_scale is not None:
        _check_rows("k_scale", k_scale, torch.float32, (B, R))
        _check_rows("v_scale", v_scale, torch.float32, (B, R))
        if k_scale.stride(0) != v_scale.stride(0):
            raise ValueError("k_scale and v_scale must share their row stride")
        sc_stride, ks_ptr, vs_ptr = k_scale.stride(0), k_scale.data_ptr(), v_scale.data_ptr()
    dev = k.device
    f32 = torch.float32
    qf = q.reshape(B, H, d).to(f32).contiguous()
    NS = R // _SPLIT_ROWS
    scores = torch.empty(B, H, R, dtype=f32, device=dev)
    part = torch.empty(B, H, NS, 2, dtype=f32, device=dev)
    part_out = torch.empty(B, H, NS, d, dtype=f32, device=dev)
    out = torch.empty(B, H, d, dtype=f32, device=dev)
    err = _cuda.library("batch_attention").ptt_batch_decode_attention(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), _KINDS[k.dtype], slot_pos.data_ptr(), slot_pos.stride(0),
        qpos.data_ptr(), ks_ptr, vs_ptr, sc_stride, B, C, H, R,
        scores.data_ptr(), part.data_ptr(), part_out.data_ptr(), out.data_ptr(), _cuda.stream_ptr(),
    )
    batch_decode_attention.launches += 1
    if err:
        raise RuntimeError(f"batch_decode_attention: CUDA error {err}")
    return out.reshape(B, H, 1, d).to(q.dtype)


batch_decode_attention.launches = 0
