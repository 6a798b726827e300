"""Batch decode attention (T == 1, B > 1) as a hand-written CUDA kernel.

Replaces pocket_tts_tpu/ops/batch_attention.py:batch_decode_attention (the
Pallas kernel `_kernel`). Contract, per stream b and head h:

  - one query q[b, h] over the slot-major cache k, v [B, C, H, d], rows
    [0, R) only (R = read_rows, C by default, any R in (0, C]);
  - row r is valid when 0 <= slot_pos[b, r] <= qpos[b];
  - softmax(q k^T / sqrt(d)) v in float32 over the valid rows, with the
    roundings of ops/attention.sdpa_slots: q and the softmax weights in bf16
    for bf16 and int8 caches, int8 rows taken as bf16, the per-row K scale on
    the scores and the V scale on the weights;
  - a stream with no valid row outputs 0.

What bounds it on the H100: the K and V rows it reads, 2*B*R*H*d bytes per
call (bf16 at B=64, R=512, H*d=1024: 134 MB, 40.3 us at 3.35 TB/s; int8 half
that plus the scales). csrc/batch_attention.cu is one launch per call: one
block per (stream, head) streams that head's K rows and then its V rows
through a ring of row tiles that the Tensor Memory Accelerator fills, keeps
the scores in shared memory for the exact softmax, and fetches no tile
without a valid row and no row at or past R. A long read, or a call of few
(stream, head) items, is cut into row chunks across the blocks of a
thread-block cluster, which exchange their max, denominator and partial
outputs through distributed shared memory. It reads the full cache buffer
bounded by read_rows, never a sliced copy, and the wrapper allocates only
the output. `launch_config` picks the block width, the ring's stages and the
split.

`batch_decode_attention` launches the kernel for CUDA tensors (or raises)
and runs `batch_decode_attention_reference`, the plain PyTorch version, for
CPU tensors. `batch_decode_attention.launches` counts kernel launches.
`kernel_takes` is the route of ops/attention's batch decode: the kernel
takes heads of HEAD_DIM only.
"""

from __future__ import annotations

import functools
import logging

import torch

logger = logging.getLogger(__name__)

HEAD_DIM = 64  # the one head size the CUDA kernel takes (the b6369a24 FlowLM's)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# One block's shared memory (csrc/batch_attention.cu:Geo): an mbarrier per
# stage, `stages` ring slots of a row tile (plus, int8, its row scales,
# padded to 128 bytes per box), a [warps][64] float32 reduction buffer, the
# cluster's exchange (max, denominator and a [64] partial output, float32),
# and per row of its chunk (padded to a multiple of the tile and of 64) a
# float32 score and a validity bit.
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_BAR_BYTES = 16 * 8
_XCH_BYTES = (2 + 64) * 4
MAX_SHARED_BYTES = 232448  # an H100 block's opt-in limit (227 KB)
SM_SHARED_BYTES = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it reserved per block
MIN_STAGES, STAGES = 2, 3  # ring stages (the kernel takes 2 to 16)
THREADS = (128, 256, 512)
MAX_SPLIT = 8  # blocks of one (stream, head) item: a cluster, at most the portable 8
SPLIT_ROWS = 512  # fewest rows per block that a call of few items is cut to


def tile_rows(dtype, threads: int) -> int:
    """Rows of one ring tile: threads / 2, half that for float32."""
    return threads // 4 if dtype == torch.float32 else threads // 2


def _block_bytes(rows: int, dtype, threads: int, stages: int) -> int:
    tr = tile_rows(dtype, threads)
    box = 16 if dtype == torch.bfloat16 and threads == 128 else tr  # rows of one copy (Geo::BOX)
    slot = tr * 64 * _ELEMENT_BYTES[dtype] + (tr // box * -(-box * 4 // 128) * 128 if dtype == torch.int8 else 0)
    align = max(tr, 64)
    rows = -(-rows // align) * align
    return _BAR_BYTES + stages * slot + threads // 32 * 64 * 4 + _XCH_BYTES + 4 * rows + rows // 8


# The most rows one block holds (128 threads, two stages; bf16 and float32,
# int8 a little more), and so the most rows a call reads.
MAX_BLOCK_ROWS = (MAX_SHARED_BYTES - _BAR_BYTES - MIN_STAGES * 8192 - 4 * 64 * 4 - _XCH_BYTES) * 8 // 33 // 64 * 64
MAX_READ_ROWS = MAX_SPLIT * MAX_BLOCK_ROWS


def shared_bytes(rows: int, dtype=torch.bfloat16, threads: int = 128, stages: int = STAGES) -> int:
    """Dynamic shared memory of one block of the kernel that holds `rows`
    rows of its (stream, head) item. Raises ValueError above
    MAX_SHARED_BYTES; with 128 threads and 2 stages that caps a block at
    MAX_BLOCK_ROWS rows for bf16 and float32 caches (a little more for
    int8), and a call at MAX_READ_ROWS."""
    n = _block_bytes(rows, dtype, threads, stages)
    if n > MAX_SHARED_BYTES:
        raise ValueError(f"{rows} rows per block ({dtype}, {threads} threads, {stages} ring stages) need {n} bytes "
                         f"of shared memory per block; the H100 allows {MAX_SHARED_BYTES} (read_rows <= "
                         f"{MAX_READ_ROWS} for bf16, over {MAX_SPLIT} blocks of {MAX_BLOCK_ROWS} rows)")
    return n


@functools.lru_cache(maxsize=None)
def launch_config(work_items: int, sms: int, read_rows: int, dtype) -> tuple[int, int, int, int, int]:
    """(threads, stages, split, chunk, shared bytes) of a call with
    `work_items` (stream, head) items on `sms` SMs, reading read_rows rows.

    An item's rows go to `split` blocks of one cluster, `chunk` rows each
    (a multiple of the tile; split 1: chunk = read_rows): as many as fill
    about two blocks per SM, with at least SPLIT_ROWS rows per block, and as
    many as one block's shared memory needs for a long read, at most
    MAX_SPLIT. Where few blocks share an SM the arithmetic of their few
    warps sets the pace, so the blocks widen to fill the SM's 1024 threads
    that 64 registers a thread allow: 128 threads at 5 or more blocks per
    SM, 256 at 3-4, 512 at 1-2. Three ring stages where the SM's shared
    memory holds its blocks with them, else two; narrower blocks, then more
    split, where one block's shared memory needs it. A cluster of more than
    two blocks takes blocks of at most 256 threads and two stages: its
    blocks must be resident at once in one GPC, and smaller blocks find room
    sooner (B=2 x 16384 on an H100: 72.4 us bf16 and 40.2 int8 in 8-block
    clusters of 256 threads and two stages, 80.1 and 57.1 at 512 threads
    and three)."""
    want = min(MAX_SPLIT, max(1, 2 * sms // work_items), max(1, read_rows // SPLIT_ROWS))
    for split in range(want, MAX_SPLIT + 1):
        per_sm = -(-work_items * split // sms)
        widest = max(THREADS[0], min(THREADS[-1] if split <= 2 else 256, 1 << ((1024 // per_sm).bit_length() - 1)))
        for threads in (t for t in reversed(THREADS) if t <= widest):
            align = max(tile_rows(dtype, threads), 64)
            chunk = -(-(-(-read_rows // split)) // align) * align
            n = -(-read_rows // chunk)  # blocks that rounding the chunk up leaves
            chunk = read_rows if n == 1 else chunk
            resident = min(per_sm, 1024 // threads)
            for stages in (STAGES, MIN_STAGES) if split <= 2 else (MIN_STAGES,):
                nbytes = _block_bytes(chunk, dtype, threads, stages)
                if nbytes <= MAX_SHARED_BYTES and (stages == MIN_STAGES or resident * (nbytes + 1024) <= SM_SHARED_BYTES):
                    return threads, stages, n, chunk, nbytes
    shared_bytes(-(-read_rows // MAX_SPLIT), dtype, THREADS[0], MIN_STAGES)  # raises
    raise AssertionError("unreachable")


def kernel_takes(head_dim: int, device: torch.device) -> bool:
    """Whether a batch decode of heads `head_dim` wide (the model's config)
    on `device` attends through batch_decode_attention: on the CPU always
    (its plain version), on the card where the kernel takes the head size,
    HEAD_DIM. Otherwise the caller runs the plain sdpa_slots, and the first
    such call of each head size logs it. The JAX package routes on another
    rule (embed_dim % 128 == 0 and R % 128 == 0)."""
    if device.type != "cuda" or head_dim == HEAD_DIM:
        return True
    _log_plain_route(head_dim)
    return False


@functools.lru_cache(maxsize=None)
def _log_plain_route(head_dim: int) -> None:
    logger.warning("batch decode attention with head_dim %d runs the plain sdpa_slots on the card: the CUDA kernel "
                   "takes head_dim %d", head_dim, HEAD_DIM)


def batch_decode_attention_reference(q, k, v, slot_pos, qpos, k_scale=None, v_scale=None, *, read_rows=None):
    """Plain PyTorch version of batch_decode_attention (same contract)."""
    from pocket_tts_tpu_torch.ops.attention import sdpa_slots  # it imports this module

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
    if not q.is_cuda or q.dtype not in _Q_KINDS or q.stride(3) != 1:
        raise ValueError(f"q: expected a CUDA float32 or bf16 tensor with contiguous head rows, got {q.device} "
                         f"{q.dtype} strides {q.stride()}")
    if d != HEAD_DIM or k.dtype not in _KINDS:
        raise ValueError(f"the CUDA batch attention takes head_dim {HEAD_DIM} and float32, bf16 or int8 caches; "
                         f"got d={d} {k.dtype}")
    _cuda.check_cuda_tensor("k", k, k.dtype, (B, C, H, d))
    _cuda.check_cuda_tensor("v", v, k.dtype, (B, C, H, d))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start 16-byte aligned")
    _cuda.check_cuda_tensor("qpos", qpos, torch.int32, (B,))
    _check_rows("slot_pos", slot_pos, torch.int32, (B, R))
    sc_stride, ks_ptr, vs_ptr = 0, None, None
    if k_scale is not None:
        _check_rows("k_scale", k_scale, torch.float32, (B, R))
        _check_rows("v_scale", v_scale, torch.float32, (B, R))
        if k_scale.stride(0) != v_scale.stride(0) or k_scale.stride(0) % 4 or k_scale.data_ptr() % 16 \
                or v_scale.data_ptr() % 16:
            raise ValueError("k_scale and v_scale must share a row stride that is a multiple of 4 and start "
                             "16-byte aligned (the row scales are copied as tiles)")
        sc_stride, ks_ptr, vs_ptr = k_scale.stride(0), k_scale.data_ptr(), v_scale.data_ptr()
    threads, stages, split, chunk, smem = launch_config(
        B * H, _cuda.sm_count(k.device), R, k.dtype)
    out = torch.empty(B, H, d, dtype=q.dtype, device=k.device)
    err = _cuda.library("batch_attention").ptt_batch_decode_attention(
        q.data_ptr(), _Q_KINDS[q.dtype], q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(), _KINDS[k.dtype],
        slot_pos.data_ptr(), slot_pos.stride(0), qpos.data_ptr(), ks_ptr, vs_ptr, sc_stride, B, C, H, R,
        threads, stages, split, chunk, smem, out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.count_launch(batch_decode_attention)
    if err:
        raise RuntimeError(f"batch_decode_attention: CUDA error {err}")
    return out.view(B, H, 1, d)


batch_decode_attention.launches = 0
