"""The two device-memory read probes of the JAX package's benchmarks as
hand-written CUDA kernels (csrc/read_probes.cu), each beside its plain
PyTorch version.

- `stream_read(tok, x, blk_rows)` replaces `make_reader`
  (benchmarks/bw_probe.py:31): a streaming read of x [rows_total, 1024]
  (int8, bf16 or float32) in blocks of `blk_rows` rows, returning the
  (8, 128) float32 `tok * 1e-20 + sum_b x[b*blk_rows : b*blk_rows + 8, :128]`
  over the rows_total // blk_rows whole blocks. Rows past the last whole
  block are not read. The kernel loads every byte of the blocks it reads
  (it folds the bytes outside the tile into a value the compiler must
  keep), so its time is the read's.
- `kv_read_sum(tok, kflat, vflat)` replaces `variant_pallas_read`
  (benchmarks/attn_micro.py:201): kflat, vflat [rows, 1024] bf16 ->
  (8, 128) float32 `tok * 1e-20 + sum_{r < 512*(rows // 512)} k[r] + v[r]`,
  the per-lane sums viewed as (8, 128). A tail of fewer than 512 rows is
  not read.

Both are bound by the bytes they read. Each wrapper launches its kernel for
CUDA tensors (or raises) and runs the plain version for CPU tensors;
`.launches` counts kernel launches. The kernels add the blocks' partial
sums with float atomics, so on the card they may differ from the plain
versions, which sum in the TPU kernels' block order, by float32 rounding
(exactly equal for integer-valued data).
"""

from __future__ import annotations

import torch

LANES = 1024  # row width of both probes
OUT_SHAPE = (8, 128)
KV_BLOCK_ROWS = 512  # rows per grid step of variant_pallas_read
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
BLOCKS_PER_SM = 8  # 256-thread blocks that fit one SM: stream_read's default grid is one full wave
# kv_read_sum's default: half a wave, so half the blocks add their partials
# into the output with atomics (chip_smoke.py phase 12 sweeps 2, 4 and 8).
KV_BLOCKS_PER_SM = 4


def stream_read_reference(tok: torch.Tensor, x: torch.Tensor, blk_rows: int) -> torch.Tensor:
    """Plain PyTorch version of stream_read, summed in the TPU kernel's
    order: the carry starts at tok * 1e-20, then each block's tile adds in
    block order, in float32."""
    n_blocks = x.shape[0] // blk_rows
    tiles = x[: n_blocks * blk_rows].view(n_blocks, blk_rows, LANES)[:, :8, :128]
    acc = tok.float() * 1e-20
    for b in range(n_blocks):
        acc = acc + tiles[b].float()
    return acc


def kv_read_sum_reference(tok: torch.Tensor, kflat: torch.Tensor, vflat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kv_read_sum, in the TPU kernel's order: per
    512-row block the float32 column sums of K plus those of V, added to the
    carry (tok * 1e-20) in block order."""
    acc = tok.float() * 1e-20
    for b in range(kflat.shape[0] // KV_BLOCK_ROWS):
        rows = slice(b * KV_BLOCK_ROWS, (b + 1) * KV_BLOCK_ROWS)
        part = kflat[rows].float().sum(dim=0) + vflat[rows].float().sum(dim=0)
        acc = acc + part.view(OUT_SHAPE)
    return acc


def _check_tok(tok: torch.Tensor) -> None:
    if tuple(tok.shape) != OUT_SHAPE or tok.dtype != torch.float32:
        raise ValueError(f"tok must be a float32 {OUT_SHAPE} carry; got {tok.dtype} {tuple(tok.shape)}")


def _launch_prelude(tok: torch.Tensor, *arrays: tuple[str, torch.Tensor, torch.dtype]):
    """Checks of the kernel route; returns the _cuda module."""
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    _cuda.check_cuda_tensor("tok", tok, torch.float32, OUT_SHAPE)
    for name, t, dtype in arrays:
        _cuda.check_cuda_tensor(name, t, dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes 16-byte aligned data")
    return _cuda


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_grid(device: torch.device, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    return blocks_per_sm * sm_count(device)


def stream_read(tok: torch.Tensor, x: torch.Tensor, blk_rows: int, grid: int | None = None) -> torch.Tensor:
    """(8, 128) float32 tok * 1e-20 plus the first 8 rows and 128 columns of
    every whole `blk_rows`-row block of x [rows_total, 1024] (int8, bf16 or
    float32). `grid` sets the kernel's blocks (default: one full wave)."""
    _check_tok(tok)
    if x.ndim != 2 or x.shape[1] != LANES or x.dtype not in _KINDS:
        raise ValueError(f"stream_read takes x [rows, {LANES}] int8, bf16 or float32; got {x.dtype} "
                         f"{tuple(x.shape)}")
    if blk_rows < 8:
        raise ValueError(f"stream_read: blk_rows must be at least 8 (the tile's rows); got {blk_rows}")
    if not x.is_cuda:
        return stream_read_reference(tok, x, blk_rows)
    _cuda = _launch_prelude(tok, ("x", x, x.dtype))
    grid = default_grid(x.device) if grid is None else int(grid)
    if grid <= 0 or x.shape[0] >= 2**31:
        raise ValueError(f"stream_read: grid must be positive and rows below 2**31; got {grid}, {x.shape[0]}")
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=x.device)
    err = _cuda.library("read_probes").ptt_stream_read(
        x.data_ptr(), _KINDS[x.dtype], x.shape[0], int(blk_rows), tok.data_ptr(), out.data_ptr(), grid,
        _cuda.stream_ptr())
    _cuda.count_launch(stream_read)
    if err:
        raise RuntimeError(f"stream_read: CUDA error {err}")
    return out


stream_read.launches = 0


def kv_read_sum(tok: torch.Tensor, kflat: torch.Tensor, vflat: torch.Tensor, grid: int | None = None) -> torch.Tensor:
    """(8, 128) float32 tok * 1e-20 plus the per-lane sums of K and V over
    the whole 512-row blocks of kflat, vflat [rows, 1024] bf16. `grid` sets
    the kernel's blocks (default: four per SM)."""
    _check_tok(tok)
    if kflat.ndim != 2 or kflat.shape[1] != LANES or kflat.dtype != torch.bfloat16 \
            or vflat.shape != kflat.shape or vflat.dtype != kflat.dtype:
        raise ValueError(f"kv_read_sum takes kflat and vflat [rows, {LANES}] bf16 of one shape; got "
                         f"{kflat.dtype} {tuple(kflat.shape)} and {vflat.dtype} {tuple(vflat.shape)}")
    if not kflat.is_cuda:
        return kv_read_sum_reference(tok, kflat, vflat)
    _cuda = _launch_prelude(tok, ("kflat", kflat, torch.bfloat16), ("vflat", vflat, torch.bfloat16))
    grid = default_grid(kflat.device, KV_BLOCKS_PER_SM) if grid is None else int(grid)
    if grid <= 0 or kflat.shape[0] >= 2**31:
        raise ValueError(f"kv_read_sum: grid must be positive and rows below 2**31; got {grid}, {kflat.shape[0]}")
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=kflat.device)
    err = _cuda.library("read_probes").ptt_kv_read_sum(
        kflat.data_ptr(), vflat.data_ptr(), kflat.shape[0], tok.data_ptr(), out.data_ptr(), grid,
        _cuda.stream_ptr())
    _cuda.count_launch(kv_read_sum)
    if err:
        raise RuntimeError(f"kv_read_sum: CUDA error {err}")
    return out


kv_read_sum.launches = 0
