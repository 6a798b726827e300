"""The two capability probes of scripts/mosaic_probe.py as hand-written CUDA
kernels (csrc/probes.cu), each beside its plain PyTorch version.

- `row_write(cache, row, index)` replaces `k_p1` / `probe_p1`
  (scripts/mosaic_probe.py:28,41): write row `index` of a (C, E) bf16 cache in
  place and return the cache; every other row keeps its bits. `index` is an
  int32 tensor on the cache's device in [0, C), read by the kernel, so no
  host sync is needed. One 2 KiB row: bound by the launch, by nature.
- `head_slice_weighted_sum(x, heads, width)` replaces `k_p2` / `probe_p2`
  (scripts/mosaic_probe.py:79,87): sum_h (h + 1) * x[:, h*width:(h+1)*width]
  in float32 over a (C, heads*width) bf16 input -> (C, width) float32. Bound
  by the input read.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `.launches` counts kernel launches.
"""

from __future__ import annotations

import torch


def row_write_reference(cache: torch.Tensor, row: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of row_write (same contract; no host sync)."""
    return cache.index_copy_(0, index.reshape(1).long(), row[None])


def head_slice_weighted_sum_reference(x: torch.Tensor, heads: int = 16, width: int = 64) -> torch.Tensor:
    """Plain PyTorch version of head_slice_weighted_sum: the float32 sum in
    the kernel's order, h = 0, 1, ..."""
    acc = torch.zeros(x.shape[0], width, dtype=torch.float32, device=x.device)
    for h in range(heads):
        acc = acc + x[:, h * width : (h + 1) * width].float() * (h + 1)
    return acc


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned data")


def row_write(cache: torch.Tensor, row: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Write `row` [E] into row `index` ([1] int32) of `cache` [C, E] bf16, in
    place; returns `cache`."""
    if cache.ndim != 2 or tuple(row.shape) != (cache.shape[1],) or index.numel() != 1:
        raise ValueError(f"row_write takes cache [C, E], row [E] and a one-element index; got "
                         f"{tuple(cache.shape)}, {tuple(row.shape)}, {tuple(index.shape)}")
    if not cache.is_cuda:
        return row_write_reference(cache, row, index)
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    C, E = cache.shape
    if E % 8:
        raise ValueError(f"row_write: the kernel stores 8 bf16 values at a time; E={E} is not a multiple of 8")
    _cuda.check_cuda_tensor("cache", cache, torch.bfloat16)
    _cuda.check_cuda_tensor("row", row, torch.bfloat16)
    _cuda.check_cuda_tensor("index", index, torch.int32)
    _check_aligned("cache", cache)
    _check_aligned("row", row)
    err = _cuda.library("probes").ptt_row_write(cache.data_ptr(), row.data_ptr(), index.data_ptr(), C, E,
                                                _cuda.stream_ptr())
    _cuda.count_launch(row_write)
    if err:
        raise RuntimeError(f"row_write: CUDA error {err}")
    return cache


row_write.launches = 0


def head_slice_weighted_sum(x: torch.Tensor, heads: int = 16, width: int = 64) -> torch.Tensor:
    """sum_h (h + 1) * x[:, h*width:(h+1)*width] of a [C, heads*width] bf16
    input -> [C, width] float32."""
    if x.ndim != 2 or x.shape[1] != heads * width:
        raise ValueError(f"head_slice_weighted_sum takes x [C, {heads}*{width}]; got {tuple(x.shape)}")
    if not x.is_cuda:
        return head_slice_weighted_sum_reference(x, heads, width)
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    if width % 8:
        raise ValueError(f"head_slice_weighted_sum: the kernel loads 8 bf16 values at a time; width={width}")
    _cuda.check_cuda_tensor("x", x, torch.bfloat16)
    _check_aligned("x", x)
    out = torch.empty(x.shape[0], width, dtype=torch.float32, device=x.device)
    err = _cuda.library("probes").ptt_head_slice_weighted_sum(x.data_ptr(), out.data_ptr(), x.shape[0], heads,
                                                              width, _cuda.stream_ptr())
    _cuda.count_launch(head_slice_weighted_sum)
    if err:
        raise RuntimeError(f"head_slice_weighted_sum: CUDA error {err}")
    return out


head_slice_weighted_sum.launches = 0
