"""Dense layers on torch-layout weights [out, in]
(port of pocket_tts_tpu/ops/linear.py).

Mixed precision follows the JAX package exactly: a lower-precision weight
pulls the activation down to its dtype, the products accumulate in float32,
and the result returns in the activation's dtype. The products are computed
as float32 matmuls of the rounded operands: a bf16 x bf16 product is exact
in float32, so this equals a bf16 matmul with float32 accumulation on both
the CPU and the card (with TF32 off, PyTorch's default for matmuls).

An int8 weight-only leaf {"q": int8 [out, in], "s": float32 [out]}
(models/weights.quantize_int8) multiplies bf16 activations by the raw codes
and applies the per-output scale to the float32 accumulator. Its route is
`int8_linear`: on a CUDA tensor one launch of the hand-written kernel
csrc/int8_linear.cu (bf16 tensor cores on the codes, the scale in the
epilogue; no float32 copy of the codes), on a CPU tensor its plain version
`int8_linear_reference`. Float and bf16 weights (the flow head, the EOS
head, Mimi) take F.linear as before.

A row-parallel layer under tensor parallelism (`out_proj`, `linear2`: each
rank holds some input columns) passes its `mesh`: the sum over tp runs on
the float32 accumulator before the int8 scale and the cast to the
activation's dtype, where GSPMD reduces the JAX package's float32
dot_general output. Reducing the rounded partials would not match, so such
a layer asks int8_linear for the unscaled accumulator.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.parallel.collectives import reduce_from_tp


def linear(x: torch.Tensor, weight, bias: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """y = x @ W^T + b with W in torch layout [out, in] (or an int8 leaf);
    `mesh` (a row-parallel shard's): the float32 accumulator is summed over
    its tp ranks."""
    out_dtype = x.dtype
    if isinstance(weight, dict):
        x = x.contiguous()  # a broadcast BOS row
        if mesh is None:
            y = int8_linear(x, weight["q"], weight["s"])
        else:
            y = (reduce_from_tp(mesh, int8_linear(x, weight["q"])) * weight["s"]).to(out_dtype)
    else:
        y = F.linear(x.to(weight.dtype).float(), weight.float())
        if mesh is not None:
            y = reduce_from_tp(mesh, y)
        y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def qkv_proj(x: torch.Tensor, weight) -> torch.Tensor:
    """Packed QKV projection, weight [3, E, E] (q rows, then k, then v) or
    its int8 leaf -> [B, T, 3, E]."""
    if isinstance(weight, dict):
        w = {"q": weight["q"].reshape(-1, weight["q"].shape[-1]), "s": weight["s"].reshape(-1)}
    else:
        w = weight.reshape(-1, weight.shape[-1])
    y = linear(x, w)
    return y.reshape(*y.shape[:-1], 3, -1)


# The kernel's output tiles (rows, columns), csrc/int8_linear.cu:launch_tile:
# 0 and 1, the rows kernel (at most 64 rows), hold a block's whole K slice,
# their 8 warps 4 (tile 0) or 2 (tile 1) along k; 2 and 3, the tiles kernel,
# stream K through a ring.
TILES = ((64, 64), (64, 128), (128, 128), (128, 256))
ROWS_WARPS_K = {0: 4, 1: 2}
UNIT = 128  # k values of a 128-byte code box: K slices and ring stages are whole units
MAX_SPLIT = 8  # K slices of a tile: the blocks of one thread-block cluster
MAX_SHARED = 232448  # an H100 block's opt-in shared memory
_X_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def rows_shared_bytes(units: int, xbytes: int, bn: int, warps_k: int) -> int:
    """Dynamic shared memory of a rows-kernel block whose K slice holds
    `units` units (csrc/int8_linear.cu:rows_smem): an mbarrier, 1024 bytes
    of alignment slack, the x boxes (64 rows) and code boxes (bn rows) of
    each unit, or the warps' partial tiles."""
    return 16 + 1024 + max(units * (64 * UNIT * xbytes + bn * UNIT), warps_k * 64 * (bn + 8) * 4)


@functools.lru_cache(maxsize=None)
def launch_config(M: int, N: int, K: int, sms: int, xbytes: int = 4) -> tuple[int, int]:
    """(tile, split) of an int8_linear call of M rows of `xbytes`-byte
    activations on `sms` SMs: an index into TILES, and the K slices of each
    output tile (the blocks of its cluster, whole units of K each).

    Both rules aim at `half` blocks: half the SMs, to a power of two (64 of
    the H100's 132), with the fewest slices (a cluster's barriers and
    exchange cost more the more blocks it has).

    At most 64 rows (a decode step's B streams; the codes' bytes set the
    pace) the rows kernel, whose blocks hold their K slice whole: the
    fewest slices, the 64-wide tile before the 128-wide one (a block moves
    fewer bytes), that give at least `half` blocks, at most one per SM, fit
    a block's shared memory, and, in 8-block clusters, at most `half`
    blocks (two clusters to a GPC of 16 SMs); where none reaches `half`,
    the most blocks. On an H100 at B=64 this took 224 us for a b6369a24
    frame's 25 calls where taking the most blocks took 294 us. Otherwise
    (more rows, where the tensor cores set the pace, or a slice that does
    not fit) the tiles kernel: 128 x 256 tiles where they give `half`
    tiles, else 128 x 128 with the fewest slices that reach `half` blocks
    (on an H100 128 x 128 tiles took 20 us at M=1024, N=K=1024 where 128 x
    256 tiles in 5 slices took 30)."""
    units = -(-K // UNIT)
    cap = min(MAX_SPLIT, units)
    half = 1 << ((sms // 2).bit_length() - 1)
    if M <= 64:
        best = None
        for split in (1, 2, 4, 8):
            for tile in (0, 1):
                bn = TILES[tile][1]
                blocks = -(-N // bn) * split
                if split > cap or blocks > sms or (split == MAX_SPLIT and blocks > half) \
                        or rows_shared_bytes(-(-units // split), xbytes, bn, ROWS_WARPS_K[tile]) > MAX_SHARED:
                    continue
                if blocks >= half:
                    return tile, split
                if best is None or blocks > best[0]:
                    best = (blocks, tile, split)
        if best is not None:
            return best[1], best[2]
    tiles = -(-M // 128) * -(-N // 256)
    if tiles >= half:
        return 3, 1
    tiles = -(-M // 128) * -(-N // 128)
    return 2, min(cap, -(-half // tiles))


def int8_linear_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of int8_linear (same contract)."""
    y = F.linear(x.to(torch.bfloat16).float(), q.float())
    return y if s is None else (y * s).to(x.dtype)


def int8_linear(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor | None = None) -> torch.Tensor:
    """s * (bf16(x) @ q^T) in x's dtype, summed in float32; with s None the
    float32 sum, unscaled.

    x [..., K] float32 or bf16, contiguous; q [N, K] int8; s [N] float32.
    On the card one launch of csrc/int8_linear.cu (N % 4 == 0; no
    gradient), on the CPU int8_linear_reference.
    `int8_linear.launches` counts kernel launches."""
    if not x.is_cuda:
        return int8_linear_reference(x, q, s)
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    N, K = q.shape
    if x.dtype not in _X_KINDS or x.ndim < 1 or x.shape[-1] != K or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous float32 or bf16 tensor [..., {K}], got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    _cuda.check_cuda_tensor("q", q, torch.int8, (N, K))
    if s is not None:
        _cuda.check_cuda_tensor("s", s, torch.float32, (N,))
    if q.device != x.device or (s is not None and s.device != x.device):
        raise ValueError(f"x, q and s must share a device; got {x.device}, {q.device}, "
                         f"{None if s is None else s.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, q, s)):
        raise RuntimeError("int8_linear has no gradient: an int8 tree is never trained")
    if N % 4:
        raise ValueError(f"the int8 linear kernel takes N % 4 == 0; got N={N}")
    M = x.numel() // K
    y = torch.empty(*x.shape[:-1], N, dtype=torch.float32 if s is None else x.dtype, device=x.device)
    if M == 0:
        return y
    if K % 16 or x.data_ptr() % 16 or q.data_ptr() % 16:
        # The copies read 16-byte aligned rows of whole 16-byte steps: such
        # operands go through zero-padded copies (the b6369a24 ones never do).
        padded = -(-K // 16) * 16
        xp, qp = x.new_zeros(M, padded), q.new_zeros(N, padded)
        xp[:, :K], qp[:, :K] = x.reshape(M, K), q
        x, q, K = xp, qp, padded
    tile, split = launch_config(M, N, K, _cuda.sm_count(x.device), x.element_size())
    err = _cuda.library("int8_linear").ptt_int8_linear(
        x.data_ptr(), _X_KINDS[x.dtype], q.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(),
        int(y.dtype == torch.bfloat16), M, N, K, tile, split, _cuda.stream_ptr(),
    )
    _cuda.count_launch(int8_linear)
    if err:
        raise RuntimeError(f"int8_linear: CUDA error {err}")
    return y


int8_linear.launches = 0
