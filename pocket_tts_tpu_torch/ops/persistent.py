"""The work split of the two persistent B=1 decode launches.

`fused_backbone_step` (csrc/fused_backbone.cu) and `fused_segment_decode`
(csrc/fused_segment.cu) are each one cooperative launch whose blocks, one
or more per SM and all resident, walk a list of phases behind grid barriers
(csrc/persistent_decode.cuh, csrc/persistent_frame.cuh). Both take the same
plan: which rows of each weight matrix and which attention items each block
owns, the phase list and the shared-memory layout. The one-frame launch is
the segment's frame without the flow head (`depth=None` below): the
backbone's matrices only, its phases ending in the head, no second
activation. Pure Python, tested on the CPU; `launch_plan` sizes the grid
on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Weight matrices of a frame, in the order of the row table the kernels read
# (enum BackboneKind, then enum FlowKind).
BACKBONE_KINDS = ("in", "qkv", "o", "ff1", "ff2")
KINDS = BACKBONE_KINDS + ("cond", "flow_in", "ada", "w0", "w2", "final")
THREADS = 512  # pd::kThreads
VEC_PER_THREAD = 2  # pd::kVecPer: a prologue's vector holds at most THREADS * 2 floats
MAX_CHUNKS = 8  # kMaxChunks: attention items per head
MIN_CHUNK = 64  # fewest cache rows per attention item
MAX_SHARED_BYTES = 232448  # an H100 block's opt-in shared memory (227 KB)
# Static shared memory of a block: red, q/k/v rows, PV partials, and 1 KB
# for the ring's two mbarriers, the phase descriptors, the row ranges and
# the compiler's alignment.
STATIC_SHARED_BYTES = (32 + 3 * 64 + THREADS // 32 * 64) * 4 + 1024
BLOCK_QUOTA = 1 << 20  # GridBarrier::kBlockQuota: a launch waits on fewer barriers
MAX_BLOCKS = 4096  # kEpoch / kBlockQuota


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def weight_kinds(L: int, E: int, FF: int, ldim: int, MC: int | None, depth: int | None) -> dict:
    """{kind: (rows, K, bytes per element)} of one frame's matrices (one
    layer's or one flow block's where there are several); the backbone's
    alone when depth is None (the one-frame launch)."""
    kinds = {"in": (E, ldim, 1), "qkv": (3 * E, E, 1), "o": (E, E, 1), "ff1": (FF, E, 1), "ff2": (E, FF, 1)}
    if depth is None:
        return kinds
    na = (3 * depth + 2) * MC
    return kinds | {
        "cond": (MC, E, 2), "flow_in": (MC, ldim, 2), "ada": (na, MC, 2), "w0": (MC, MC, 2), "w2": (MC, MC, 2),
        "final": (ldim, MC, 2),
    }


def phase_list(L: int, depth: int | None) -> list[tuple[str, tuple[str, ...]]]:
    """The phases of one frame, in order, each (name, weight kinds it reads);
    a grid barrier follows each (the last of a launch excepted). depth None:
    the one-frame launch, whose head (out_norm, the EOS logit, the slot_pos
    append) reads no weight matrix."""
    phases = [("in", ("in",))]
    for l in range(L):
        phases += [(f"qkv{l}", ("qkv",)), (f"scores{l}", ()), (f"pv{l}", ()), (f"o{l}", ("o",)),
                   (f"ff1_{l}", ("ff1",)), (f"ff2_{l}", ("ff2",))]
    if depth is None:
        return phases + [("head", ())]
    phases += [("head", ("cond", "flow_in")), ("ada", ("ada",))]
    for i in range(depth):
        phases += [(f"w0_{i}", ("w0",)), (f"w2_{i}", ("w2",))]
    return phases + [("final", ("final",))]


def _even(n: int, blocks: int) -> list[int]:
    return [b * n // blocks for b in range(blocks + 1)]


def segment_plan(L: int, E: int, H: int, FF: int, ldim: int, MC: int | None, depth: int | None, C: int,
                 blocks: int) -> dict:
    """The work split of one kernel launch over `blocks` blocks: the
    segment's (flow head of width MC and depth `depth`), or with MC and
    depth None the one-frame launch's.

    rows[kind]: block b owns rows [rows[kind][b], rows[kind][b + 1]) of that
    matrix in every phase that reads it (an even split). Attention items are
    (head, chunk): chunk c of head h covers cache rows [c * chunk,
    min(C, (c + 1) * chunk)); item h * chunks + c belongs to block b when
    items[b] <= it < items[b + 1], in the scores phase and in the PV phase,
    which reads the scores the block kept. A chunk is a multiple of 32 rows,
    at least MIN_CHUNK, sized for at most MAX_CHUNKS (and blocks / H) items
    a head. Shared memory: the weight ring, two slots of slot_bytes at 0
    (weight phase j's rows, block_bytes of each matrix it reads, are copied
    into slot j % 2 while weight phase j - 1 runs), the bf16 activation
    (xs_off), the second one of the segment's head phase (xs2_off; none in
    the one-frame launch) and each item's scores plus its self score
    (sc_off, chunk + 4 floats an item); `table` is the int32 row table the
    kernel takes. A launch of S frames passes S * barriers_per_frame - 1
    grid barriers."""
    target = max(1, min(MAX_CHUNKS, blocks // H))
    chunk = max(MIN_CHUNK, -(-(-(-C // target)) // 32) * 32)
    chunks = -(-C // chunk)
    kinds = weight_kinds(L, E, FF, ldim, MC, depth)
    rows = {k: _even(kinds[k][0], blocks) for k in kinds}
    items = _even(H * chunks, blocks)
    max_items = max(b - a for a, b in zip(items, items[1:]))
    phases = phase_list(L, depth)
    # A ring slot holds the most bytes a block copies for one weight phase:
    # its rows of each matrix the phase reads, each matrix 128-byte aligned.
    block_bytes = {k: max(b - a for a, b in zip(rows[k], rows[k][1:])) * kinds[k][1] * kinds[k][2] for k in kinds}
    slot_bytes = max(sum(_align128(block_bytes[k]) for k in ks) for _, ks in phases if ks)
    xs_off = 2 * slot_bytes
    xs2_off = xs_off + _align16(max(K for _, K, _ in kinds.values()) * 2)
    sc_off = xs2_off + (0 if depth is None else _align16(ldim * 2))
    shared = sc_off + max_items * (chunk + 4) * 4
    if shared + STATIC_SHARED_BYTES > MAX_SHARED_BYTES:
        raise ValueError(f"C={C}, {blocks} blocks: {shared + STATIC_SHARED_BYTES} bytes of shared memory per block "
                         f"(a weight ring of two {slot_bytes}-byte slots); the H100 allows {MAX_SHARED_BYTES}")
    return {
        "blocks": blocks, "rows": rows, "kinds": kinds, "chunk": chunk, "chunks": chunks, "items": items,
        "max_items": max_items, "phases": [name for name, _ in phases], "barriers_per_frame": len(phases),
        "block_bytes": block_bytes, "slot_bytes": slot_bytes, "xs_off": xs_off, "xs2_off": xs2_off,
        "sc_off": sc_off, "shared_bytes": shared,
        "table": [r for k in kinds for r in rows[k]] + items,
    }


@functools.lru_cache(maxsize=None)
def launch_plan(device_index: int, L, E, H, FF, ldim, MC, depth, C):
    """(plan, its row table on the device) of a launch on that device, of
    the segment kernel or (MC and depth None) of the one-frame kernel: the
    grid is every SM times the blocks an SM holds at the plan's shared
    memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), all resident,
    as a cooperative launch needs; plan["blocks_per_sm"] says how many."""
    from pocket_tts_tpu_torch.ops import _cuda

    name = "fused_backbone_step" if depth is None else "fused_segment_decode"
    occupancy = (_cuda.library("fused_backbone").ptt_fused_backbone_occupancy if depth is None
                 else _cuda.library("fused_segment").ptt_fused_segment_occupancy)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    plan = segment_plan(L, E, H, FF, ldim, MC, depth, C, sms)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = occupancy(plan["shared_bytes"], ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"{name}: no block fits an SM at {plan['shared_bytes']} bytes of shared memory "
                           f"(CUDA error {err})")
    if per_sm.value > 1:
        plan = segment_plan(L, E, H, FF, ldim, MC, depth, C, sms * per_sm.value)
    plan["blocks_per_sm"] = per_sm.value
    if plan["blocks"] > MAX_BLOCKS:
        raise ValueError(f"{name}: {plan['blocks']} blocks; the grid barrier counts at most {MAX_BLOCKS}")
    table = torch.tensor(plan["table"], dtype=torch.int32, device=torch.device("cuda", device_index))
    return plan, table


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def barrier_counter(device) -> torch.Tensor:
    """The grid barrier's arrival counter of the current stream on `device`
    (zeroed once; each launch of either kernel adds a whole epoch, so it is
    never reset and both kernels share it on one stream)."""
    from pocket_tts_tpu_torch.ops import _cuda

    key = (device.index, _cuda.stream_ptr())
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _COUNTERS[key]
