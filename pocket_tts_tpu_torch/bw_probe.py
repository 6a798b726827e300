"""Device-memory read-rate probe: the counterpart of benchmarks/bw_probe.py
on the port's stream_read kernel (ops/read_probes.py).

For int8, bf16 and float32, an array [rows_total, 1024] of about --mb MiB
(rows_total rounded down to a multiple of 4096) of seeded random data is
read in blocks of 256 to 4096 KiB, --iters calls chained through the
(8, 128) carry (each call's output is the next call's tok, so the calls run
one after the other without copying the array), best of --repeats timings. Each dtype ends with one more
line: the grid size (kernel blocks) that read fastest at that dtype's
fastest block size.

Usage: python -m pocket_tts_tpu_torch.bw_probe [--mb 256] [--iters 16] [--repeats 5] [--device cuda]

On the card the times come from CUDA events around a replay of the chained
calls captured in a CUDA graph (utils/timing.py); with --device cpu the
plain PyTorch version runs and the rates are the CPU's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from pocket_tts_tpu_torch.models.tts_model import _resolve_device
from pocket_tts_tpu_torch.ops.read_probes import LANES, OUT_SHAPE, sm_count, stream_read
from pocket_tts_tpu_torch.utils.timing import best_seconds

DTYPES = ((torch.int8, "int8"), (torch.bfloat16, "bfloat16"), (torch.float32, "float32"))
BLOCK_KIB = (256, 512, 1024, 2048, 4096)
GRID_WAVES = (1, 2, 4, 8)  # swept grids: this many blocks per SM (8 is one full wave)


def chained_seconds(fn, iters: int, repeats: int, device: torch.device) -> float:
    """Best of `repeats` wall times of `iters` calls of fn(acc) -> acc,
    each fed the previous output."""
    def chain():
        acc = torch.zeros(OUT_SHAPE, dtype=torch.float32, device=device)
        for _ in range(iters):
            acc = fn(acc)
        return acc

    return best_seconds(chain, repeats, device, counted=(stream_read,))


def random_array(rows: int, dtype: torch.dtype, device: torch.device, seed: int = 0) -> torch.Tensor:
    """[rows, 1024] seeded random values (uniform int8 codes, or normal
    values). The JAX script reads ones; random data leaves no room for the
    memory system to move fewer bytes than the array holds."""
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, (rows, LANES), generator=g, dtype=torch.int8, device=device)
    return torch.randn(rows, LANES, generator=g, device=device).to(dtype)


def sweep(mb: int, iters: int, repeats: int, device, dtypes=DTYPES, block_kib=BLOCK_KIB, print_fn=print) -> dict:
    """The probe's sweep. Returns {dtype name: {"nbytes", "rows_total",
    "blocks": {blk_kib: (blk_rows, GB/s)}, "best": (blk_kib, blk_rows,
    grid, GB/s)}}; the grid sweep runs on the card only."""
    device = _resolve_device(device)
    results = {}
    for dtype, name in dtypes:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        rows_total = mb * 2**20 // (LANES * itemsize) // 4096 * 4096
        nbytes = rows_total * LANES * itemsize
        if rows_total == 0:
            continue
        x = random_array(rows_total, dtype, device)
        blocks = {}
        for blk_kib in block_kib:
            blk_rows = blk_kib * 1024 // (LANES * itemsize)
            if blk_rows < 8 or rows_total % blk_rows:
                continue
            seconds = chained_seconds(lambda acc: stream_read(acc, x, blk_rows), iters, repeats, device)
            gbs = nbytes * iters / seconds / 1e9
            blocks[blk_kib] = (blk_rows, gbs)
            print_fn(f"dtype={name:9s} blk={blk_kib:5d} KiB ({blk_rows:5d} rows): {gbs:6.0f} GB/s")
        if not blocks:
            continue
        best_kib = max(blocks, key=lambda k: blocks[k][1])
        blk_rows, gbs = blocks[best_kib]
        grid = None
        if device.type == "cuda":
            sms = sm_count(device)
            rates = {}
            for waves in GRID_WAVES:
                g = waves * sms
                seconds = chained_seconds(lambda acc: stream_read(acc, x, blk_rows, grid=g), iters, repeats, device)
                rates[g] = nbytes * iters / seconds / 1e9
            grid = max(rates, key=rates.get)
            gbs = rates[grid]
            print_fn(f"dtype={name:9s} best grid={grid:5d} blocks ({grid // sms} per SM) at blk={best_kib:5d} KiB: "
                     f"{gbs:6.0f} GB/s (swept {', '.join(f'{g}: {r:.0f}' for g, r in rates.items())})")
        results[name] = {"nbytes": nbytes, "rows_total": rows_total, "blocks": blocks,
                         "best": (best_kib, blk_rows, grid, gbs)}
        del x
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Device-memory read-rate probe of the PyTorch/CUDA port")
    ap.add_argument("--mb", type=int, default=256, help="array size to stream")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = _resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}; CUDA events around a CUDA graph of the chained calls",
              flush=True)
    else:
        print(f"device: {device} (plain PyTorch version; the CPU's rate, not the card's)", flush=True)
    sweep(args.mb, args.iters, args.repeats, device, print_fn=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
