"""Run the two cache-layout probes on the card: the counterpart of
scripts/mosaic_probe.py, on that script's own inputs.

  P1  in-place write of one bf16 row at an index read on the device, into a
      (64, 1024) cache whose other rows must keep their bits
      (ops/probes.row_write);
  P2  weighted sum of the 16 per-head 64-wide slices of a (64, 1024) bf16
      array, in float32 (ops/probes.head_slice_weighted_sum).

Usage: python -m pocket_tts_tpu_torch.probes [--device cuda]
Prints one line per probe, "...: OK" or "...: WRONG RESULT", and exits 1 on
a wrong result.
"""

from __future__ import annotations

import argparse
import sys

import torch

from pocket_tts_tpu_torch.models.tts_model import _resolve_device
from pocket_tts_tpu_torch.ops.probes import head_slice_weighted_sum, row_write

C, E = 64, 1024
HEADS, WIDTH = 16, 64
QW = 13  # the row P1 writes


def probe_row_write(device: torch.device) -> bool:
    """P1 on the script's inputs: cache = arange % 13, row = arange % 31 +
    100, index 13; the result must equal the expected array bit for bit."""
    cache = (torch.arange(C * E, dtype=torch.float32).reshape(C, E) % 13).to(torch.bfloat16)
    row = (torch.arange(E, dtype=torch.float32) % 31 + 100.0).to(torch.bfloat16)
    want = cache.clone()
    want[QW] = row
    got = row_write(cache.to(device), row.to(device), torch.tensor([QW], dtype=torch.int32, device=device))
    return torch.equal(got.cpu(), want)


def probe_head_slice_weighted_sum(device: torch.device) -> bool:
    """P2 on the script's input x = arange % 97; allclose(atol=1e-2) to the
    float32 sum of the slices, as the script checks it."""
    x = (torch.arange(C * E, dtype=torch.float32).reshape(C, E) % 97).to(torch.bfloat16)
    want = sum(x[:, WIDTH * h : WIDTH * (h + 1)].float() * (h + 1) for h in range(HEADS))
    got = head_slice_weighted_sum(x.to(device), HEADS, WIDTH).cpu()
    return torch.allclose(got, want, rtol=0, atol=1e-2)


PROBES = (
    ("P2 per-head slice weighted sum", probe_head_slice_weighted_sum),
    ("P1 in-place row write at a device index", probe_row_write),
)


def run(device) -> bool:
    """Run both probes, print one line each; True when both are right."""
    device = _resolve_device(device)
    ok = True
    for name, probe in PROBES:
        right = probe(device)
        print(f"{name}: {'OK' if right else 'WRONG RESULT'}", flush=True)
        ok = ok and right
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Cache-layout probes of the PyTorch/CUDA port")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    return 0 if run(args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
