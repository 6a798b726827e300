"""Batched decode-attention microbench: the counterpart of
benchmarks/attn_micro.py on the port.

It times the attention of one decode step at the batch shape (B=64, C=512,
H=16, d=64, one query per stream) in several forms, each chained (call i+1's
query is out_i * 1e-6 + q_0, so the calls run one after the other), best of
--repeats timings of --iters calls:

  readsum     K and V read once each into a float32 reduction (plain PyTorch)
  readdot     K and V contracted with a ones vector (a bf16 GEMV each)
  pallas_read K and V flattened to [B*C, 1024] and summed per lane by the
              kv_read_sum kernel (ops/read_probes.py): the read floor
  slots       the port's sdpa_slots over the slot-major [B, C, H, d] cache
  indicator   scores through one batched matmul with a 0/1 head-indicator
              matrix over the flat [B, C, H*d] cache; PV batched per head
  ind2        both products through the indicator form
  hsd         a cache stored [B, H, C, d] (not a serving layout; a bound on
              what a layout change could buy)
  int8        sdpa_slots over int8 rows with per-row scales (quantize_kv_rows)
  kernel      batch_decode_attention, bf16 cache
  kernel_i8   batch_decode_attention, int8 cache

Effective bandwidth = the K+V bytes of the step / its time.

Usage: python -m pocket_tts_tpu_torch.attn_micro [--B 64] [--C 512] [--iters 64] [--repeats 5] [--device cuda]

Inputs come from a seeded torch.Generator (their values differ from the JAX
script's threefry draws). On the card the times come from CUDA events around
a replay of the chained calls captured in a CUDA graph (utils/timing.py);
with --device cpu every form runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from pocket_tts_tpu_torch.models.tts_model import _resolve_device
from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows, sdpa_slots
from pocket_tts_tpu_torch.ops.batch_attention import batch_decode_attention
from pocket_tts_tpu_torch.ops.read_probes import kv_read_sum
from pocket_tts_tpu_torch.utils.timing import best_seconds

H, D = 16, 64
VARIANTS = ("readsum", "readdot", "pallas_read", "slots", "indicator", "ind2", "hsd", "int8", "kernel", "kernel_i8")


def make_inputs(B: int, C: int, device: torch.device, seed: int = 0) -> dict:
    """q [B, H, 1, d] and the caches every variant reads, bf16 (int8 rows
    with per-row scales for the int8 forms), every row valid."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, 1, D, generator=g).to(torch.bfloat16).to(device)
    k = torch.randn(B, C, H, D, generator=g).to(torch.bfloat16).to(device)
    v = torch.randn(B, C, H, D, generator=g).to(torch.bfloat16).to(device)
    (k8, k_scale), (v8, v_scale) = quantize_kv_rows(k), quantize_kv_rows(v)
    M = torch.zeros(H * D, H, dtype=torch.bfloat16, device=device)
    M[torch.arange(H * D), torch.arange(H * D) // D] = 1.0
    return {
        "q": q, "k": k, "v": v, "kflat": k.view(B, C, H * D), "vflat": v.view(B, C, H * D),
        "k8": k8, "v8": v8, "k_scale": k_scale, "v_scale": v_scale, "M": M,
        "k_hsd": k.transpose(1, 2).contiguous(), "v_hsd": v.transpose(1, 2).contiguous(),
        "valid": torch.ones(B, 1, 1, C, dtype=torch.bool, device=device),
        "slot_pos": torch.arange(C, dtype=torch.int32, device=device).expand(B, C).contiguous(),
        "qpos": torch.full((B,), C, dtype=torch.int32, device=device),
        "ones_j": torch.ones(H * D, dtype=torch.bfloat16, device=device),
    }


def _softmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked float32 softmax over the last axis."""
    return torch.softmax(torch.where(valid, scores, torch.full_like(scores, -1e9)), dim=-1)


def variants(t: dict) -> dict:
    """{name: fn(q) -> out [B, H, 1, d] bf16} over the inputs t."""
    B, C = t["k"].shape[:2]
    scale = 1.0 / math.sqrt(D)

    def readsum(q):
        w = q[0, 0, 0, 0].float()
        s = (t["kflat"].float() * w).sum(dim=(1, 2)) + (t["vflat"].float() * w).sum(dim=(1, 2))
        return q + (s[:, None, None, None] * 1e-9).to(q.dtype)

    def readdot(q):
        w = t["ones_j"] * q[0, 0, 0, 0]
        s = torch.matmul(t["kflat"], w).float().sum(dim=1) + torch.matmul(t["vflat"], w).float().sum(dim=1)
        return q + (s[:, None, None, None] * 1e-9).to(q.dtype)

    def pallas_read(q):
        tok = torch.nn.functional.pad(q[0, :8, 0, :].float(), (0, 128 - D))  # [8, 64] -> (8, 128)
        out = kv_read_sum(tok, t["kflat"].view(B * C, H * D), t["vflat"].view(B * C, H * D))
        return q + (out.sum() * 1e-9).to(q.dtype)

    def slots(q):
        return sdpa_slots(q.transpose(1, 2), t["k"], t["v"], t["valid"]).transpose(1, 2)

    def indicator_scores(q):
        qm = q.reshape(B, H * D)[:, :, None] * t["M"][None]  # [B, J, H]
        scores = torch.bmm(t["kflat"], qm).float()  # [B, C, H]
        return scores.transpose(1, 2)[:, :, None, :] * scale  # [B, H, 1, C]

    def indicator(q):
        w = _softmax(indicator_scores(q), t["valid"])
        return torch.einsum("bhqc,bchd->bhqd", w.to(torch.bfloat16), t["v"])

    def ind2(q):
        w = _softmax(indicator_scores(q), t["valid"])  # [B, H, 1, C]
        w_exp = torch.matmul(w[:, :, 0, :].transpose(1, 2).to(torch.bfloat16), t["M"].T)  # [B, C, J]
        out = (w_exp.float() * t["vflat"].float()).sum(dim=1)  # [B, J]
        return out.reshape(B, H, 1, D).to(q.dtype)

    def hsd(q):
        scores = torch.matmul(q, t["k_hsd"].transpose(-1, -2)).float() * scale  # [B, H, 1, C]
        return torch.matmul(_softmax(scores, t["valid"]).to(torch.bfloat16), t["v_hsd"])

    def int8(q):
        return sdpa_slots(q.transpose(1, 2), t["k8"], t["v8"], t["valid"], t["k_scale"], t["v_scale"]).transpose(1, 2)

    def kernel(q):
        return batch_decode_attention(q, t["k"], t["v"], t["slot_pos"], t["qpos"], read_rows=C)

    def kernel_i8(q):
        return batch_decode_attention(q, t["k8"], t["v8"], t["slot_pos"], t["qpos"], t["k_scale"], t["v_scale"],
                                      read_rows=C)

    return {"readsum": readsum, "readdot": readdot, "pallas_read": pallas_read, "slots": slots,
            "indicator": indicator, "ind2": ind2, "hsd": hsd, "int8": int8, "kernel": kernel, "kernel_i8": kernel_i8}


def step_bytes(name: str, B: int, C: int) -> int:
    """The K+V bytes one step reads: bf16, or int8 rows (scales neglected)."""
    n = B * C * H * D * 2
    return n if name in ("int8", "kernel_i8") else 2 * n


def time_variant(fn, q0: torch.Tensor, iters: int, repeats: int) -> float:
    """Best seconds per chained call of fn."""
    def chained():
        qi, out = q0, None
        for _ in range(iters):
            out = fn(qi)
            qi = out * 1e-6 + q0  # tiny feedback: the calls run in order
        return out

    return best_seconds(chained, repeats, q0.device, counted=(kv_read_sum, batch_decode_attention)) / iters


def run(B: int, C: int, iters: int, repeats: int, device, names=VARIANTS, print_fn=print) -> dict:
    """Time each named variant; print its line; -> {name: (us/step, GB/s)}."""
    device = _resolve_device(device)
    t = make_inputs(B, C, device)
    fns = variants(t)
    print_fn(f"B={B} C={C} H={H} d={D}  KV bytes/step: bf16={step_bytes('slots', B, C) / 1e6:.0f} MB "
             f"int8={step_bytes('int8', B, C) / 1e6:.0f} MB")
    results = {}
    with torch.no_grad():
        for name in names:
            seconds = time_variant(fns[name], t["q"], iters, repeats)
            us, gbs = seconds * 1e6, step_bytes(name, B, C) / seconds / 1e9
            results[name] = (us, gbs)
            print_fn(f"{name:10s} {us:8.1f} us/step  {gbs:7.0f} GB/s effective")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Batched decode-attention microbench of the PyTorch/CUDA port")
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--C", type=int, default=512)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = _resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}; CUDA events around a CUDA graph of the chained calls",
              flush=True)
    else:
        print(f"device: {device} (every form on the CPU; not the card's times)", flush=True)
    run(args.B, args.C, args.iters, args.repeats, device, print_fn=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
