"""One B=1 FlowLM decode frame as a hand-written CUDA kernel.

Replaces pocket_tts_tpu/ops/fused_backbone.py:fused_backbone_step (the
Pallas kernel `_kernel` with the head folded in). Contract, per frame:

  - select the BOS embedding or the previous latent, int8 `input_linear`;
  - L x [LN(1e-5) -> int8 q/k/v -> interleaved RoPE -> attention over the
    slot-major cache (valid iff 0 <= slot_pos < qpos, the row at widx
    excluded) with the new row folded into the softmax -> int8 out-proj ->
    residual -> LN -> int8 FF1 -> exact GELU, hidden rounded to bf16 ->
    int8 FF2 -> residual];
  - out_norm -> h, the EOS logit;
  - the (k, v) row of every layer and slot_pos written IN PLACE at
    min(widx, C - 1).

Roundings mirror the JAX int8 path: bf16 activations into the int8 products
with float32 accumulation and a per-output scale, bf16 q/k/v and softmax
weights in attention, a bf16 FF hidden, exact erf.

What bounds it on the H100: the 75.5 MB of int8 backbone weights read once
per frame (BENCHMARKS.md "Round-5 residue"), about 23 us at 3.35 TB/s; each
weight byte meets one multiply-add, so no tensor-core rate applies. The
kernel (csrc/fused_backbone.cu, built from csrc/persistent_frame.cuh and
csrc/persistent_decode.cuh) is one cooperative launch per call, the
segment kernel's frame without the flow head: one block per SM walks 6 L + 2
phases (the input projection; per layer qkv, scores, pv, o, ff1, ff2; the
head) behind grid barriers; every weight phase spreads its rows over all
blocks, which bulk-copy them into a shared-memory ring while the phase
before runs; the attention is split over (head, chunk of cache rows) items
(`split_attention_reference` in ops/fused_segment.py is its plain form); in
the head one block computes out_norm, the EOS logit and the slot_pos
append. In practice each phase waits on a few L2 round trips, which bound
it more than the bytes (PERF.md). `ops/persistent.segment_plan` (with no
flow head) is the work split.

`fused_backbone_step` launches the kernel for CUDA tensors (or raises) and
runs `fused_backbone_step_reference`, the plain PyTorch version with the same
contract, for CPU tensors. `fused_backbone_step.launches` counts kernel
launches, one per call. Both B=1 kernels take caches whose capacity passes
`capacity_ok`; the routing rules (models/flow_lm.fused_step_ok,
models/generate.segment_kernel_ok) send larger caches down the plain path.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.persistent import THREADS, VEC_PER_THREAD, barrier_counter, launch_plan


# The B=1 kernels take caches whose capacity is a multiple of the 32-row
# attention grid and at most MAX_CAPACITY rows, the largest they are checked
# for (ops/persistent.segment_plan fits every C up to it in a block's shared
# memory).
CAPACITY_ALIGN = 32
MAX_CAPACITY = 12288


def capacity_ok(C: int) -> bool:
    """Whether the B=1 kernels take a cache of C rows."""
    return C % CAPACITY_ALIGN == 0 and C <= MAX_CAPACITY


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def pack_backbone(flow_params: dict, num_heads: int, max_period: float) -> dict:
    """Stack the int8-quantized FlowLM weights (models/weights.quantize_int8
    with its default subtrees) into the kernel's per-layer layout: int8
    [out, in] matrices with float32 per-output scales, float32 LN rows."""
    layers = flow_params["transformer"]["layers"]
    w_in = flow_params["input_linear"]["weight"]
    ws = [lp["self_attn"]["in_proj"]["weight"] for lp in layers] + [w_in]
    if not all(isinstance(w, dict) for w in ws):
        raise ValueError("the fused backbone needs int8-quantized params (param_dtype='int8')")

    def stack(get):
        return torch.stack([get(lp) for lp in layers]).contiguous()

    E = w_in["q"].shape[0]
    return {
        "wqkv": stack(lambda lp: lp["self_attn"]["in_proj"]["weight"]["q"].reshape(3 * E, E)),
        "sqkv": stack(lambda lp: lp["self_attn"]["in_proj"]["weight"]["s"].reshape(3 * E).float()),
        "wo": stack(lambda lp: lp["self_attn"]["out_proj"]["weight"]["q"]),
        "so": stack(lambda lp: lp["self_attn"]["out_proj"]["weight"]["s"].float()),
        "w1": stack(lambda lp: lp["linear1"]["weight"]["q"]),
        "s1": stack(lambda lp: lp["linear1"]["weight"]["s"].float()),
        "w2": stack(lambda lp: lp["linear2"]["weight"]["q"]),
        "s2": stack(lambda lp: lp["linear2"]["weight"]["s"].float()),
        "ln": stack(
            lambda lp: torch.stack(
                [lp["norm1"]["weight"], lp["norm1"]["bias"], lp["norm2"]["weight"], lp["norm2"]["bias"]]
            ).float()
        ),
        "win": w_in["q"].contiguous(),
        "s_in": w_in["s"].float().contiguous(),
        "bos": flow_params["bos_emb"].float().contiguous(),
        "out_norm": torch.stack(
            [flow_params["out_norm"]["weight"], flow_params["out_norm"]["bias"]]
        ).float().contiguous(),
        "eos_w": flow_params["out_eos"]["weight"][0].float().contiguous(),
        "eos_b": flow_params["out_eos"]["bias"].float().contiguous(),
        "num_heads": int(num_heads),
        "max_period": float(max_period),
    }


def rope_cos_sin(qpos: int, head_dim: int, max_period: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos, sin) [d/2] for one position (ops/rope.rope_angles)."""
    ds = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(qpos), dtype=torch.float32, device=device) * torch.exp(
        ds * (-math.log(max_period) * 2.0 / head_dim)
    )
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation of x [H, d] in float32."""
    xs = x.reshape(x.shape[0], -1, 2)
    xr, xi = xs[..., 0], xs[..., 1]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1).reshape(x.shape)


def attention_reference(q, k, v, kc, vc, valid):
    """One query per head over the cache rows where `valid` [C] holds plus
    the new row itself -> [H, d] float32. q, k, v [H, d] float32 (rotated,
    bf16-exact); kc, vc [C, H, d]. Scores and sums in float32, the softmax
    weights rounded to bf16 after the normalisation."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("chd,hd->hc", kc.float(), q) * scale
    scores = torch.where(valid[None, :], scores, torch.full_like(scores, -1e9))
    s_self = (q * k).sum(-1) * scale  # [H]
    m = torch.maximum(scores.amax(-1), s_self)
    e = torch.exp(scores - m[:, None])
    e_self = torch.exp(s_self - m)
    denom = e.sum(-1) + e_self
    w = _bf16r(e / denom[:, None])
    w_self = _bf16r(e_self / denom)
    return torch.einsum("hc,chd->hd", w, vc.float()) + w_self[:, None] * v


def backbone_frame_reference(packed, x_in, k_caches, v_caches, slot_pos, qpos: int, widx: int):
    """One frame from the input row x_in [ldim] (float32) -> (h [E], eos [1]);
    appends in place. The plain version of the backbone phases of a frame of
    the persistent kernels (csrc/persistent_frame.cuh)."""
    H = packed["num_heads"]
    E = packed["win"].shape[0]
    d = E // H
    C = k_caches[0].shape[1]
    x = F.linear(_bf16r(x_in), packed["win"].float()) * packed["s_in"]
    cos, sin = rope_cos_sin(qpos, d, packed["max_period"], x.device)
    sp = slot_pos[0]
    rows = torch.arange(C, device=x.device)
    valid = (sp >= 0) & (sp < qpos) & (rows != widx)
    for l in range(packed["wqkv"].shape[0]):
        ln = packed["ln"][l]
        h = layer_norm(x, ln[0], ln[1], eps=1e-5)
        qkv = F.linear(_bf16r(h), packed["wqkv"][l].float()) * packed["sqkv"][l]
        q, k, v = qkv.reshape(3, H, d)
        q = _bf16r(_rotate(q, cos, sin))
        k = _bf16r(_rotate(k, cos, sin))
        v = _bf16r(v)
        kc, vc = k_caches[l][0], v_caches[l][0]  # [C, H, d]
        attn = attention_reference(q, k, v, kc, vc, valid)
        x = x + F.linear(_bf16r(attn.reshape(E)), packed["wo"][l].float()) * packed["so"][l]
        h = layer_norm(x, ln[2], ln[3], eps=1e-5)
        hid = F.gelu(F.linear(_bf16r(h), packed["w1"][l].float()) * packed["s1"][l])
        x = x + F.linear(_bf16r(hid), packed["w2"][l].float()) * packed["s2"][l]
        kc[widx] = k.to(kc.dtype)
        vc[widx] = v.to(vc.dtype)
    slot_pos[0, widx] = qpos
    hn = layer_norm(x, packed["out_norm"][0], packed["out_norm"][1], eps=1e-5)
    eos = (hn * packed["eos_w"]).sum()[None] + packed["eos_b"]
    return hn, eos


def fused_backbone_step_reference(packed, latent, is_bos, k_caches, v_caches, slot_pos, qpos, widx):
    """Plain PyTorch version of fused_backbone_step (same contract)."""
    widx = min(int(widx), k_caches[0].shape[1] - 1)
    x_in = packed["bos"] if is_bos else latent[0].float()
    h, eos = backbone_frame_reference(packed, x_in, k_caches, v_caches, slot_pos, int(qpos), widx)
    return h[None], eos


def _backbone_args(packed, k_caches, v_caches, slot_pos):
    """Validate the CUDA operands and fill the C argument block (with its
    scratch tensors, which the caller keeps alive for the launch)."""
    from pocket_tts_tpu_torch.ops import _cuda

    _cuda.check_device()
    L, three_e, E = packed["wqkv"].shape
    H = packed["num_heads"]
    d = E // H
    FF = packed["w1"].shape[1]
    ldim = packed["win"].shape[1]
    C = k_caches[0].shape[1]
    if d != 64 or E % 16 or FF % 16 or ldim % 16 or not capacity_ok(C) or L > _cuda.MAX_LAYERS:
        raise ValueError(
            f"the CUDA backbone takes head_dim 64, E/FF/ldim multiples of 16, C a multiple of {CAPACITY_ALIGN} up "
            f"to {MAX_CAPACITY} and at most {_cuda.MAX_LAYERS} layers; got E={E} H={H} FF={FF} ldim={ldim} C={C} "
            f"L={L}"
        )
    if len(k_caches) != L or len(v_caches) != L:
        raise ValueError(f"expected {L} k and v caches")
    i8, f32 = torch.int8, torch.float32
    for name, dtype, shape in (
        ("wqkv", i8, (L, 3 * E, E)), ("sqkv", f32, (L, 3 * E)), ("wo", i8, (L, E, E)), ("so", f32, (L, E)),
        ("w1", i8, (L, FF, E)), ("s1", f32, (L, FF)), ("w2", i8, (L, E, FF)), ("s2", f32, (L, E)),
        ("ln", f32, (L, 4, E)), ("win", i8, (E, ldim)), ("s_in", f32, (E,)), ("bos", f32, (ldim,)),
        ("out_norm", f32, (2, E)), ("eos_w", f32, (E,)), ("eos_b", f32, (1,)),
    ):
        _cuda.check_cuda_tensor(name, packed[name], dtype, shape)
    for i, t in enumerate(list(k_caches) + list(v_caches)):
        _cuda.check_cuda_tensor(f"cache[{i}]", t, torch.bfloat16, (1, C, H, d))
    _cuda.check_cuda_tensor("slot_pos", slot_pos, torch.int32, (1, C))
    dev = slot_pos.device
    scratch = {
        "x": torch.empty(E, dtype=f32, device=dev),
        "qkv": torch.empty(3 * E, dtype=f32, device=dev),
        "hidden": torch.empty(FF, dtype=torch.bfloat16, device=dev),
    }
    args = _cuda.PttBackbone()
    for name in ("wqkv", "sqkv", "wo", "so", "w1", "s1", "w2", "s2", "ln", "win", "s_in", "bos",
                 "out_norm", "eos_w", "eos_b"):
        setattr(args, name, packed[name].data_ptr())
    for i in range(L):
        args.k[i] = k_caches[i].data_ptr()
        args.v[i] = v_caches[i].data_ptr()
    args.slot_pos = slot_pos.data_ptr()
    for name, t in scratch.items():
        setattr(args, name, t.data_ptr())
    args.L, args.E, args.H, args.FF, args.ldim, args.C = L, E, H, FF, ldim, C
    args.rope_coef = float(torch.tensor(-math.log(packed["max_period"]) * 2.0 / d, dtype=f32))
    return args, scratch


def fused_backbone_step(packed, latent, is_bos: bool, k_caches, v_caches, slot_pos, qpos: int, widx: int):
    """One B=1 decode frame -> (h [1, E] float32 after out_norm, eos logit
    [1] float32); caches and slot_pos update in place at min(widx, C - 1).

    packed: pack_backbone(...); latent [1, ldim] float32 (ignored at BOS);
    k_caches / v_caches: L x [1, C, H, d] bf16; slot_pos [1, C] int32."""
    if not slot_pos.is_cuda:
        return fused_backbone_step_reference(packed, latent, is_bos, k_caches, v_caches, slot_pos, qpos, widx)
    from pocket_tts_tpu_torch.ops import _cuda

    args, scratch = _backbone_args(packed, k_caches, v_caches, slot_pos)
    _cuda.check_cuda_tensor("latent", latent, torch.float32, (1, args.ldim))
    limit = VEC_PER_THREAD * THREADS
    if max(args.E, args.ldim) > limit:
        raise ValueError(f"the CUDA backbone takes E and ldim up to {limit}; got E={args.E} ldim={args.ldim}")
    widx = min(int(widx), args.C - 1)
    dev = slot_pos.device
    plan, table = launch_plan(dev.index if dev.index is not None else torch.cuda.current_device(), args.L, args.E,
                              args.H, args.FF, args.ldim, None, None, args.C)
    n_items = plan["items"][-1]
    part = torch.empty(n_items * 64, dtype=torch.float32, device=dev)
    stats = torch.empty(n_items * 2, dtype=torch.float32, device=dev)
    h = torch.empty(1, args.E, dtype=torch.float32, device=dev)
    eos = torch.empty(1, dtype=torch.float32, device=dev)
    err = _cuda.library("fused_backbone").ptt_fused_backbone_step(
        ctypes.byref(args), latent.data_ptr(), int(bool(is_bos)), int(qpos), widx, h.data_ptr(), eos.data_ptr(),
        table.data_ptr(), plan["blocks"], plan["chunk"], plan["chunks"], plan["slot_bytes"], plan["xs_off"],
        plan["sc_off"], plan["shared_bytes"], part.data_ptr(), stats.data_ptr(), barrier_counter(dev).data_ptr(),
        _cuda.stream_ptr(),
    )
    if err:
        raise RuntimeError(f"fused_backbone_step: CUDA error {err} (cooperative launch of {plan['blocks']} blocks)")
    _cuda.count_launch(fused_backbone_step)
    # `scratch`, `part` and `stats` stay referenced until here; later reuse of
    # their memory is ordered after the kernel on the same stream by the
    # caching allocator.
    return h, eos


fused_backbone_step.launches = 0
