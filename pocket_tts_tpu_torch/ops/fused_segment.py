"""S autoregressive B=1 FlowLM frames as a hand-written CUDA kernel.

Replaces pocket_tts_tpu/ops/fused_segment.py:fused_segment_decode (the
Pallas kernel `_seg_kernel`). Each frame is the fused_backbone_step frame
followed by the flow-matching head — one Euler step (s=0, t=1) of
SimpleMLPAdaLN with bf16 weights and float32 accumulation:

    y      = cond(h) + tcomb              (tcomb: the timestep embedding of
                                           the step, precomputed at pack time)
    ada    = W_ada silu(y) + b            (every block's shift/scale/gate)
    x      = input_proj(noise)
    x     += gate_i * MLP_i(LN_1e-6(x) * (1 + scale_i) + shift_i)
    latent = noise + final(LN_1e-6(x) * (1 + scale) + shift)

and the latent feeds the next frame; later frames read the (k, v) rows
earlier frames appended. Activations are rounded to bf16 into every product.

What bounds it on the H100: per frame the 75.5 MB int8 backbone stream
(BENCHMARKS.md "Round-5 residue") plus about 20 MB of bf16 flow weights.
The flow GEMVs reuse the backbone's warp-per-row weight streaming
(csrc/decode_common.cuh) with fused SiLU, AdaLN, gated-residual and Euler
epilogues; the loop over the S frames runs in C (csrc/fused_segment.cu), one
host call per segment.

`fused_segment_decode` launches the kernel for CUDA tensors (or raises) and
runs `fused_segment_decode_reference` for CPU tensors.
`fused_segment_decode.launches` counts kernel launches and `.frames` the
frames they decoded.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.ops.adaln import SimpleMLPAdaLN
from pocket_tts_tpu_torch.ops.fused_backbone import _backbone_args, _bf16r, backbone_frame_reference
from pocket_tts_tpu_torch.ops.norms import layer_norm


def pack_flow(flow_net: SimpleMLPAdaLN, flow_params: dict) -> dict:
    """bf16 flow-head weights [out, in] with float32 biases/LN rows, and the
    float32 timestep conditioning of the single Euler step (s=0, t=1)."""
    p = flow_params
    one = torch.ones(1, 1, dtype=torch.float32, device=p["cond_embed"]["bias"].device)
    tcomb = flow_net.time_conditioning(p, 0 * one, one)[0].float()
    mods = [b["adaLN_modulation"][1] for b in p["res_blocks"]] + [p["final_layer"]["adaLN_modulation"][1]]
    blocks = p["res_blocks"]

    def bf(w):
        return w.to(torch.bfloat16).contiguous()

    def f32(b):
        return b.float().contiguous()

    return {
        "wc": bf(p["cond_embed"]["weight"]), "bc": f32(p["cond_embed"]["bias"]), "tcomb": tcomb.contiguous(),
        "win": bf(p["input_proj"]["weight"]), "b_in": f32(p["input_proj"]["bias"]),
        "wa": bf(torch.cat([m["weight"] for m in mods])), "ba": f32(torch.cat([m["bias"] for m in mods])),
        "w0": bf(torch.stack([b["mlp"][0]["weight"] for b in blocks])),
        "b0": f32(torch.stack([b["mlp"][0]["bias"] for b in blocks])),
        "w2": bf(torch.stack([b["mlp"][2]["weight"] for b in blocks])),
        "b2": f32(torch.stack([b["mlp"][2]["bias"] for b in blocks])),
        "lnw": f32(torch.stack([b["in_ln"]["weight"] for b in blocks])),
        "lnb": f32(torch.stack([b["in_ln"]["bias"] for b in blocks])),
        "wf": bf(p["final_layer"]["linear"]["weight"]), "bf": f32(p["final_layer"]["linear"]["bias"]),
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ w^T with float32 accumulation (w already bf16)."""
    return F.linear(_bf16r(x), w.float())


def flow_head_reference(fp: dict, h: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One Euler step of the bf16 flow head: h [E], noise [ldim] -> latent."""
    mc = fp["bc"].shape[0]
    depth = fp["w0"].shape[0]
    y = _mm(h, fp["wc"]) + fp["bc"] + fp["tcomb"]
    ada = _mm(F.silu(y), fp["wa"]) + fp["ba"]
    x = _mm(noise, fp["win"]) + fp["b_in"]
    for i in range(depth):
        shift, scale, gate = ada[3 * i * mc : 3 * (i + 1) * mc].reshape(3, mc)
        m = layer_norm(x, fp["lnw"][i], fp["lnb"][i], eps=1e-6) * (1 + scale) + shift
        u = F.silu(_mm(m, fp["w0"][i]) + fp["b0"][i])
        x = x + gate * (_mm(u, fp["w2"][i]) + fp["b2"][i])
    shift, scale = ada[3 * depth * mc :].reshape(2, mc)
    m = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    return noise + (_mm(m, fp["wf"]) + fp["bf"])


def fused_segment_decode_reference(
    packed, flow_packed, latent, is_bos, noise, k_caches, v_caches, slot_pos, qpos0, widx0
):
    """Plain PyTorch version of fused_segment_decode (same contract)."""
    C = k_caches[0].shape[1]
    S = noise.shape[0]
    latents, eos = [], []
    x_in = packed["bos"] if is_bos else latent[0].float()
    for s in range(S):
        widx = min(int(widx0) + s, C - 1)
        h, e = backbone_frame_reference(packed, x_in, k_caches, v_caches, slot_pos, int(qpos0) + s, widx)
        x_in = flow_head_reference(flow_packed, h, noise[s].float())
        latents.append(x_in)
        eos.append(e)
    return torch.stack(latents), torch.cat(eos)


def _flow_args(fp, E: int, ldim: int, device):
    from pocket_tts_tpu_torch.ops import _cuda

    depth, mc, _ = fp["w0"].shape
    na = (3 * depth + 2) * mc
    if mc % 16 or ldim % 16:
        raise ValueError(f"the CUDA flow head takes widths that are multiples of 16; got {mc}, {ldim}")
    bf16, f32 = torch.bfloat16, torch.float32
    for name, dtype, shape in (
        ("wc", bf16, (mc, E)), ("bc", f32, (mc,)), ("tcomb", f32, (mc,)), ("win", bf16, (mc, ldim)),
        ("b_in", f32, (mc,)), ("wa", bf16, (na, mc)), ("ba", f32, (na,)), ("w0", bf16, (depth, mc, mc)),
        ("b0", f32, (depth, mc)), ("w2", bf16, (depth, mc, mc)), ("b2", f32, (depth, mc)),
        ("lnw", f32, (depth, mc)), ("lnb", f32, (depth, mc)), ("wf", bf16, (ldim, mc)), ("bf", f32, (ldim,)),
    ):
        _cuda.check_cuda_tensor(name, fp[name], dtype, shape)
    scratch = {
        "y": torch.empty(mc, dtype=f32, device=device),
        "ada": torch.empty(na, dtype=f32, device=device),
        "fx": torch.empty(mc, dtype=f32, device=device),
        "u": torch.empty(mc, dtype=f32, device=device),
    }
    args = _cuda.PttFlow()
    for name in ("wc", "bc", "tcomb", "win", "b_in", "wa", "ba", "w0", "b0", "w2", "b2", "lnw", "lnb", "wf", "bf"):
        setattr(args, name, fp[name].data_ptr())
    for name, t in scratch.items():
        setattr(args, name, t.data_ptr())
    args.MC, args.depth = mc, depth
    return args, scratch


def fused_segment_decode(
    packed, flow_packed, latent, is_bos: bool, noise, k_caches, v_caches, slot_pos, qpos0: int, widx0: int
):
    """S = noise.shape[0] decode frames -> (latents [S, ldim] float32, eos
    logits [S] float32); caches and slot_pos update in place at rows
    min(widx0 + s, C - 1).

    packed: fused_backbone.pack_backbone(...); flow_packed: pack_flow(...);
    latent [1, ldim] float32 carry (ignored at BOS); noise [S, ldim] float32
    flow starting noise (temperature applied)."""
    if not slot_pos.is_cuda:
        return fused_segment_decode_reference(
            packed, flow_packed, latent, is_bos, noise, k_caches, v_caches, slot_pos, qpos0, widx0
        )
    from pocket_tts_tpu_torch.ops import _cuda

    args, scratch = _backbone_args(packed, k_caches, v_caches, slot_pos)
    fargs, fscratch = _flow_args(flow_packed, args.E, args.ldim, slot_pos.device)
    S = noise.shape[0]
    _cuda.check_cuda_tensor("latent", latent, torch.float32, (1, args.ldim))
    _cuda.check_cuda_tensor("noise", noise, torch.float32, (S, args.ldim))
    latents = torch.empty(S, args.ldim, dtype=torch.float32, device=slot_pos.device)
    eos = torch.empty(S, dtype=torch.float32, device=slot_pos.device)
    err = _cuda.library("fused_segment").ptt_fused_segment_decode(
        ctypes.byref(args), ctypes.byref(fargs), latent.data_ptr(), int(bool(is_bos)), noise.data_ptr(),
        S, int(qpos0), int(widx0), latents.data_ptr(), eos.data_ptr(), _cuda.stream_ptr(),
    )
    if _cuda.count_launch(fused_segment_decode):
        fused_segment_decode.frames += S
    if err:
        raise RuntimeError(f"fused_segment_decode: CUDA error {err}")
    # scratch / fscratch stay referenced until here (see fused_backbone_step).
    return latents, eos


fused_segment_decode.launches = 0
fused_segment_decode.frames = 0  # decoded frames, S per launch
