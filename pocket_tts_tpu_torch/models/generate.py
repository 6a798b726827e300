"""One decode segment: S FlowLM frames, vectorized EOS bookkeeping, one
Mimi vocode of the whole segment (port of pocket_tts_tpu/models/generate.py).

Dispatch follows the JAX package: a segment runs the whole-segment kernel
(ops/fused_segment.fused_segment_decode) when B == 1, lsd_decode_steps == 1,
the model carries packed int8 kernel weights, the cache is not int8 and
S % 8 == 0; otherwise it loops over frames with flow_lm.decode_step, whose
B=1 int8 steps run the per-frame kernel (ops/fused_backbone.fused_backbone_step)
and whose batch steps attend through ops/batch_attention.batch_decode_attention.
Given the model's StepGraphs, batch steps on the card replay a captured CUDA
graph of that step instead (models/step_graph.py).
With the span recorder on (utils/trace.py), `segment.flow` covers the FlowLM
frames (its `replayed` attribute: the frames that replayed a captured step)
and `segment.mimi` the vocode.
"""

from __future__ import annotations

import torch

from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.step_graph import StepGraphs
from pocket_tts_tpu_torch.ops.fused_segment import fused_segment_decode
from pocket_tts_tpu_torch.utils import trace


def decode_mimi_chunk(flow_params, mimi_params, mimi: MimiModel, latents, mimi_state):
    """Denormalize S latents [B, S, ldim] and vocode them as one streaming
    chunk -> (audio [B, S, frame] float32, new mimi state)."""
    B, S, _ = latents.shape
    mimi_in = (latents * flow_params["emb_std"] + flow_params["emb_mean"]).transpose(1, 2)
    wav, mimi_state = mimi.decode_from_latent(mimi_params, mimi.quantize(mimi_params, mimi_in), mimi_state)
    return wav.reshape(B, S, wav.shape[-1] // S), mimi_state


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """Float audio in [-1, 1] -> int16 PCM, as a 16-bit WAV writer rounds it."""
    return (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def initial_carry(batch: int, ldim: int, frames_after_eos, max_gen, device) -> dict:
    """Fresh decode carry: per-stream BOS flags, EOS sentinels and step
    counters (the engine admits streams into slots mid-flight), and `tick`,
    the batch-common count of decoded frames."""
    return {
        "latent": torch.zeros(batch, ldim, dtype=torch.float32, device=device),
        "is_bos": torch.ones(batch, dtype=torch.bool, device=device),
        "eos_step": torch.full((batch,), 2**30, dtype=torch.int64, device=device),
        "step": torch.zeros(batch, dtype=torch.int64, device=device),
        "tick": 0,
        "frames_after_eos": torch.as_tensor(frames_after_eos, dtype=torch.int64, device=device),
        "max_gen": torch.as_tensor(max_gen, dtype=torch.int64, device=device),
    }


def segment_kernel_ok(flow_lm: FlowLMModel, flow_params, flow_state, lsd_decode_steps: int, S: int) -> bool:
    """The JAX package's dispatch rule for the whole-segment kernel: the
    per-frame kernel's (which holds the kernels' capacity limit and keeps
    them off on a mesh), one flow step and whole 8-frame groups."""
    return (flow_lm.fused_step_ok(flow_params, flow_state, len(flow_state["pos"])) and lsd_decode_steps == 1
            and "fused_flow" in flow_params and S % 8 == 0)


def step_graph_ok(flow_lm: FlowLMModel, flow_params, flow_state, lsd_decode_steps: int, S: int) -> bool:
    """Whether a segment's frames replay a captured step
    (models/step_graph.py): B > 1 on a CUDA device off a mesh, where the
    frame loop would otherwise run the plain step (no B=1 kernel)."""
    B = len(flow_state["pos"])
    return (B > 1 and flow_state["transformer"]["layers"][0]["k"].is_cuda and flow_lm.mesh is None
            and not flow_lm.fused_step_ok(flow_params, flow_state, B)
            and not segment_kernel_ok(flow_lm, flow_params, flow_state, lsd_decode_steps, S))


def run_segment(
    flow_lm: FlowLMModel,
    mimi: MimiModel,
    params: dict,
    flow_state: dict,
    mimi_state: dict,
    carry: dict,
    noise_seq: torch.Tensor,  # [S, B, ldim] flow starting noise
    lsd_decode_steps: int,
    eos_threshold: float,
    emit_pcm16: bool = False,
    read_limit: int | None = None,
    step_graphs: StepGraphs | None = None,
):
    """Decode one segment -> (flow_state, mimi_state, carry, audio [B, S,
    frame], emit [B, S] bool, all_done bool tensor). Caches update in place.
    read_limit bounds the cache rows the per-frame attention reads; the
    caller guarantees widx + S <= read_limit. The carry's `is_bos` and
    `step` are per stream ([B] tensors); the B=1 kernels take the BOS flag
    as a host bool, one device read per segment. `step_graphs` (the
    model's) replays batch steps on the card where step_graph_ok allows."""
    flow_params, mimi_params = params["flow_lm"], params["mimi"]
    S, B, _ = noise_seq.shape
    replayed = 0
    with trace.span("segment.flow") as flow_span:
        if segment_kernel_ok(flow_lm, flow_params, flow_state, lsd_decode_steps, S):
            tstate = flow_state["transformer"]
            layers = tstate["layers"]
            lat, eos_logits = fused_segment_decode(
                flow_params["fused_backbone"], flow_params["fused_flow"], carry["latent"], carry["is_bos"],
                noise_seq[:, 0, :], [l["k"] for l in layers], [l["v"] for l in layers],
                layers[0]["slot_pos"], flow_state["pos"][0], tstate["widx"],
            )
            tstate["widx"] += S
            flow_state["pos"] = [p + S for p in flow_state["pos"]]
            latents = lat[:, None, :]  # [S, 1, ldim]
            eos_flags = (eos_logits > eos_threshold)[:, None]  # [S, 1]
        elif step_graphs is not None and step_graph_ok(flow_lm, flow_params, flow_state, lsd_decode_steps, S):
            latents, eos_flags, replayed = step_graphs.decode(
                flow_lm, flow_params, flow_state, carry["latent"], carry["is_bos"], noise_seq, lsd_decode_steps,
                eos_threshold, read_limit,
            )
        else:
            if step_graphs is not None and B > 1 and noise_seq.is_cuda:
                step_graphs.eager_steps += S
            latent, is_bos = carry["latent"], carry["is_bos"]
            lat_list, eos_list = [], []
            for i in range(S):
                flow_state, latent, is_eos = flow_lm.decode_step(
                    flow_params, flow_state, latent, is_bos, noise_seq[i], lsd_decode_steps, eos_threshold,
                    read_limit=read_limit,
                )
                is_bos = False
                lat_list.append(latent)
                eos_list.append(is_eos)
            latents, eos_flags = torch.stack(lat_list), torch.stack(eos_list)
        if flow_span is not trace.OFF:
            flow_span.set(replayed=replayed)

    # Vectorized EOS bookkeeping: the running eos_step at frame i (after
    # folding frame i's own flag) is the prefix-min of flagged step indices.
    device = latents.device
    steps = carry["step"] + torch.arange(S, dtype=torch.int64, device=device)[:, None]  # [S, B]
    cand = torch.where(eos_flags, steps, torch.full_like(steps, 2**30))
    eos_step_seq = torch.minimum(carry["eos_step"][None, :], torch.cummin(cand, dim=0).values)  # [S, B]
    emit = (steps < eos_step_seq + carry["frames_after_eos"][None, :]) & (steps < carry["max_gen"][None, :])
    carry = {
        **carry,
        "latent": latents[-1],
        "is_bos": torch.zeros_like(carry["is_bos"]),
        "eos_step": eos_step_seq[-1],
        "step": carry["step"] + S,
        "tick": carry["tick"] + S,
    }
    with trace.span("segment.mimi"):
        audio, mimi_state = decode_mimi_chunk(flow_params, mimi_params, mimi, latents.transpose(0, 1), mimi_state)
        if emit_pcm16:
            audio = to_pcm16(audio)
    steps_target = torch.minimum(carry["eos_step"] + carry["frames_after_eos"] + 1, carry["max_gen"])
    all_done = torch.all(carry["step"] >= steps_target)
    return flow_state, mimi_state, carry, audio, emit.transpose(0, 1), all_done
