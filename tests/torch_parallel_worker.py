"""Rank functions for tests/test_torch_parallel.py's spawned worlds.

The ranks import this module by name, so it imports only the PyTorch port
(never jax, the JAX package or a test module); the test passes every input
and gets back numpy results.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.generate import initial_carry, run_segment
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.models.weights import cast_serving_dtype, map_tensors, named_leaves, quantize_int8
from pocket_tts_tpu_torch.parallel.collectives import all_gather_dp
from pocket_tts_tpu_torch.parallel.dryrun import dryrun_rank
from pocket_tts_tpu_torch.parallel.mesh import (
    dp_range,
    gather_leaf,
    gather_params,
    make_mesh,
    shard_batch_tree,
    shard_params,
)
from pocket_tts_tpu_torch.training import (
    adamw,
    init_train_state,
    make_train_step,
    restore_train_state,
    save_train_state,
)

MESH_SHAPES = ((2, 2), (4, 1), (1, 4))


def tiny_model(tiny: dict, params: dict, param_dtype="float32", mesh=None, kv_int8=False) -> TTSModel:
    """tests/test_parallel.py's _tiny_tts_model: temperature 0, one flow
    step, no clamp, EOS never."""
    return TTSModel.from_params(Config(**tiny), params, FallbackWordTokenizer(4000), param_dtype, device="cpu",
                                mesh=mesh, temp=0.0, lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9,
                                kv_int8=kv_int8)


def _dp_gather(mesh, t: torch.Tensor) -> np.ndarray:
    return np.concatenate(all_gather_dp(mesh, t.float().cpu().numpy()))


def segment(tiny: dict, params: dict, emb: np.ndarray, S: int, mesh=None) -> np.ndarray:
    """Prefill B streams of emb [B, T, dim], decode one S-frame segment at
    temperature 0 and vocode it -> audio [B, S, 1920] (tests/test_parallel.py's
    test_sharded_segment_matches_unsharded, capacity 128)."""
    cfg = Config(**tiny)
    ldim = cfg.mimi.quantizer.dimension
    B, T, _ = emb.shape
    flow_lm, mimi = FlowLMModel(cfg.flow_lm, latent_dim=ldim, mesh=mesh), MimiModel(cfg.mimi, mesh)
    flow_state, mimi_state = flow_lm.init_state(B, 128), mimi.init_decode_state(B, max_chunk_frames=S)
    carry = initial_carry(B, ldim, [3] * B, [S] * B, "cpu")
    lo, hi = dp_range(mesh, B)
    if mesh is not None:
        params = shard_params(mesh, params)
        flow_state, mimi_state, carry = (shard_batch_tree(mesh, t, B) for t in (flow_state, mimi_state, carry))
    with torch.no_grad():
        flow_state = flow_lm.prefill(params["flow_lm"], flow_state, torch.tensor(emb[lo:hi]), [T] * (hi - lo))
        out = run_segment(flow_lm, mimi, params, flow_state, mimi_state, carry, torch.zeros(S, hi - lo, ldim), 1, 1e9)
    return _dp_gather(mesh, out[3]) if mesh is not None else out[3].numpy()


def decode(tiny: dict, params: dict, emb: np.ndarray, kv_int8: bool, mesh=None) -> tuple[dict, dict]:
    """Prefill emb [B, T, dim], then one decode step, with float32 weights
    and cache or (kv_int8) int8 weights and an int8 cache -> (every layer's
    k_scale and v_scale [B, C] over the whole batch (int8), the collectives
    of the decode step by op:axis)."""
    model = tiny_model(tiny, params, "int8" if kv_int8 else "float32", mesh, kv_int8=kv_int8)
    fl, fp = model.flow_lm, model.params["flow_lm"]
    B, T, _ = emb.shape
    lo, hi = dp_range(mesh, B)
    state = fl.init_state(B, 64, dtype=model.flow_state_dtype)
    if mesh is not None:
        state = shard_batch_tree(mesh, state, B)
    with torch.no_grad():
        state = fl.prefill(fp, state, torch.tensor(emb[lo:hi]), [T] * (hi - lo))
        before = dict(mesh.counts) if mesh is not None else {}
        fl.decode_step(fp, state, torch.zeros(hi - lo, fl.ldim), True, torch.zeros(hi - lo, fl.ldim), 1, 1e9)
    after = mesh.counts if mesh is not None else {}
    counts = {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}
    scales = {}
    for i, layer in enumerate(state["transformer"]["layers"] if kv_int8 else []):
        for name in ("k_scale", "v_scale"):
            scales[f"{i}.{name}"] = _dp_gather(mesh, layer[name]) if mesh is not None else layer[name].numpy()
    return scales, counts


def single_stream(model: TTSModel, inputs: dict) -> dict:
    """One stream (whole on every dp rank of a mesh): generate_audio and
    generate_audio_stream from the voice prompt, and generate_audio from a
    voice cloned from a waveform (the Mimi encoder's transformer on the
    mesh)."""
    voice = model._state_from_prompt(torch.tensor(inputs["voice"]))
    text = inputs["texts"][-1]
    return {
        "bulk": model.generate_audio(voice, text),
        "stream": np.concatenate(list(model.generate_audio_stream(voice, text))),
        "clone": model.generate_audio(model.get_state_for_audio_prompt(inputs["wave"]), text),
    }


def train_step(tiny: dict, params: dict, batch: dict, mesh=None):
    """One AdamW step of the float32 FlowLM on the whole batch with passed-in
    noise -> (state, loss, {leaf: its gradient, whole})."""
    model = tiny_model(tiny, params, "float32", mesh)
    state = init_train_state(model.flow_lm, model.params["flow_lm"], adamw(1e-3))
    inputs = [torch.tensor(batch[k]) for k in ("tokens", "latents", "eos")]
    noise = tuple(torch.tensor(batch[k]) for k in ("tau", "u", "eps"))
    state, metrics = make_train_step(model.flow_lm)(state, None, *inputs, noise=noise)
    grads = map_tensors(state.params, lambda t: t.grad)
    if mesh is not None:
        grads = gather_params(mesh, grads)
    return state, float(metrics["loss"]), {n: g.numpy() for n, g in named_leaves(grads)}


def world(tiny: dict, params: dict, inputs: dict, tmp: str) -> dict:
    """Every sharded case of the test on a (dp=2, tp=2) world of 4 ranks,
    then the dry run's stages (parallel/dryrun.dryrun_rank) on the same
    world; rank 0 returns the whole-batch results."""
    t0 = time.monotonic()
    out = {"layouts": {}}
    for dp, tp in MESH_SHAPES:
        m = make_mesh(dp, tp, "cpu")
        out["layouts"][(dp, tp)] = ((m.dp_rank, m.tp_rank), dist.get_process_group_ranks(m.dp_group),
                                    dist.get_process_group_ranks(m.tp_group))
    mesh = make_mesh(2, 2, "cpu")
    rank0 = mesh.rank == 0

    for kind, tree in (("float32", params), ("int8", quantize_int8(cast_serving_dtype(params, torch.bfloat16)))):
        back = gather_params(mesh, shard_params(mesh, tree))
        out[f"gather_exact_{kind}"] = all(
            a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(tree), named_leaves(back)))

    out["segment"] = segment(tiny, params, inputs["emb"], 3, mesh)

    model = tiny_model(tiny, params, "float32", mesh)
    voice = model._state_from_prompt(torch.tensor(inputs["voice"]))
    out["batch"] = model.generate_audio_batch(voice, inputs["texts"])
    path = Path(tmp) / "export.safetensors"
    out["export_count"] = model.save_checkpoint(path)
    out["single"] = single_stream(model, inputs)
    built = TTSModel.load_model(inputs["config"], device="cpu", dp=2, tp=2)
    out["load_model_dp_tp"] = (built.mesh.shape, tuple(built.params["flow_lm"]["transformer"]["layers"][0]
                                                       ["linear1"]["weight"].shape))

    out["int8_scales"], out["int8_counts"] = decode(tiny, params, inputs["emb"], True, mesh)
    _, out["float32_counts"] = decode(tiny, params, inputs["emb"], False, mesh)

    state, out["loss"], out["grads"] = train_step(tiny, params, inputs["train"], mesh)
    ckpt = Path(tmp) / "state.pt"
    save_train_state(state, ckpt)
    names = [n for n, _ in named_leaves(state.params)]
    moments = state.optimizer.state_dict()["state"]
    out["saved_params"] = {n: t.detach().numpy() for n, t in named_leaves(gather_params(mesh, state.params))}
    out["saved_exp_avg"] = {names[i]: gather_leaf(mesh, names[i].split("."), st["exp_avg"]).numpy()
                            for i, st in moments.items()}
    fresh = tiny_model(tiny, params, "float32", mesh)
    restored = restore_train_state(ckpt, init_train_state(fresh.flow_lm, fresh.params["flow_lm"], adamw(1e-3)))
    out["restored_on_mesh_exact"] = restored.step == state.step and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(restored.params), named_leaves(state.params))) and all(
        torch.equal(restored.optimizer.state_dict()["state"][i][k], st[k]) for i, st in moments.items()
        for k in ("exp_avg", "exp_avg_sq"))
    out["counts"] = dict(mesh.counts)
    out["seconds"] = time.monotonic() - t0
    out["dryrun"] = dryrun_rank(2, 2, "cpu", inputs["config"])
    if not rank0:
        out = {k: out[k] for k in ("layouts", "gather_exact_float32", "gather_exact_int8", "restored_on_mesh_exact",
                                   "load_model_dp_tp", "dryrun")}
    return out


# The launcher's failure cases: rank 1 fails only once every rank has joined
# the group, so that no other rank fails first while joining.


def fail_on_rank_one() -> int:
    dist.barrier()
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    return dist.get_rank()


def exit_on_rank_one() -> int:
    dist.barrier()
    if dist.get_rank() == 1:
        time.sleep(1)  # rank 0 is through the barrier and done with its peer
        os._exit(3)  # dies without a word, as a killed process would
    return dist.get_rank()


def sleep_on_rank_one() -> int:
    if dist.get_rank() == 1:
        time.sleep(120)
    return dist.get_rank()
