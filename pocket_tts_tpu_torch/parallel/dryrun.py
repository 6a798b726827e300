"""Multi-rank dry run: the sharded pipeline end to end on a world of N ranks
(port of pocket_tts_tpu/parallel/dryrun.py).

`dryrun_multichip(n)` starts n ranks (parallel/launch.py) on a (dp, tp)
mesh and runs, with real dp x tp shardings:

  1. the generate segment on the JAX package's toy config: prefill, the
     segment decode, the Mimi vocoder, the batch over dp and the weights
     over tp;
  2. one AdamW flow-matching train step on the toy config;
  3. `config` (the published b6369a24 by default) through the public mesh
     API: `TTSModel.load_model(mesh=..., param_dtype="int8")` and a sharded
     `generate_audio_batch` of 8 streams, with bf16 and with int8 KV
     caches;
  4. the serving engine on that model (bf16 KV, EOS disabled; the JAX dry
     run's engine tick, pocket_tts_tpu/parallel/dryrun.py:181-254): 8 slots
     over dp, each rank's KV and parking store on its heads, 8 submits
     admitted and decoded by one step(), a churn arrival that parks one
     stream, its cancel, and the parked stream's resume within 8 steps; then
     the same session at temperature 0 run to its end (`engine_session`,
     which a caller repeats on an unsharded engine);
  5. one float32 train step of `config`'s FlowLM at B=8 x (32 text tokens +
     125 latent frames) on a `load_model(mesh=...)` model.

It returns what a caller needs to hold the sharded runs against unsharded
ones (rank 0's audio, loss and gathered gradients, each batch run's
capacity and read limits, the engine sessions' audio and counters; every
rank's kernel launches, decoded engine frames and collective counts) and
prints one summary line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.default_parameters import DEFAULT_VARIANT
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.generate import initial_carry, run_segment
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.weights import map_tensors, named_leaves
from pocket_tts_tpu_torch.parallel.collectives import all_gather_dp
from pocket_tts_tpu_torch.parallel.launch import launch
from pocket_tts_tpu_torch.parallel.mesh import dp_range, gather_params, make_mesh, shard_batch_tree, shard_params

_DRYRUN_CONFIG = {
    "flow_lm": {
        "dtype": "float32",
        "flow": {"depth": 2, "dim": 32},
        "transformer": {"d_model": 64, "hidden_scale": 2, "max_period": 10000, "num_heads": 4, "num_layers": 2},
        "lookup_table": {"dim": 64, "n_bins": 256, "tokenizer": "sentencepiece", "tokenizer_path": "unused://"},
    },
    "mimi": {
        "dtype": "float32",
        "sample_rate": 24000,
        "channels": 1,
        "frame_rate": 12.5,
        "seanet": {
            "dimension": 48, "channels": 1, "n_filters": 4, "n_residual_layers": 1, "ratios": [6, 5, 4],
            "kernel_size": 7, "residual_kernel_size": 3, "last_kernel_size": 3, "dilation_base": 2,
            "pad_mode": "constant", "compress": 2,
        },
        "transformer": {
            "d_model": 48, "num_heads": 4, "num_layers": 1, "layer_scale": 0.01, "context": 32,
            "dim_feedforward": 96, "input_dimension": 48, "output_dimensions": [48],
        },
        "quantizer": {"dimension": 8, "output_dimension": 48},
    },
}

# The streams of stage 3: eight texts of 2 to 8 words, one 64-frame segment.
DRYRUN_TEXTS = [
    "The quick brown fox.",
    "It was a bright cold day in April.",
    "A grey sky full of birds.",
    "Hello there.",
    "Every clock keeps time.",
    "Rivers run down to the sea.",
    "The clocks were striking thirteen.",
    "She read the letter twice.",
]
TRAIN_BATCH = (8, 32, 125)  # stage 5's train step: streams, text tokens, latent frames
# Stage 4, the JAX dry run's engine tick: 8 slots of 4-frame segments, every
# running stream preemptable and every parked one resumed at once.
ENGINE_KW = dict(slots=8, segment_frames=4, capacity=512, text_pad=16, warmup_frames=0, preempt_min_lead_s=-1e9,
                 resume_urgent_lead_s=-1e9, max_parked=2)
ENGINE_TEXTS = [f"Dry run stream number {i}." for i in range(8)]
CHURN_TEXT = "Churn arrival while saturated."
RESUME_STEPS = 8  # the parked stream resumes within this many steps
MAX_SESSION_STEPS = 200
KERNELS = ("batch_decode_attention", "fused_backbone_step", "fused_segment_decode", "int8_linear")


def _pick_mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp): the largest tp in {4, 2, 1} that divides n and leaves dp >=
    2, so that both axes run (at n=4 the JAX package's rule picks tp=4 and
    leaves dp at 1); n < 2 or an odd n gives tp=1."""
    for tp in (4, 2, 1):
        if n_devices % tp == 0 and n_devices // tp >= 2:
            return n_devices // tp, tp
    return max(1, n_devices), 1


def train_batch(n_bins: int, ldim: int, B: int, Tt: int, Tl: int, seed: int):
    """Seeded tokens [B, Tt], latents [B, Tl, ldim] and EOS labels (1 on
    each stream's last frame), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, n_bins, (B, Tt), generator=gen)
    latents = torch.randn(B, Tl, ldim, generator=gen)
    eos = torch.zeros(B, Tl)
    eos[:, -1] = 1.0
    return tokens, latents, eos


def _launches() -> dict:
    from pocket_tts_tpu_torch.ops import batch_attention, fused_backbone, fused_segment, linear

    fns = (batch_attention.batch_decode_attention, fused_backbone.fused_backbone_step,
           fused_segment.fused_segment_decode, linear.int8_linear)
    return {name: fn.launches for name, fn in zip(KERNELS, fns)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def engine_voice(model):
    """The engine stage's voice: a seeded 25-row prompt (a collective prefill
    on a mesh)."""
    prompt = torch.randn(1, 25, model.flow_lm.dim, generator=torch.Generator().manual_seed(11)) * 0.02
    return model._state_from_prompt(prompt)


def _queued(handle) -> list:
    """The frames waiting in a handle's queue (taken out)."""
    frames = []
    while not handle._queue.empty():
        frame = handle._queue.get_nowait()
        if frame is not None:
            frames.append(frame)
    return frames


def engine_session(engine, voice, to_end: bool) -> dict:
    """The engine stage's steps on an engine (rank 0's of a mesh engine, or
    an unsharded one): the 8 texts submitted, one step() that admits all 8
    and delivers first_segment_frames frames of each, a churn arrival whose
    step parks one stream, the churn cancelled, steps until the parked
    stream resumes (at most RESUME_STEPS), and with to_end steps until every
    request is done -> its counters, step walls and (to_end) each request's
    audio. Raises where a step does not do its part."""
    walls = []

    def step() -> int:
        t0 = time.monotonic()
        active = engine.step()
        walls.append(time.monotonic() - t0)
        return active

    handles = [engine.submit(t, voice, frames_after_eos=1) for t in ENGINE_TEXTS]
    if step() != len(handles):
        raise RuntimeError("the first engine step must admit every submitted stream")
    first = sum(h._frames_delivered for h in handles)
    if first != engine.first_segment_frames * len(handles):
        raise RuntimeError(f"the first engine step delivered {first} frames")
    churn = engine.submit(CHURN_TEXT, voice, frames_after_eos=1)
    step()
    if engine.preemptions < 1 or churn._frames_delivered < 1:
        raise RuntimeError("the churn arrival must park a running stream and decode")
    churn.cancel()
    while engine.resumes < 1 and len(walls) < 2 + RESUME_STEPS:
        step()
    if engine.resumes < 1:
        raise RuntimeError(f"the parked stream did not resume within {RESUME_STEPS} steps")
    handles.append(churn)
    out = {"first_frames": first, "parks": engine.preemptions, "resumes": engine.resumes}
    if to_end:
        while not all(h.done for h in handles) and len(walls) < MAX_SESSION_STEPS:
            step()
        out["audio"] = [h.audio() for h in handles]
    else:
        out["audio"] = None
        frames = [f for h in handles for f in _queued(h)]
        if not all(np.isfinite(f).all() for f in frames):
            raise RuntimeError("the engine delivered non-finite frames")
    out.update(walls=walls, frames=engine.frames_dispatched)
    return out


def _engine_stage(model, mesh) -> dict:
    """Stage 4 on every rank -> rank 0's sessions (the default temperature,
    then temperature 0 to the end) and every rank's decoded frames and
    kernel launches."""
    from pocket_tts_tpu_torch.default_parameters import DEFAULT_TEMPERATURE
    from pocket_tts_tpu_torch.serving.engine import TTSEngine

    out, frames, t0 = {}, 0, time.monotonic()
    before = _launches()
    for name, temp in (("tick", DEFAULT_TEMPERATURE), ("exact", 0.0)):
        model.temp = temp
        voice = engine_voice(model)
        engine = TTSEngine(model, **ENGINE_KW)
        k = engine.flow_state["transformer"]["layers"][0]["k"]
        store_k = engine._store_flow["transformer"]["layers"][0]["k"]
        heads, d = model.config.flow_lm.transformer.num_heads // mesh.tp, k.shape[-1]
        want = [(ENGINE_KW["slots"] // mesh.dp, ENGINE_KW["capacity"], heads, d),
                (ENGINE_KW["max_parked"], ENGINE_KW["capacity"], heads, d)]
        if [tuple(k.shape), tuple(store_k.shape)] != want:
            raise RuntimeError(f"engine KV {tuple(k.shape)} and store {tuple(store_k.shape)} on rank {mesh.rank}: "
                               f"expected this rank's slots and heads, {want}")
        if mesh.rank == 0:
            out[name] = engine_session(engine, voice, to_end=name == "exact")
            engine.stop()  # ends the followers' run()
        else:
            engine.run()
        frames += engine.frames_dispatched
    _sync(mesh.device)
    out.update(frames=frames, launches={k: v - before[k] for k, v in _launches().items()},
               wall=time.monotonic() - t0)
    return out


def dryrun_rank(dp: int, tp: int, device_type: str, config: str) -> dict:
    """One rank of the dry run, on a world of dp * tp ranks that is up: the
    five stages above -> this rank's results (summarize reads them)."""
    from pocket_tts_tpu_torch.models.tts_model import TTSModel
    from pocket_tts_tpu_torch.training import adamw, init_train_state, make_train_step
    from pocket_tts_tpu_torch.training.flow_matching import flow_noise

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    mesh = make_mesh(dp, tp, device_type)
    dev, out = mesh.device, {"rank": mesh.rank, "backend": mesh.backend, "walls": {}}

    # ------------------------------------------------ 1. generate segment
    cfg = Config(**_DRYRUN_CONFIG)
    ldim = cfg.mimi.quantizer.dimension
    flow_m, mimi_m = FlowLMModel(cfg.flow_lm, latent_dim=ldim, mesh=mesh), MimiModel(cfg.mimi, mesh)
    gen = torch.Generator().manual_seed(0)
    params = shard_params(mesh, {"flow_lm": flow_m.init_params(gen), "mimi": mimi_m.init_params(gen)})
    B, S = 2 * dp, 2  # two streams per dp rank
    flow_state = shard_batch_tree(mesh, flow_m.init_state(B, 128), B)  # caches of this rank's heads
    mimi_state = shard_batch_tree(mesh, mimi_m.init_decode_state(B, max_chunk_frames=S), B)
    lo, hi = dp_range(mesh, B)
    emb = torch.randn(B, 8, flow_m.dim, generator=gen)[lo:hi].to(dev)
    with torch.no_grad():
        flow_state = flow_m.prefill(params["flow_lm"], flow_state, emb, [8] * (hi - lo))
        carry = shard_batch_tree(mesh, initial_carry(B, ldim, [3] * B, [4] * B, "cpu"), B)
        noise = (torch.randn(S, B, ldim, generator=gen) * 0.7 ** 0.5)[:, lo:hi].to(dev)
        seg = run_segment(flow_m, mimi_m, params, flow_state, mimi_state, carry, noise, 1, -4.0)
    audio = np.concatenate(all_gather_dp(mesh, seg[3].cpu().numpy()))
    if audio.shape != (B, S, 1920) or not np.isfinite(audio).all():
        raise RuntimeError(f"sharded generate segment gave {audio.shape}, finite: {np.isfinite(audio).all()}")

    # ------------------------------------------------ 2. train step (toy)
    state = init_train_state(flow_m, params["flow_lm"], adamw(1e-4))
    tokens, latents, eos = (t.to(dev) for t in train_batch(255, ldim, B, 6, 5, seed=3))
    rng = torch.Generator(device=dev).manual_seed(5)
    state, metrics = make_train_step(flow_m)(state, rng, tokens, latents, eos)
    toy_loss = float(metrics["loss"])
    if not np.isfinite(toy_loss):
        raise RuntimeError(f"sharded train step loss {toy_loss}")
    out.update(segment_audio=audio, toy_loss=toy_loss)
    out["walls"]["toy_stages"] = time.monotonic() - t0

    # ------------------------------------------------ 3. `config` through the public mesh API
    out["batch"], out["launches"], out["generation"] = {}, {}, {}
    for kv in ("bf16", "int8"):
        t0 = time.monotonic()
        model = TTSModel.load_model(config, temp=0.0, eos_threshold=1e9, param_dtype="int8", device=device_type,
                                    mesh=mesh, kv_int8=kv == "int8", allow_random_init=True)
        voice = model.get_state_for_audio_prompt("alba")
        out["walls"][f"load_{kv}"] = time.monotonic() - t0
        before = _launches()
        _sync(dev)
        t0 = time.monotonic()
        audios = model.generate_audio_batch(voice, DRYRUN_TEXTS)
        _sync(dev)
        out["walls"][f"batch_{kv}"] = time.monotonic() - t0
        out["launches"][kv] = {k: v - before[k] for k, v in _launches().items()}
        out["generation"][kv] = dict(model.last_generation)  # its frames, capacity and read limits
        if len(audios) != len(DRYRUN_TEXTS) or any(
                a.ndim != 1 or a.shape[0] == 0 or a.shape[0] % 1920 or not np.isfinite(a).all() for a in audios):
            raise RuntimeError(f"sharded generate_audio_batch ({kv} KV) must return finite whole frames per stream")
        out["batch"][kv] = audios if mesh.rank == 0 else None
        if kv == "bf16":
            engine_model = model
        del model
    out["frames"] = out["generation"]["int8"]["frames"]

    # ------------------------------------------------ 4. the serving engine on the mesh
    out["engine"] = _engine_stage(engine_model, mesh)
    del engine_model

    # ------------------------------------------------ 5. train step of `config`

    t0 = time.monotonic()
    model = TTSModel.load_model(config, device=device_type, mesh=mesh, allow_random_init=True)
    out["walls"]["load_float32"] = time.monotonic() - t0
    flow_m = model.flow_lm
    state = init_train_state(flow_m, model.params["flow_lm"], adamw(1e-3))
    del model
    Bt, Tt, Tl = TRAIN_BATCH
    batch = [t.to(dev) for t in train_batch(flow_m.n_bins, flow_m.ldim, Bt, Tt, Tl, seed=3)]
    noise = tuple(t.to(dev) for t in flow_noise(torch.Generator().manual_seed(4), Bt, Tl, flow_m.ldim))
    _sync(dev)
    t0 = time.monotonic()
    state, metrics = make_train_step(flow_m)(state, None, *batch, noise=noise)
    _sync(dev)
    out["walls"]["train_step"] = time.monotonic() - t0
    t0 = time.monotonic()
    grads = gather_params(mesh, map_tensors(state.params, lambda t: t.grad))
    out["train"] = {"loss": float(metrics["loss"]),
                    "grads": {n: g.cpu().numpy() for n, g in named_leaves(grads)} if mesh.rank == 0 else None}
    out["walls"]["gather_grads"] = time.monotonic() - t0
    out["counts"] = dict(mesh.counts)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", config: str = DEFAULT_VARIANT,
                     timeout: float = 900.0) -> dict:
    """Run the five stages on n_devices ranks of `device` ("cuda": the
    cards, or one card shared; "cpu": gloo on the host) -> summarize's
    result. Raises if any rank fails or hangs."""
    dp, tp = _pick_mesh_shape(n_devices)
    t0 = time.monotonic()
    ranks = launch(dryrun_rank, n_devices, (dp, tp, device, str(config)), device_type=device, timeout=timeout)
    return summarize(ranks, dp, tp, device, str(config), time.monotonic() - t0)


def summarize(ranks: list, dp: int, tp: int, device: str, config: str, wall_s: float) -> dict:
    """Every rank's dryrun_rank result -> rank 0's, with "launches",
    "counts" and "engine_ranks" (each rank's engine frames and launches) of
    every rank, "dp", "tp" and "wall_s"; prints the summary line."""
    result = dict(ranks[0], dp=dp, tp=tp, wall_s=wall_s,
                  launches=[r["launches"] for r in ranks], counts=[r["counts"] for r in ranks],
                  engine_ranks=[{"frames": r["engine"]["frames"], "launches": r["engine"]["launches"]} for r in ranks])
    audio, tick = result["segment_audio"], result["engine"]["tick"]
    print(f"dryrun_multichip OK: {len(ranks)} ranks (dp={dp}, tp={tp}) over {result['backend']} on {device}, "
          f"generate segment audio {audio.shape}, train loss {result['toy_loss']:.4f}, {config} "
          f"generate_audio_batch of {len(DRYRUN_TEXTS)} streams decoded {result['frames']} frames with bf16 and "
          f"int8 KV, its engine tick delivered {tick['first_frames']} frames; churn preemption under the mesh OK "
          f"({tick['parks']} park(s), {tick['resumes']} resume(s) through the parking store), its train step at "
          f"B={TRAIN_BATCH[0]} loss {result['train']['loss']:.4f}", flush=True)
    return result
