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
     caches, then one float32 train step of its FlowLM at B=8 x (32 text
     tokens + 125 latent frames) on a `load_model(mesh=...)` model.

It returns what a caller needs to hold the sharded runs against unsharded
ones (rank 0's audio, loss and gathered gradients, and each batch run's
capacity and read limits; every rank's kernel launches and collective
counts) and prints one summary line. The JAX dry run's third stage, an
engine tick with park and resume under the mesh, comes with the engine
under a mesh (ROADMAP queue 1).
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
TRAIN_BATCH = (8, 32, 125)  # stage 3's train step: streams, text tokens, latent frames
KERNELS = ("batch_decode_attention", "fused_backbone_step", "fused_segment_decode")


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
    from pocket_tts_tpu_torch.ops import batch_attention, fused_backbone, fused_segment

    fns = (batch_attention.batch_decode_attention, fused_backbone.fused_backbone_step,
           fused_segment.fused_segment_decode)
    return {name: fn.launches for name, fn in zip(KERNELS, fns)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def dryrun_rank(dp: int, tp: int, device_type: str, config: str) -> dict:
    """One rank of the dry run, on a world of dp * tp ranks that is up: the
    three stages above -> this rank's results (summarize reads them)."""
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
        del model
    out["frames"] = out["generation"]["int8"]["frames"]

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
    """Run the three stages on n_devices ranks of `device` ("cuda": the
    cards, or one card shared; "cpu": gloo on the host) -> summarize's
    result. Raises if any rank fails or hangs."""
    dp, tp = _pick_mesh_shape(n_devices)
    t0 = time.monotonic()
    ranks = launch(dryrun_rank, n_devices, (dp, tp, device, str(config)), device_type=device, timeout=timeout)
    return summarize(ranks, dp, tp, device, str(config), time.monotonic() - t0)


def summarize(ranks: list, dp: int, tp: int, device: str, config: str, wall_s: float) -> dict:
    """Every rank's dryrun_rank result -> rank 0's, with "launches" and
    "counts" of every rank, "dp", "tp" and "wall_s"; prints the summary
    line."""
    result = dict(ranks[0], dp=dp, tp=tp, wall_s=wall_s,
                  launches=[r["launches"] for r in ranks], counts=[r["counts"] for r in ranks])
    audio = result["segment_audio"]
    print(f"dryrun_multichip OK: {len(ranks)} ranks (dp={dp}, tp={tp}) over {result['backend']} on {device}, "
          f"generate segment audio {audio.shape}, train loss {result['toy_loss']:.4f}, {config} "
          f"generate_audio_batch of {len(DRYRUN_TEXTS)} streams decoded {result['frames']} frames with bf16 and "
          f"int8 KV, its train step at B={TRAIN_BATCH[0]} loss {result['train']['loss']:.4f}", flush=True)
    return result
