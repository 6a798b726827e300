#!/usr/bin/env python3
"""Drive the PyTorch port's B=1 int8 main path once on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA kernels from pocket_tts_tpu_torch/csrc with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, at the
     b6369a24 geometry with a prefilled C=256 cache: fused_backbone_step for
     a BOS and a non-BOS frame, fused_segment_decode at S=8 and S=64
     (outputs, full updated caches, slot_pos);
  4. the main path: TTSModel.load_model(param_dtype="int8") at b6369a24
     width (seeded random weights), the "alba" voice, generate_audio_stream
     and generate_audio on a two-sentence text; every streamed frame is 1920
     finite samples, copy_state=True leaves the voice state bit-identical,
     both kernels launch and every decoded frame goes through one of them,
     a WAV is written;
  5. at the cache capacity the main path decoded at: each kernel against
     its plain version once more, then warm timings beside the card's name
     and power limit: each kernel and its plain version, generate_audio's
     real-time factor and generate_audio_stream's time to first audio
     (medians of several warm runs).

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TEXT = "The quick brown fox jumps over the lazy dog. It was a bright cold day in April."
C_TEST = 256  # cache capacity of the first kernel comparisons (two 128-slot buckets)
RUNS_RTF, RUNS_TTFA = 5, 9  # warm runs behind each end-to-end median

# Tolerances of kernel vs plain version. Both round at the same points (bf16
# activations, q/k/v, softmax weights and FF hidden; float32 sums); they differ
# by float32 summation order and libm ulps, and such a difference can flip one
# bf16 rounding, which later layers and frames carry on. The bounds are the
# JAX package's own parity gates for the same kernels
# (tests/test_fused_backbone.py: 2e-2 on h and caches; tests/test_fused_segment.py:
# 0.15 on latents and caches, mean latent error < 2e-2), widened for the
# one-frame kernel to 5e-2 on the EOS logit, a 1024-term dot product of h.
TOL_STEP = 2e-2
TOL_EOS = 5e-2
TOL_SEGMENT = 0.15
TOL_SEGMENT_MEAN = 2e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main() -> None:
    if not (ROOT / "pocket_tts_tpu_torch").is_dir():
        fail("pocket_tts_tpu_torch/ not found next to chip_smoke.py; run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from pocket_tts_tpu_torch.models.tts_model import TTSModel
    from pocket_tts_tpu_torch.ops import _cuda
    from pocket_tts_tpu_torch.ops.fused_backbone import fused_backbone_step, fused_backbone_step_reference
    from pocket_tts_tpu_torch.ops.fused_segment import fused_segment_decode, fused_segment_decode_reference

    # ---------------------------------------------------------------- phase 2
    t0 = time.monotonic()
    for name in ("fused_backbone", "fused_segment"):
        _cuda.library(name)
    print(f"build: {time.monotonic() - t0:.1f} s  {json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    for name in ("fused_backbone", "fused_segment"):
        for line in _cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    t0 = time.monotonic()
    # Random weights make the EOS logit cross the default threshold at once;
    # disable EOS so every run decodes its full schedule (as bench.py does).
    model = TTSModel.load_model(param_dtype="int8", device="cuda", seed=0, eos_threshold=1e9)
    print(f"load_model(int8, b6369a24): {time.monotonic() - t0:.1f} s", flush=True)
    fl = model.params["flow_lm"]
    packed, flow_packed = fl["fused_backbone"], fl["fused_flow"]
    ldim = model.flow_lm.ldim
    gen = torch.Generator().manual_seed(1)

    def prefilled(capacity):
        state = model.flow_lm.init_state(1, capacity, dtype=torch.bfloat16, device=dev)
        prompt = (torch.randn(1, 100, model.flow_lm.dim, generator=gen) * 0.3).to(dev)
        with torch.no_grad():
            state = model.flow_lm.prefill(fl, state, prompt, [100])
        sp = state["transformer"]["layers"][0]["slot_pos"]
        sp[0, torch.randperm(100, generator=gen)[:12].to(dev)] = -1  # holes in the history
        return state

    def cache_args(state):
        layers = state["transformer"]["layers"]
        return [l["k"] for l in layers], [l["v"] for l in layers], layers[0]["slot_pos"]

    def compare_states(tag, a, b, tol):
        err = 0.0
        for la, lb in zip(a["transformer"]["layers"], b["transformer"]["layers"]):
            err = max(err, max_err(la["k"], lb["k"]), max_err(la["v"], lb["v"]))
        sp_ok = torch.equal(a["transformer"]["layers"][0]["slot_pos"], b["transformer"]["layers"][0]["slot_pos"])
        if err > tol or not sp_ok:
            fail(f"{tag}: caches differ by {err:.4g} (tol {tol}), slot_pos equal: {sp_ok}")
        return err

    errs = {"fused_backbone_step": 0.0, "fused_segment_decode": 0.0}
    latent = torch.randn(1, ldim, generator=gen).to(dev)

    def compare_step(base, is_bos, qpos):
        C = base["transformer"]["layers"][0]["k"].shape[1]
        sk, sr = copy.deepcopy(base), copy.deepcopy(base)
        hk, ek = fused_backbone_step(packed, latent, is_bos, *cache_args(sk), qpos, qpos)
        hr, er = fused_backbone_step_reference(packed, latent, is_bos, *cache_args(sr), qpos, qpos)
        torch.cuda.synchronize()
        e_h, e_eos = max_err(hk, hr), max_err(ek, er)
        e_c = compare_states(f"fused_backbone_step C={C} bos={is_bos}", sk, sr, TOL_STEP)
        if not (e_h <= TOL_STEP and e_eos <= TOL_EOS):
            fail(f"fused_backbone_step C={C} bos={is_bos}: h err {e_h:.4g}, eos err {e_eos:.4g}")
        errs["fused_backbone_step"] = max(errs["fused_backbone_step"], e_h, e_c)
        print(f"fused_backbone_step C={C} bos={is_bos}: max|h| err {e_h:.3g}, eos err {e_eos:.3g}, "
              f"cache err {e_c:.3g} (tol {TOL_STEP}; eos {TOL_EOS})", flush=True)

    def compare_segment(base, S, is_bos):
        C = base["transformer"]["layers"][0]["k"].shape[1]
        sk, sr = copy.deepcopy(base), copy.deepcopy(base)
        noise = (torch.randn(S, ldim, generator=gen) * 0.8).to(dev)
        lk, ek = fused_segment_decode(packed, flow_packed, latent, is_bos, noise, *cache_args(sk), 100, 100)
        lr, er = fused_segment_decode_reference(packed, flow_packed, latent, is_bos, noise, *cache_args(sr), 100, 100)
        torch.cuda.synchronize()
        e_l, e_mean, e_eos = max_err(lk, lr), float((lk - lr).abs().mean()), max_err(ek, er)
        e_c = compare_states(f"fused_segment_decode C={C} S={S}", sk, sr, TOL_SEGMENT)
        if not (e_l <= TOL_SEGMENT and e_mean <= TOL_SEGMENT_MEAN and e_eos <= TOL_SEGMENT):
            fail(f"fused_segment_decode C={C} S={S}: latent err {e_l:.4g} (mean {e_mean:.4g}), eos err {e_eos:.4g}")
        errs["fused_segment_decode"] = max(errs["fused_segment_decode"], e_l, e_c)
        print(f"fused_segment_decode C={C} S={S} bos={is_bos}: max latent err {e_l:.3g} (mean {e_mean:.3g}), "
              f"eos err {e_eos:.3g}, cache err {e_c:.3g} (tol {TOL_SEGMENT}, mean {TOL_SEGMENT_MEAN})",
              flush=True)

    with torch.no_grad():
        base = prefilled(C_TEST)
        compare_step(base, True, 100)
        compare_step(base, False, 101)
        compare_segment(base, 8, True)
        compare_segment(base, 64, False)

    # ---------------------------------------------------------------- phase 4
    voice = model.get_state_for_audio_prompt("alba")
    snapshot = copy.deepcopy(voice.tree)
    fused_backbone_step.launches = 0
    fused_segment_decode.launches = 0
    fused_segment_decode.frames = 0
    t0 = time.monotonic()
    stream = model.generate_audio_stream(voice, TEXT)
    first = next(stream)
    torch.cuda.synchronize()
    ttfa_cold = time.monotonic() - t0
    frames = [first, *stream]
    bulk = model.generate_audio(voice, TEXT)
    # Frame accounting: a copy_state=False run advances the write index by
    # the padded prompt plus every decoded frame.
    work = type(voice)(copy.deepcopy(voice.tree), voice.pos, voice.written)
    kernel_frames0 = fused_backbone_step.launches + fused_segment_decode.frames
    list(model.generate_audio_stream(work, TEXT, copy_state=False))
    n_tok = len(model.tokenizer.encode(TEXT))
    t_pad = max(32, -(-n_tok // 32) * 32)
    decoded = work.written - voice.written - t_pad
    kernel_frames = fused_backbone_step.launches + fused_segment_decode.frames - kernel_frames0
    torch.cuda.synchronize()
    launches = {"fused_backbone_step": fused_backbone_step.launches,
                "fused_segment_decode": fused_segment_decode.launches}
    c_main = model.flow_lm.state_capacity(work.tree)  # the cache capacity the main path decoded at
    print(f"main path: {len(frames)} streamed frames, bulk {bulk.shape[0]} samples, launches {launches}, "
          f"accounting run decoded {decoded} frames, {kernel_frames} through the kernels, "
          f"cache capacity C={c_main}", flush=True)
    if not frames or any(f.shape != (1920,) or not bool(torch.isfinite(torch.from_numpy(f)).all()) for f in frames):
        fail("streamed frames must each be 1920 finite samples")
    if bulk.ndim != 1 or bulk.shape[0] == 0 or bulk.shape[0] % 1920 or not bool(torch.isfinite(torch.from_numpy(bulk)).all()):
        fail(f"generate_audio returned {bulk.shape}, not a non-empty finite multiple of 1920 samples")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if decoded <= 0 or kernel_frames != decoded:
        fail(f"{decoded} frames decoded but {kernel_frames} went through the kernels")
    same = all(
        torch.equal(a, b)
        for a, b in zip(_tensors(voice.tree), _tensors(snapshot))
    )
    if not same:
        fail("copy_state=True changed the voice state")
    from pocket_tts_tpu_torch.data.audio import audio_write

    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "out.wav"
        audio_write(wav, bulk, model.sample_rate)
        print(f"wrote {wav.stat().st_size} bytes of WAV ({bulk.shape[0] / model.sample_rate:.2f} s)", flush=True)

    # ---------------------------------------------------------------- phase 5
    def device_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    timings = {}
    with torch.no_grad():
        # The kernels once more against their plain versions, now at the
        # capacity the main path decoded at, then timed there.
        st = prefilled(c_main)
        compare_step(st, False, 100)
        compare_segment(st, 64, False)
        ks, vs, sp = cache_args(st)
        timings["fused_backbone_step"] = (
            device_ms(lambda: fused_backbone_step(packed, latent, False, ks, vs, sp, 100, 100), 50),
            device_ms(lambda: fused_backbone_step_reference(packed, latent, False, ks, vs, sp, 100, 100), 10),
        )
        noise = torch.zeros(64, ldim, device=dev)
        timings["fused_segment_decode"] = tuple(
            t / 64
            for t in (
                device_ms(lambda: fused_segment_decode(packed, flow_packed, latent, False, noise, ks, vs, sp, 100, 100), 5),
                device_ms(lambda: fused_segment_decode_reference(packed, flow_packed, latent, False, noise, ks, vs, sp, 100, 100), 2),
            )
        )
    for name, (ms, plain_ms) in timings.items():
        print(f"{name}: {ms:.4f} ms/frame (CUDA kernel) vs {plain_ms:.4f} ms/frame (plain PyTorch), "
              f"C={c_main} warm, CUDA events [{card}]", flush=True)

    walls = []
    for _ in range(RUNS_RTF):
        t0 = time.monotonic()
        bulk = model.generate_audio(voice, TEXT)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    seconds = bulk.shape[0] / model.sample_rate
    rtfs = sorted(seconds / w for w in walls)
    ttfas = []
    for _ in range(RUNS_TTFA):
        t0 = time.monotonic()
        stream = model.generate_audio_stream(voice, TEXT)
        next(stream)
        torch.cuda.synchronize()
        ttfas.append((time.monotonic() - t0) * 1000)
        stream.close()  # copy_state=True: the voice state is untouched by the unfinished run
    ttfas.sort()
    print(f"generate_audio: {seconds:.2f} s of audio, RTF median {statistics.median(rtfs):.1f}x real time "
          f"(min {rtfs[0]:.1f}, max {rtfs[-1]:.1f}; {RUNS_RTF} warm runs) [{card}]", flush=True)
    print(f"generate_audio_stream: time to first audio median {statistics.median(ttfas):.1f} ms "
          f"(min {ttfas[0]:.1f}, max {ttfas[-1]:.1f}; {RUNS_TTFA} warm runs), "
          f"{ttfa_cold * 1000:.1f} ms first call [{card}]", flush=True)

    kernels = [
        {
            "name": "fused_backbone_step", "route": "cuda",
            "source": "pocket_tts_tpu_torch/csrc/fused_backbone.cu",
            "replaces": "pocket_tts_tpu/ops/fused_backbone.py:1080",
            "launches": launches["fused_backbone_step"], "max_abs_err": errs["fused_backbone_step"],
            "ms": timings["fused_backbone_step"][0], "plain_ms": timings["fused_backbone_step"][1],
        },
        {
            "name": "fused_segment_decode", "route": "cuda",
            "source": "pocket_tts_tpu_torch/csrc/fused_segment.cu",
            "replaces": "pocket_tts_tpu/ops/fused_segment.py:709",
            "launches": launches["fused_segment_decode"], "max_abs_err": errs["fused_segment_decode"],
            "ms": timings["fused_segment_decode"][0], "plain_ms": timings["fused_segment_decode"][1],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def _tensors(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _tensors(item)
    elif hasattr(tree, "shape"):
        yield tree


if __name__ == "__main__":
    main()
