#!/usr/bin/env python3
"""Drive the PyTorch port's B=1 int8 main path and its batch path once on
one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi); CUDA must be available;
  2. build the three CUDA kernels from pocket_tts_tpu_torch/csrc with nvcc
     (sm_90a), all at once, and print their registers and spills;
  3. hold each kernel against its plain PyTorch version on the card, at the
     b6369a24 geometry with a prefilled C=256 cache: fused_backbone_step for
     a BOS and a non-BOS frame, fused_segment_decode at S=8 and S=64
     (outputs, full updated caches, slot_pos); batch_decode_attention at
     H=16, d=64, B=64, C=512 for bf16 and int8 caches, read_rows 512 and 256
     (rows past 256 poisoned), holes, -1 rows, varied query positions, one
     stream with no valid row (its output must be exactly 0);
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
     (medians of several warm runs);
  6. the batch path: generate_audio_batch at b6369a24 width, int8 weights,
     (a) 64 texts of mixed length with one shared voice, bf16 KV, (b) the
     same with kv_int8=True, (c) 4 streams with 4 voices. Every stream
     returns finite audio of whole 1920-sample frames; the read limit takes
     two values below capacity in (a); batch_decode_attention launches 6
     times per decoded frame (every batch decode attention went through the
     kernel); copy_state leaves the voices bit-identical;
  7. batch timings beside the card's name and power limit: the batch kernel's
     device time per call (torch.profiler kernel times) vs its plain version
     and (bf16) scaled_dot_product_attention at B=64, R=512 with every row
     valid, against the K+V read bound; the B=64 device ms per decode step
     and per frame of a 64-frame segment (CUDA events); the aggregate
     real-time factor of generate_audio_batch at B=64 (median of warm runs);
     a torch.profiler breakdown of one warm B=64 run.

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
RUNS_BATCH_RTF = 3  # warm generate_audio_batch runs behind the B=64 median
BATCH_WORDS = (
    "the quick brown fox jumps over the lazy dog while a bright cold day in april strikes thirteen and every "
    "clock in the city keeps its own time as rivers run down to the sea past mills and bridges under a grey "
    "sky full of birds"
).split()
BATCH_TEXTS = [" ".join(BATCH_WORDS[: 6 + (i * 37) % 41]).capitalize() + "." for i in range(64)]
BATCH_VOICES = ["alba", "marius", "javert", "jean"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (the kernels' FMAs)

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
# batch_decode_attention: the JAX package's gates for its kernel against the
# XLA oracle (tests/test_batch_attention.py:47,76). The CUDA kernel rounds
# at the plain version's points, so it differs by float32 sum order only.
TOL_BATCH = {"bf16": 2e-2, "int8": 3e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    from concurrent.futures import ThreadPoolExecutor

    from pocket_tts_tpu_torch.models.tts_model import TTSModel
    from pocket_tts_tpu_torch.ops import _cuda
    from pocket_tts_tpu_torch.ops.batch_attention import batch_decode_attention, batch_decode_attention_reference
    from pocket_tts_tpu_torch.ops.fused_backbone import fused_backbone_step, fused_backbone_step_reference
    from pocket_tts_tpu_torch.ops.fused_segment import fused_segment_decode, fused_segment_decode_reference

    # ---------------------------------------------------------------- phase 2
    sources = ("fused_backbone", "fused_segment", "batch_attention")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all started together
        list(pool.map(_cuda.library, sources))
    print(f"build: {time.monotonic() - t0:.1f} s  {json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    for name in sources:
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
        errs["batch_decode_attention"] = compare_batch_attention(torch, dev, batch_decode_attention,
                                                                 batch_decode_attention_reference)

    # ---------------------------------------------------------------- phase 4
    voice = model.get_state_for_audio_prompt("alba")
    snapshot = copy.deepcopy(voice.tree)
    fused_backbone_step.launches = 0
    fused_segment_decode.launches = 0
    fused_segment_decode.frames = 0
    batch_decode_attention.launches = 0
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
    if batch_decode_attention.launches:
        fail(f"the B=1 path launched batch_decode_attention {batch_decode_attention.launches} times")
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
        # Bounds: each frame reads every packed weight once and the KV rows
        # valid for its query (rows at positions below it); 2 ops per weight.
        w_backbone = sum(t.numel() * t.element_size() for t in packed.values() if torch.is_tensor(t))
        w_flow = sum(t.numel() * t.element_size() for t in flow_packed.values() if torch.is_tensor(t))
        n_weights = sum(t.numel() for t in packed.values() if torch.is_tensor(t) and t.dtype == torch.int8)
        n_flow = sum(t.numel() for t in flow_packed.values() if torch.is_tensor(t) and t.dtype == torch.bfloat16)
        row_bytes = 2 * len(ks) * ks[0].shape[2] * ks[0].shape[3] * ks[0].element_size()
        valid_rows = int(((sp >= 0) & (sp < 100)).sum())
        bounds = {
            "fused_backbone_step": bound(w_backbone + valid_rows * row_bytes, 2 * n_weights),
            "fused_segment_decode": bound(w_backbone + w_flow + (valid_rows + 31.5) * row_bytes,
                                          2 * (n_weights + n_flow)),  # mean over 64 frames
        }
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
              f"bound {bounds[name][0]:.4f} ms/frame ({bounds[name][1]}), C={c_main} warm, CUDA events [{card}]",
              flush=True)

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

    # ---------------------------------------------------------------- phases 6-7
    batch = batch_path(torch, model, card, batch_decode_attention, fused_backbone_step, fused_segment_decode)
    timings["batch_decode_attention"], bounds["batch_decode_attention"], library_ms = time_batch_attention(
        torch, dev, card, batch_decode_attention, batch_decode_attention_reference, device_ms)
    batch_timings(torch, model, card, device_ms)

    def entry(name, source, replaces, n_launches, library=None):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": errs[name],
            "ms": timings[name][0], "plain_ms": timings[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": library,
        }

    kernels = [
        entry("fused_backbone_step", "pocket_tts_tpu_torch/csrc/fused_backbone.cu",
              "pocket_tts_tpu/ops/fused_backbone.py:1080", launches["fused_backbone_step"]),
        entry("fused_segment_decode", "pocket_tts_tpu_torch/csrc/fused_segment.cu",
              "pocket_tts_tpu/ops/fused_segment.py:709", launches["fused_segment_decode"]),
        entry("batch_decode_attention", "pocket_tts_tpu_torch/csrc/batch_attention.cu",
              "pocket_tts_tpu/ops/batch_attention.py:189", batch["launches"], library_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def batch_attention_inputs(torch, dev, B=64, C=512, H=16, d=64, seed=2):
    """q [B, H, 1, d] float32, bf16 k/v [B, C, H, d], slot_pos and qpos with
    per-stream valid prefixes, holes, rows past the query position, and
    stream 3 without a valid row."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, 1, d, generator=g)
    k, v = torch.randn(B, C, H, d, generator=g), torch.randn(B, C, H, d, generator=g)
    lens = torch.randint(C // 4, C + 1, (B,), generator=g)
    sp = torch.full((B, C), -1, dtype=torch.int32)
    for b in range(B):
        n = int(lens[b])
        sp[b, :n] = torch.arange(n, dtype=torch.int32)
        sp[b, torch.randperm(n, generator=g)[: n // 10]] = -1
    qpos = (lens - torch.randint(0, 24, (B,), generator=g)).clamp(min=0).to(torch.int32)
    sp[3] = -1
    return [t.to(dev) for t in (q, k.to(torch.bfloat16), v.to(torch.bfloat16), sp, qpos)]


def compare_batch_attention(torch, dev, kernel, plain) -> float:
    """Kernel vs plain version for bf16 and int8 caches, read_rows 512 and
    256 (rows past 256 poisoned in the cache); returns the largest error."""
    from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows

    q, k, v, sp, qpos = batch_attention_inputs(torch, dev)
    worst = 0.0
    for kind in ("bf16", "int8"):
        if kind == "int8":
            (kk, ks), (vv, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        else:
            kk, vv, ks, vs = k.clone(), v.clone(), None, None
        for R in (512, 256):
            if R == 256:  # a row the kernel must not read
                kk[:, R:] = 127 if kind == "int8" else float("nan")
                vv[:, R:] = 127 if kind == "int8" else float("nan")
                if ks is not None:
                    ks[:, R:], vs[:, R:] = float("nan"), float("nan")
            args = (q, kk, vv, sp[:, :R], qpos, None if ks is None else ks[:, :R], None if vs is None else vs[:, :R])
            out, ref = kernel(*args, read_rows=R), plain(*args, read_rows=R)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"batch_decode_attention {kind} B=64 C=512 R={R}: max|err| {err:.3g} (tol {TOL_BATCH[kind]}), "
                  f"zero-row stream exactly 0: {bool((out[3] == 0).all())}", flush=True)
            if not (err <= TOL_BATCH[kind] and bool(torch.isfinite(out).all()) and bool((out[3] == 0).all())):
                fail(f"batch_decode_attention {kind} R={R}: err {err:.4g}, or non-finite, or stream 3 not 0")
            worst = max(worst, err)
    return worst


def batch_path(torch, model, card, batch_kernel, step_kernel, segment_kernel) -> dict:
    """(a) 64 texts, one voice, bf16 KV; (b) the same, kv_int8; (c) 4
    voices. Returns the batch kernel's launches over the three runs."""
    import numpy as np

    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    t0 = time.monotonic()
    model8 = TTSModel.load_model(param_dtype="int8", device="cuda", seed=0, eos_threshold=1e9, kv_int8=True)
    print(f"load_model(int8, kv_int8=True): {time.monotonic() - t0:.1f} s", flush=True)
    total = 0
    runs = (("a", model, BATCH_TEXTS, ["alba"]), ("b", model8, BATCH_TEXTS, ["alba"]),
            ("c", model, BATCH_TEXTS[-4:], BATCH_VOICES))
    for tag, m, texts, voice_names in runs:
        voices = [m.get_state_for_audio_prompt(name) for name in voice_names]
        snapshots = [copy.deepcopy(v.tree) for v in voices]
        batch_kernel.launches = step_kernel.launches = segment_kernel.launches = 0
        t0 = time.monotonic()
        outs = m.generate_audio_batch(voices[0] if len(voices) == 1 else voices, texts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        gen = m.last_generation
        n_launches = batch_kernel.launches
        total += n_launches
        limits = sorted({r for r in gen["read_limits"] if r is not None})
        seconds = sum(o.shape[0] for o in outs) / m.sample_rate
        print(f"batch ({tag}) B={gen['batch']} kv_int8={m.kv_int8}: {gen['frames']} frames decoded, capacity "
              f"{gen['capacity']}, read limits {gen['read_limits']}, batch kernel launches {n_launches}, "
              f"{seconds:.1f} s of audio in {wall:.2f} s (first call) [{card}]", flush=True)
        if len(outs) != len(texts) or any(
            o.ndim != 1 or o.shape[0] == 0 or o.shape[0] % 1920 or not np.isfinite(o).all() for o in outs
        ):
            fail(f"batch ({tag}): every stream must return finite audio of whole 1920-sample frames")
        layers = m.flow_lm.config.transformer.num_layers
        if n_launches != layers * gen["frames"] or step_kernel.launches or segment_kernel.launches:
            fail(f"batch ({tag}): {n_launches} batch kernel launches for {gen['frames']} frames x {layers} layers "
                 f"(B=1 kernels {step_kernel.launches}, {segment_kernel.launches})")
        if tag == "a" and len(limits) < 2:
            fail(f"batch (a): the read limit took {limits} below capacity {gen['capacity']}; expected two values")
        for v, snap in zip(voices, snapshots):
            if not all(torch.equal(x, y) for x, y in zip(_tensors(v.tree), _tensors(snap))):
                fail(f"batch ({tag}): generate_audio_batch changed a voice state")
    return {"launches": total}


def kernel_ms(torch, fn, reps: int) -> float:
    """Device time per call of fn: the sum of its kernels' times from
    torch.profiler (CUPTI), so the host's enqueue rate does not enter."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        fail("torch.profiler recorded no kernel time")
    return total / reps / 1e3


def time_batch_attention(torch, dev, card, kernel, plain, device_ms):
    """Per-call device times (kernel_ms) at B=64, R=512, every row valid:
    kernel, plain version and (bf16) scaled_dot_product_attention with the
    boolean mask; the bound is the K+V read. The kernel's CUDA-event time
    per call, which includes the wrapper's host time, is printed beside.
    Returns the bf16 kernel's (ms, plain ms), its bound and the SDPA time."""
    import torch.nn.functional as F

    from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows

    q, k, v, _, _ = batch_attention_inputs(torch, dev, seed=3)
    B, C, H, d = k.shape
    sp = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C).contiguous()
    qpos = torch.full((B,), C, dtype=torch.int32, device=dev)
    (k8, ks), (v8, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    small = q.numel() * 4 * 2 + sp.numel() * 4 + qpos.numel() * 4  # q in, out, slot_pos, qpos
    ops = 4 * B * H * C * d
    result = {}
    for kind, args in (("bf16", (q, k, v, sp, qpos, None, None)), ("int8", (q, k8, v8, sp, qpos, ks, vs))):
        nbytes = 2 * k.numel() * args[1].element_size() + small + (2 * ks.numel() * 4 if kind == "int8" else 0)
        ms = kernel_ms(torch, lambda: kernel(*args, read_rows=C), 50)
        event_ms = device_ms(lambda: kernel(*args, read_rows=C), 50)
        plain_ms = kernel_ms(torch, lambda: plain(*args, read_rows=C), 10)
        result[kind] = (ms, plain_ms, bound(nbytes, ops), event_ms)
    qb, kt, vt = q.to(torch.bfloat16), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = ((sp >= 0) & (sp <= qpos[:, None]))[:, None, None, :]
    sdpa_ms = kernel_ms(torch, lambda: F.scaled_dot_product_attention(qb, kt, vt, attn_mask=mask), 50)
    for kind, (ms, plain_ms, (b_ms, _), event_ms) in result.items():
        extra = f", scaled_dot_product_attention {sdpa_ms * 1e3:.1f} us" if kind == "bf16" else ""
        print(f"batch_decode_attention {kind} B=64 R=512 all rows valid: {ms * 1e3:.1f} us/call of device time "
              f"(CUDA kernel, {b_ms / ms:.0%} of the bound; {event_ms * 1e3:.1f} us/call by CUDA events with the "
              f"wrapper's host time) vs {plain_ms * 1e3:.1f} us (plain PyTorch){extra}; bound {b_ms * 1e3:.1f} us "
              f"at 3.35 TB/s; torch.profiler kernel times [{card}]", flush=True)
    ms, plain_ms, bnd, _ = result["bf16"]
    return (ms, plain_ms), bnd, sdpa_ms


def batch_timings(torch, model, card, device_ms) -> None:
    """B=64 at b6369a24 width, int8 weights, bf16 KV: the aggregate RTF of
    generate_audio_batch (median of warm runs), device ms per decode step
    and per frame of a 64-frame segment (CUDA events, host gaps included),
    and a torch.profiler breakdown of one warm run."""
    from torch.profiler import ProfilerActivity, profile

    from pocket_tts_tpu_torch.models.generate import initial_carry, run_segment
    from pocket_tts_tpu_torch.models.tts_model import stack_states

    voice = model.get_state_for_audio_prompt("alba")
    walls = []
    for _ in range(RUNS_BATCH_RTF):
        t0 = time.monotonic()
        outs = model.generate_audio_batch(voice, BATCH_TEXTS)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    seconds = sum(o.shape[0] for o in outs) / model.sample_rate
    rtfs = sorted(seconds / w for w in walls)
    print(f"generate_audio_batch B=64: {seconds:.1f} s of audio, aggregate RTF median {statistics.median(rtfs):.1f}x "
          f"(min {rtfs[0]:.1f}, max {rtfs[-1]:.1f}; {RUNS_BATCH_RTF} warm runs, "
          f"{model.last_generation['frames']} frames per stream decoded) [{card}]", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        model.generate_audio_batch(voice, BATCH_TEXTS)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # Kernel events only: an operator's entry repeats the device time of the
    # kernels it launched.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    categories = {"batch attention": ("scores_kernel", "pv_kernel", "combine_kernel"),
                  "GEMM": ("gemm", "xmma", "gemv"), "convolution": ("conv", "cudnn"), "copy/cast": ("copy",)}
    split = dict.fromkeys([*categories, "other elementwise"], 0.0)
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in categories.items() if any(k in name for k in keys)), "other elementwise")
        split[cat] += e.self_device_time_total / 1e3
    print(f"profile of one warm generate_audio_batch B=64: wall {wall_ms:.1f} ms with the profiler on, device busy "
          f"{busy_ms:.1f} ms in {sum(e.count for e in kernels)} kernels; idle share "
          f"{1 - busy_ms / (statistics.median(walls) * 1e3):.2f} against the median unprofiled wall "
          f"{statistics.median(walls) * 1e3:.1f} ms; busy ms by kind "
          f"{json.dumps({k: round(v, 1) for k, v in split.items()})} [{card}]", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x  {e.key[:90]}")

    fl, gen = model.params["flow_lm"], model.last_generation
    B, dev = 64, model.device
    with torch.no_grad():
        tree = model.flow_lm.expand_state(stack_states(model.flow_lm, [voice] * B).tree, gen["capacity"])
        tokens = torch.randint(0, model.flow_lm.n_bins, (B, 64), generator=torch.Generator().manual_seed(4))
        tree = model.flow_lm.prefill(fl, tree, model.flow_lm.embed_text(fl, tokens.to(dev)), [64] * B)
        latent = torch.zeros(B, model.flow_lm.ldim, device=dev)
        noise = torch.zeros(64, B, model.flow_lm.ldim, device=dev)
        step_ms = device_ms(lambda: model.flow_lm.decode_step(fl, tree, latent, False, noise[0], 1, 1e9), 32)
        mimi_state = model._warm_mimi_state(B, 64, 1)
        carry = initial_carry(B, model.flow_lm.ldim, [2**20] * B, [2**20] * B, dev)
        seg_ms = device_ms(lambda: run_segment(model.flow_lm, model.mimi, model.params, tree, mimi_state, carry,
                                               noise, 1, 1e9), 2) / 64
    print(f"B=64 decode: {step_ms:.3f} ms per decode step (FlowLM, {gen['capacity']}-row cache read whole), "
          f"{seg_ms:.3f} ms per frame of a 64-frame segment (FlowLM + Mimi), CUDA events, warm [{card}]",
          flush=True)


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
