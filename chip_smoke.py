#!/usr/bin/env python3
"""Drive the PyTorch port's B=1 int8 main path, its batch path, the probe
entry point, the serving engine, the HTTP server, voice cloning,
fine-tuning and the sharded (dp, tp) mesh path once on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi); CUDA must be available;
  2. build the five CUDA sources from pocket_tts_tpu_torch/csrc with nvcc
     (sm_90a), all at once, and print each kernel's registers, shared
     memory and spills, and the cooperative grid (blocks per SM), phase
     count and work split of fused_backbone_step and fused_segment_decode
     at b6369a24 width;
  3. hold each kernel against its plain PyTorch version on the card, at the
     b6369a24 geometry with a prefilled C=256 cache: fused_backbone_step for
     a BOS and a non-BOS frame, with the write index clamped (widx = C - 1
     and beyond), at C=512 and at C=224, off its attention chunk (h, the EOS
     logit, full updated caches, slot_pos), fused_segment_decode at S=8
     with BOS, at S=64, at S=64 with the write index clamped (widx0 + S >
     C - 1) and at S=64 with C=224, off its attention chunk (outputs, full
     updated caches, slot_pos); batch_decode_attention
     at H=16, d=64 for bf16 and int8 caches (BATCH_CASES: B=64 with C=512
     read at 512 and 256 and C=384 read at 384 and a ragged 200, rows past
     the limit poisoned; the 4-voice batch's B=4 x 512 read at 512, 384 and
     256; B=8 x 4096; B=2 x 4096 read whole and at 2600; B=2 x 16384),
     float32 caches and a bf16 q, holes, -1
     rows, varied query positions, one stream with no valid row (its output
     must be exactly 0), and NaN in every hole row;
  4. the main path: TTSModel.load_model(param_dtype="int8") at b6369a24
     width (seeded random weights), the "alba" voice, generate_audio_stream
     and generate_audio on a two-sentence text; every streamed frame is 1920
     finite samples, copy_state=True leaves the voice state bit-identical,
     both kernels launch and every decoded frame goes through one of them,
     a WAV is written;
  5. at the cache capacity the main path decoded at: each kernel against
     its plain version once more, then warm timings beside the card's name
     and power limit: each kernel and its plain version (fused_segment_decode
     at S=64 and fused_backbone_step, there and at C=1024, by torch.profiler
     kernel time, one kernel per call, beside the wall between CUDA events;
     plain versions by CUDA events), generate_audio's
     real-time factor and generate_audio_stream's time to first audio
     (medians of several warm runs), and one warm generate_audio under
     torch.profiler (device busy time, kernel records, idle share against
     the unprofiled wall);
  6. the batch path: generate_audio_batch at b6369a24 width, int8 weights,
     (a) 64 texts of mixed length with one shared voice, bf16 KV, (b) the
     same with kv_int8=True, (c) 4 streams with 4 voices. Every stream
     returns finite audio of whole 1920-sample frames; the read limit takes
     two values below capacity in (a); batch_decode_attention launches 6
     times per decoded frame (every batch decode attention went through the
     kernel); copy_state leaves the voices bit-identical;
  7. batch timings beside the card's name and power limit: the batch kernel's
     device time per call (torch.profiler kernel times, the mean over the
     records received; one kernel per call),
     its device wall per call in a replayed CUDA graph of 50 calls and its
     wall per call between CUDA events around 50 calls from the host (the
     wrapper's host time included), vs its plain version and (bf16)
     scaled_dot_product_attention (graph walls) at B=64, R=512 with every row valid,
     against the K+V read bound, and at the server engine's B=8 x 4096, the
     4-voice batch's B=4 x 512 and the engine's largest read, B=2 x 16384
     (bf16 and int8); the B=64 device ms per decode step
     and per frame of a 64-frame segment (CUDA events); the aggregate
     real-time factor of generate_audio_batch at B=64 (median of warm runs);
     a torch.profiler breakdown of one warm B=64 run;
  8. the probes: row_write bit-equal to its plain version at (64, 1024) for
     rows 0, 7, 8, 13, 63 and at (65536, 1024), only that row changed;
     head_slice_weighted_sum within 1e-5 relative of its plain version on
     the probe script's input and on seeded random inputs at (64, 1024) and
     (65536, 1024); the probe entry point run in this process (its launches
     counted) and as `python -m pocket_tts_tpu_torch.probes` (exit 0); both
     kernels timed at (65536, 1024) by torch.profiler kernel time beside
     their bounds, their plain versions and one PyTorch call each (graph
     walls; the sum
     over inputs and outputs rotated past the L2, so both reach HBM);
  9. the serving engine at b6369a24 width, int8 weights and int8 KV:
     TTSEngine(slots=64, segment_frames=8, capacity=384) serves 96 requests
     (48 at once, then 2 every 40 ms) in its serving thread, once on a
     warm-up engine (first use of its shapes) and once measured; every request
     completes with finite audio of exactly its expected frames, preemption,
     resumption, compaction and growth happen, every batch decode attention
     goes through the kernel (launches = 6 x dispatched frames, no B=1
     kernel), every state tensor is on the card and the voice stays
     bit-identical; aggregate RTF, TTFA p50/p99, lateness p99, tick walls,
     parks/resumes/swaps, and 10 warm ticks run twice on the same workload,
     unprofiled for the wall and under torch.profiler for the device busy
     time (idle share, busy time by kind). Then a slots=1 engine (bf16 KV)
     serves two requests, every frame through fused_backbone_step;
 10. the HTTP server (make_handler on a ThreadingHTTPServer at 127.0.0.1:0)
     over an 8-slot engine with the server's defaults: one warm-up GET alone,
     then 8 concurrent GETs return 200 and a 24 kHz 16-bit WAV of whole
     frames, a burst of 40 more draws at least one 503 with Retry-After >= 1,
     /x is 404 and empty text 400; the median time to the first PCM byte;
 11. a 2-slot engine constructed at capacity=200 (off the B=1 kernels'
     32-row grid; it rounds up to 224) serves two short requests, every step
     through the batch kernel at a ragged 224 rows; then each kernel against
     its plain version at every capacity the engines of phases 9-11 decoded
     at that phases 3-5 did not compare;
 12. the read probes: stream_read for int8, bf16 and float32 at (256, 1024)
     and (300, 1024) (a partial last block) and at (65536, 1024), over
     several grids, against its plain version (integer data: exact; normal
     data: TOL_READ_SUM of the largest output); kv_read_sum at B=64, C=512
     and B=3, C=200 (one block, 88 rows unread) within TOL_KV_SUM; the
     bw_probe sweep (256 MiB, every dtype, block size and swept grid) and
     the attn_micro variants (B=64, C=512) run in this process, launches
     counted (graph replays included), and both entry points as `python -m`
     at reduced sizes (exit 0); then stream_read against its plain version
     on the sweep's own 256 MiB arrays at every block size and grid the
     sweep ran, and kv_read_sum on attn_micro's own inputs at every grid
     timed; stream_read at 256 MiB per dtype at its best block size and grid
     and kv_read_sum at B=64, C=512 by torch.profiler kernel time beside
     their bounds, plain versions and one PyTorch call each; kernel and
     kernel_i8 as fractions of the measured pallas_read floor and
     stream_read ceilings; every rate measured must stay at or below 105%
     of 3.35 TB/s;
 13. voice cloning at b6369a24 width in int8 (a model built by from_params
     from seeded random weights with a random speaker projection): a seeded
     10 s 16 kHz WAV under build/ is cloned (prompt length ceil(frames),
     state on the card), generate_audio decodes from the cloned state
     (finite audio of whole 1920-sample frames, every frame through a B=1
     kernel), then a 35 s WAV with truncate=True (state <= 380 frames) and
     a [T] array; the clone latency split into read + convert, encode,
     projection and prefill (CUDA events, medians of warm runs);
 14. fine-tuning at b6369a24 width in float32 (seeded random weights, TF32
     off): the flow-matching loss and its gradients at B=2 (16 text tokens,
     32 latent frames) on the card against the same call on the CPU with
     the same noise (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD); 20 AdamW steps at B=8
     (32 tokens, 125 frames) whose last five losses average below their
     first five, timed per step by CUDA events, then 3 steps under
     torch.profiler (device busy, kernel records per step, idle share, the
     optimizer's device time); the train state saved and restored bit-exact;
     the trained weights exported with save_checkpoint, loaded by load_model
     as an int8 model on the card (its leaves equal the trained weights cast
     and quantized), a voice cloned from a seeded 3 s array, and the main
     text decoded by generate_audio_stream through both B=1 kernels; then the
     capacity gate: the main model's voice expanded to C=12416 (past the
     kernels' 12288 rows) decodes the main text with neither B=1 kernel
     launched, its latents within TOL_SEGMENT (max) and TOL_SEGMENT_MEAN
     (mean) of the same voice and flow noise decoded at C=12288 through the
     kernels;
 15. the mesh: dryrun_multichip(4) runs 4 ranks (dp=2, tp=2) that share the
     one card over gloo: the toy generate segment and train step, then
     b6369a24 in int8 through load_model(mesh=...) and generate_audio_batch
     of its 8 texts at temperature 0 with bf16 and with int8 KV caches
     (each rank decodes 4 streams on 8 of the 16 heads through
     batch_decode_attention, 6 launches a frame on every rank, and launches
     no B=1 kernel), and one float32 train step of its FlowLM at B=8 x
     (32 + 125); the parent process holds each against the same model
     unsharded on the card (audio within TOL_MESH_AUDIO of each stream's
     peak; loss and gradients within TOL_TRAIN_LOSS and TOL_TRAIN_GRAD) and
     prints the backend and the wall of each part, labelled as 4 ranks
     sharing one card. batch_decode_attention is held against its plain
     version at a rank's shapes (B=4, H=8) at the capacity and every read
     limit the ranks decoded with (TOL_BATCH); a witness prints where the
     sharded audio first departs from the unsharded, beside the gap that
     the plain attention alone opens in the unsharded model.

The total wall time is printed before the last two lines. The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import copy
import itertools
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
C_OFF_CHUNK = 224  # the 200-row engine's capacity: 3.5 attention chunks of the B=1 kernels
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
TOL_BATCH = {"bf16": 2e-2, "int8": 3e-2, "float32": 2e-2}
# batch_decode_attention comparisons of phase 3: (B, C, read_rows in
# decreasing order). C=512 read whole and at the 256 limit, C=384 whole and
# at a ragged 200 (rows past each limit poisoned), the 4-voice batch's B=4 x
# 512 at its three read limits, the server engine's B=8 x 4096 (2-block
# clusters), B=2 x 4096 whole (8-block clusters) and at R=2600 (5-block
# clusters whose last block holds fewer rows), and the engine's largest
# read, 4 x 4096 rows (8-block clusters).
BATCH_CASES = ((64, 512, (512, 256)), (64, 384, (384, 200)), (4, 512, (512, 384, 256)), (8, 4096, (4096,)),
               (2, 4096, (4096, 2600)), (2, 16384, (16384,)))
# Phase 7 times the batch kernel at B=64, R=512 and at these (B, R).
TIMED_SHAPES = ((8, 4096), (4, 512), (2, 16384))
# head_slice_weighted_sum: float32 sums of 16 bf16 x small-integer products,
# each exact; another summation order moves only the last bits.
TOL_PROBE_SUM = 1e-5  # relative to the largest |output|
# stream_read and kv_read_sum add their blocks' partial sums with float
# atomics, in the order the blocks finish; the plain versions sum in the TPU
# kernels' block order. Integer-valued data sums exactly in any order; other
# data differs by float32 rounding: at most 1e-5 (stream_read: up to 1024
# tile partials, the sweep's 256 MiB arrays in 256 KiB blocks) and 1e-4
# (kv_read_sum: 32768 rows of column sums in another grouping) of the
# largest output.
TOL_READ_SUM = 1e-5
TOL_KV_SUM = 1e-4
# Fine-tuning (phase 14): the card and the CPU compute the same float32 loss
# and gradients (TF32 off) and differ by summation order: the loss within
# rel 1e-4, each gradient leaf within 1e-3 of its largest |value|.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
# The mesh (phase 15) against the same model unsharded, audio max |err| over
# each stream's peak |audio|: the batch kernel's gates of phase 3 (TOL_BATCH),
# taken relative to the peak. The ranks compute what the unsharded model
# computes and differ by float32 summation order in the tp reductions and in
# the batch kernel's per-call split (8 heads a rank, not 16). On the CPU at
# tiny width (tests/test_torch_parallel.py, the same dry run) the sharded
# audio equals the unsharded at JAX's mesh tolerance with bf16 KV and stays
# within these bounds with int8 KV.
TOL_MESH_AUDIO = {"bf16": TOL_BATCH["bf16"], "int8": TOL_BATCH["int8"]}
TRAIN_STEPS = 20  # AdamW steps at B=8, 32 text tokens, 125 latent frames
TRAIN_WINDOW = 3  # further steps under torch.profiler
READ_RATE_LIMIT = 1.05 * HBM_BYTES_PER_S  # a faster read than this is a fault of the probe
SERVER_TEXTS = [" ".join(BATCH_WORDS[: 6 + (i * 7) % 10]).capitalize() + "." for i in range(48)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them (printed)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def main() -> None:
    t_start = time.monotonic()
    if not (ROOT / "pocket_tts_tpu_torch").is_dir():
        fail("pocket_tts_tpu_torch/ not found next to chip_smoke.py; run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card = card_line()
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
    sources = ("fused_backbone", "fused_segment", "batch_attention", "probes", "read_probes")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all started together
        list(pool.map(_cuda.library, sources))
    print(f"build: {time.monotonic() - t0:.1f} s  {json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    for name in sources:
        for line in _cuda.build_log(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    from pocket_tts_tpu_torch.config.schema import builtin_config_path, load_config
    from pocket_tts_tpu_torch.ops.persistent import launch_plan

    cfg = load_config(builtin_config_path("b6369a24"))
    t = cfg.flow_lm.transformer
    seg_dims = (t.num_layers, t.d_model, t.num_heads, t.d_model * t.hidden_scale, cfg.mimi.quantizer.dimension,
                cfg.flow_lm.flow.dim, cfg.flow_lm.flow.depth)
    for name, dims in (("fused_backbone_step", (*seg_dims[:5], None, None)), ("fused_segment_decode", seg_dims)):
        plan, _ = launch_plan(torch.cuda.current_device(), *dims, C_TEST)
        print(f"{name}: one cooperative launch of {plan['blocks']} blocks ({plan['blocks_per_sm']} per SM of "
              f"{torch.cuda.get_device_properties(0).multi_processor_count}) x 512 threads, {plan['shared_bytes']} "
              f"bytes of dynamic shared memory, {plan['barriers_per_frame']} phases a frame, attention in "
              f"{plan['chunks']} chunks of {plan['chunk']} rows a head at C={C_TEST}", flush=True)

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

    def compare_step(base, is_bos, qpos, widx=None):
        C = base["transformer"]["layers"][0]["k"].shape[1]
        widx = qpos if widx is None else widx
        sk, sr = copy.deepcopy(base), copy.deepcopy(base)
        hk, ek = fused_backbone_step(packed, latent, is_bos, *cache_args(sk), qpos, widx)
        hr, er = fused_backbone_step_reference(packed, latent, is_bos, *cache_args(sr), qpos, widx)
        torch.cuda.synchronize()
        tag = f"fused_backbone_step C={C} bos={is_bos} widx={widx}"
        e_h, e_eos = max_err(hk, hr), max_err(ek, er)
        e_c = compare_states(tag, sk, sr, TOL_STEP)
        if not (e_h <= TOL_STEP and e_eos <= TOL_EOS):
            fail(f"{tag}: h err {e_h:.4g}, eos err {e_eos:.4g}")
        errs["fused_backbone_step"] = max(errs["fused_backbone_step"], e_h, e_c)
        print(f"{tag}: max|h| err {e_h:.3g}, eos err {e_eos:.3g}, cache err {e_c:.3g} (tol {TOL_STEP}; "
              f"eos {TOL_EOS})", flush=True)

    def compare_segment(base, S, is_bos, widx0=100):
        C = base["transformer"]["layers"][0]["k"].shape[1]
        sk, sr = copy.deepcopy(base), copy.deepcopy(base)
        noise = (torch.randn(S, ldim, generator=gen) * 0.8).to(dev)
        lk, ek = fused_segment_decode(packed, flow_packed, latent, is_bos, noise, *cache_args(sk), 100, widx0)
        lr, er = fused_segment_decode_reference(packed, flow_packed, latent, is_bos, noise, *cache_args(sr), 100,
                                                widx0)
        torch.cuda.synchronize()
        tag = f"fused_segment_decode C={C} S={S} bos={is_bos} widx0={widx0}"
        e_l, e_mean, e_eos = max_err(lk, lr), float((lk - lr).abs().mean()), max_err(ek, er)
        e_c = compare_states(tag, sk, sr, TOL_SEGMENT)
        if not (e_l <= TOL_SEGMENT and e_mean <= TOL_SEGMENT_MEAN and e_eos <= TOL_SEGMENT):
            fail(f"{tag}: latent err {e_l:.4g} (mean {e_mean:.4g}), eos err {e_eos:.4g}")
        errs["fused_segment_decode"] = max(errs["fused_segment_decode"], e_l, e_c)
        print(f"{tag}: max latent err {e_l:.3g} (mean {e_mean:.3g}), eos err {e_eos:.3g}, cache err {e_c:.3g} "
              f"(tol {TOL_SEGMENT}, mean {TOL_SEGMENT_MEAN})", flush=True)

    with torch.no_grad():
        base = prefilled(C_TEST)
        compare_step(base, True, 100)
        compare_step(base, False, 101)
        compare_step(base, False, 101, widx=C_TEST - 1)  # the write index clamped: appends land at C - 1
        compare_step(base, False, 101, widx=C_TEST + 7)
        compare_step(prefilled(512), False, 100)  # the engines grow to 512
        compare_step(prefilled(C_OFF_CHUNK), False, 100)  # C off the attention chunk
        compare_segment(base, 8, True)
        compare_segment(base, 64, False)
        compare_segment(base, 64, False, widx0=C_TEST - 20)  # widx0 + S > C - 1: appends clamp at C - 1
        compare_segment(prefilled(C_OFF_CHUNK), 64, False)  # C off the attention chunk
        errs["batch_decode_attention"] = max(
            compare_batch_attention(torch, dev, batch_decode_attention, batch_decode_attention_reference,
                                    BATCH_CASES),
            compare_batch_attention(torch, dev, batch_decode_attention, batch_decode_attention_reference,
                                    ((64, 384, (384, 200)), (2, 4096, (4096, 2600))), kinds=("float32", "bf16"),
                                    q_dtype=torch.bfloat16),
            compare_nan_holes(torch, dev, batch_decode_attention, batch_decode_attention_reference),
        )
    step_caps, batch_caps = {C_TEST, 512, C_OFF_CHUNK}, {(B, C) for B, C, _ in BATCH_CASES}  # compared so far

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
        step_caps.add(c_main)
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
        step = lambda: fused_backbone_step(packed, latent, False, ks, vs, sp, 100, 100)  # noqa: E731
        step_ms, step_records = kernel_profile(torch, step, 20, "backbone_step_kernel")
        step_event_ms = device_ms(step, 50)
        timings["fused_backbone_step"] = (
            step_ms, device_ms(lambda: fused_backbone_step_reference(packed, latent, False, ks, vs, sp, 100, 100), 10))
        # At C=1024 the attention reads 8 chunks of 128 rows a head.
        st_long = prefilled(1024)
        compare_step(st_long, False, 100)
        step_caps.add(1024)
        ks_l, vs_l, sp_l = cache_args(st_long)
        step_long = lambda: fused_backbone_step(packed, latent, False, ks_l, vs_l, sp_l, 100, 100)  # noqa: E731
        long_ms, long_records = kernel_profile(torch, step_long, 20, "backbone_step_kernel")
        long_event_ms = device_ms(step_long, 50)
        long_bound = bound(w_backbone + int(((sp_l >= 0) & (sp_l < 100)).sum()) * row_bytes, 2 * n_weights)
        noise = torch.zeros(64, ldim, device=dev)
        segment = lambda: fused_segment_decode(packed, flow_packed, latent, False, noise, ks, vs, sp, 100, 100)  # noqa: E731
        seg_ms, seg_records = kernel_profile(torch, segment, 10, "segment_decode_kernel")
        seg_event_ms = device_ms(segment, 5)
        timings["fused_segment_decode"] = (seg_ms / 64, device_ms(
            lambda: fused_segment_decode_reference(packed, flow_packed, latent, False, noise, ks, vs, sp, 100, 100),
            2) / 64)
    name = "fused_backbone_step"
    print(f"{name}: {timings[name][0]:.4f} ms/frame of device time (CUDA kernel, one per call, torch.profiler mean "
          f"of {step_records} records of 20 calls, {bounds[name][0] / timings[name][0]:.0%} of the bound), "
          f"{step_event_ms:.4f} ms/frame between CUDA events around 50 host calls, vs {timings[name][1]:.4f} "
          f"ms/frame (plain PyTorch, CUDA events), bound {bounds[name][0]:.4f} ms/frame ({bounds[name][1]}), "
          f"C={c_main} warm [{card}]", flush=True)
    print(f"{name} C=1024: {long_ms:.4f} ms/frame of device time (torch.profiler mean of {long_records} records of "
          f"20 calls, {long_bound[0] / long_ms:.0%} of the bound), {long_event_ms:.4f} ms/frame between CUDA events, "
          f"bound {long_bound[0]:.4f} ms/frame ({long_bound[1]}); {long_ms / timings[name][0]:.3f} x its time at "
          f"C={c_main} [{card}]", flush=True)
    name = "fused_segment_decode"
    print(f"{name} S=64: {timings[name][0]:.4f} ms/frame of device time (CUDA kernel, one per call, torch.profiler "
          f"mean of {seg_records} records of 10 calls, {bounds[name][0] / timings[name][0]:.0%} of the bound), "
          f"{seg_event_ms / 64:.4f} ms/frame between CUDA events around 5 host calls, vs {timings[name][1]:.4f} "
          f"ms/frame (plain PyTorch, CUDA events), bound {bounds[name][0]:.4f} ms/frame ({bounds[name][1]}), "
          f"C={c_main} warm [{card}]", flush=True)

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
    # Where one warm generate_audio's time goes: torch.profiler device busy
    # time against the unprofiled wall (the profiler stretches host time).
    _, busy_ms, by_kind, kernels = profiled_busy(torch, lambda: model.generate_audio(voice, TEXT))
    wall_ms = statistics.median(walls) * 1e3
    seg_ms = sum(e.self_device_time_total for e in kernels if "segment_decode_kernel" in e.key) / 1e3
    step_busy = [e for e in kernels if "backbone_step_kernel" in e.key]
    print(f"generate_audio B=1 breakdown: device busy {busy_ms:.1f} ms in {sum(e.count for e in kernels)} kernel "
          f"records ({seg_ms:.1f} ms in fused_segment_decode's kernel, "
          f"{sum(e.self_device_time_total for e in step_busy) / 1e3:.1f} ms in {sum(e.count for e in step_busy)} "
          f"records of fused_backbone_step's), unprofiled wall median {wall_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.2f}; busy ms by kind "
          f"{json.dumps({k: round(v, 1) for k, v in by_kind.items()})} [{card}]", flush=True)

    # ---------------------------------------------------------------- phases 6-7
    batch = batch_path(torch, model, card, batch_decode_attention, fused_backbone_step, fused_segment_decode)
    timings["batch_decode_attention"], bounds["batch_decode_attention"], library = time_batch_attention(
        torch, dev, card, batch_decode_attention, batch_decode_attention_reference)
    library = {"batch_decode_attention": library}
    batch_timings(torch, model, card, device_ms)

    # ---------------------------------------------------------------- phase 8
    probe = probes_phase(torch, dev, card)
    for name, (err, ms, plain_ms, bnd, lib_ms) in probe["kernels"].items():
        errs[name], timings[name], bounds[name], library[name] = err, (ms, plain_ms), bnd, lib_ms

    # ---------------------------------------------------------------- phases 9-10
    counters = (batch_decode_attention, fused_backbone_step, fused_segment_decode)
    served = engine_phase(torch, model, batch["model_kv_int8"], card, *counters)
    del batch["model_kv_int8"]
    torch.cuda.empty_cache()
    server_caps = server_phase(torch, model, card)

    # ---------------------------------------------------------------- phase 11
    off_grid_caps = off_grid_engine(model, card, batch_decode_attention)
    with torch.no_grad():
        for C in sorted(served["step_capacities"] - step_caps):
            compare_step(prefilled(C), False, 100)
        cases = sorted({(64, C) for C in served["batch_capacities"]} | {(8, C) for C in server_caps}
                       | {(2, C) for C in off_grid_caps})
        cases = [(B, C, (C,)) for B, C in cases if (B, C) not in batch_caps]
        if cases:
            errs["batch_decode_attention"] = max(errs["batch_decode_attention"], compare_batch_attention(
                torch, dev, batch_decode_attention, batch_decode_attention_reference, cases))
    print(f"engine capacities: 64 slots {sorted(served['batch_capacities'])}, 1 slot "
          f"{sorted(served['step_capacities'])}, server (8 slots) {sorted(server_caps)}, 2 slots "
          f"{sorted(off_grid_caps)}; each compared above", flush=True)

    # ---------------------------------------------------------------- phase 12
    read = read_probes_phase(torch, dev, card, batch_decode_attention)
    for name, (err, ms, plain_ms, bnd, lib_ms) in read["kernels"].items():
        errs[name], timings[name], bounds[name], library[name] = err, (ms, plain_ms), bnd, lib_ms
    print(f"batch_decode_attention bf16 B=64 R=512 (phase 7) {timings['batch_decode_attention'][0] * 1e3:.1f} us "
          f"against kv_read_sum's {timings['kv_read_sum'][0] * 1e3:.1f} us for the same K+V bytes: "
          f"{timings['kv_read_sum'][0] / timings['batch_decode_attention'][0]:.2f} x the read floor's speed [{card}]",
          flush=True)

    # ---------------------------------------------------------------- phase 13
    clone_phase(torch, model, card, fused_backbone_step, fused_segment_decode, dev)

    # ---------------------------------------------------------------- phase 14
    training_phase(torch, model, card, fused_backbone_step, fused_segment_decode, dev)

    # ---------------------------------------------------------------- phase 15
    del model
    torch.cuda.empty_cache()
    mesh_launches, mesh_err = mesh_phase(torch, card)
    errs["batch_decode_attention"] = max(errs["batch_decode_attention"], mesh_err)
    print(f"chip_smoke.py wall time: {time.monotonic() - t_start:.1f} s [{card}]", flush=True)

    def entry(name, source, replaces, n_launches):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": errs[name],
            "ms": timings[name][0], "plain_ms": timings[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": library.get(name),
        }

    # Launches: each kernel's count over the main-path runs that reach it,
    # each counted from 0 just before its run (B=1 path, batch path, engine,
    # probe entry point, the bw_probe and attn_micro entry points, and the
    # mesh path's ranks).
    kernels = [
        entry("fused_backbone_step", "pocket_tts_tpu_torch/csrc/fused_backbone.cu",
              "pocket_tts_tpu/ops/fused_backbone.py:1080",
              launches["fused_backbone_step"] + served["fused_backbone_step"]),
        entry("fused_segment_decode", "pocket_tts_tpu_torch/csrc/fused_segment.cu",
              "pocket_tts_tpu/ops/fused_segment.py:709", launches["fused_segment_decode"]),
        entry("batch_decode_attention", "pocket_tts_tpu_torch/csrc/batch_attention.cu",
              "pocket_tts_tpu/ops/batch_attention.py:189",
              batch["launches"] + served["batch_decode_attention"] + mesh_launches),
        entry("row_write", "pocket_tts_tpu_torch/csrc/probes.cu", "scripts/mosaic_probe.py:41",
              probe["launches"]["row_write"]),
        entry("head_slice_weighted_sum", "pocket_tts_tpu_torch/csrc/probes.cu", "scripts/mosaic_probe.py:87",
              probe["launches"]["head_slice_weighted_sum"]),
        entry("stream_read", "pocket_tts_tpu_torch/csrc/read_probes.cu", "benchmarks/bw_probe.py:31",
              read["launches"]["stream_read"]),
        entry("kv_read_sum", "pocket_tts_tpu_torch/csrc/read_probes.cu", "benchmarks/attn_micro.py:201",
              read["launches"]["kv_read_sum"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def zero_row_stream(B: int) -> int:
    return min(3, B - 1)


def batch_attention_inputs(torch, dev, B=64, C=512, H=16, d=64, seed=2):
    """q [B, H, 1, d] float32, bf16 k/v [B, C, H, d], slot_pos and qpos with
    per-stream valid prefixes, holes, rows past the query position, and
    one stream (zero_row_stream) without a valid row."""
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
    sp[zero_row_stream(B)] = -1
    return [t.to(dev) for t in (q, k.to(torch.bfloat16), v.to(torch.bfloat16), sp, qpos)]


def compare_batch_attention(torch, dev, kernel, plain, cases, kinds=("bf16", "int8"), q_dtype=None, H=16) -> float:
    """Kernel vs plain version for each cache kind; `cases` holds (B, C,
    read_rows in decreasing order); the rows past a read limit below C are
    poisoned in the cache. q is float32 unless q_dtype says otherwise; H
    heads of 64. Returns the largest error."""
    from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows

    worst = 0.0
    for B, C, reads in cases:
        q, k, v, sp, qpos = batch_attention_inputs(torch, dev, B=B, C=C, H=H)
        q, z = q if q_dtype is None else q.to(q_dtype), zero_row_stream(B)
        for kind in kinds:
            if kind == "int8":
                (kk, ks), (vv, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            else:
                dt = torch.float32 if kind == "float32" else torch.bfloat16
                kk, vv, ks, vs = k.to(dt, copy=True), v.to(dt, copy=True), None, None
            for R in reads:
                if R < C:  # a row the kernel must not read
                    kk[:, R:] = 127 if kind == "int8" else float("nan")
                    vv[:, R:] = 127 if kind == "int8" else float("nan")
                    if ks is not None:
                        ks[:, R:], vs[:, R:] = float("nan"), float("nan")
                args = (q, kk, vv, sp[:, :R], qpos, None if ks is None else ks[:, :R],
                        None if vs is None else vs[:, :R])
                out, ref = kernel(*args, read_rows=R), plain(*args, read_rows=R)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                zero = bool((out[z] == 0).all())
                print(f"batch_decode_attention {kind} cache, {q.dtype} q, B={B} C={C} H={H} R={R}: max|err| {err:.3g} "
                      f"(tol {TOL_BATCH[kind]}), zero-row stream exactly 0: {zero}", flush=True)
                if not (err <= TOL_BATCH[kind] and bool(torch.isfinite(out).all()) and zero
                        and out.dtype == ref.dtype):
                    fail(f"batch_decode_attention {kind} B={B} C={C} H={H} R={R}: err {err:.4g}, or non-finite, "
                         f"or stream {z} not 0, or dtype {out.dtype} != {ref.dtype}")
                worst = max(worst, err)
    return worst


def compare_nan_holes(torch, dev, kernel, plain) -> float:
    """The kernel fetches boxes of rows, so it reads the hole rows (slot_pos
    -1) of a box that holds a valid row, and selects them away: NaN in every
    hole of K and V (bf16) or of their row scales (int8) leaves the output
    within TOL_BATCH of the plain version's on the clean cache. Returns the
    largest error."""
    from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows

    q, k, v, sp, qpos = batch_attention_inputs(torch, dev, B=64, C=512)
    holes, worst = sp < 0, 0.0
    for kind in ("bf16", "int8"):
        kk, vv, ks, vs = k.clone(), v.clone(), None, None
        if kind == "int8":
            (kk, ks), (vv, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        ref = plain(q, kk, vv, sp, qpos, ks, vs)
        if kind == "int8":
            ks[holes], vs[holes] = float("nan"), float("nan")
        else:
            kk[holes], vv[holes] = float("nan"), float("nan")
        out = kernel(q, kk, vv, sp, qpos, ks, vs)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        print(f"batch_decode_attention {kind}, NaN in every hole row: max|err| {err:.3g} against the clean cache's "
              f"plain version (tol {TOL_BATCH[kind]})", flush=True)
        if not (err <= TOL_BATCH[kind] and bool(torch.isfinite(out).all())):
            fail(f"batch_decode_attention {kind}: NaN hole rows moved the output by {err:.4g} or made it non-finite")
        worst = max(worst, err)
    return worst


def batch_path(torch, model, card, batch_kernel, step_kernel, segment_kernel) -> dict:
    """(a) 64 texts, one voice, bf16 KV; (b) the same, kv_int8; (c) 4
    voices. Returns the batch kernel's launches over the three runs and the
    kv_int8 model (the engine phase serves it)."""
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
    return {"launches": total, "model_kv_int8": model8}


def kernel_profile(torch, fn, reps: int, name: str) -> tuple[float, int]:
    """Device time per call of fn, which launches one kernel whose name
    contains `name` (a memset may go with it): the mean over the records of
    that kernel which torch.profiler (CUPTI) delivered for `reps` calls, so
    the host's enqueue rate does not enter; and the records received. CUPTI
    has delivered records for only some of a window's calls on an H100, so
    the mean is over the records, not over the calls. Fails if the window
    holds another kernel, or more records than calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window with no record at all is measured again, at most three times
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "Memset" not in e.key]
        mine = [e for e in events if name in e.key]
        records = sum(e.count for e in mine)
        others = sorted({e.key for e in events} - {e.key for e in mine})
        if others or records > reps:
            fail(f"{name}: {records} records for {reps} calls, other kernels {others}; expected one kernel per call")
        if records:
            return sum(e.self_device_time_total for e in mine) / records / 1e3, records
    fail(f"torch.profiler recorded no {name} kernel in three windows of {reps} calls")


def graph_ms(torch, fn, calls: int = 50, replays: int = 10) -> float:
    """Device wall per call with the gaps between launches: the best of
    `replays` CUDA-event timings of a replayed CUDA graph of `calls`
    captured calls of fn (utils/timing.best_seconds; a measurement only,
    the port never runs a graph)."""
    from pocket_tts_tpu_torch.utils.timing import best_seconds

    def run():
        for _ in range(calls):
            fn()

    return best_seconds(run, replays, torch.device("cuda")) / calls * 1e3


def event_ms(torch, fn, calls: int = 50) -> float:
    """Wall per call between CUDA events around `calls` calls of fn issued
    back to back: the device time, or the host's time per call where that
    is longer."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def attention_timings(torch, dev, kernel, plain=None, B=64, C=512) -> dict:
    """The batch kernel at B streams over C rows, every row valid, bf16 and
    int8 caches: device ms per call (torch.profiler kernel time; one kernel
    per call, or kernel_profile fails) and the records it is the mean of,
    device wall per call in a CUDA graph of 50 calls, wall per call between
    CUDA events around 50 calls from the host, the bound (the K+V read);
    with `plain`, the plain version's graph wall, and for bf16
    scaled_dot_product_attention with the boolean mask (graph wall).
    -> {kind: {...}}."""
    import torch.nn.functional as F

    from pocket_tts_tpu_torch.ops.attention import quantize_kv_rows

    q, k, v, _, _ = batch_attention_inputs(torch, dev, B=B, C=C, seed=3)
    H, d = k.shape[2:]
    sp = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C).contiguous()
    qpos = torch.full((B,), C, dtype=torch.int32, device=dev)
    (k8, ks), (v8, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    small = q.numel() * 4 * 2 + sp.numel() * 4 + qpos.numel() * 4  # q in, out, slot_pos, qpos
    ops = 4 * B * H * C * d
    result = {}
    for kind, args in (("bf16", (q, k, v, sp, qpos, None, None)), ("int8", (q, k8, v8, sp, qpos, ks, vs))):
        nbytes = 2 * k.numel() * args[1].element_size() + small + (2 * ks.numel() * 4 if kind == "int8" else 0)
        ms, records = kernel_profile(torch, lambda: kernel(*args, read_rows=C), 50, "decode_attention_kernel")
        result[kind] = {"ms": ms, "records": records, "bound_ms": bound(nbytes, ops),
                        "graph_ms": graph_ms(torch, lambda: kernel(*args, read_rows=C)),
                        "event_ms": event_ms(torch, lambda: kernel(*args, read_rows=C))}
        if plain is not None:
            result[kind]["plain_ms"] = graph_ms(torch, lambda: plain(*args, read_rows=C), calls=10, replays=3)
    if plain is not None:
        qb, kt, vt = q.to(torch.bfloat16), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = ((sp >= 0) & (sp <= qpos[:, None]))[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(qb, kt, vt, attn_mask=mask)  # noqa: E731
        result["bf16"]["sdpa_ms"] = graph_ms(torch, sdpa)
    return result


def time_batch_attention(torch, dev, card, kernel, plain):
    """Phase 7's kernel timings at B=64, R=512 (and at TIMED_SHAPES), every
    row valid: torch.profiler kernel time (one kernel per call), the
    device wall per call of a CUDA graph of 50 calls, the wall per call
    between CUDA events around 50 host calls, the plain version and (bf16)
    scaled_dot_product_attention; the bound is the K+V read. Returns the
    bf16 kernel's (ms, plain ms), its bound and the SDPA time."""
    result = attention_timings(torch, dev, kernel, plain)
    rows = [("B=64 R=512", kind, t) for kind, t in result.items()]
    for B, C in TIMED_SHAPES:
        rows += [(f"B={B} R={C}", kind, t) for kind, t in attention_timings(torch, dev, kernel, B=B, C=C).items()]
    for shape, kind, t in rows:
        b_ms = t["bound_ms"][0]
        extra = ""
        if "plain_ms" in t:
            extra = f" vs {t['plain_ms'] * 1e3:.1f} us (plain PyTorch, graph wall)"
        if "sdpa_ms" in t:
            extra += f", scaled_dot_product_attention {t['sdpa_ms'] * 1e3:.1f} us (graph wall)"
        print(f"batch_decode_attention {kind} {shape} all rows valid: {t['ms'] * 1e3:.1f} us/call of device time "
              f"(CUDA kernel, one per call, mean of {t['records']} records of 50 calls, {b_ms / t['ms']:.0%} of the bound; "
              f"{t['graph_ms'] * 1e3:.1f} us/call of device wall in a CUDA graph of 50 calls; "
              f"{t['event_ms'] * 1e3:.1f} us/call between CUDA events around 50 host calls){extra}; bound "
              f"{b_ms * 1e3:.1f} us at 3.35 TB/s; torch.profiler kernel times [{card}]", flush=True)
    t = result["bf16"]
    return (t["ms"], t["plain_ms"]), t["bound_ms"], t["sdpa_ms"]


def batch_timings(torch, model, card, device_ms) -> None:
    """B=64 at b6369a24 width, int8 weights, bf16 KV: the aggregate RTF of
    generate_audio_batch (median of warm runs), device ms per decode step
    and per frame of a 64-frame segment (CUDA events, host gaps included),
    and a torch.profiler breakdown of one warm run."""
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

    wall_ms, busy_ms, split, kernels = profiled_busy(torch, lambda: model.generate_audio_batch(voice, BATCH_TEXTS))
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


def probes_phase(torch, dev, card) -> dict:
    """Phase 8: both probe kernels against their plain versions, the probe
    entry point in this process (launches counted) and as a subprocess, and
    timings at (65536, 1024). Returns {"kernels": {name: (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by), library_ms)}, "launches": {name: n}}."""
    from pocket_tts_tpu_torch import probes
    from pocket_tts_tpu_torch.ops.probes import (
        head_slice_weighted_sum,
        head_slice_weighted_sum_reference,
        row_write,
        row_write_reference,
    )

    g = torch.Generator().manual_seed(8)
    E, H, W = 1024, 16, 64
    errs = {"row_write": 0.0, "head_slice_weighted_sum": 0.0}
    for C, rows in ((64, (0, 7, 8, 13, 63)), (65536, (0, 13, 40000, 65535))):
        cache = (torch.randn(C, E, generator=g) * 4).to(torch.bfloat16).to(dev)
        row = (torch.randn(E, generator=g) * 4).to(torch.bfloat16).to(dev)
        for i in rows:
            got, ref = cache.clone(), cache.clone()
            index = torch.tensor([i], dtype=torch.int32, device=dev)
            out = row_write(got, row, index)
            row_write_reference(ref, row, index)
            torch.cuda.synchronize()
            others = torch.arange(C, device=dev) != i
            if not (out is got and torch.equal(got, ref) and torch.equal(got[i], row)
                    and torch.equal(got[others], cache[others])):
                fail(f"row_write ({C}, {E}) row {i}: not bit-equal to its plain version, or another row changed")
        print(f"row_write ({C}, {E}) rows {list(rows)}: bit-equal to the plain version, other rows untouched",
              flush=True)
    script_x = (torch.arange(64 * E, dtype=torch.float32).reshape(64, E) % 97).to(torch.bfloat16)
    for tag, x in (("script input (64, 1024)", script_x),
                   ("random (64, 1024)", torch.randn(64, E, generator=g).to(torch.bfloat16)),
                   ("random (65536, 1024)", (torch.randn(65536, E, generator=g) * 8).to(torch.bfloat16))):
        x = x.to(dev)
        out, ref = head_slice_weighted_sum(x, H, W), head_slice_weighted_sum_reference(x, H, W)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        rel = err / max(float(ref.abs().max()), 1e-30)
        print(f"head_slice_weighted_sum {tag}: max|err| {err:.3g}, relative {rel:.3g} (tol {TOL_PROBE_SUM})",
              flush=True)
        if not (rel <= TOL_PROBE_SUM and bool(torch.isfinite(out).all())):
            fail(f"head_slice_weighted_sum {tag}: relative error {rel:.4g}")
        errs["head_slice_weighted_sum"] = max(errs["head_slice_weighted_sum"], err)

    # The probe entry point, in this process: its launches are the main path's.
    row_write.launches = head_slice_weighted_sum.launches = 0
    if not probes.run("cuda"):
        fail("the probe entry point reported a wrong result")
    torch.cuda.synchronize()
    launches = {"row_write": row_write.launches, "head_slice_weighted_sum": head_slice_weighted_sum.launches}
    if launches != {"row_write": 1, "head_slice_weighted_sum": 1}:
        fail(f"the probe entry point launched {launches}, not each kernel once")
    proc = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch.probes"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    print(f"python -m pocket_tts_tpu_torch.probes: exit {proc.returncode}; {proc.stdout.strip()!r}", flush=True)
    if proc.returncode != 0:
        fail(f"python -m pocket_tts_tpu_torch.probes exited {proc.returncode}: {proc.stderr[-2000:]}")

    # Timings at (65536, 1024): kernel time by torch.profiler, the plain
    # versions and the library calls by graph walls. Successive
    # calls of the sum read four inputs in turn (512 MiB together) and write
    # nine outputs in turn (the last eight are held: 144 MiB), so no call
    # finds its input, or the lines of its output, left in the 50 MB L2 by
    # the calls before. Even so the 16 MiB output does not bound the call:
    # it is written into the L2, whose write-back to HBM can fall after the
    # kernel (the sum read faster than its input and output over 3.35 TB/s),
    # so the bound is the 128 MiB input read.
    C = 65536
    cache = torch.randn(C, E, generator=g).to(torch.bfloat16).to(dev)
    row = torch.randn(E, generator=g).to(torch.bfloat16).to(dev)
    index = torch.tensor([12345], dtype=torch.int32, device=dev)
    index_long = index.long()
    xs = itertools.cycle([torch.randn(C, E, generator=g).to(torch.bfloat16).to(dev) for _ in range(4)])
    weights = torch.arange(1, H + 1, dtype=torch.float32, device=dev).view(1, H, 1)
    held = collections.deque(maxlen=8)
    p1 = (*kernel_profile(torch, lambda: row_write(cache, row, index), 48, "row_write_kernel"),
          graph_ms(torch, lambda: row_write_reference(cache, row, index), calls=48),
          graph_ms(torch, lambda: cache.index_copy_(0, index_long, row[None]), calls=48))
    p2 = (*kernel_profile(torch, lambda: held.append(head_slice_weighted_sum(next(xs), H, W)), 48,
                          "head_slice_weighted_sum_kernel"),
          graph_ms(torch, lambda: held.append(head_slice_weighted_sum_reference(next(xs), H, W)), calls=20, replays=3),
          graph_ms(torch, lambda: held.append((next(xs).view(C, H, W).float() * weights).sum(1)), calls=20,
                   replays=3))
    held.clear()
    x = next(xs)
    b1 = bound(2 * E * 2 + 4, 0)  # one row read and written, the index read
    b2 = bound(x.numel() * 2, 2 * x.numel())  # x read (the output stays in the L2); a multiply-add per element
    for name, (ms, records, plain_ms, lib_ms), (b_ms, by), lib in (
        ("row_write", p1, b1, "index_copy_"),
        ("head_slice_weighted_sum", p2, b2, "(x.view(C,16,64).float() * w).sum(1)"),
    ):
        print(f"{name} ({C}, {E}): {ms * 1e3:.2f} us/call of device time (CUDA kernel, torch.profiler, mean of "
              f"{records} records of 48 calls; bound {b_ms * 1e3:.3f} us by "
              f"{by}{'; a 2 KiB row write is bound by its launch, by nature' if name == 'row_write' else ''}) vs "
              f"{plain_ms * 1e3:.2f} us (plain PyTorch) and {lib_ms * 1e3:.2f} us ({lib}), graph walls [{card}]",
              flush=True)
    return {
        "kernels": {"row_write": (errs["row_write"], p1[0], p1[2], b1, p1[3]),
                    "head_slice_weighted_sum": (errs["head_slice_weighted_sum"], p2[0], p2[2], b2, p2[3])},
        "launches": launches,
    }


def read_probes_phase(torch, dev, card, batch_kernel) -> dict:
    """Phase 12: stream_read and kv_read_sum against their plain versions,
    the bw_probe and attn_micro entry points in this process (launches
    counted) and as subprocesses, and timings at the probes' shapes.
    Returns {"kernels": {name: (max_abs_err, ms, plain_ms, (bound_ms,
    bound_by), library_ms)}, "launches": {name: n}}."""
    from pocket_tts_tpu_torch import attn_micro, bw_probe
    from pocket_tts_tpu_torch.ops.read_probes import (
        kv_read_sum,
        kv_read_sum_reference,
        sm_count,
        stream_read,
        stream_read_reference,
    )

    g = torch.Generator().manual_seed(12)
    sms = sm_count(dev)
    errs = {"stream_read": 0.0, "kv_read_sum": 0.0}

    def check(name, got, ref, tol, tag, show=True):
        torch.cuda.synchronize()
        err, scale = max_err(got, ref), max(float(ref.abs().max()), 1e-30)
        if show:
            print(f"{name} {tag}: max|err| {err:.3g}, relative {err / scale:.3g} (tol {tol} of the largest output)",
                  flush=True)
        if not (err <= tol * scale and bool(torch.isfinite(got).all())):
            fail(f"{name} {tag}: max|err| {err:.4g} against the plain version (largest output {scale:.4g})")
        errs[name] = max(errs[name], err)
        return err

    tok = torch.randn(8, 128, generator=g).to(dev)
    for dtype, tile in ((torch.int8, 32), (torch.bfloat16, 16), (torch.float32, 8)):
        for rows, blk in ((256, tile), (300, 64), (65536, 256), (65536, 2048)):
            if dtype == torch.int8:
                x = torch.randint(-128, 128, (rows, 1024), generator=g, dtype=torch.int8)
            else:
                x = torch.randint(-64, 65, (rows, 1024), generator=g).to(dtype)
            x = x.to(dev)
            ref = stream_read_reference(tok, x, blk)
            for grid in ((None, 1, 3 * sms) if rows < 1024 else (None, sms + 7)):  # one block alone reads slowly
                check("stream_read", stream_read(tok, x, blk, grid=grid), ref, TOL_READ_SUM,
                      f"{str(dtype).split('.')[-1]} ({rows}, 1024) blk {blk} grid {grid or 'default'} integers")
            if dtype != torch.int8:
                x = (torch.randn(rows, 1024, generator=g) * 4).to(dtype).to(dev)
                check("stream_read", stream_read(tok, x, blk), stream_read_reference(tok, x, blk), TOL_READ_SUM,
                      f"{str(dtype).split('.')[-1]} ({rows}, 1024) blk {blk} normal")
    for B, C in ((64, 512), (3, 200)):
        k = torch.randn(B * C, 1024, generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn(B * C, 1024, generator=g).to(torch.bfloat16).to(dev)
        if C == 200:  # rows past the last whole 512-row block must not be read
            k[512:], v[512:] = float("nan"), float("nan")
        ref = kv_read_sum_reference(tok, k, v)
        for grid in (None, 7):
            check("kv_read_sum", kv_read_sum(tok, k, v, grid=grid), ref, TOL_KV_SUM,
                  f"B={B} C={C} ({B * C} rows) grid {grid or 'default'}")

    # The entry points in this process: their launches are the main path's.
    rates = []
    stream_read.launches = kv_read_sum.launches = 0
    sweep = bw_probe.sweep(256, 16, 5, dev, print_fn=lambda line: print(f"bw_probe: {line} [{card}]", flush=True))
    n_stream = stream_read.launches
    for res in sweep.values():
        rates += [gbs * 1e9 for _, gbs in res["blocks"].values()] + [res["best"][3] * 1e9]
    batch_launches = batch_kernel.launches
    micro = attn_micro.run(64, 512, 64, 5, dev, print_fn=lambda line: print(f"attn_micro: {line} [{card}]", flush=True))
    torch.cuda.synchronize()
    launches = {"stream_read": n_stream, "kv_read_sum": kv_read_sum.launches}
    print(f"entry points in this process: launches {launches}, batch_decode_attention "
          f"{batch_kernel.launches - batch_launches}", flush=True)
    if min(launches.values()) <= 0 or batch_kernel.launches == batch_launches:
        fail(f"an entry point did not launch its kernel: {launches}")
    for module, args in (("bw_probe", ["--mb", "64", "--iters", "4", "--repeats", "2"]),
                         ("attn_micro", ["--iters", "8", "--repeats", "2"])):
        proc = subprocess.run([sys.executable, "-m", f"pocket_tts_tpu_torch.{module}", *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        print(f"python -m pocket_tts_tpu_torch.{module} {' '.join(args)}: exit {proc.returncode}, "
              f"{len(proc.stdout.splitlines())} lines", flush=True)
        if proc.returncode != 0:
            fail(f"python -m pocket_tts_tpu_torch.{module} exited {proc.returncode}: {proc.stderr[-2000:]}")

    # On the sweep's own inputs, each dtype's 256 MiB array as bw_probe made
    # it (random_array, seed 0): the kernel against its plain version at
    # every block size the sweep read and at every grid it ran (the default
    # one full wave, and 1, 2, 4 and 8 blocks per SM), then its timings at the
    # sweep's best block and grid: device time by torch.profiler (the mean
    # over the records received) and the device wall per call of a replayed
    # CUDA graph of 50 calls (the output's memset and the gaps between
    # launches included). The plain versions and the library calls are timed
    # by graph walls.
    grids = (None, *(waves * sms for waves in bw_probe.GRID_WAVES))
    kernels = {}
    ceilings = {}
    for name, res in sweep.items():
        dtype = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}[name]
        blk_kib, blk_rows, grid, _ = res["best"]
        x = bw_probe.random_array(res["rows_total"], dtype, dev)
        for kib, (rows, _) in res["blocks"].items():
            ref = stream_read_reference(tok, x, rows)
            err = max(check("stream_read", stream_read(tok, x, rows, grid=gr), ref, TOL_READ_SUM,
                            f"{name} 256 MiB blk {kib} KiB grid {gr or 'default'}", show=False) for gr in grids)
            print(f"stream_read {name} 256 MiB (the sweep's array) blk {kib} KiB ({rows} rows), grids "
                  f"{', '.join(str(gr or 'default') for gr in grids)}: max|err| {err:.3g}, relative "
                  f"{err / float(ref.abs().max()):.3g} (tol {TOL_READ_SUM} of the largest output)", flush=True)
        ms, records = kernel_profile(torch, lambda: stream_read(tok, x, blk_rows, grid=grid), 20, "stream_read_kernel")
        wall_ms = graph_ms(torch, lambda: stream_read(tok, x, blk_rows, grid=grid))
        plain_ms = graph_ms(torch, lambda: stream_read_reference(tok, x, blk_rows), calls=2, replays=3)
        lib_ms = graph_ms(torch, lambda: x.sum(dtype=torch.float32))
        nbytes = res["nbytes"]
        b = bound(nbytes, 2 * 8 * 128 * (res["rows_total"] // blk_rows))
        ceilings[name] = nbytes / (ms * 1e-3)
        rates += [ceilings[name], nbytes / (wall_ms * 1e-3), nbytes / (lib_ms * 1e-3)]
        print(f"stream_read {name} 256 MiB blk {blk_kib} KiB ({blk_rows} rows) grid {grid}: {ms * 1e3:.1f} us/call "
              f"of device time (CUDA kernel; torch.profiler, mean of {records} records of 20 calls), "
              f"{ceilings[name] / 1e9:.0f} GB/s = {ceilings[name] / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; "
              f"{wall_ms * 1e3:.1f} us/call of device wall in a CUDA graph of 50 calls "
              f"({nbytes / wall_ms / 1e6:.0f} GB/s); bound {b[0] * 1e3:.1f} us; plain {plain_ms * 1e3:.1f} us; "
              f"x.sum(dtype=float32) {lib_ms * 1e3:.1f} us (graph walls) [{card}]", flush=True)
        kernels[name] = (ms, plain_ms, b, lib_ms)
        del x
    # kv_read_sum on attn_micro's own inputs (make_inputs, seed 0: K and V
    # flattened to [B*C, 1024], tok padded from q as its pallas_read form
    # does) at its default grid and at each grid timed below, then timed.
    B, C = 64, 512
    t = attn_micro.make_inputs(B, C, dev)
    kflat, vflat = t["kflat"].view(B * C, 1024), t["vflat"].view(B * C, 1024)
    tok_q = torch.nn.functional.pad(t["q"][0, :8, 0, :].float(), (0, 128 - attn_micro.D))
    ref = kv_read_sum_reference(tok_q, kflat, vflat)
    for grid in (None, 2 * sms, 4 * sms, 8 * sms):
        check("kv_read_sum", kv_read_sum(tok_q, kflat, vflat, grid=grid), ref, TOL_KV_SUM,
              f"B={B} C={C} attn_micro's inputs grid {grid or 'default'}")
    del t
    kv_grids = {n * sms: kernel_profile(torch, lambda: kv_read_sum(tok, kflat, vflat, grid=n * sms), 50,
                                        "kv_read_sum_kernel")[0] for n in (2, 4, 8)}
    print("kv_read_sum B=64 C=512 by grid: " + ", ".join(f"{grid} blocks {ms * 1e3:.1f} us" for grid, ms
                                                          in kv_grids.items()) + f" [{card}]", flush=True)
    kv_ms, kv_records = kernel_profile(torch, lambda: kv_read_sum(tok, kflat, vflat), 50, "kv_read_sum_kernel")
    kv_wall = graph_ms(torch, lambda: kv_read_sum(tok, kflat, vflat))
    kv_plain = graph_ms(torch, lambda: kv_read_sum_reference(tok, kflat, vflat), calls=5, replays=3)
    kv_lib = graph_ms(torch, lambda: (kflat.sum(0, dtype=torch.float32), vflat.sum(0, dtype=torch.float32)))
    kv_bytes = 2 * kflat.numel() * 2
    kv_bound = bound(kv_bytes, 2 * kflat.numel())
    rates += [kv_bytes / (t * 1e-3) for t in (kv_ms, kv_wall, kv_lib, *kv_grids.values())]
    print(f"kv_read_sum B={B} C={C}: {kv_ms * 1e3:.1f} us/call of device time (CUDA kernel; torch.profiler, "
          f"mean of {kv_records} records of 50 calls), {kv_bytes / kv_ms / 1e6:.0f} GB/s = "
          f"{kv_bytes / (kv_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; {kv_wall * 1e3:.1f} us/call of device "
          f"wall in a CUDA graph of 50 calls; bound {kv_bound[0] * 1e3:.1f} us; plain {kv_plain * 1e3:.1f} us; the "
          f"pair of column sums (sum(0, dtype=float32) of K and of V) {kv_lib * 1e3:.1f} us (graph walls) [{card}]",
          flush=True)
    floor_us = micro["pallas_read"][0]
    for name, ceiling in (("kernel", "bfloat16"), ("kernel_i8", "int8")):
        us = micro[name][0]
        ceiling_us = attn_micro.step_bytes(name, B, C) / ceilings[ceiling] * 1e6
        print(f"attn_micro {name}: {us:.1f} us/step = {floor_us / us:.2f} x the pallas_read floor's speed "
              f"({floor_us:.1f} us for the bf16 K+V) and {ceiling_us / us:.2f} x the {ceiling} stream_read ceiling's "
              f"({ceiling_us:.1f} us for its bytes) [{card}]", flush=True)
    rates += [gbs * 1e9 for _, gbs in micro.values()]
    if max(rates) > READ_RATE_LIMIT:
        fail(f"a read reported {max(rates) / 1e9:.0f} GB/s, above 105% of 3.35 TB/s: the probe is wrong")
    print(f"every read rate measured <= {max(rates) / 1e9:.0f} GB/s (limit {READ_RATE_LIMIT / 1e9:.0f})", flush=True)
    ms, plain_ms, b, lib_ms = kernels["bfloat16"]
    return {
        "kernels": {"stream_read": (errs["stream_read"], ms, plain_ms, b, lib_ms),
                    "kv_read_sum": (errs["kv_read_sum"], kv_ms, kv_plain, kv_bound, kv_lib)},
        "launches": launches,
    }


def _write_prompt_wav(path: Path, seconds: float, rate: int, seed: int) -> None:
    """A seeded voice-like prompt: three harmonics with a slow vibrato and a
    little noise, 16-bit PCM."""
    import numpy as np

    from pocket_tts_tpu_torch.data.audio import audio_write

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 140 + 20 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    wav = 0.3 * np.sin(phase) + 0.15 * np.sin(2 * phase) + 0.08 * np.sin(3 * phase)
    wav += 0.02 * rng.standard_normal(t.shape)
    path.parent.mkdir(parents=True, exist_ok=True)
    audio_write(path, wav.astype(np.float32), rate)


def clone_phase(torch, model, card, step_kernel, segment_kernel, dev) -> None:
    """Phase 13: voice cloning at b6369a24 width in int8, from a WAV file,
    with truncate, and from a [T] array; the cloned voice decoded through
    the B=1 kernels; the clone latency split into its parts."""
    import numpy as np

    from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
    from pocket_tts_tpu_torch.models.mimi import MimiModel
    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    cfg = model.config
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(13)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    params["flow_lm"]["speaker_proj_weight"] = torch.randn(flow_lm.dim, flow_lm.speaker_dim, generator=gen) * 0.02
    clone = TTSModel.from_params(cfg, params, model.tokenizer, "int8", device=dev, eos_threshold=1e9)
    del params
    wav10, wav35 = ROOT / "build" / "clone_10s_16k.wav", ROOT / "build" / "clone_35s_16k.wav"
    _write_prompt_wav(wav10, 10.0, 16000, seed=10)
    _write_prompt_wav(wav35, 35.0, 16000, seed=35)

    def check_state(tag, state, frames):
        tensors = list(_tensors(state.tree))
        on_card = all(t.device.type == dev.type for t in tensors)
        print(f"clone {tag}: prompt {state.pos[0]} frames (expected {frames}), written {state.written}, "
              f"{len(tensors)} state tensors on the card: {on_card}", flush=True)
        if state.pos != [frames] or state.written != frames or not on_card:
            fail(f"clone {tag}: state pos {state.pos}, written {state.written}, on the card {on_card}; "
                 f"expected {frames} frames")

    frame = clone.frame_size
    state = clone.get_state_for_audio_prompt(wav10)
    check_state("10 s WAV", state, -(-10 * clone.sample_rate // frame))
    step_kernel.launches = segment_kernel.launches = 0
    segment_kernel.frames = 0
    audio = clone.generate_audio(state, TEXT)
    torch.cuda.synchronize()
    decoded = clone.last_generation["frames"]
    kernel_frames = step_kernel.launches + segment_kernel.frames
    finite = bool(np.isfinite(audio).all())
    print(f"clone 10 s WAV: generate_audio {audio.shape[0]} samples ({audio.shape[0] / clone.sample_rate:.2f} s), "
          f"finite {finite}, {decoded} frames decoded, {kernel_frames} through the B=1 kernels "
          f"(step {step_kernel.launches}, segment {segment_kernel.launches} launches)", flush=True)
    if audio.ndim != 1 or audio.shape[0] == 0 or audio.shape[0] % frame or not finite:
        fail(f"clone: generate_audio returned {audio.shape}, not finite audio of whole {frame}-sample frames")
    if decoded <= 0 or kernel_frames != decoded:
        fail(f"clone: {decoded} frames decoded but {kernel_frames} went through the B=1 kernels")
    long_state = clone.get_state_for_audio_prompt(wav35, truncate=True)
    check_state("35 s WAV, truncate=True", long_state, -(-30 * clone.sample_rate // frame))
    if long_state.pos[0] > 380:
        fail(f"clone: truncate=True kept {long_state.pos[0]} frames")
    del long_state
    samples = (np.random.default_rng(7).standard_normal(3 * clone.sample_rate + 777) * 0.1).astype(np.float32)
    check_state("[T] array", clone.get_state_for_audio_prompt(samples), -(-samples.shape[0] // frame))

    # Clone latency: CUDA events around each part, the card idle between
    # parts; read + convert runs on the host, so its events time its wall.
    parts = collections.defaultdict(list)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        wav = clone._read_audio_prompt(wav10)
        ev[1].record()
        with torch.no_grad():
            x = torch.as_tensor(wav[None], dtype=torch.float32).to(clone.device)
            latents = clone.mimi.encode_to_latent(clone.params["mimi"], x).transpose(1, 2)
            ev[2].record()
            prompt = clone.flow_lm.project_speaker(clone.params["flow_lm"], latents)
            ev[3].record()
        clone._state_from_prompt(prompt)
        ev[4].record()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
        for i, name in enumerate(("read + convert", "encode", "projection", "prefill")):
            parts[name].append(ev[i].elapsed_time(ev[i + 1]))
    med = {name: statistics.median(v[1:]) for name, v in parts.items()}  # the first run warms up
    print("clone latency, 10 s 16 kHz WAV, median of 5 warm runs: " + ", ".join(
        f"{name} {ms:.2f} ms" for name, ms in med.items()) + f"; sum {sum(med.values()):.2f} ms, host wall "
        f"{statistics.median(walls[1:]):.2f} ms (first run {walls[0]:.1f} ms); CUDA events [{card}]", flush=True)
    del clone
    torch.cuda.empty_cache()


def training_phase(torch, model, card, step_kernel, segment_kernel, dev) -> None:
    """Phase 14: fine-tuning at b6369a24 width: card/CPU parity of the loss
    and gradients, 20 timed AdamW steps, the train-state round trip, the
    export into an int8 serving model decoding through both B=1 kernels,
    and the B=1 kernels' capacity gate."""
    import numpy as np
    import yaml
    from torch.profiler import ProfilerActivity, profile

    import pocket_tts_tpu_torch.models.generate as generate
    from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
    from pocket_tts_tpu_torch.models.mimi import MimiModel
    from pocket_tts_tpu_torch.models.tts_model import ModelState, TTSModel
    from pocket_tts_tpu_torch.models.weights import (
        cast_serving_dtype,
        map_tensors,
        named_leaves,
        quantize_int8,
        save_checkpoint,
    )
    from pocket_tts_tpu_torch.ops.fused_backbone import MAX_CAPACITY
    from pocket_tts_tpu_torch.parallel.dryrun import train_batch
    from pocket_tts_tpu_torch.training import (
        adamw,
        flow_matching_loss,
        init_train_state,
        make_train_step,
        restore_train_state,
        save_train_state,
    )
    from pocket_tts_tpu_torch.training.flow_matching import flow_noise
    from pocket_tts_tpu_torch.utils.safetensors import load_safetensors

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for matmuls: the training step must run in float32")
    cfg = model.config
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(14)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    params["flow_lm"]["speaker_proj_weight"] = torch.randn(flow_lm.dim, flow_lm.speaker_dim, generator=gen) * 0.02

    # Parity: one loss and its gradients on the card and on the CPU, same
    # weights, batch and noise.
    batch = train_batch(flow_lm.n_bins, flow_lm.ldim, 2, 16, 32, seed=1)
    noise = flow_noise(torch.Generator().manual_seed(2), 2, 32, flow_lm.ldim)

    def loss_and_grads(where):
        state = init_train_state(flow_lm, map_tensors(params["flow_lm"], lambda t: t.to(where)), adamw(1e-3))
        loss, _ = flow_matching_loss(flow_lm, state.params, None, *(t.to(where) for t in batch),
                                     noise=tuple(t.to(where) for t in noise))
        loss.backward()
        return float(loss.detach()), {name: leaf.grad.cpu() for name, leaf in named_leaves(state.params)}

    (loss_cpu, grads_cpu), (loss_dev, grads_dev) = loss_and_grads("cpu"), loss_and_grads(dev)
    loss_rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    grad_rel, worst = 0.0, ""
    for name, ref in grads_cpu.items():
        scale = float(ref.abs().max())
        diff = float((grads_dev[name] - ref).abs().max())
        rel = diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))
        if rel > grad_rel:
            grad_rel, worst = rel, name
    print(f"training parity B=2 Tl=32, card vs CPU: loss {loss_dev:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.3g}, tol "
          f"{TOL_TRAIN_LOSS}); largest gradient difference {grad_rel:.3g} of its leaf's max |value| ({worst}; tol "
          f"{TOL_TRAIN_GRAD}) over {len(grads_cpu)} leaves [{card}]", flush=True)
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD):
        fail(f"training parity: loss rel {loss_rel:.3g}, gradient {grad_rel:.3g} at {worst}")
    del grads_cpu, grads_dev

    # Training: AdamW steps on one batch, each step's wall between CUDA events.
    state = init_train_state(flow_lm, map_tensors(params["flow_lm"], lambda t: t.to(dev)), adamw(1e-3))
    train_step = make_train_step(flow_lm)
    tokens, latents, eos = (t.to(dev) for t in train_batch(flow_lm.n_bins, flow_lm.ldim, 8, 32, 125, seed=3))
    rng = torch.Generator(device=dev).manual_seed(4)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    metrics = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    events[0].record()
    for i in range(TRAIN_STEPS):
        state, m = train_step(state, rng, tokens, latents, eos)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    host_s = time.monotonic() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    train_losses = [float(m["loss"]) for m in metrics]
    warm_ms = statistics.median(step_ms[1:])
    first5, last5 = statistics.mean(train_losses[:5]), statistics.mean(train_losses[-5:])
    print(f"training B=8 Tt=32 Tl=125: {TRAIN_STEPS} AdamW steps, loss {train_losses[0]:.4f} -> "
          f"{train_losses[-1]:.4f} (mean of the first five {first5:.4f}, of the last five {last5:.4f}); wall per step "
          f"between CUDA events: first {step_ms[0]:.2f} ms, median of the other {TRAIN_STEPS - 1} {warm_ms:.2f} ms "
          f"(min {min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}); host wall {host_s * 1e3 / TRAIN_STEPS:.2f} "
          f"ms per step [{card}]", flush=True)
    if not all(np.isfinite(train_losses)) or not last5 < first5:
        fail(f"training: the loss did not fall: {train_losses}")

    # Where a step's time goes: a profiled window of further steps.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_WINDOW):
            state, _ = train_step(state, rng, tokens, latents, eos)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = _kernel_events(torch, averages)
    if not kernels:
        fail("training: torch.profiler recorded no kernel in the profiled steps")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / TRAIN_WINDOW
    records = sum(e.count for e in kernels) / TRAIN_WINDOW
    # The optimizer: torch.optim's own record_function ranges. The host-side
    # range's device time sums the kernels its operators launched; the
    # device-side span runs from its first kernel to its last.
    opt = {}
    for name in ("Optimizer.step#", "Optimizer.zero_grad#"):
        host = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith(name)]
        span = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA and e.key.startswith(name)]
        opt[name] = [sum(e.device_time_total for e in host) / 1e3 / TRAIN_WINDOW,
                     sum(e.self_device_time_total for e in span) / 1e3 / TRAIN_WINDOW,
                     sum(e.cpu_time_total for e in host) / 1e3 / TRAIN_WINDOW]
    by_kind = {k: round(v / TRAIN_WINDOW, 3) for k, v in _busy_by_kind(kernels).items()}
    step_opt, zero = opt["Optimizer.step#"], opt["Optimizer.zero_grad#"]
    print(f"training step under torch.profiler ({TRAIN_WINDOW} steps): device busy {busy_ms:.2f} ms per step in "
          f"{records:.0f} kernel records, idle share {1 - busy_ms / warm_ms:.2f} against the unprofiled "
          f"{warm_ms:.2f} ms; optimizer.step {step_opt[0]:.3f} ms of kernel time per step "
          f"({step_opt[0] / max(busy_ms, 1e-9):.1%} of busy), a {step_opt[1]:.3f} ms device span, {step_opt[2]:.2f} ms on the host (profiled); zero_grad "
          f"{zero[0]:.3f} ms of kernel time, a {zero[1]:.3f} ms span; busy ms per step by kind {json.dumps(by_kind)} "
          f"[{card}]", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print("training step, largest kernels (device ms per step, records per step): " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3 / TRAIN_WINDOW:.3f} ms x{e.count // TRAIN_WINDOW}"
        for e in top), flush=True)

    # The train state round trip.
    out = ROOT / "build" / "finetune"
    save_train_state(state, out / "train_state.pt")
    template = init_train_state(flow_lm, map_tensors(params["flow_lm"], lambda t: t.to(dev)), adamw(1e-3))
    restored = restore_train_state(out / "train_state.pt", template)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(state.params), named_leaves(restored.params)))
    steps_done = TRAIN_STEPS + TRAIN_WINDOW
    print(f"train state saved and restored at step {restored.step}: params bit-identical {same}", flush=True)
    if restored.step != steps_done or not same:
        fail(f"train state round trip: step {restored.step} (expected {steps_done}), params equal {same}")
    del template, restored

    # Fine-tune to serving: export, load as an int8 model, decode.
    trained = map_tensors(state.params, lambda t: t.detach())
    weights = out / "finetuned.safetensors"
    n = save_checkpoint({"flow_lm": trained, "mimi": params["mimi"]}, weights)
    flat = load_safetensors(weights)
    exported = all(np.array_equal(flat[f"flow_lm.{name}"], leaf.cpu().numpy().reshape(flat[f"flow_lm.{name}"].shape))
                   for name, leaf in named_leaves(trained))
    raw = model.config.model_dump(mode="json")
    raw.update(weights_path=str(weights), weights_path_without_voice_cloning=None)
    (out / "finetuned.yaml").write_text(yaml.safe_dump(raw))
    tuned = TTSModel.load_model(out / "finetuned.yaml", param_dtype="int8", device=dev, eos_threshold=1e9)
    # What from_params makes of the trained weights: the serving cast and the
    # int8 codes, computed on the host as load_model computes them.
    trained_cpu = map_tensors(trained, lambda t: t.cpu())
    expected = quantize_int8(cast_serving_dtype({"flow_lm": trained_cpu}, torch.bfloat16))["flow_lm"]
    got = dict(named_leaves(tuned.params["flow_lm"]))
    loaded = all(torch.equal(got[name].cpu(), leaf) for name, leaf in named_leaves(expected))
    print(f"export: {n} tensors written, the file's FlowLM leaves equal the trained ones: {exported}; load_model "
          f"int8 from the file (random_init {tuned.random_init}): every FlowLM leaf equals the trained weights cast "
          f"and quantized: {loaded}", flush=True)
    if not (exported and loaded) or tuned.random_init:
        fail("export: the fine-tuned weights did not reach the int8 serving model")
    # A loaded checkpoint has no predefined voice offline: clone one.
    voice = tuned.get_state_for_audio_prompt(
        (np.random.default_rng(7).standard_normal(3 * tuned.sample_rate) * 0.1).astype(np.float32))
    step_kernel.launches = segment_kernel.launches = 0
    segment_kernel.frames = 0
    frames = list(tuned.generate_audio_stream(voice, TEXT))
    torch.cuda.synchronize()
    decoded = tuned.last_generation["frames"]
    kernel_frames = step_kernel.launches + segment_kernel.frames
    finite = all(f.shape == (1920,) and np.isfinite(f).all() for f in frames)
    print(f"fine-tuned int8 model: generate_audio_stream {len(frames)} frames, finite {finite}, {decoded} decoded, "
          f"{kernel_frames} through the B=1 kernels (step {step_kernel.launches}, segment {segment_kernel.launches} "
          f"launches)", flush=True)
    if not frames or not finite or min(step_kernel.launches, segment_kernel.launches) <= 0 or kernel_frames != decoded:
        fail("fine-tuned int8 model: the decode did not run through both B=1 kernels")
    del tuned, state, trained, trained_cpu, expected, got
    torch.cuda.empty_cache()

    # The capacity gate: past the B=1 kernels' largest cache (12288 rows)
    # the decode takes the plain path; 12416 is the next 128-row capacity
    # bucket. Latents are recorded where each segment reaches Mimi.
    gate = (MAX_CAPACITY, -(-(MAX_CAPACITY + 1) // 128) * 128)
    main_voice = model.get_state_for_audio_prompt("alba")
    decode_chunk = generate.decode_mimi_chunk
    runs = {}
    for C in gate:
        latents_seen = []

        def record(flow_params, mimi_params, mimi, lat, mimi_state):
            latents_seen.append(lat.clone())
            return decode_chunk(flow_params, mimi_params, mimi, lat, mimi_state)

        state = ModelState(model.flow_lm.expand_state(main_voice.tree, C), main_voice.pos, main_voice.written)
        model._gen.manual_seed(21)  # the same flow noise at both capacities
        step_kernel.launches = segment_kernel.launches = 0
        segment_kernel.frames = 0
        generate.decode_mimi_chunk = record
        try:
            t0 = time.monotonic()
            audio = model.generate_audio(state, TEXT)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            generate.decode_mimi_chunk = decode_chunk
        runs[C] = (torch.cat(latents_seen, dim=1)[0], model.last_generation["frames"],
                   step_kernel.launches + segment_kernel.frames, step_kernel.launches + segment_kernel.launches)
        print(f"capacity gate C={C}: decoded at capacity {model.last_generation['capacity']}, "
              f"{model.last_generation['frames']} frames in {wall * 1e3:.1f} ms, B=1 kernel launches: step "
              f"{step_kernel.launches}, segment {segment_kernel.launches}; audio finite "
              f"{bool(np.isfinite(audio).all())} [{card}]", flush=True)
        if model.last_generation["capacity"] != C or not np.isfinite(audio).all():
            fail(f"capacity gate C={C}: decoded at {model.last_generation['capacity']}, or non-finite audio")
    (lat_k, decoded_k, kernel_frames_k, _), (lat_p, _, _, launches_p) = (runs[C] for C in gate)
    if kernel_frames_k != decoded_k:
        fail(f"capacity gate: at C={gate[0]} {kernel_frames_k} of {decoded_k} frames went through the B=1 kernels")
    if launches_p:
        fail(f"capacity gate: at C={gate[1]} the B=1 kernels launched {launches_p} times")
    e_max, e_mean = max_err(lat_p, lat_k), float((lat_p - lat_k).abs().mean())
    print(f"capacity gate: {lat_p.shape[0]} latents on the plain path at C={gate[1]} against the kernels "
          f"at C={gate[0]}: max err {e_max:.3g} (tol {TOL_SEGMENT}), mean {e_mean:.3g} (tol "
          f"{TOL_SEGMENT_MEAN})", flush=True)
    if lat_p.shape != lat_k.shape or not (e_max <= TOL_SEGMENT and e_mean <= TOL_SEGMENT_MEAN):
        fail(f"capacity gate: latents differ by {e_max:.4g} (mean {e_mean:.4g})")
    torch.cuda.empty_cache()


def frame_errors(got, ref) -> list:
    """Each 1920-sample frame's largest |err| over the streams that hold it,
    relative to the stream's peak |audio|."""
    import numpy as np

    errs = [0.0] * (max(len(r) for r in ref) // 1920)
    for g, r in zip(got, ref):
        per = np.abs(g - r).reshape(-1, 1920).max(axis=1) / max(float(np.abs(r).max()), 1e-30)
        errs[: len(per)] = np.maximum(errs[: len(per)], per).tolist()
    return errs


def divergence(errs: list) -> str:
    first = next((f for f, e in enumerate(errs) if e > 1e-3), None)
    return (f"{max(errs):.3g} of the peak, frame 0 {errs[0]:.3g}, first frame over 1e-3 "
            f"{'none' if first is None else first} of {len(errs)}")


def mesh_phase(torch, card) -> tuple[int, float]:
    """Phase 15: dryrun_multichip(4) on 4 ranks sharing the card, and its
    sharded generate_audio_batch and train step held against the same model
    unsharded in this process; the batch kernel held against its plain
    version on a rank's heads at the capacity and read limits the ranks
    decoded with. Returns the batch kernel's launches on the ranks and its
    largest error here."""
    from unittest import mock

    import numpy as np

    from pocket_tts_tpu_torch.models.tts_model import TTSModel
    from pocket_tts_tpu_torch.models.weights import named_leaves
    from pocket_tts_tpu_torch.ops import batch_attention
    from pocket_tts_tpu_torch.parallel.dryrun import DRYRUN_TEXTS, TRAIN_BATCH, dryrun_multichip, train_batch
    from pocket_tts_tpu_torch.training import adamw, init_train_state, make_train_step
    from pocket_tts_tpu_torch.training.flow_matching import flow_noise

    t0 = time.monotonic()
    out = dryrun_multichip(4)
    wall = time.monotonic() - t0
    where = "a card each" if out["backend"] == "nccl" else "sharing one card"
    label = f"{len(out['launches'])} ranks {where} (dp={out['dp']}, tp={out['tp']}) over {out['backend']}"
    walls = ", ".join(f"{k} {v:.2f} s" for k, v in out["walls"].items())
    print(f"mesh: dryrun_multichip(4) {wall:.1f} s in all (spawn, kernel builds, model loads included); rank 0 walls: "
          f"{walls} [{label}; {card}]", flush=True)
    dev = torch.device("cuda")
    layers, frames, total, kernel_err = 6, out["frames"], 0, 0.0
    for kv in ("bf16", "int8"):
        per_rank = [r[kv] for r in out["launches"]]
        print(f"mesh ({kv} KV): batch_decode_attention launches per rank "
              f"{[r['batch_decode_attention'] for r in per_rank]} for {frames} frames x {layers} layers, B=1 kernel "
              f"launches per rank {[r['fused_backbone_step'] + r['fused_segment_decode'] for r in per_rank]}",
              flush=True)
        if any(r["batch_decode_attention"] != layers * frames or r["fused_backbone_step"] or r["fused_segment_decode"]
               for r in per_rank):
            fail(f"mesh ({kv} KV): every rank must attend through batch_decode_attention at every decode step "
                 f"and launch no B=1 kernel: {per_rank}")
        total += sum(r["batch_decode_attention"] for r in per_rank)
        model = TTSModel.load_model(temp=0.0, eos_threshold=1e9, param_dtype="int8", device="cuda",
                                    kv_int8=kv == "int8")
        # The kernel on a rank's slice: B / dp streams and H / tp heads (rows of 512 elements, not 1024), at
        # the capacity and every read limit the ranks decoded with.
        gen = out["generation"][kv]
        C, heads = gen["capacity"], model.config.flow_lm.transformer.num_heads // out["tp"]
        reads = tuple(sorted({C if r is None else max(8, min(r, C)) for r in gen["read_limits"]}, reverse=True))
        kernel_err = max(kernel_err, compare_batch_attention(
            torch, dev, batch_attention.batch_decode_attention, batch_attention.batch_decode_attention_reference,
            [(len(DRYRUN_TEXTS) // out["dp"], C, reads)], kinds=(kv,), H=heads))
        voice = model.get_state_for_audio_prompt("alba")
        t0 = time.monotonic()
        ref = model.generate_audio_batch(voice, DRYRUN_TEXTS)
        torch.cuda.synchronize()
        ref_wall = time.monotonic() - t0
        got = out["batch"][kv]
        if [g.shape for g in got] != [r.shape for r in ref]:
            fail(f"mesh ({kv} KV): stream lengths {[g.shape for g in got]} against {[r.shape for r in ref]}")
        errs = [float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1e-30) for g, r in zip(got, ref)]
        abs_err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
        print(f"mesh ({kv} KV): sharded generate_audio_batch of {len(got)} streams against the model unsharded: "
              f"max |err| {abs_err:.3g}, {max(errs):.3g} of the stream's peak (tol {TOL_MESH_AUDIO[kv]}); walls "
              f"{out['walls'][f'batch_{kv}']:.2f} s sharded [{label}], {ref_wall:.2f} s unsharded (first call) "
              f"[{card}]", flush=True)
        if max(errs) > TOL_MESH_AUDIO[kv]:
            fail(f"mesh ({kv} KV): sharded audio differs by {max(errs):.4g} of the peak")
        # Witness of the gap's kind: the same unsharded model with its batch attention on the plain sdpa_slots
        # (the kernel's rounding points, another summation order) against it on the kernel, and where each gap
        # opens over the frames.
        with mock.patch.object(batch_attention, "kernel_takes", lambda head_dim, device: False):
            plain = model.generate_audio_batch(voice, DRYRUN_TEXTS)
        print(f"mesh ({kv} KV) witness: sharded against unsharded {divergence(frame_errors(got, ref))}; unsharded "
              f"with plain attention against unsharded with the kernel {divergence(frame_errors(plain, ref))}",
              flush=True)
        del model, voice
        torch.cuda.empty_cache()

    model = TTSModel.load_model(device="cuda")  # float32, seed 0: the ranks' weights before sharding
    flow_lm = model.flow_lm
    state = init_train_state(flow_lm, model.params["flow_lm"], adamw(1e-3))
    del model
    B, Tt, Tl = TRAIN_BATCH
    batch = [t.to(dev) for t in train_batch(flow_lm.n_bins, flow_lm.ldim, B, Tt, Tl, seed=3)]
    noise = tuple(t.to(dev) for t in flow_noise(torch.Generator().manual_seed(4), B, Tl, flow_lm.ldim))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, metrics = make_train_step(flow_lm)(state, None, *batch, noise=noise)
    torch.cuda.synchronize()
    step_wall = time.monotonic() - t0
    loss = float(metrics["loss"])
    loss_rel = abs(out["train"]["loss"] - loss) / abs(loss)
    grad_rel, worst = 0.0, ""
    for name, leaf in named_leaves(state.params):
        ref = leaf.grad.cpu().numpy()
        scale, diff = float(np.abs(ref).max()), float(np.abs(out["train"]["grads"][name] - ref).max())
        rel = diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))
        if rel > grad_rel:
            grad_rel, worst = rel, name
    print(f"mesh train step B={B} Tt={Tt} Tl={Tl} float32: loss {out['train']['loss']:.6f} sharded vs {loss:.6f} "
          f"unsharded (rel {loss_rel:.3g}, tol {TOL_TRAIN_LOSS}); largest gradient difference {grad_rel:.3g} of its "
          f"leaf's max |value| ({worst}; tol {TOL_TRAIN_GRAD}); walls {out['walls']['train_step']:.3f} s sharded "
          f"(first step) [{label}], {step_wall:.3f} s unsharded (first step) [{card}]", flush=True)
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD):
        fail(f"mesh train step: loss rel {loss_rel:.3g}, gradient {grad_rel:.3g} at {worst}")
    del state
    torch.cuda.empty_cache()
    return total, kernel_err


def _expected_frames(model, text: str, text_pad: int) -> int:
    """Frames the engine decodes for `text` with EOS disabled: max_gen of
    every sentence chunk's token parts (the direct API's chunking)."""
    from pocket_tts_tpu_torch.default_parameters import MAX_TOKEN_PER_CHUNK
    from pocket_tts_tpu_torch.models.text import estimate_max_gen_len, split_into_best_sentences

    total = 0
    for chunk in split_into_best_sentences(model.tokenizer, text, min(MAX_TOKEN_PER_CHUNK, text_pad)):
        tokens = model.tokenizer.encode(chunk)
        for start in range(0, len(tokens), text_pad):
            total += estimate_max_gen_len(len(tokens[start : start + text_pad]), model.config.mimi.frame_rate)
    return total


def _percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _track_capacities(engine) -> set:
    """The set of KV capacities `engine` decodes at: its start and every
    growth (kept up to date as it serves)."""
    seen, grow = {engine.capacity}, engine._maybe_grow

    def maybe_grow():
        grow()
        seen.add(engine.capacity)

    engine._maybe_grow = maybe_grow
    return seen


def _serve_requests(torch, engine, voice, texts):
    """Submit 48 texts at once, then 2 every 40 ms, to the engine running in
    its serving thread; wait for every stream. -> (handles, audios, wall s)."""
    t0 = time.monotonic()
    handles = [engine.submit(t, voice) for t in texts[:48]]
    thread = engine.serve_forever_in_thread()
    for i in range(48, len(texts), 2):
        time.sleep(0.04)
        handles += [engine.submit(t, voice) for t in texts[i : i + 2]]
    audios = [h.audio() for h in handles]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine.stop()
    thread.join(timeout=120)
    if thread.is_alive():
        fail("the engine's serving thread did not stop")
    return handles, audios, wall


def engine_phase(torch, model, model8, card, batch_kernel, step_kernel, segment_kernel) -> dict:
    """Phase 9: the 64-slot engine over the kv_int8 model (a first engine
    serves the workload once to warm every shape it meets; a fresh one is
    measured), then a 1-slot engine over the bf16-KV model. Returns the
    kernels' launches of the measured runs and the capacities the engines
    decoded at."""
    import numpy as np

    from pocket_tts_tpu_torch.serving.engine import TTSEngine

    voice = model8.get_state_for_audio_prompt("alba")
    snapshot = copy.deepcopy(voice.tree)
    texts = BATCH_TEXTS + BATCH_TEXTS[:32]
    kw = dict(slots=64, segment_frames=8, capacity=384, record_frame_times=True)
    engine = TTSEngine(model8, **kw)
    batch_caps = _track_capacities(engine)
    _, _, wall = _serve_requests(torch, engine, voice, texts)
    print(f"engine warm-up: TTSEngine(slots=64, segment_frames=8, capacity=384), kv_int8, served the workload in "
          f"{wall:.2f} s (first use of its shapes)", flush=True)
    engine = TTSEngine(model8, **kw)
    caps = _track_capacities(engine)
    batch_kernel.launches = step_kernel.launches = segment_kernel.launches = 0
    handles, audios, wall = _serve_requests(torch, engine, voice, texts)
    n_batch = batch_kernel.launches
    layers = model8.flow_lm.config.transformer.num_layers
    expected = [_expected_frames(model8, t, engine.text_pad) for t in texts]
    got = [a.shape[0] // 1920 for a in audios]
    seconds = sum(a.shape[0] for a in audios) / model8.sample_rate
    ttfa = [h.frame_times[0] - h.submit_time for h in handles]
    lateness = np.concatenate([engine.frame_lateness(h) for h in handles])
    walls = engine.tick_walls
    print(f"engine: {len(handles)} requests, {seconds:.1f} s of audio in {wall:.2f} s, aggregate RTF "
          f"{seconds / wall:.1f}x; TTFA p50 {_percentile(ttfa, 50) * 1e3:.1f} ms, p99 {_percentile(ttfa, 99) * 1e3:.1f} "
          f"ms; lateness p99 {_percentile(lateness, 99) * 1e3:.1f} ms over {lateness.size} frames; tick wall p50 "
          f"{_percentile(walls, 50) * 1e3:.1f} ms, p99 {_percentile(walls, 99) * 1e3:.1f} ms over {len(walls)} ticks; "
          f"parks {engine.preemptions}, resumes {engine.resumes}, swaps {engine.swaps}, compactions "
          f"{engine.compactions}, growths {engine.growths} (capacity {engine.capacity}); "
          f"{engine.frames_dispatched} frames dispatched, batch kernel launches {n_batch} [{card}]", flush=True)
    if any(a.ndim != 1 or not np.isfinite(a).all() for a in audios) or got != expected:
        bad = [(t[:30], g, e) for t, g, e in zip(texts, got, expected) if g != e][:5]
        fail(f"engine: every request must return finite audio of exactly its expected frames; {bad}")
    if not (engine.preemptions > 0 and engine.resumes == engine.preemptions):
        fail(f"engine: {engine.preemptions} parks and {engine.resumes} resumes; expected some, all resumed")
    if engine.compactions < 1 or engine.growths < 1:
        fail(f"engine: {engine.compactions} compactions and {engine.growths} growths; expected at least one each")
    if n_batch != layers * engine.frames_dispatched or step_kernel.launches or segment_kernel.launches:
        fail(f"engine: {n_batch} batch kernel launches for {engine.frames_dispatched} frames x {layers} layers "
             f"(B=1 kernels {step_kernel.launches}, {segment_kernel.launches})")
    if not all(t.is_cuda for t in engine.state_tensors()):
        fail("engine: a state tensor is not on the card")
    if not all(torch.equal(x, y) for x, y in zip(_tensors(voice.tree), _tensors(snapshot))):
        fail("engine: serving changed the voice state")

    window_ms, profiled_ms, busy_ms, split, kernels = engine_window(torch, engine, voice)
    print(f"engine profile, 10 warm ticks after 64 admissions: wall {window_ms:.1f} ms unprofiled "
          f"({profiled_ms:.1f} ms with the profiler on), device busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} kernels, idle share {1 - busy_ms / window_ms:.2f} against the "
          f"unprofiled wall; busy ms by kind {json.dumps({k: round(v, 1) for k, v in split.items()})} [{card}]",
          flush=True)
    # Dispatch reads nothing back from the card (the pipelining rests on it):
    # queue two segments with every synchronising CUDA call made an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        queued = [engine._dispatch_segment(), engine._dispatch_segment()]
    except RuntimeError as exc:
        fail(f"engine: dispatching a segment synchronised with the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for dispatched in queued:
        engine._deliver(dispatched)
    print("engine: two segments dispatched with synchronising calls made errors: none made", flush=True)
    del engine
    torch.cuda.empty_cache()

    # One slot, bf16 KV: every frame through the per-frame B=1 kernel.
    voice1 = model.get_state_for_audio_prompt("alba")
    engine = TTSEngine(model, slots=1, segment_frames=4, capacity=384)
    step_caps = _track_capacities(engine)
    batch_kernel.launches = step_kernel.launches = segment_kernel.launches = 0
    pair = BATCH_TEXTS[:2]
    handles = [engine.submit(t, voice1) for t in pair]
    engine.run()
    audios = [h.audio() for h in handles]
    got = [a.shape[0] // 1920 for a in audios]
    expected = [_expected_frames(model, t, engine.text_pad) for t in pair]
    print(f"engine slots=1: {engine.frames_dispatched} frames dispatched, fused_backbone_step launches "
          f"{step_kernel.launches}, frames per request {got}, capacities {sorted(step_caps)} [{card}]", flush=True)
    if got != expected or any(not np.isfinite(a).all() for a in audios):
        fail(f"engine slots=1: frames {got}, expected {expected}, or non-finite audio")
    if step_kernel.launches != engine.frames_dispatched or batch_kernel.launches or segment_kernel.launches:
        fail(f"engine slots=1: {step_kernel.launches} fused_backbone_step launches for {engine.frames_dispatched} "
             f"frames (batch {batch_kernel.launches}, segment {segment_kernel.launches})")
    return {"batch_decode_attention": n_batch, "fused_backbone_step": step_kernel.launches,
            "batch_capacities": batch_caps | caps, "step_capacities": step_caps}


def profiled_busy(torch, fn):
    """Run fn under torch.profiler -> (wall ms with the profiler on, device
    busy ms, busy ms by kind, kernel events). Kernel events only: an
    operator's entry repeats the device time of the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = _kernel_events(torch, prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall_ms, busy_ms, _busy_by_kind(kernels), kernels


def _kernel_events(torch, averages):
    """The kernels among torch.profiler's averaged events: device events with
    device time, less the device-side spans of record_function ranges (such
    as torch.optim's `Optimizer.step#...`), which cover kernels counted
    already and the gaps between them."""
    return [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def engine_window(torch, engine, voice):
    """10 warm ticks after 64 admissions, twice on the same workload: once
    unprofiled for the wall (then drained), once under the profiler for the
    device busy time, which the profiler's host cost does not change.
    -> (unprofiled wall ms, profiled wall ms, busy ms, busy ms by kind,
    kernel events)."""

    def admit():
        for t in BATCH_TEXTS:
            engine.submit(t, voice)
        engine.run(max_ticks=4)
        torch.cuda.synchronize()

    admit()
    t0 = time.monotonic()
    engine.run(max_ticks=10)
    torch.cuda.synchronize()
    window_ms = (time.monotonic() - t0) * 1e3
    engine.run()
    admit()
    return (window_ms, *profiled_busy(torch, lambda: engine.run(max_ticks=10)))


def off_grid_engine(model, card, batch_kernel) -> set:
    """Phase 11: a 2-slot engine constructed at capacity=200, off the B=1
    kernels' 32-row grid, serves two short requests; it rounds the capacity
    up to 224, and text_pad=16 keeps the requests' need below that, so every
    step reads a ragged 224 rows. Returns the capacities it decoded at."""
    import numpy as np

    from pocket_tts_tpu_torch.serving.engine import TTSEngine

    voice = model.get_state_for_audio_prompt("alba")
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=200, text_pad=16)
    caps = _track_capacities(engine)
    pair = ["The quick brown fox.", "A bright cold day."]
    batch_kernel.launches = 0
    handles = [engine.submit(t, voice) for t in pair]
    engine.run()
    audios = [h.audio() for h in handles]
    got = [a.shape[0] // 1920 for a in audios]
    expected = [_expected_frames(model, t, engine.text_pad) for t in pair]
    layers = model.flow_lm.config.transformer.num_layers
    print(f"engine capacity=200, 2 slots: capacity {engine.capacity}, growths {engine.growths}, frames per request "
          f"{got}, {engine.frames_dispatched} frames dispatched, batch kernel launches {batch_kernel.launches} "
          f"[{card}]", flush=True)
    if engine.capacity != 224 or engine.growths or got != expected or any(not np.isfinite(a).all() for a in audios):
        fail(f"engine capacity=200: capacity {engine.capacity}, growths {engine.growths}, frames {got} (expected "
             f"{expected}), or non-finite audio")
    if batch_kernel.launches != layers * engine.frames_dispatched:
        fail(f"engine capacity=200: {batch_kernel.launches} batch kernel launches for {engine.frames_dispatched} "
             f"frames x {layers} layers")
    return caps


def _busy_by_kind(kernels) -> dict:
    categories = {"batch attention": ("decode_attention_kernel",),
                  "GEMM": ("gemm", "xmma", "gemv"), "convolution": ("conv", "cudnn"), "copy/cast": ("copy",)}
    split = dict.fromkeys([*categories, "other elementwise"], 0.0)
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in categories.items() if any(k in name for k in keys)), "other elementwise")
        split[cat] += e.self_device_time_total / 1e3
    return split


def server_phase(torch, model, card) -> set:
    """Phase 10: HTTP round trips through make_handler over an 8-slot engine
    with the server's defaults (PCM16 frames, capacity 4096), max_pending=16.
    Returns the capacities its engine decoded at."""
    import io
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    from pocket_tts_tpu_torch.serving.engine import TTSEngine
    from pocket_tts_tpu_torch.serving.server import make_handler

    engine = TTSEngine(model, slots=8, segment_frames=4, emit_pcm16=True, max_pending=16)
    caps = _track_capacities(engine)
    engine_thread = engine.serve_forever_in_thread()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(model, engine))
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    results, first_bytes = {}, {}

    def fetch(key, text):
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(f"{url}/tts?text={urllib.parse.quote(text)}&voice=alba", timeout=600) as r:
                head = r.read(46)  # the WAV header and the first PCM sample
                first_bytes[key] = time.monotonic() - t0
                results[key] = (r.status, head + r.read(), None)
        except urllib.error.HTTPError as exc:
            results[key] = (exc.code, b"", exc.headers.get("Retry-After"))

    def valid_wav(data: bytes) -> bool:
        w = wave.open(io.BytesIO(data))
        samples = (len(data) - 44) // 2  # the header's frame count is a placeholder
        pad = int(0.2 * model.sample_rate)  # the writer's trailing silence
        return (w.getframerate() == 24000 and w.getsampwidth() == 2 and w.getnchannels() == 1
                and samples > pad and (samples - pad) % 1920 == 0)

    fetch(("warm-up", 0), SERVER_TEXTS[-1])  # one request alone: builds the voice, first use of the shapes
    if results[("warm-up", 0)][0] != 200 or not valid_wav(results[("warm-up", 0)][1]):
        fail(f"server: the warm-up GET returned {results[('warm-up', 0)][0]} or not a valid WAV")
    cold_ms = first_bytes[("warm-up", 0)] * 1e3
    t0 = time.monotonic()
    threads = [threading.Thread(target=fetch, args=(("first", i), SERVER_TEXTS[i])) for i in range(8)]
    for t in threads:
        t.start()
    while len(first_bytes) < 8 and time.monotonic() - t0 < 300 and any(t.is_alive() for t in threads):
        time.sleep(0.01)
    burst = [threading.Thread(target=fetch, args=(("burst", i), SERVER_TEXTS[8 + i])) for i in range(40)]
    for t in burst:
        t.start()
    for t in threads + burst:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    codes = {}
    for key, (code, _, _) in results.items():
        codes[code] = codes.get(code, 0) + 1
    firsts = sorted(first_bytes[("first", i)] for i in range(8) if ("first", i) in first_bytes)
    print(f"server: 8 concurrent GETs then a burst of 40 in {wall:.2f} s; status codes {codes}; time to the first "
          f"PCM byte of the 8: median {statistics.median(firsts) * 1e3:.1f} ms (min {firsts[0] * 1e3:.1f}, max "
          f"{firsts[-1] * 1e3:.1f}; {cold_ms:.1f} ms for the warm-up GET alone); engine parks "
          f"{engine.preemptions}, rejected {engine.rejected} [{card}]", flush=True)
    if len(results) != 49 or any(t.is_alive() for t in threads + burst):
        fail("server: a request did not finish")
    for i in range(8):
        code, data, _ = results[("first", i)]
        if code != 200 or not valid_wav(data):
            fail(f"server: concurrent GET {i} returned {code} or not a 24 kHz 16-bit WAV of whole frames")
    shed = [(code, ra) for key, (code, _, ra) in results.items() if key[0] == "burst" and code == 503]
    if not shed or any(ra is None or int(ra) < 1 for _, ra in shed):
        fail(f"server: the burst drew no 503 with Retry-After >= 1 ({codes})")
    for key, (code, data, _) in results.items():
        if code == 200 and not valid_wav(data):
            fail(f"server: {key} returned 200 without a valid WAV")
        if code not in (200, 503):
            fail(f"server: {key} returned {code}")
    for path, want in (("/x", 404), ("/tts?text=", 400)):
        try:
            urllib.request.urlopen(url + path, timeout=60)
            got = 200
        except urllib.error.HTTPError as exc:
            got = exc.code
        if got != want:
            fail(f"server: GET {path} returned {got}, expected {want}")
    print(f"server: /x 404, empty text 400; {len(shed)} of 40 burst requests shed with Retry-After "
          f"{sorted({int(ra) for _, ra in shed})}", flush=True)
    httpd.shutdown()
    engine.stop()
    engine_thread.join(timeout=120)
    if engine_thread.is_alive():
        fail("the server's engine thread did not stop")
    return caps


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
