"""The benchmark of the PyTorch and CUDA port of pocket-tts
(pocket_tts_tpu_torch), one cell per run:

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is workloads/<cell>.json: its configuration (configs/<config>.json,
with its plain reference in references/), its traffic driver
(traffic/<traffic>.py) and that traffic's parameters. The run builds the
model from the seed on the card, warms up the cell's shapes, measures for
`--seconds`, then checks a seeded sample of the window's answers against
the reference. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics, each read by metrics/<name>.py),
device, with --trace 1 a breakdown of the device trace, and last the
numbers compared with their limits. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 2.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from common import FRAME_SECONDS, Context, load_json, load_module  # noqa: E402

CHECK_SEED = "check"  # the stream of the seed that draws the requests compared


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def benchmark_metrics(workload: str, traced: bool) -> list[dict]:
    """The metrics BENCHMARK.json gives this cell: per-layer with --trace 1,
    end-to-end otherwise."""
    spec = load_json(ROOT / "BENCHMARK.json")
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in spec[kind] if "workloads" not in m or workload in m["workloads"]]


def card(torch, device) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


class Checker:
    """The plain reference of the cell's configuration (references/), built
    from the run's seed after the program's state is gone."""

    def __init__(self, ctx: Context):
        self.ref = load_module(HERE / "references" / f"{ctx.config['reference']}.py")
        self.model = self.ref.Reference(ctx.config, ctx.seed, ctx.device)
        self.rate = ctx.config["model"]["mimi"]["frame_rate"]

    def samples(self, r) -> int:
        """The PCM samples a request is due: every chunk's frames."""
        tok = self.model.tokenizer
        chunks = self.ref.text_chunks(tok, r.text) if r.chunked else [tok.encode(r.text)]
        return sum(self.ref.max_frames(len(c), self.rate) for c in chunks) * self.ref.FRAME_SAMPLES

    def gap(self, r) -> float:
        return self.ref.audio_gap(r.audio, self.model.audio(r.voice, r.text, r.chunked, r.alone))


def check(ctx: Context, checker: Checker) -> tuple[bool, dict]:
    """The numbers compared, each with its limit. Every request due in the
    window must have finished, with exactly its frames; a sample of them
    drawn from the seed, the longest included, is decoded again by the
    reference, and the widest audio gap of the sample is compared."""
    import math

    window = ctx.window_requests()
    done = [r for r in window if r.error is None and r.audio is not None]
    numbers = {"unfinished": (len(window) - len(done), 0),
               "frames_wrong": (sum(r.audio.shape[0] != checker.samples(r) for r in done), 0)}
    if "clone_reused" in ctx.counters:
        numbers["clone_reused"] = (ctx.counters["clone_reused"], 0)
    gap = math.inf
    if done:
        order = sorted(range(len(done)), key=lambda i: -done[i].audio.shape[0])
        rest = ctx.rng(CHECK_SEED).permutation(order[1:])[: ctx.workload["check_requests"] - 1]
        sample = [done[i] for i in [order[0], *rest]]
        gaps = [checker.gap(r) for r in sample]
        gap = max(gaps)
        frames = sum(r.audio.shape[0] for r in sample) // checker.ref.FRAME_SAMPLES
        print(f"check sample: {len(sample)} requests, {frames} frames; audio gaps {gaps}", file=sys.stderr)
    numbers["audio_gap"] = (gap, ctx.workload["limits"]["audio_gap"])
    ok = all(math.isfinite(v) and v <= lim for v, lim in numbers.values())
    return ok, {k: {"value": float(v) if math.isfinite(v) else None, "limit": lim} for k, (v, lim) in numbers.items()}


def run(args, workload: dict, config: dict, device, torch, t_start: float = T_START) -> dict:
    """One run of a cell on `device`; returns the result line's object. On
    a device other than a CUDA card (a rehearsal) no metric is reported under
    the result's `metrics`: the values go under `rehearsal`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    ctx = Context(workload, config, args.seed, args.seconds, bool(args.trace), device, t_start)
    if on_card:
        ctx.sync = torch.cuda.synchronize
        ctx.device_name = torch.cuda.get_device_name(device)
    ctx.setup_split["imports"] = time.monotonic() - t_start
    driver = load_module(HERE / "traffic" / f"{workload['traffic']}.py")
    metrics = benchmark_metrics(workload["name"], ctx.trace)
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py") for m in metrics}
    system = driver.setup(ctx)
    if ctx.trace:
        from devtrace import Tracer

        ctx.tracer = Tracer(torch, workload["trace_seconds"], workload.get("trace_at") == "end", on_card)
        ctx.tracer.prime()
        for reader in readers.values():
            if hasattr(reader, "hook"):
                reader.hook(ctx, system)
    driver.measure(ctx, system)
    ctx.drained_at = time.monotonic()
    if ctx.tracer is not None:
        ctx.tracer.stop()
    if on_card:
        torch.cuda.synchronize()
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else device.type, "count": 1,
                   "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if on_card:
        device_info.update(card(torch, device))
    breakdown = None
    if ctx.tracer is not None:
        device_info["busy_s"] = ctx.tracer.busy_s()
        device_info["window_s"] = ctx.tracer.window_s
        breakdown = ctx.tracer.breakdown(ctx.spans)
        t, events = ctx.tracer, ctx.tracer.device_events()
        first, last = ((events[0][1] - t.t0_ns) / 1e9, (events[-1][2] - t.t1_ns) / 1e9) if events else (None, None)
        probes = {name: t.delta(name) for name in t.probes}
        print(f"trace: {len(events)} device records over {t.window_s:.3f} s, busy {t.busy_s():.3f} s; first record "
              f"{first} s after the start, last {last} s after the stop; counters {probes}", file=sys.stderr)
    window = ctx.window_requests()
    failed = sum(r.error is not None for r in window)
    _log_run(ctx, failed)
    # The program's state goes before the reference runs.
    system = None
    ctx.counters.pop("engine", None)
    ctx.tracer = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ok, numbers = check(ctx, Checker(ctx))
    result = {"correct": ok, "attempted": len(window), "failed": failed,
              "metrics": values if on_card else {}, "device": device_info}
    if not on_card:
        result["rehearsal"] = values
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = numbers
    return result


def _log_run(ctx: Context, failed: int) -> None:
    """The run's own record on standard error: the set-up split, the window,
    the sample counts and the per-request latencies behind the metrics."""
    import numpy as np

    from common import percentile

    window = ctx.window_requests()
    ttfa = [r.ttfa for r in window if r.ttfa is not None]
    print(f"set-up {ctx.setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in ctx.setup_split.items()),
          file=sys.stderr)
    print(f"window {ctx.window[1] - ctx.window[0]:.3f} s, requests {len(window)} (failed {failed}), "
          f"audio {ctx.audio_seconds:.2f} s", file=sys.stderr)
    if ttfa:
        print(f"ttfa over {len(ttfa)} requests: p50 {1e3 * percentile(ttfa, 50):.2f} ms, p95 "
              f"{1e3 * percentile(ttfa, 95):.2f} ms, max {1e3 * max(ttfa):.2f} ms", file=sys.stderr)
    late = ctx.counters.get("lateness")
    if late:
        print(f"generator lateness: p95 {1e3 * percentile(late, 95):.2f} ms, max {1e3 * max(late):.2f} ms",
              file=sys.stderr)
    worst = [float(np.max(np.asarray(t) - (t[0] + FRAME_SECONDS * np.arange(len(t)))))
             for t in (r.frame_times for r in window) if len(t) > 1]
    if worst and ctx.counters.get("engine") is not None:
        print(f"frame lateness, worst per request: p95 {1e3 * percentile(worst, 95):.2f} ms over {len(worst)} "
              "requests", file=sys.stderr)


def main() -> int:
    args = parse()
    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    # Every build and kernel cache inside the checkout, at fixed paths.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"no result: {workload['name']} needs {workload['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run(args, workload, config, torch.device("cuda", 0), torch)
    for name, n in result["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
