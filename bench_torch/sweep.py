"""The knee of the serving engine's cell: the highest of a set of Poisson
arrival rates at which the engine still serves every request, keeps its
time to first audio at the 95th percentile within the project's 500 ms bar
and does not let its backlog grow, with every lower rate passing too. Run
once on the card when the cell is defined; the cell then offers 4/5 of it.

    python3 bench_torch/sweep.py --workload engine64-poisson --seed <n> --seconds 20 --rates 4 6 8 10 12

One process builds the model once and gives each rate a fresh engine, the
cell's warm-up arrivals and a window of --seconds. Prints one line per rate
and a last JSON line with the table and the knee. The backlog (requests
accepted and not yet decoding) is sampled about once a second; it grows
where its mean over the window's last third exceeds that over its first
third by more than two requests."""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from common import Context, load_json, load_module, percentile  # noqa: E402

TTFA_BAR_S = 0.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="engine64-poisson")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pocket_tts_tpu_torch.serving.engine import TTSEngine

    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    driver = load_module(HERE / "traffic" / f"{workload['traffic']}.py")
    device = torch.device("cuda", 0)
    base = Context(workload, config, args.seed, args.seconds, False, device, time.monotonic())
    system = driver.setup(base)
    system.pop("engine", None)
    base.counters.clear()
    p = workload["params"]
    rows, knee = [], None
    for rate in sorted(args.rates):
        ctx = Context({**workload, "params": {**p, "rate": rate}}, config, args.seed, args.seconds, False, device,
                      time.monotonic())
        engine = TTSEngine(system["model"], slots=p["slots"], segment_frames=p["segment_frames"],
                           capacity=p["capacity"], record_frame_times=True)
        driver.warm_up(ctx, engine, system["voice"])
        ctx.counters["engine"] = engine
        driver.measure(ctx, {**system, "engine": engine})
        window = ctx.window_requests()
        ttfa = [r.ttfa for r in window if r.ttfa is not None]
        half = len(window) // 2
        early = [r.ttfa for r in window[:half] if r.ttfa is not None]
        late = [r.ttfa for r in window[half:] if r.ttfa is not None]
        row = {"rate": rate, "requests": len(window), "failed": sum(r.error is not None for r in window),
               "ttfa_p50_ms": 1e3 * percentile(ttfa, 50), "ttfa_p95_ms": 1e3 * percentile(ttfa, 95),
               "ttfa_p50_first_half_ms": 1e3 * percentile(early, 50),
               "ttfa_p50_second_half_ms": 1e3 * percentile(late, 50),
               "backlog_first_third": _mean_backlog(ctx, 0), "backlog_last_third": _mean_backlog(ctx, 2),
               "audio_s_per_s": ctx.audio_seconds / args.seconds,
               "tick_ms": 1e3 * sum(engine.tick_walls) / max(1, len(engine.tick_walls))}
        row["passes"] = (row["failed"] == 0 and len(ttfa) == len(window) and row["ttfa_p95_ms"] <= 1e3 * TTFA_BAR_S
                         and row["backlog_last_third"] <= row["backlog_first_third"] + 2)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if all(r["passes"] for r in rows):
            knee = rate
        del engine, ctx
        torch.cuda.empty_cache()
        if sum(not r["passes"] for r in rows) >= 2:
            break  # two rates past the knee are enough
    print(json.dumps({"card": torch.cuda.get_device_name(device), "knee": knee, "rows": rows}), flush=True)
    return 0


def _mean_backlog(ctx, third: int) -> float:
    """Mean backlog over one third of the window (0: first, 2: last)."""
    t0, t1 = ctx.window
    a, b = t0 + third * (t1 - t0) / 3, t0 + (third + 1) * (t1 - t0) / 3
    samples = [n for t, n in ctx.counters["backlog"] if a <= t < b]
    return sum(samples) / max(1, len(samples))


if __name__ == "__main__":
    sys.exit(main())
