"""The readings behind a cell's limits (how `correct` is decided, steps 4
and 5), on the card at the cell's own size:

    python3 bench_torch/calibrate.py --workload stream-b1 --sound 11 22 33 --control 44 55 66 --seconds 5

--sound: runs of the cell itself (run.run: the program set up from the
seed, the traffic for a short window at the cell's own load, then the
check) one after another in this one process; each prints its check's
numbers. The largest audio gap over them is the lower reading.

--control: for each control the configuration lists (`controls`, keys of
the reference's CONTROLS: the reference one precision step below what the
configuration states), the requests a run checks (the longest text of the
cell's range and texts drawn as the traffic draws them, sent as the
traffic's `request` sends them) answered by that control in the program's
place and judged by run.check, the code that judges every run. Each has
to come out not correct; the smallest audio gap is the upper reading.

Prints one JSON line per run and a last line with both readings."""

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402
from common import Context, load_json, load_module, texts  # noqa: E402


def control_check(workload: dict, config: dict, seed: int, control: str, device, folder: Path) -> tuple[bool, dict]:
    """run.check of the requests a run of the cell checks, answered by
    `control` in the program's place."""
    ref = load_module(HERE / "references" / f"{config['reference']}.py")
    driver = load_module(HERE / "traffic" / f"{workload['traffic']}.py")
    p = workload["params"]
    ctx = Context(workload, config, seed, 0.0, False, device, time.monotonic())
    n = workload["check_requests"]
    pool = texts(ctx, 1, p["max_words"], p["max_words"], "calibrate-longest")
    pool += texts(ctx, n - 1, p["min_words"], p["max_words"], "calibrate")
    ctx.requests = [driver.request(ctx, t, i, folder) for i, t in enumerate(pool)]
    model = ref.Reference(config, seed, device, control=control)
    for r in ctx.requests:
        r.audio = model.audio(r.voice, r.text, r.chunked, r.alone)
    del model
    return run.check(ctx, run.Checker(ctx))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    device = torch.device(args.device)
    lower, upper = 0.0, {}
    for seed in args.sound:
        a = run.parse(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)])
        result = run.run(a, workload, config, device, torch, t_start=time.monotonic())
        gap = result["check"]["audio_gap"]["value"]
        lower = max(lower, gap if gap is not None else float("inf"))
        print(json.dumps({"sound": seed, "correct": result["correct"], "attempted": result["attempted"],
                          "check": result["check"]}), flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="bench-calibrate-") as folder:
        for seed in args.control:
            for control in config["controls"]:
                ok, numbers = control_check(workload, config, seed, control, device, Path(folder))
                gap = numbers["audio_gap"]["value"]
                upper[control] = min(upper.get(control, float("inf")), gap if gap is not None else float("inf"))
                print(json.dumps({"control": control, "seed": seed, "correct": ok, "check": numbers}), flush=True)
                gc.collect()
    print(json.dumps({"workload": args.workload, "lower_reading": lower, "upper_readings": upper,
                      "limit": workload["limits"]["audio_gap"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
