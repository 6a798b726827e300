"""The engine cell's batch_decode_attention roofline: device time per call
against the K and V bytes of the valid rows of every active slot
(rooflines/batch_decode_attention.py) at the card's HBM peak. The valid
rows come from the engine's host mirror of the stream positions at each
segment it dispatches in the traced window (a slot at position p decodes
frame i of the segment over p + i + 1 rows); one launch per layer and
frame."""

import time

from common import HERE, load_module, peak


def hook(ctx, system):
    engine = system["engine"]
    dispatch = engine._dispatch_segment
    log = ctx.counters["dispatches"] = []

    def counted():
        before = list(engine._pos)
        out = dispatch()
        rows = frames = 0
        for b, _, _ in out[0]:
            s = engine._pos[b] - before[b]
            frames = max(frames, s)
            rows += s * before[b] + s * (s + 1) // 2
        log.append((time.time_ns(), rows, frames))
        return out

    engine._dispatch_segment = counted


def read(ctx):
    roof = load_module(HERE / "rooflines" / "batch_decode_attention.py")
    t, bw = ctx.tracer, peak(ctx, "hbm_bytes_per_s")
    times = t.kernel_times(roof.KERNEL)
    layers = ctx.config["model"]["flow_lm"]["transformer"]["num_layers"]
    traced = [(rows, frames) for at, rows, frames in ctx.counters.get("dispatches", []) if t.t0_ns <= at <= t.t1_ns]
    calls = sum(frames for _, frames in traced)
    if bw is None or not times or not calls:
        return None
    per_call = roof.call_bytes(ctx.config["model"], ctx.config["serving"]["kv_int8"],
                               sum(rows for rows, _ in traced) / calls)
    return 100.0 * per_call / bw / (sum(times) / len(times))
