"""The program's own spans in a traced run (the port's span recorder,
pocket_tts_tpu_torch/utils/trace.py). The metrics that read them call
attach() from their hook, so only a traced run records: it turns the
recorder on with a sink that keeps each record in
ctx.counters["program_spans"] and adds (name, start, end) to ctx.spans, so
that the device trace's breakdown names each idle gap by the innermost
program span around it. On a port without the recorder attach() does
nothing and the readers find nothing to read.

The first records() after the run fails a run whose trace lost its kernel
records (check_trace), turns the recorder off and prints, once,
on standard error: the traced window's idle seconds summed by the innermost
span around each gap's middle, over every gap; the share of idle time inside
a program span, inside a benchmark span only, and in no span; the host
time of each span in the traced window, less its children's; where the
decode loop ran, its segments' host time per frame clear of the trace and
in it; and where the engine ran, its ticks split into their parts."""

from __future__ import annotations

import importlib
import importlib.util
import sys
import time
from collections import defaultdict

import numpy as np

MODULE = "pocket_tts_tpu_torch.utils.trace"
TICK_PARTS = ("engine.admit", "engine.apply", "engine.fetch", "engine.deliver")
COPY_RECORDS = ("Memcpy", "Memset")  # the profiler's names of the device's copy and fill records


def attach(ctx) -> bool:
    """Turn the program's spans on for this run (once); False where the
    port has no recorder."""
    if ctx.counters.get("program_spans") is not None:
        return True
    if importlib.util.find_spec(MODULE) is None:
        return False
    trace = importlib.import_module(MODULE)
    records = ctx.counters["program_spans"] = []
    ctx.counters["program_span_ids"] = ids = set()
    # time.time_ns() of time.monotonic() == 0: converts the window's bounds.
    ctx.counters["epoch_of_monotonic_ns"] = time.time_ns() - time.monotonic_ns()

    def sink(record) -> None:
        records.append(record)
        span = (record.name, record.start_ns, record.end_ns)
        ids.add(id(span))
        ctx.spans.append(span)

    trace.enable(sink)
    ctx.counters["program_trace"] = trace
    return True


def check_trace(ctx) -> None:
    """Fail the run where the card's trace holds copy records and no kernel
    record: the kernels ran, but the profiler lost their records, and every
    device reading of the window would be wrong (an idle share near 100%)."""
    t = ctx.tracer
    if t is None or not t.stopped or not t.on_card or ctx.counters.get("trace_checked"):
        return
    events = t.device_events()
    if events and all(name.startswith(COPY_RECORDS) for name, _, _ in events):
        raise RuntimeError(f"the device trace holds {len(events)} copy records and no kernel record")
    ctx.counters["trace_checked"] = True


def records(ctx):
    """The run's program span records, or None where none were recorded.
    The first call checks the trace (check_trace), turns the recorder off
    and prints the idle summary."""
    check_trace(ctx)
    recs = ctx.counters.get("program_spans")
    if recs is None:
        return None
    trace = ctx.counters.pop("program_trace", None)
    if trace is not None:
        trace.disable()
        for line in summary(ctx):
            print(line, file=sys.stderr)
    return recs


def to_ns(ctx, monotonic_s: float) -> int:
    """A time.monotonic() reading on the spans' clock (time.time_ns())."""
    return int(monotonic_s * 1e9) + ctx.counters["epoch_of_monotonic_ns"]


def in_window(recs, name: str, lo_ns: int, hi_ns: int) -> list:
    """The records named `name` that start and end inside [lo_ns, hi_ns]."""
    return [r for r in recs if r.name == name and lo_ns <= r.start_ns and r.end_ns <= hi_ns]


def untraced(ctx, recs, name: str) -> list:
    """The records named `name` inside the window and clear of the trace:
    none that overlaps the traced seconds or the stopping of the trace,
    which slow the host."""
    lo, hi = (to_ns(ctx, t) for t in ctx.window)
    t = ctx.tracer
    a, b = t.t0_ns, max(t.t1_ns, to_ns(ctx, t.stop_span[1]))
    return [r for r in in_window(recs, name, lo, hi) if r.end_ns <= a or r.start_ns >= b]


def per_frame_us(segments):
    """Host microseconds of generate.segment spans per frame they decode
    (their S attributes); None without a frame."""
    frames = sum(r.attrs["S"] for r in segments)
    return sum(r.end_ns - r.start_ns for r in segments) / 1e3 / frames if frames else None


def tick_parts_ms(ctx, recs) -> tuple[int, dict]:
    """(ticks, mean ms per tick of engine.tick and each of its parts) over
    the engine.tick spans that engine.tick_ms reads: from the window's
    opening to the trace's start."""
    ticks = in_window(recs, "engine.tick", to_ns(ctx, ctx.window[0]), ctx.tracer.t0_ns)
    if not ticks:
        return 0, {}
    ids = {r.id for r in ticks}
    total = defaultdict(int)
    total["engine.tick"] = sum(r.end_ns - r.start_ns for r in ticks)
    for r in recs:
        if r.parent in ids and r.name in TICK_PARTS:
            total[r.name] += r.end_ns - r.start_ns
    return len(ticks), {name: ns / len(ticks) / 1e6 for name, ns in total.items()}


def idle_by_span(gaps, spans, program_ids) -> tuple[dict, dict]:
    """Idle nanoseconds by the innermost span around each gap's middle
    ("no span" outside all), and by where the middle lies: inside a
    program span, inside a benchmark span only, or in no span."""
    by_name: dict = defaultdict(int)
    by_kind = {"program": 0, "benchmark": 0, "none": 0}
    if not spans:
        by_name["no span"] = by_kind["none"] = sum(e - s for s, e in gaps)
        return by_name, by_kind
    starts = np.array([s for _, s, _ in spans], dtype=np.int64)
    ends = np.array([e for _, _, e in spans], dtype=np.int64)
    program = np.array([id(x) in program_ids for x in spans], dtype=bool)
    lengths = (ends - starts).astype(np.float64)
    for k in range(0, len(gaps), 1024):
        chunk = np.array(gaps[k : k + 1024], dtype=np.int64)
        mids = (chunk[:, 0] + chunk[:, 1]) // 2
        inside = (starts[None, :] <= mids[:, None]) & (mids[:, None] <= ends[None, :])
        innermost = np.where(inside, lengths[None, :], np.inf).argmin(axis=1)
        for (s, e), row, best in zip(chunk, inside, innermost):
            idle = int(e - s)
            if not row.any():
                by_name["no span"] += idle
                by_kind["none"] += idle
                continue
            by_name[spans[best][0]] += idle
            by_kind["program" if (row & program).any() else "benchmark"] += idle
    return by_name, by_kind


def self_time(recs, lo_ns: int, hi_ns: int) -> dict:
    """Host nanoseconds by span name inside [lo_ns, hi_ns], each span's own
    time: its interval clipped to the window, less its children's."""
    def clipped(r) -> int:
        return max(0, min(r.end_ns, hi_ns) - max(r.start_ns, lo_ns))

    own = {r.id: clipped(r) for r in recs}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= clipped(r)
    by_name: dict = defaultdict(int)
    for r in recs:
        if own[r.id] > 0:
            by_name[r.name] += own[r.id]
    return by_name


def summary(ctx) -> list[str]:
    """The lines the first records() prints (none without a stopped trace)."""
    t = ctx.tracer
    if t is None or not t.stopped:
        return []
    program_ids = ctx.counters["program_span_ids"]
    spans = [x for x in ctx.spans if x[1] <= t.t1_ns and x[2] >= t.t0_ns]
    by_name, by_kind = idle_by_span(t.idle_gaps(), spans, program_ids)
    idle = sum(by_kind.values())
    named = ", ".join(f"{n} {v / 1e9:.6f} s" for n, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
    shares = ", ".join(f"{k} {100.0 * v / idle:.1f}%" for k, v in by_kind.items()) if idle else "no idle time"
    lines = [f"program spans: idle {idle / 1e9:.6f} s of the {t.window_s:.6f} s traced window; by innermost span: "
             f"{named}", f"program spans: idle time inside a program span / a benchmark span only / no span: {shares}"]
    own = self_time(ctx.counters["program_spans"], t.t0_ns, t.t1_ns)
    lines.append("program spans: host time in the traced window by span, less its children: "
                 + ", ".join(f"{n} {v / 1e9:.6f} s" for n, v in sorted(own.items(), key=lambda kv: -kv[1])))
    segments = [r for r in ctx.counters["program_spans"] if r.name == "generate.segment"]
    if segments:
        lo, hi = t.t0_ns, t.t1_ns
        clear = {id(r) for r in untraced(ctx, segments, "generate.segment")}
        traced = [r for r in segments if lo <= r.start_ns and r.end_ns <= hi]
        lines.append("program spans: generate.segment per frame, us: clear of the trace "
                     f"{per_frame_us([r for r in segments if id(r) in clear])}, in the trace {per_frame_us(traced)}")
    n, parts = tick_parts_ms(ctx, ctx.counters["program_spans"])
    if n:
        split = " + ".join(f"{name} {parts.get(name, 0.0):.3f}" for name in TICK_PARTS)
        rest = parts["engine.tick"] - sum(parts.get(name, 0.0) for name in TICK_PARTS)
        lines.append(f"program spans: {n} engine ticks from the window's opening to the trace's start, mean ms: "
                     f"engine.tick {parts['engine.tick']:.3f} = {split} + the rest {rest:.3f}")
    return lines
