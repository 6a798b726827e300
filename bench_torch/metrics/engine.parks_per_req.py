"""Streams the engine parked (TTSEngine.preemptions) in the window before
the trace starts, per request due in that part of the window (the trace,
the window's last seconds, slows the host)."""


def hook(ctx, system):
    engine = system["engine"]
    ctx.tracer.probes["engine_parks"] = lambda: engine.preemptions
    ctx.tracer.probes["engine_trace_start"] = lambda: __import__("time").monotonic()


def read(ctx):
    a = ctx.counters.get("engine_start")
    parks = ctx.tracer.marks.get(("engine_parks", "start"))
    until = ctx.tracer.marks.get(("engine_trace_start", "start"))
    if a is None or parks is None or until is None:
        return None
    n = sum(1 for r in ctx.window_requests() if r.due < until)
    return (parks - a[1]) / n if n else None
