"""95th percentile over the requests due in the window before the trace
starts (the trace holds the window's last seconds and slows the host, as
engine.tick_ms leaves its ticks out) of each one's wait in the engine's
queue: RequestHandle.admit_time (when its first chunk was planned into a
slot) minus its submit_time. A request never admitted counts until the
traffic finished (ctx.drained_at), as ttfa_p95_ms counts it.
traffic/engine_poisson.py drops its handles, so the hook keeps them, in the
order of ctx.requests, by wrapping the engine's submit on the instance."""

import program_spans
from common import percentile


def hook(ctx, system):
    if not program_spans.attach(ctx):
        return
    engine = system["engine"]
    submit = engine.submit
    handles = ctx.counters["engine_handles"] = []

    def kept(*args, **kwargs):
        handle = submit(*args, **kwargs)
        handles.append(handle)
        return handle

    engine.submit = kept


def read(ctx):
    program_spans.records(ctx)
    handles = ctx.counters.get("engine_handles")
    if not handles or len(handles) != len(ctx.requests):
        return None
    waits = []
    for r, h in zip(ctx.requests, handles):
        if r.text != h.text:
            return None
        if r.in_window and program_spans.to_ns(ctx, r.due) < ctx.tracer.t0_ns:
            admitted = h.admit_time if h.admit_time is not None else ctx.drained_at
            waits.append(admitted - h.submit_time)
    return 1e3 * percentile(waits, 95) if waits else None
