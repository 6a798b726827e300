"""Share of the traced window in which no device operation ran: 1 minus the
union of the profiler's device records over the window."""


def read(ctx):
    t = ctx.tracer
    return None if t is None or not t.stopped else 100.0 * (1 - t.busy_s() / t.window_s)
