"""95th percentile over every request of the window of the time to its
first audio frame, from when it was due (open loop) or sent (closed loop).
A request with no frame counts with the time it was waited for."""

from common import percentile


def read(ctx):
    waits = []
    for r in ctx.window_requests():
        waits.append(r.ttfa if r.ttfa is not None else ctx.drained_at - r.due)
    return 1e3 * percentile(waits, 95)
