"""Model FLOPs of the frames served in the window (flops/<reference>.py),
per second of the window, as a share of the card's bf16 dense peak."""

from common import peak, served_flops


def read(ctx):
    p = peak(ctx, "bf16_flops_per_s")
    if p is None:
        return None
    seconds = ctx.window[1] - ctx.window[0] - ctx.tracer.paused(ctx.window)  # less the trace's stop
    return 100.0 * served_flops(ctx, ctx.window_requests()) / seconds / p
