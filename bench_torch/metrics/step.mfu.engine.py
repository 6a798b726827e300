"""The engine cell's step.mfu: model FLOPs of every frame delivered in the
window (to any request, those sent before it included), per second of the
window, as a share of the card's bf16 dense peak."""

from common import peak, served_flops


def read(ctx):
    p = peak(ctx, "bf16_flops_per_s")
    if p is None:
        return None
    t0, t1 = ctx.window
    flops = served_flops(ctx, ctx.requests, lambda r, i: t0 <= r.frame_times[i] < t1)
    return 100.0 * flops / (t1 - t0) / p
