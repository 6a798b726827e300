"""Audio seconds delivered in the window over the window's seconds."""

from common import rate


def read(ctx):
    return rate(ctx.audio_seconds, ctx.window)
