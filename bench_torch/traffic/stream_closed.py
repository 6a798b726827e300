"""One client in a closed loop: generate_audio_stream of one text after
another from one predefined voice, each request sent when the last one's
final frame arrived. The window holds every request sent before `seconds`
ran out, from the first send to the last frame."""

from __future__ import annotations

import time

import numpy as np

from common import FRAME_SECONDS, Context, Request, stream_request, texts
from system import build_model


def request(ctx: Context, text: str, i: int, folder=None) -> Request:
    """Request i as this traffic sends it (calibrate.py's controls answer the same)."""
    return Request(text, ctx.params["voice"], alone=True)


def setup(ctx: Context):
    model = build_model(ctx)
    p = ctx.params
    t0 = time.monotonic()
    voice = model.get_state_for_audio_prompt(p["voice"])
    # Warm-up: texts spread over the length range, which meet every segment
    # size and cache capacity the traffic meets.
    for words in np.linspace(p["min_words"], p["max_words"], p["warmup_requests"]).round().astype(int):
        for _ in model.generate_audio_stream(voice, texts(ctx, 1, int(words), int(words), "warmup")[0]):
            pass
    ctx.setup_split["warmup"] = time.monotonic() - t0
    return {"model": model, "voice": voice}


def measure(ctx: Context, system: dict) -> None:
    p = ctx.params
    pool = texts(ctx, 4096, p["min_words"], p["max_words"])
    t0 = ctx.begin_window()
    i = 0
    while time.monotonic() - t0 < ctx.seconds:
        r = request(ctx, pool[i % len(pool)], i)
        ctx.requests.append(r)
        r.sent = r.due = time.monotonic()
        stream_request(ctx, system["model"], system["voice"], r)
        i += 1
        ctx.poll()
    ctx.window = (ctx.requests[0].sent, ctx.requests[-1].done)
    ctx.audio_seconds = sum(len(r.frame_times) for r in ctx.requests) * FRAME_SECONDS
