"""Offline batches in a closed loop: generate_audio_batch of `batch` texts
from one predefined voice, the next call sent when the last returns. The
window holds every call sent before `seconds` ran out, from the first send
to the last return, so whole calls are counted."""

from __future__ import annotations

import time

from common import Context, Request, texts
from system import build_model


def request(ctx: Context, text: str, i: int, folder=None) -> Request:
    """Request i as this traffic sends it (calibrate.py's controls answer the same)."""
    return Request(text, ctx.params["voice"], chunked=False)


def setup(ctx: Context):
    model = build_model(ctx)
    p = ctx.params
    t0 = time.monotonic()
    voice = model.get_state_for_audio_prompt(p["voice"])
    model.generate_audio_batch(voice, texts(ctx, p["batch"], p["min_words"], p["max_words"], "warmup"))
    ctx.setup_split["warmup"] = time.monotonic() - t0
    return {"model": model, "voice": voice}


def measure(ctx: Context, system: dict) -> None:
    p = ctx.params
    model, voice = system["model"], system["voice"]
    t0 = ctx.begin_window()
    calls = 0
    while time.monotonic() - t0 < ctx.seconds:
        batch = [request(ctx, t, calls * p["batch"] + j)
                 for j, t in enumerate(texts(ctx, p["batch"], p["min_words"], p["max_words"], f"call{calls}"))]
        sent = time.monotonic()
        with ctx.span("generate_audio_batch"):
            audios = model.generate_audio_batch(voice, [r.text for r in batch])
        done = time.monotonic()
        for r in batch:
            r.due, r.sent, r.done = sent, sent, done
        for r, a in zip(batch, audios):
            r.audio = a
        for r in batch[len(audios):]:
            r.error = "no audio returned"
        ctx.requests += batch
        calls += 1
        ctx.poll()
    ctx.window = (ctx.requests[0].sent, ctx.requests[-1].done)
    rate = ctx.config["model"]["mimi"]["sample_rate"]
    ctx.audio_seconds = sum(r.audio.shape[0] for r in ctx.requests if r.audio is not None) / rate
