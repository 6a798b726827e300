"""Open-loop Poisson arrivals into the serving engine (TTSEngine driven by
serve_forever_in_thread): requests from one predefined voice at `rate` per
second, each submitted when it is due whatever the engine is doing. A
session before the arrivals warms the engine up; the arrivals of the first
`warmup_seconds` fill it and are set-up too; the window is the next
`seconds`. Arrivals go on after the window until every request due in it
has its first frame, then the window's requests are drained, so each one's
time to first audio, timed from when it was due, counts."""

from __future__ import annotations

import time

from common import FRAME_SECONDS, Context, Request, arrivals, texts
from system import build_model

DRAIN_SECONDS = 60.0  # how long past the window a request may take to finish


def request(ctx: Context, text: str, i: int, folder=None) -> Request:
    """Request i as this traffic sends it (calibrate.py's controls answer the same)."""
    return Request(text, ctx.params["voice"])


def setup(ctx: Context):
    from pocket_tts_tpu_torch.serving.engine import TTSEngine

    model = build_model(ctx)
    p = ctx.params
    voice = model.get_state_for_audio_prompt(p["voice"])
    engine = TTSEngine(model, slots=p["slots"], segment_frames=p["segment_frames"], capacity=p["capacity"],
                       record_frame_times=True)
    warm_up(ctx, engine, voice)
    ctx.counters["engine"] = engine
    return {"model": model, "voice": voice, "engine": engine}


def warm_up(ctx: Context, engine, voice) -> None:
    """One session before the arrivals start: the kernels' first use (a
    build in a fresh checkout), every prefill width, both segment sizes and
    the cache's growth to the capacity the longest texts need."""
    p = ctx.params
    t0 = time.monotonic()
    lo, hi = p["min_words"], p["max_words"]
    for words in (lo, (lo + hi) // 2, (lo + 3 * hi) // 4, hi):
        engine.submit(texts(ctx, 1, words, words, "warmup")[0], voice)
    engine.run()
    ctx.setup_split["warmup"] = time.monotonic() - t0


def measure(ctx: Context, system: dict) -> None:
    p = ctx.params
    engine, voice = system["engine"], system["voice"]
    rate, lo, hi = p["rate"], p["min_words"], p["max_words"]
    thread = engine.serve_forever_in_thread()
    base = time.monotonic()
    t_open = base + p["warmup_seconds"]
    t_close = t_open + ctx.seconds
    # Three phases, each with as many arrivals and the same text lengths for
    # every seed: the warm-up, the window, and after it until every request
    # due in the window has its first frame.
    phases = [(arrivals(ctx, base, p["warmup_seconds"], rate, "warmup-arrivals"), "warmup-texts", False),
              (arrivals(ctx, t_open, ctx.seconds, rate, "window-arrivals"), "window-texts", True),
              (arrivals(ctx, t_close, DRAIN_SECONDS, rate, "after-arrivals"), "after-texts", False)]
    window = []
    backlog = ctx.counters["backlog"] = []  # (time, requests accepted and not yet decoding), about once a second
    try:
        for dues, stream, in_window in phases:
            pool = texts(ctx, len(dues), lo, hi, stream)
            if in_window:
                _sleep_until(t_open)
                ctx.begin_window()
                ctx.counters["engine_start"] = (len(engine.tick_walls), engine.preemptions, engine.backlog)
            elif window:  # after the window
                _sleep_until(t_close)
                ctx.counters["engine_end"] = (len(engine.tick_walls), engine.preemptions, engine.backlog)
                if ctx.tracer is not None:
                    ctx.tracer.stop()  # the trace holds the window's last seconds
            for due, text in zip(dues, pool):
                if not in_window and window and all(r.handle.frame_times for r in window):
                    break
                _sleep_until(due)
                if not backlog or due - backlog[-1][0] >= 1.0:
                    backlog.append((due, engine.backlog))
                r = request(ctx, text, len(ctx.requests))
                r.due, r.in_window = due, in_window
                r.sent = time.monotonic()
                with ctx.span("submit"):
                    r.handle = engine.submit(r.text, voice)
                ctx.requests.append(r)
                if in_window:
                    window.append(r)
                ctx.poll()
        deadline = t_close + DRAIN_SECONDS
        while not all(r.handle.done for r in window) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        engine.stop()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the engine's serving thread did not stop")
    for r in ctx.requests:
        r.frame_times = list(r.handle.frame_times)
        r.first = r.frame_times[0] if r.frame_times else None
        if r.in_window:
            if r.handle.done:
                r.audio = r.handle.audio()
                r.done = r.frame_times[-1] if r.frame_times else r.sent
            else:
                r.error = "not finished within a minute of the window's close"
        r.handle = None
    ctx.window = (t_open, t_close)
    frames = sum(1 for r in ctx.requests for t in r.frame_times if t_open <= t < t_close)
    ctx.audio_seconds = frames * FRAME_SECONDS
    ctx.counters["lateness"] = [r.sent - r.due for r in ctx.requests]


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))
