"""One client in a closed loop that clones a voice and then speaks in it:
each request writes a WAV prompt of its own (`prompt_seconds` of 16 kHz
mono: one of `wavs` seeded voices, started at a sample offset no other
request of the run uses, so no two requests send the same bytes), clones
it with get_state_for_audio_prompt(path) and streams a text through
generate_audio_stream from the cloned state. The time to first audio
includes the clone, not the write. The window is as in stream_closed."""

from __future__ import annotations

import tempfile
import time
import wave
import weakref
from pathlib import Path

import numpy as np

from common import FRAME_SECONDS, Context, Request, stream_request, texts
from system import build_model

OFFSET_STEP = 1601  # samples; prime, so (k * OFFSET_STEP) mod n differs for every k < n


def prompt_pcm(seconds: float, rate: int, rng: np.random.Generator) -> np.ndarray:
    """A seeded voice-like prompt (chip_smoke.py's): three harmonics of a
    pitch with a slow vibrato, a little noise, as 16-bit PCM."""
    t = np.arange(int(seconds * rate)) / rate
    f0 = rng.uniform(100, 220) + 20 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    wav = 0.3 * np.sin(phase) + 0.15 * np.sin(2 * phase) + 0.08 * np.sin(3 * phase)
    wav += 0.02 * rng.standard_normal(t.shape)
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def write_wav(path: Path, pcm: np.ndarray, rate: int) -> None:
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


def request_prompt(folder: Path, voices: list, i: int, rate: int) -> str:
    """Request i's WAV: voice i mod len(voices), rotated by a multiple of
    OFFSET_STEP that only this request uses (request i < len(voices) gets
    the voice as drawn)."""
    pcm = voices[i % len(voices)]
    path = folder / f"request{i}.wav"
    write_wav(path, np.roll(pcm, (i // len(voices)) * OFFSET_STEP % len(pcm)), rate)
    return str(path)


def voices(ctx: Context) -> list:
    """The run's `wavs` seeded voices, drawn once."""
    if "voices" not in ctx.counters:
        p, rng = ctx.params, ctx.rng("prompts")
        ctx.counters["voices"] = [prompt_pcm(p["prompt_seconds"], p["prompt_rate"], rng) for _ in range(p["wavs"])]
    return ctx.counters["voices"]


def request(ctx: Context, text: str, i: int, folder: Path) -> Request:
    """Request i as this traffic sends it, its WAV written to `folder`
    (calibrate.py's controls answer the same)."""
    return Request(text, request_prompt(folder, voices(ctx), i, ctx.params["prompt_rate"]), alone=True)


def setup(ctx: Context):
    model = build_model(ctx)
    p = ctx.params
    t0 = time.monotonic()
    folder = tempfile.TemporaryDirectory(prefix="bench-clone-")
    ctx.counters["prompt_folder"] = folder  # the reference reads the prompts after the program is gone
    warm = Path(folder.name) / "warmup.wav"
    write_wav(warm, voices(ctx)[-1][::-1].copy(), p["prompt_rate"])  # no request sends these bytes
    ctx.setup_split["prompts"] = time.monotonic() - t0
    t0 = time.monotonic()
    for words in (p["min_words"], p["max_words"]):
        state = model.get_state_for_audio_prompt(str(warm))
        for _ in model.generate_audio_stream(state, texts(ctx, 1, words, words, "warmup")[0]):
            pass
    ctx.setup_split["warmup"] = time.monotonic() - t0
    return {"model": model, "folder": Path(folder.name)}


def measure(ctx: Context, system: dict) -> None:
    p = ctx.params
    model = system["model"]
    pool = texts(ctx, 4096, p["min_words"], p["max_words"])
    alive: list = []  # weak references to every cloned state: a live one returned again is a cache hit
    reused = 0
    t0 = ctx.begin_window()
    i = 0
    while time.monotonic() - t0 < ctx.seconds:
        r = request(ctx, pool[i % len(pool)], i, system["folder"])
        ctx.requests.append(r)
        r.sent = r.due = time.monotonic()
        with ctx.span("clone", sync=ctx.trace):
            state = model.get_state_for_audio_prompt(r.voice)
        reused += any(w() is state for w in alive)
        alive = [w for w in alive if w() is not None] + [weakref.ref(state)]
        stream_request(ctx, model, state, r)
        del state
        i += 1
        ctx.poll()
    ctx.counters["clone_reused"] = reused
    ctx.window = (ctx.requests[0].sent, ctx.requests[-1].done)
    ctx.audio_seconds = sum(len(r.frame_times) for r in ctx.requests) * FRAME_SECONDS
