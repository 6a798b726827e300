"""What every part of the benchmark shares: the run's context, request
records, spans, the traffic's texts and arrivals, and the statistics."""

from __future__ import annotations

import importlib.util
import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FRAME_SECONDS = 0.08  # one 1920-sample frame at 24 kHz

# The words of the traffic's texts (chip_smoke.py's BATCH_WORDS).
WORDS = (
    "the quick brown fox jumps over the lazy dog while a bright cold day in april strikes thirteen and every "
    "clock in the city keeps its own time as rivers run down to the sea past mills and bridges under a grey "
    "sky full of birds"
).split()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(config: dict):
    return load_module(HERE / "references" / f"{config['reference']}.py")


@dataclass
class Request:
    """One request as the traffic sent it and the program answered it.
    Times are time.monotonic() seconds; `due` is when an open loop meant to
    send it (a closed loop: when it was sent)."""

    text: str
    voice: str
    chunked: bool = True  # the API splits the text into sentence chunks
    alone: bool = False  # decoded by itself through the streaming API (the B=1 path)
    due: float = 0.0
    sent: float = 0.0
    first: Optional[float] = None  # first audio frame
    done: Optional[float] = None
    frame_times: list = field(default_factory=list)
    audio: Optional[np.ndarray] = None
    error: Optional[str] = None
    in_window: bool = True
    handle: object = None

    @property
    def ttfa(self) -> Optional[float]:
        return None if self.first is None else self.first - self.due


class Context:
    """One run: the cell, its configuration, the seed and window length, the
    spans the benchmark records around its calls, what the traffic driver
    reports, and the trace."""

    def __init__(self, workload: dict, config: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.workload, self.config = workload, config
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.t_start = t_start
        self.params = workload.get("params", {})
        self.spans: list[tuple[str, int, int]] = []  # (name, start, end) in time.time_ns()
        self.setup_split: dict[str, float] = {}
        self.requests: list[Request] = []
        self.window: tuple[float, float] = (0.0, 0.0)  # monotonic seconds
        self.audio_seconds = 0.0  # audio delivered in the window
        self.counters: dict = {}  # what per-layer metrics read, by name
        self.tracer = None
        self.memory_peak_bytes = 0
        self.setup_s = 0.0
        self.drained_at = 0.0  # when the traffic driver returned (a request with no frame waited until then)
        self.sync = lambda: None  # waits for the device (torch.cuda.synchronize on a card)
        self.device_name = ""

    @contextmanager
    def span(self, name: str, sync: bool = False):
        """Record a host span; sync=True waits for the device at both ends,
        so the span holds the device work of the calls inside it."""
        if sync:
            self.sync()
        t0 = time.time_ns()
        try:
            yield
        finally:
            if sync:
                self.sync()
            self.spans.append((name, t0, time.time_ns()))

    def span_seconds(self, name: str) -> list[float]:
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]

    def begin_window(self) -> float:
        """The window opens: set-up ends here, and a traced run's trace starts."""
        if self.tracer is not None:
            self.tracer.open(self.seconds)
        t = time.monotonic()
        self.setup_s = t - self.t_start
        return t

    def rng(self, stream: str) -> np.random.Generator:
        """A numpy generator drawn from the seed, one stream per use."""
        return np.random.default_rng([self.seed % 2**64, int.from_bytes(stream.encode()[:8], "little")])

    def poll(self) -> None:
        """Between requests: stop a trace that has run its length."""
        if self.tracer is not None:
            self.tracer.poll()

    def window_requests(self) -> list[Request]:
        return [r for r in self.requests if r.in_window]


def texts(ctx: Context, n: int, min_words: int, max_words: int, stream: str = "texts") -> list[str]:
    """n texts of words drawn from WORDS, each starting with a capital and
    ending with a period. Their word counts run through min_words..max_words
    in blocks, each block the whole range in an order drawn from the seed;
    a last, partial block takes evenly spaced counts. So any seed sends the
    same counts, and every prefix of whole blocks is balanced."""
    rng = ctx.rng(stream)
    lengths = np.arange(min_words, max_words + 1)
    whole, rest = divmod(n, len(lengths))
    blocks = [rng.permutation(lengths) for _ in range(whole)]
    blocks.append(rng.permutation(np.linspace(min_words, max_words, rest).round().astype(int)))
    counts = np.concatenate(blocks)
    return [" ".join(rng.choice(WORDS, size=int(k))).capitalize() + "." for k in counts]


def poisson_gaps(ctx: Context, n: int, rate: float, stream: str = "arrivals") -> np.ndarray:
    """n exponential inter-arrival gaps of mean 1 / rate: the same set of
    quantiles for every seed, in an order drawn from the seed."""
    q = (np.arange(n) + 0.5) / n
    return ctx.rng(stream).permutation(-np.log1p(-q) / rate)


def arrivals(ctx: Context, start: float, seconds: float, rate: float, stream: str) -> np.ndarray:
    """Poisson arrival times in [start, start + seconds): round(rate *
    seconds) of them, the first at `start`, spaced by exponential gaps of
    one set of quantiles for every seed in an order drawn from the seed,
    scaled to the phase. Every seed sends as many requests in the phase."""
    n = max(1, round(rate * seconds))
    gaps = poisson_gaps(ctx, n, rate, stream)
    return start + seconds * (np.cumsum(gaps) - gaps[0]) / gaps.sum()


def percentile(values, q: float) -> float:
    """The q-th percentile (linear interpolation between order statistics)
    over all values."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    pos = (v.size - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.size - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def rate(amount: float, window: tuple[float, float]) -> float:
    """Amount per second over the whole window."""
    return amount / (window[1] - window[0])


def stream_request(ctx: Context, model, voice, r: Request) -> None:
    """Drive generate_audio_stream for one request, timing each frame."""
    frames = []
    with ctx.span("stream"):
        for frame in model.generate_audio_stream(voice, r.text):
            now = time.monotonic()
            if r.first is None:
                r.first = now
            r.frame_times.append(now)
            frames.append(frame)
    r.done = time.monotonic()
    r.audio = np.concatenate(frames) if frames else np.zeros(0, np.float32)


def peak(ctx: Context, key: str):
    """A published peak of the run's card (peaks.json), or None."""
    name = ctx.device_name
    for card, peaks in load_json(HERE / "peaks.json").items():
        if card in name:
            return peaks[key]
    return None


def request_rows(ctx: Context, r: Request) -> list[tuple[int, int]]:
    """(valid cache rows, frame index within its chunk) of every frame the
    request was served: the voice prompt's rows, the chunk's text tokens,
    and the frames up to this one."""
    ref = reference_module(ctx.config)
    if not hasattr(ctx, "_tokenizer"):
        ctx._tokenizer = ref.HashTokenizer(ctx.config["model"]["flow_lm"]["lookup_table"]["n_bins"])
    if r.voice.endswith(".wav"):
        rate = ctx.config["model"]["mimi"]["sample_rate"]
        prompt = math.ceil(ctx.params["prompt_seconds"] * rate / ref.FRAME_SAMPLES)
    else:
        prompt = ctx.config["voice"]["prompt_frames"]
    chunks = ref.text_chunks(ctx._tokenizer, r.text) if r.chunked else [ctx._tokenizer.encode(r.text)]
    rows = []
    for tokens in chunks:
        rows += [(prompt + len(tokens) + f + 1, f) for f in range(ref.max_frames(len(tokens)))]
    return rows


def served_flops(ctx: Context, requests, keep=lambda r, i: True) -> float:
    """Model FLOPs (flops/<reference>.py) of the frames served to
    `requests`; keep(r, i) picks frame i of request r."""
    flops = load_module(HERE / "flops" / f"{ctx.config['reference']}.py")
    model, steps = ctx.config["model"], ctx.config["serving"]["lsd_decode_steps"]
    total = 0.0
    for r in requests:
        served = len(r.frame_times) if r.frame_times else (0 if r.audio is None else r.audio.shape[0] // 1920)
        for i, (rows, f) in enumerate(request_rows(ctx, r)[:served]):
            if keep(r, i):
                total += flops.frame_flops(model, rows, f, steps)
    return total
