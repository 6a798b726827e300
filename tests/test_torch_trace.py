"""The port's span recorder (pocket_tts_tpu_torch/utils/trace.py) and the
spans the serving engine, the decode loop and voice cloning record, on the
CPU at the tiny widths of the port's engine tests."""

import importlib.util
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.data.audio import audio_write
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from pocket_tts_tpu_torch.utils import trace
from tiny_config import TINY

ENGINE_SPANS = {"engine.tick", "engine.admit", "engine.apply", "engine.op.admit", "engine.op.prefill",
                "engine.op.segment", "engine.fetch", "engine.deliver"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def records():
    """Tracing on for one test, every record in the returned list."""
    out = []
    trace.enable(out.append)
    try:
        yield out
    finally:
        trace.disable()


@pytest.fixture(scope="module")
def model():
    cfg = Config(**TINY)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(0)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    params["flow_lm"]["speaker_proj_weight"] = torch.randn(flow_lm.dim, flow_lm.speaker_dim, generator=gen) * 0.02
    return TTSModel.from_params(cfg, params, FallbackWordTokenizer(4000), "float32", device="cpu", temp=0.7,
                                lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9)


@pytest.fixture(scope="module")
def voice(model):
    gen = torch.Generator().manual_seed(5)
    return model._state_from_prompt(torch.randn(1, 10, model.flow_lm.dim, generator=gen))


def _serve(model, voice, texts):
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=256, record_frame_times=True)
    handles = [engine.submit(t, voice) for t in texts]
    engine.run()
    return engine, handles


def _check_nesting(spans):
    """Every span with a parent lies inside its parent's interval, on its
    parent's thread."""
    by_id = {r.id: r for r in spans}
    assert len(by_id) == len(spans)
    for r in spans:
        assert r.start_ns <= r.end_ns
        if r.parent is not None and r.parent in by_id:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (p, r)
            assert p.thread == r.thread


def test_off_by_default_records_nothing(model, voice):
    got = []
    trace.enable(got.append)
    trace.disable()
    assert trace.span("engine.tick", slots=3) is trace.OFF
    with trace.span("x") as s:
        s.set(n=1)
    _serve(model, voice, ["One two three four."])
    list(model.generate_audio_stream(voice, "Five six seven."))
    assert got == []


def test_engine_works_out_no_span_attribute_while_off(model, voice, monkeypatch):
    def refused(self, **attrs):
        raise AssertionError(f"span attributes worked out with the recorder off: {attrs}")

    monkeypatch.setattr(trace._Off, "set", refused)
    engine, handles = _serve(model, voice, ["One two three four.", "Five six."])
    assert all(h.done for h in handles) and engine.tick_walls


def test_every_plan_item_has_its_span_name():
    from pocket_tts_tpu_torch.serving import engine

    ops = {name[len("_op_"):] for name in dir(TTSEngine) if name.startswith("_op_")}
    assert engine._OP_SPANS == {op: f"engine.op.{op}" for op in ops}


def test_serve_records_its_spans(model, voice, records):
    texts = ["One two three four five.", "Six seven eight.", "Nine ten eleven twelve thirteen."]
    engine, handles = _serve(model, voice, texts)
    names = {r.name for r in records}
    assert ENGINE_SPANS <= names, ENGINE_SPANS - names
    _check_nesting(records)
    by_id = {r.id: r for r in records}
    in_tick = Counter()
    for r in records:
        if r.name == "engine.tick":
            assert r.parent is None
        elif r.name.startswith("engine.op."):
            assert by_id[r.parent].name == "engine.apply"
        elif r.name.startswith("segment."):
            assert by_id[r.parent].name == "engine.op.segment"
        elif r.parent is not None:  # the iteration that starts from idle, and the last delivery, are no tick
            assert by_id[r.parent].name == "engine.tick"
            in_tick[r.name] += 1
    assert set(in_tick) == {"engine.admit", "engine.apply", "engine.fetch", "engine.deliver"}
    ticks = [r for r in records if r.name == "engine.tick"]
    assert len(ticks) == len(engine.tick_walls) + 1  # a wall is timed when the next tick starts
    first = next(r for r in records if r.name == "engine.op.segment")
    assert first.start_ns < ticks[0].start_ns  # dispatched by the iteration that started from idle
    assert sum(t.attrs["frames"] for t in ticks) == engine.frames_dispatched - engine.first_segment_frames
    assert sum(t.attrs["admitted"] for t in ticks) == len(texts) - 2  # two slots filled from idle
    for h in handles:
        assert h.done and h.frame_times
        assert h.submit_time <= h.admit_time <= h.frame_times[0]


def test_engine_spans_keep_to_their_thread(model, voice, records):
    """Spans of the engine's serving thread and of the caller's thread never
    take each other as parent, though they overlap in time."""
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=256)
    thread = engine.serve_forever_in_thread()
    try:
        with trace.span("caller") as caller:
            handles = [engine.submit(t, voice) for t in ("One two three.", "Four five six seven.")]
            deadline = time.monotonic() + 60
            while not all(h.done for h in handles) and time.monotonic() < deadline:
                with trace.span("caller.wait"):
                    time.sleep(0.005)
    finally:
        engine.stop()
        thread.join(timeout=60)
    assert not thread.is_alive() and all(h.done for h in handles)
    main = threading.get_ident()
    ours = {r.id for r in records if r.thread == main}
    theirs = {r.id for r in records if r.thread == thread.ident}
    assert ours and theirs and len(ours) + len(theirs) == len(records)
    for r in records:
        assert r.parent is None or r.parent in (ours if r.thread == main else theirs)
    assert {r.name for r in records if r.parent == caller.id} == {"caller.wait"}
    ticks = [r for r in records if r.name == "engine.tick"]
    outer = next(r for r in records if r.name == "caller")
    assert any(outer.start_ns < t.start_ns < outer.end_ns for t in ticks)  # they did overlap


def test_stream_records_the_decode_loop(model, voice, records):
    frames = list(model.generate_audio_stream(voice, "The quick brown fox jumps over the lazy dog."))
    names = Counter(r.name for r in records)
    for name in ("generate.prepare", "generate.prefill", "generate.segment", "generate.fetch", "segment.flow",
                 "segment.mimi"):
        assert names[name] >= 1, name
    _check_nesting(records)
    segments = [r for r in records if r.name == "generate.segment"]
    assert sum(r.attrs["S"] for r in segments) == model.last_generation["frames"]
    assert all(r.attrs["B"] == 1 for r in segments)
    assert len(frames) <= model.last_generation["frames"]
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name in ("segment.flow", "segment.mimi"):
            assert by_id[r.parent].name == "generate.segment"
    assert names["generate.fetch"] == len(segments)  # one read-back per streamed segment


def test_no_span_stays_open_across_a_yield(model, voice, records):
    """The caller's work between frames is its own: a span it opens there
    has the caller's span as parent, never one of the decode loop's."""
    with trace.span("caller") as caller:
        for _ in model.generate_audio_stream(voice, "One two three four five six."):
            with trace.span("caller.frame"):
                pass
    frames = [r for r in records if r.name == "caller.frame"]
    assert frames and all(r.parent == caller.id for r in frames)
    assert all(r.parent == caller.id for r in records if r.name.startswith("generate."))


def test_batch_records_fetch_and_collect(model, voice, records):
    texts = ["One two three.", "Four five six seven eight nine ten."]
    audios = model.generate_audio_batch(voice, texts)
    names = Counter(r.name for r in records)
    assert names["generate.collect"] == 1 and names["generate.prefill"] == 1
    segments = [r for r in records if r.name == "generate.segment"]
    assert names["generate.fetch"] == len(segments) and all(r.attrs["B"] == 2 for r in segments)
    assert sum(r.attrs["S"] for r in segments) == model.last_generation["frames"]
    collect = next(r for r in records if r.name == "generate.collect")
    assert all(r.end_ns <= collect.start_ns for r in segments)
    assert len(audios) == 2


def test_wav_clone_records_read_encode_and_prefill(model, tmp_path, records):
    t = np.arange(16000) / 16000
    path = tmp_path / "speaker.wav"
    audio_write(path, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    state = model.get_state_for_audio_prompt(path)
    assert state.pos[0] > 0
    names = [r.name for r in records]
    assert names == ["clone.read", "clone.encode", "voice.prefill"]
    assert all(r.parent is None for r in records)
    assert records[0].end_ns <= records[1].start_ns and records[1].end_ns <= records[2].start_ns


def test_span_clock_holds_the_profilers_op_record(records):
    """The recorder's clock is the device trace's: a span around a torch op
    holds the profiler's record of that op, as bench_torch/devtrace.py reads
    it (off a card it records host operators)."""
    path = Path(__file__).resolve().parents[1] / "bench_torch" / "devtrace.py"
    spec = importlib.util.spec_from_file_location("devtrace_for_test", path)
    devtrace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(devtrace)
    tracer = devtrace.Tracer(torch, 60.0, on_card=False)
    tracer.open(60.0)
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with trace.span("op"):
        torch.mm(a, b)
    tracer.stop()
    (op,) = records
    mm = [(s, e) for n, s, e in tracer.device_events() if n == "aten::mm"]
    assert len(mm) == 1
    assert op.start_ns <= mm[0][0] <= mm[0][1] <= op.end_ns
