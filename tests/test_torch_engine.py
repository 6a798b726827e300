"""The port's continuous-batching engine (pocket_tts_tpu_torch/serving/engine.py)
on the CPU at tiny widths: the cases of tests/test_engine.py against the
port, plus the port's own hazards (in-place caches against the voice and the
pipelined delivery, the shared slot_pos through every row mover, int8 KV
scales, device placement)."""

import time
import zlib

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer, estimate_max_gen_len
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.serving.engine import EngineOverloaded, TTSEngine
from tiny_config import TINY

RNG = np.random.default_rng(17)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops run fastest on one thread, and the suite's parallel workers
    would otherwise oversubscribe the cores with torch's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reseed(request):
    """Each test draws the same inputs however the tests are selected."""
    global RNG
    RNG = np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _tiny_model(param_dtype="float32", kv_int8=False, temp=0.7):
    cfg = Config(**TINY)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(0)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    return TTSModel.from_params(cfg, params, FallbackWordTokenizer(4000), param_dtype, device="cpu", temp=temp,
                                lsd_decode_steps=1, noise_clamp=None,
                                eos_threshold=1e9,  # EOS disabled -> deterministic lengths
                                kv_int8=kv_int8)


@pytest.fixture(scope="module")
def model():
    return _tiny_model()


def _prompt(n, dim):
    return torch.from_numpy(RNG.standard_normal((1, n, dim)).astype(np.float32))


@pytest.fixture
def voice(model):
    return model._state_from_prompt(_prompt(10, model.flow_lm.dim))


def _expected_frames(model, text):
    tokens = model.tokenizer.encode(text)
    return estimate_max_gen_len(len(tokens), model.config.mimi.frame_rate)


def _snapshot(tree):
    out = []
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += _snapshot(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            out += _snapshot(item)
    elif isinstance(tree, torch.Tensor):
        out.append(tree.clone())
    return out


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_engine_completes_more_requests_than_slots(model, voice):
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32)
    texts = ["One two three four five.", "Six seven eight nine ten eleven.", "Twelve thirteen fourteen."]
    handles = [engine.submit(t, voice) for t in texts]
    engine.run(stop_when_idle=True)
    for text, handle in zip(texts, handles):
        audio = handle.audio()
        assert handle.done
        assert audio.shape[0] == _expected_frames(model, text) * 1920  # EOS disabled: max_gen frames
        assert np.isfinite(audio).all()


def test_engine_mid_flight_admission(model, voice):
    engine = TTSEngine(model, slots=2, segment_frames=2, capacity=512, text_pad=32)
    h1 = engine.submit("Alpha beta gamma delta epsilon zeta eta.", voice)
    for _ in range(3):
        engine.step()
    h2 = engine.submit("Iota kappa lambda.", voice)
    engine.run(stop_when_idle=True)
    assert h1.audio().shape[0] == _expected_frames(model, "Alpha beta gamma delta epsilon zeta eta.") * 1920
    assert h2.audio().shape[0] == _expected_frames(model, "Iota kappa lambda.") * 1920


def test_engine_compaction(model, voice):
    """A small capacity forces compaction; streams must still complete."""
    engine = TTSEngine(model, slots=1, segment_frames=4, capacity=256, text_pad=32)
    texts = ["Aa bb cc dd ee.", "Ff gg hh ii jj.", "Kk ll mm nn oo."]
    handles = [engine.submit(t, voice) for t in texts]
    engine.run(stop_when_idle=True)
    assert engine.compactions >= 1
    for text, handle in zip(texts, handles):
        audio = handle.audio()
        assert audio.shape[0] == _expected_frames(model, text) * 1920
        assert np.isfinite(audio).all()


def test_engine_matches_generate_audio_at_temp_zero(model, voice):
    """temp=0 decodes without noise: the engine must reproduce the direct
    generate path (catches admission bugs)."""
    old_temp = model.temp
    model.temp = 0.0
    try:
        text = "Exact parity check sentence with several words."
        direct = model.generate_audio(voice, text, frames_after_eos=2, warmup_frames=1)
        engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32)
        handle = engine.submit(text, voice, frames_after_eos=2)
        engine.run(stop_when_idle=True)
        served = handle.audio()
        assert served.shape == direct.shape
        np.testing.assert_allclose(served, direct, rtol=1e-4, atol=1e-6)
    finally:
        model.temp = old_temp


def test_engine_pcm16_emission(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=4, capacity=512, text_pad=32, emit_pcm16=True)
    handle = engine.submit("Pcm sixteen emission test words.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    audio = handle.audio()
    assert audio.dtype == np.int16
    assert audio.shape[0] % 1920 == 0 and audio.shape[0] > 0


def test_engine_long_text_chunks(model, voice):
    """Texts beyond max_tokens split into chunks that stream through one
    handle, in order, each restarting from the voice state."""
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32)
    text = "One two three four five six. Seven eight nine ten eleven twelve."
    handle = engine.submit(text, voice, frames_after_eos=2, max_tokens=8)
    engine.run(stop_when_idle=True)
    expected = sum(_expected_frames(model, c)
                   for c in ["One two three four five six.", "Seven eight nine ten eleven twelve."])
    assert handle.audio().shape[0] == expected * 1920


def test_engine_cancellation(model, voice):
    """Cancelling frees the slot and ends the stream; others are unaffected."""
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32)
    long_text = "A very long sentence with many many words to speak."
    h1 = engine.submit(long_text, voice, frames_after_eos=2)
    for _ in range(2):
        engine.step()
    h1.cancel()
    h2 = engine.submit("Short follow up here.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    a1, a2 = h1.audio(), h2.audio()
    assert h1.done and h2.done
    assert a1.shape[0] < _expected_frames(model, long_text) * 1920
    assert a2.shape[0] == _expected_frames(model, "Short follow up here.") * 1920


def test_engine_randomized_churn(model):
    """10 requests with mixed voices and lengths over 3 slots, staggered:
    every handle completes with exactly its expected frames."""
    rng = np.random.default_rng(99)
    voices = [model._state_from_prompt(torch.from_numpy(rng.standard_normal((1, n, model.flow_lm.dim))
                                                        .astype(np.float32)))
              for n in (6, 14, 25)]
    engine = TTSEngine(model, slots=3, segment_frames=4, capacity=512, text_pad=32)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
    requests = [(" ".join(rng.choice(words, int(rng.integers(3, 9)))) + ".", voices[i % 3]) for i in range(10)]
    handles = []
    for i, (text, voice) in enumerate(requests):
        handles.append(engine.submit(text, voice, frames_after_eos=2))
        if i % 3 == 2:
            for _ in range(2):
                engine.step()
    engine.run(stop_when_idle=True)
    for (text, _), handle in zip(requests, handles):
        audio = handle.audio()
        assert handle.done
        assert audio.shape[0] == _expected_frames(model, text) * 1920, text
        assert np.isfinite(audio).all()


def test_engine_cancel_no_frames_after_terminator(model, voice):
    """Frames of stale in-flight segments never land after the terminator
    of a cancelled request (pipelined delivery)."""
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32)
    h = engine.submit("A very long sentence with many many words to speak.", voice, frames_after_eos=2)
    for _ in range(2):
        engine.step()
    h.cancel()
    engine.run(stop_when_idle=True)
    _ = h.audio()
    assert h._queue.empty()


def test_engine_cancel_while_queued(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32)
    h1 = engine.submit("First active request with several words.", voice, frames_after_eos=2)
    h2 = engine.submit("Queued request that gets cancelled.", voice, frames_after_eos=2)
    h2.cancel()
    engine.run(stop_when_idle=True)
    assert h1.audio().shape[0] > 0
    assert h2.done and h2.audio().shape[0] == 0


def test_engine_frame_times_and_lateness(model, voice):
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=256, text_pad=32, record_frame_times=True)
    h = engine.submit("One two three.", voice, frames_after_eos=1)
    engine.run(stop_when_idle=True)
    n_frames = h.audio().shape[0] // 1920
    assert len(h.frame_times) == n_frames > 0
    assert all(b >= a for a, b in zip(h.frame_times, h.frame_times[1:]))
    lateness = engine.frame_lateness(h)
    assert lateness.shape == (n_frames,)
    assert lateness[0] == 0.0
    assert engine.tick_walls and all(w >= 0 for w in engine.tick_walls)


def test_engine_grows_capacity_for_oversized_request(model):
    """A request beyond the constructed capacity is admitted after the cache
    grows at a tick boundary; the parking store grows with it."""
    long_voice = model._state_from_prompt(_prompt(64, model.flow_lm.dim))
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=128, text_pad=16, max_capacity=1024)
    text = "one two three four five six seven eight nine ten eleven twelve."
    h = engine.submit(text, long_voice, frames_after_eos=1)
    engine.run(stop_when_idle=True)
    assert engine.capacity > 128 and engine.growths == 1
    assert engine._store_flow["transformer"]["layers"][0]["k"].shape[1] == engine.capacity
    audio = h.audio()
    assert audio.shape[0] > 0 and np.isfinite(audio).all()
    h2 = engine.submit("hello there.", long_voice, frames_after_eos=1)
    engine.run(stop_when_idle=True)
    assert h2.audio().shape[0] > 0


def test_engine_rejects_beyond_max_capacity(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=4, capacity=64, text_pad=16, max_capacity=64)
    with pytest.raises(ValueError, match="max_capacity"):
        engine.submit("one two three four five six seven eight nine ten eleven twelve.", voice)


# --------------------------------------------------------------- preemption


def test_engine_refuses_a_max_capacity_past_the_card_kernel(model):
    """On the card every tick at slots > 1 reads the cache through the batch
    kernel, which takes at most MAX_READ_ROWS rows: a larger max_capacity is
    refused when the engine is built, not on the tick that first grows past
    it. A one-slot engine and a CPU engine take it."""
    from types import SimpleNamespace

    from pocket_tts_tpu_torch.ops.batch_attention import MAX_READ_ROWS

    on_card = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="max_capacity"):
        TTSEngine(on_card, slots=2, capacity=64, max_capacity=MAX_READ_ROWS + 4096)
    assert TTSEngine(model, slots=2, capacity=64, max_capacity=MAX_READ_ROWS + 4096).max_capacity > MAX_READ_ROWS


def test_engine_preemption_exact_audio_at_temp_zero(model, voice):
    """A stream parked mid-decode and resumed later produces exactly the
    audio of an unpreempted run (park/resume lose no KV, Mimi or carry
    state)."""
    old_temp = model.temp
    model.temp = 0.0
    try:
        long_text = "A very long sentence with many many words to speak aloud."
        short_text = "Quick interjection."
        direct = model.generate_audio(voice, long_text, frames_after_eos=2, warmup_frames=1)
        engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32,
                           preempt_min_lead_s=-1e9, resume_urgent_lead_s=-1e9)
        h1 = engine.submit(long_text, voice, frames_after_eos=2)
        for _ in range(3):
            engine.step()  # h1 delivers its first frames -> preemptable
        h2 = engine.submit(short_text, voice, frames_after_eos=2)
        engine.run(stop_when_idle=True)
        assert engine.preemptions >= 1 and engine.resumes >= 1
        np.testing.assert_allclose(h1.audio(), direct, rtol=1e-4, atol=1e-6)
        assert h2.audio().shape[0] == _expected_frames(model, short_text) * 1920
    finally:
        model.temp = old_temp


def test_engine_swap_back_with_all_lanes_full(model, voice):
    """Two streams sharing one slot and one parking lane time-share it
    through swaps, and both produce exactly their unpreempted audio."""
    old_temp = model.temp
    model.temp = 0.0
    try:
        t1 = "A very long sentence with many many words to speak aloud."
        t2 = "Another equally long sentence that also has many words in it."
        direct1 = model.generate_audio(voice, t1, frames_after_eos=2, warmup_frames=1)
        direct2 = model.generate_audio(voice, t2, frames_after_eos=2, warmup_frames=1)
        engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32, max_parked=1,
                           preempt_min_lead_s=-1e9, resume_urgent_lead_s=1e9, swap_margin_s=-1e9)
        h1 = engine.submit(t1, voice, frames_after_eos=2)
        for _ in range(3):
            engine.step()
        h2 = engine.submit(t2, voice, frames_after_eos=2)
        engine.run(stop_when_idle=True)
        assert engine.swaps >= 1, "the single-lane scenario must swap"
        np.testing.assert_allclose(h1.audio(), direct1, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(h2.audio(), direct2, rtol=1e-4, atol=1e-6)
    finally:
        model.temp = old_temp


def test_engine_preemption_randomized(model, voice):
    """Every arrival parks a victim: every stream still completes with
    exactly its expected frames."""
    engine = TTSEngine(model, slots=2, segment_frames=2, capacity=512, text_pad=32, preempt_min_lead_s=-1e9)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot"]
    rng = np.random.default_rng(5)
    requests = [" ".join(rng.choice(words, int(rng.integers(3, 7)))) + "." for _ in range(8)]
    handles = []
    for i, text in enumerate(requests):
        handles.append(engine.submit(text, voice, frames_after_eos=2))
        if i % 2 == 1:
            for _ in range(2):
                engine.step()
    engine.run(stop_when_idle=True)
    assert engine.preemptions >= 1
    for text, handle in zip(requests, handles):
        audio = handle.audio()
        assert handle.done
        assert audio.shape[0] == _expected_frames(model, text) * 1920, text
        assert np.isfinite(audio).all()


def test_engine_cancel_while_parked(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32,
                       preempt_min_lead_s=-1e9, resume_urgent_lead_s=-1e9)
    long_text = "A very long sentence with many many words to speak aloud."
    h1 = engine.submit(long_text, voice, frames_after_eos=2)
    for _ in range(3):
        engine.step()
    h2 = engine.submit("Quick interjection.", voice, frames_after_eos=2)
    engine.step()  # parks h1, admits h2
    assert len(engine._parked) == 1
    h1.cancel()
    engine.run(stop_when_idle=True)
    assert h1.done
    assert h1.audio().shape[0] < _expected_frames(model, long_text) * 1920
    assert h2.audio().shape[0] == _expected_frames(model, "Quick interjection.") * 1920


def test_engine_never_preempts_before_first_frame(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32,
                       preempt_min_lead_s=-1e9, resume_urgent_lead_s=-1e9)
    h1 = engine.submit("First stream words here.", voice, frames_after_eos=2)
    engine._admit_pending()
    assert engine._pick_victims(1, time.monotonic(), set()) == []
    h2 = engine.submit("Second stream words.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    assert h1.audio().shape[0] == _expected_frames(model, "First stream words here.") * 1920
    assert h2.audio().shape[0] == _expected_frames(model, "Second stream words.") * 1920


def test_engine_preemption_disabled(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32, preempt=False,
                       preempt_min_lead_s=-1e9)
    h1 = engine.submit("First stream words here.", voice, frames_after_eos=2)
    for _ in range(3):
        engine.step()
    h2 = engine.submit("Second stream words.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    assert engine.preemptions == 0
    assert h1.audio().shape[0] == _expected_frames(model, "First stream words here.") * 1920
    assert h2.audio().shape[0] == _expected_frames(model, "Second stream words.") * 1920


# --------------------------------------------------------- admission control


def test_engine_rejects_when_saturated(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32, max_pending=2)
    texts = ["One two three.", "Four five six."]
    accepted = [engine.submit(t, voice, frames_after_eos=2) for t in texts]
    with pytest.raises(EngineOverloaded) as exc:
        engine.submit("Ten eleven twelve.", voice, frames_after_eos=2)
    assert exc.value.retry_after_s > 0
    assert engine.rejected == 1
    engine.run(stop_when_idle=True)
    for text, h in zip(texts, accepted):
        assert h.done
        assert h.audio().shape[0] == _expected_frames(model, text) * 1920
    h = engine.submit("Accepted after drain.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    assert h.audio().size > 0


def test_engine_retry_after_tracks_drain_rate(model, voice):
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32)
    hs = [engine.submit(f"Warm up number {i}.", voice, frames_after_eos=2) for i in range(2)]
    engine.run(stop_when_idle=True)
    assert all(h.done for h in hs)
    assert len(engine._completions) == 2
    assert 0.5 <= engine._estimate_retry_after(backlog=8) <= 30.0


def test_engine_unbounded_by_default(model, voice):
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32)
    handles = [engine.submit(f"Request {i}.", voice, frames_after_eos=2) for i in range(12)]
    assert engine.backlog == 12
    engine.run(stop_when_idle=True)
    assert all(h.done for h in handles)
    assert engine.rejected == 0


def test_engine_16_slots_constructs_and_serves(model, voice):
    """A 16-slot engine constructs (the constructor-order regression of the
    JAX engine) and serves one stream at partial occupancy, where only the
    active row's audio is fetched."""
    engine = TTSEngine(model, slots=16, segment_frames=2, capacity=512, text_pad=32)
    h = engine.submit("Gather precompile regression.", voice, frames_after_eos=2)
    engine.run(stop_when_idle=True)
    assert h.done
    assert h.audio().shape[0] == _expected_frames(model, "Gather precompile regression.") * 1920


# --------------------------------------------------------- the port's own hazards


def test_engine_leaves_the_voice_bit_identical(model, voice):
    """The caches update in place: admission must copy the voice rows out of
    the cached expanded voice, never alias them, or the next tick would write
    into every later request's voice."""
    before = _snapshot(voice.tree)
    engine = TTSEngine(model, slots=2, segment_frames=2, capacity=128, text_pad=16)
    assert engine.capacity == voice.tree["transformer"]["layers"][0]["k"].shape[1]  # expand is a no-op
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in ("Alpha beta.", "Gamma delta epsilon.")]
    engine.run(stop_when_idle=True)
    assert all(h.done for h in handles)
    assert _same(before, _snapshot(voice.tree))


def test_engine_delivers_dispatch_time_snapshots(model, voice):
    """Under pipelining a segment is delivered after the next one is queued:
    delivery reads the carry snapshot taken at dispatch, so a slot that the
    next tick re-admits (which rewrites max_gen in place) still retires and
    emits by its own counters."""
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32)
    texts = ["One two.", "Three four five.", "Six seven."]
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in texts]
    engine.run(stop_when_idle=True)
    for text, h in zip(texts, handles):
        assert h.audio().shape[0] == _expected_frames(model, text) * 1920


def _check_shared_slot_pos(state):
    layers = state["transformer"]["layers"]
    assert all(l["slot_pos"] is layers[0]["slot_pos"] for l in layers)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_row_movers_keep_slot_pos_shared_and_move_scales(kv_int8, voice):
    """Admission, park, resume, swap, compaction and growth keep the one
    slot_pos tensor shared by every layer, in the batch state and in the
    parking store; an int8 cache's per-row scales move with their rows, and
    every state tensor stays on the model's device."""
    m = _tiny_model(kv_int8=kv_int8, temp=0.0)
    v = m._state_from_prompt(_prompt(10, m.flow_lm.dim))
    engine = TTSEngine(m, slots=1, segment_frames=2, capacity=128, text_pad=16, max_parked=1,
                       preempt_min_lead_s=-1e9, resume_urgent_lead_s=1e9, swap_margin_s=-1e9)
    texts = ["A long sentence with many words to speak aloud.", "Another long sentence with many words."]
    direct = [m.generate_audio(v, t, frames_after_eos=2, warmup_frames=1) for t in texts]
    h1 = engine.submit(texts[0], v, frames_after_eos=2)
    for _ in range(3):
        engine.step()
    h2 = engine.submit(texts[1], v, frames_after_eos=2)
    while not (h1.done and h2.done):
        engine.step()
        _check_shared_slot_pos(engine.flow_state)
        _check_shared_slot_pos(engine._store_flow)
    assert engine.swaps >= 1 and engine.compactions >= 1
    names = sorted(engine.flow_state["transformer"]["layers"][0])
    assert names == (["k", "k_scale", "slot_pos", "v", "v_scale"] if kv_int8 else ["k", "slot_pos", "v"])
    assert all(t.device == m.device for t in engine.state_tensors())
    for h, ref in zip((h1, h2), direct):
        # int8 rows: the engine's cache layout differs from the direct run's
        # (compaction, admission offsets), which moves no value; the decode is
        # the same arithmetic, so the waveforms agree to float32 noise.
        np.testing.assert_allclose(h.audio(), ref, rtol=1e-4, atol=1e-5)


def test_engine_run_stops_and_limits_ticks(model, voice):
    """run(max_ticks=n) returns after n decode ticks with nothing in flight,
    and stop() ends a serving loop."""
    engine = TTSEngine(model, slots=2, segment_frames=2, capacity=512, text_pad=32)
    h = engine.submit("A very long sentence with many many words to speak.", voice, frames_after_eos=2)
    engine.run(max_ticks=3)
    assert not h.done and engine.frames_dispatched == 2 + 2 + 2
    thread = engine.serve_forever_in_thread()
    h.audio()
    engine.stop()
    thread.join(timeout=30)
    assert not thread.is_alive() and h.done


def test_engine_never_parks_a_stream_that_reached_max_gen(model, voice):
    """Under pipelining a stream whose dispatched frames reached max_gen is
    still active until its last segment is delivered; it is never chosen to
    be parked or swapped out (the park would only be undone), so every park
    of a run with EOS disabled is resumed."""
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=512, text_pad=32, preempt_min_lead_s=-1e9)
    h = engine.submit("One two three.", voice, frames_after_eos=2)
    for _ in range(3):
        engine.step()
    slot = engine._slots[0]
    assert slot.active and slot.frames_left > 0
    assert engine._pick_victims(1, time.monotonic(), set()) == [0]
    slot.frames_left = 0
    assert engine._pick_victims(1, time.monotonic(), set()) == []
    slot.frames_left = 1
    engine.run()
    assert h.done
    engine = TTSEngine(model, slots=2, segment_frames=2, capacity=512, text_pad=32, preempt_min_lead_s=-1e9,
                       max_parked=2)
    handles = [engine.submit(f"Stream {w} with a few words.", voice, frames_after_eos=2)
               for w in ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot")]
    engine.run()
    assert all(h.done for h in handles)
    assert engine.preemptions >= 1 and engine.resumes == engine.preemptions
