"""The batch decode step as a captured CUDA graph (models/step_graph.py) and
what it rests on: cache writes at a device index, in-place compaction and
the batch path's kept decode state.

The CPU tests hold the device-indexed writes to the slice writes they stand
in for, in-place compaction to the gather it replaces, and the kept state to
the caller's voice; and show that the CPU and B=1 paths capture nothing.
The tests marked `card` need an NVIDIA card and skip without one: on the
card a replay must give the eager step's bits (latents, EOS flags, K/V,
scales, slot_pos), the launch counters must count what the replays ran, and
a key is captured once. This file imports no JAX, so it also runs on the
card: `python -m pytest --noconftest tests/test_torch_step_graph.py -m card`.
"""

import copy
import zlib

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.generate import step_graph_ok
from pocket_tts_tpu_torch.models.step_graph import StepGraphs
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.ops.attention import CausalKVAttention
from pocket_tts_tpu_torch.ops.batch_attention import batch_decode_attention
from pocket_tts_tpu_torch.ops.rope import rope_angles
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from pocket_tts_tpu_torch.utils import trace


def _config(d_model: int, num_heads: int) -> Config:
    """tests/tiny_config.TINY's model at another FlowLM width (head size
    d_model / num_heads; 64 takes the batch attention kernel on the card)."""
    return Config(**{
        "flow_lm": {
            "dtype": "float32",
            "flow": {"depth": 2, "dim": 32},
            "transformer": {"d_model": d_model, "hidden_scale": 2, "max_period": 10000, "num_heads": num_heads,
                            "num_layers": 2},
            "lookup_table": {"dim": d_model, "n_bins": 4000, "tokenizer": "sentencepiece",
                             "tokenizer_path": "unavailable://"},
        },
        "mimi": {
            "dtype": "float32", "sample_rate": 24000, "channels": 1, "frame_rate": 12.5,
            "seanet": {"dimension": 48, "channels": 1, "n_filters": 4, "n_residual_layers": 1, "ratios": [6, 5, 4],
                       "kernel_size": 7, "residual_kernel_size": 3, "last_kernel_size": 3, "dilation_base": 2,
                       "pad_mode": "constant", "compress": 2},
            "transformer": {"d_model": 48, "num_heads": 4, "num_layers": 1, "layer_scale": 0.01, "context": 32,
                            "dim_feedforward": 96, "input_dimension": 48, "output_dimensions": [48]},
            "quantizer": {"dimension": 8, "output_dimension": 48},
        },
    })


def _model(device="cpu", d_model=64, num_heads=4, param_dtype="float32", kv_int8=False, temp=0.7) -> TTSModel:
    cfg = _config(d_model, num_heads)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(0)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    return TTSModel.from_params(cfg, params, FallbackWordTokenizer(4000), param_dtype, device=device, temp=temp,
                                lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9, kv_int8=kv_int8)


@pytest.fixture
def rng(request):
    """Each test draws the same inputs however the tests are selected."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the captured step runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _leaves(tstate: dict) -> list:
    """(name, tensor) of every cache leaf of a FlowLM transformer state, the
    shared slot_pos once."""
    out = [(f"{i}.{name}", leaf) for i, layer in enumerate(tstate["layers"])
           for name, leaf in layer.items() if name != "slot_pos"]
    return out + [("slot_pos", tstate["layers"][0]["slot_pos"])]


def _fill_cache(state: dict, rng, valid: int) -> None:
    """Random rows in a CausalKVAttention cache (int8 codes with positive
    scales, or floats); the first `valid` rows of each stream at positions
    0.., a few holes among them, the rest invalid."""
    B, C = state["slot_pos"].shape
    if state["k"].dtype == torch.int8:
        for name in ("k", "v"):
            state[name].copy_(torch.from_numpy(rng.integers(-127, 128, state[name].shape).astype(np.int8)))
        for name in ("k_scale", "v_scale"):
            state[name].copy_(torch.from_numpy(rng.uniform(0.01, 0.1, (B, C)).astype(np.float32)))
    else:
        for name in ("k", "v"):
            state[name].copy_(torch.from_numpy(rng.standard_normal(state[name].shape).astype(np.float32)))
    sp = np.full((B, C), -1, dtype=np.int32)
    sp[:, :valid] = np.arange(valid)
    sp[rng.random((B, C)) < 0.2] = -1
    state["slot_pos"].copy_(torch.from_numpy(sp))


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("widx", [0, 9, 29, 31, 40, -2])  # C = 32: C - T and past it clamp, as below 0
def test_device_index_writes_equal_slice_writes(rng, dtype, T, widx):
    """An append at a one-element device tensor writes the K, V, scale and
    slot_pos rows that the host-int slice write does, clamped at C - T the
    same way, and attends the same."""
    B, C, E, H = 3, 32, 32, 2
    attn = CausalKVAttention(E, H)
    params = attn.init_params(torch.Generator().manual_seed(1))
    by_int = attn.init_state(B, C, dtype)
    _fill_cache(by_int, rng, valid=24)
    by_tensor = copy.deepcopy(by_int)
    x = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32))
    positions = torch.from_numpy(rng.integers(24, 40, (B, 1)).astype(np.int32)) + torch.arange(T, dtype=torch.int32)
    rope_cache = rope_angles(positions, E // H)
    out_int = attn(params, x, by_int, positions, widx, rope_cache)
    out_tensor = attn(params, x, by_tensor, positions, torch.tensor([widx], dtype=torch.int32), rope_cache)
    assert torch.equal(out_int, out_tensor)
    for name, leaf in by_int.items():
        assert torch.equal(leaf, by_tensor[name]), name
    w = min(max(widx, 0), C - T)
    assert torch.equal(by_tensor["slot_pos"][:, w : w + T], positions)


def _gather_compact(flow_lm: FlowLMModel, state: dict, new_written: int) -> dict:
    """compact_state as it was: a new tree of gathered copies."""
    sp = state["transformer"]["layers"][0]["slot_pos"]
    order = torch.argsort(torch.where(sp >= 0, sp, torch.full_like(sp, 2**30)), dim=1, stable=True)

    def g(_, a):
        return torch.gather(a, 1, order.reshape(order.shape + (1,) * (a.ndim - 2)).expand(a.shape))

    return flow_lm._map_rows(state, g, new_written)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_compact_state_in_place_keeps_every_buffer(rng, dtype):
    model = _model()
    fl = model.flow_lm
    state = fl.init_state(3, 48, dtype=dtype)
    for layer in state["transformer"]["layers"]:
        _fill_cache(layer, rng, valid=40)  # the shared slot_pos is drawn anew each time: the last draw holds
    state["transformer"]["widx"] = 40
    expected = _gather_compact(fl, copy.deepcopy(state), 40)
    ptrs = [leaf.data_ptr() for _, leaf in _leaves(state["transformer"])]
    out = fl.compact_state(state, 40)
    assert out is state and state["transformer"]["widx"] == 40
    assert [leaf.data_ptr() for _, leaf in _leaves(state["transformer"])] == ptrs
    for (name, got), (_, want) in zip(_leaves(state["transformer"]), _leaves(expected["transformer"])):
        assert torch.equal(got, want), name
    layers = state["transformer"]["layers"]
    assert all(l["slot_pos"] is layers[0]["slot_pos"] for l in layers)
    sp = layers[0]["slot_pos"]
    assert bool((sp[:, :-1] >= 0).ge(sp[:, 1:] >= 0).all())  # valid rows first


@pytest.mark.parametrize("kv_int8", [False, True])
def test_batch_path_keeps_its_state_and_leaves_the_voice_untouched(rng, kv_int8):
    """generate_audio_batch decodes in the model's kept state: the same
    buffers on a second call of the same sizes, the caller's voice
    bit-identical after both, the same audio at temperature 0, and at most
    two states kept."""
    model = _model(kv_int8=kv_int8, temp=0.0)
    voice = model._state_from_prompt(torch.from_numpy(rng.standard_normal((1, 10, model.flow_lm.dim))
                                                      .astype(np.float32)))
    before = [leaf.clone() for _, leaf in _leaves(voice.tree["transformer"])]
    pos, written, widx = list(voice.pos), voice.written, voice.tree["transformer"]["widx"]
    texts = ["One two three.", "Four five six seven."]
    first = model.generate_audio_batch(voice, texts)
    (key, kept), = model._batch_states.items()
    ptrs = [leaf.data_ptr() for _, leaf in _leaves(kept["transformer"])]
    second = model.generate_audio_batch(voice, texts)
    assert list(model._batch_states) == [key]
    assert [leaf.data_ptr() for _, leaf in _leaves(model._batch_states[key]["transformer"])] == ptrs
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    after = [leaf for _, leaf in _leaves(voice.tree["transformer"])]
    assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(before, after))
    assert (voice.pos, voice.written, voice.tree["transformer"]["widx"]) == (pos, written, widx)
    model.generate_audio_batch(voice, texts + ["Eight."])
    model.generate_audio_batch(voice, texts + ["Eight.", "Nine ten."])
    assert len(model._batch_states) == 2 and key not in model._batch_states


class _Rerun:
    """A stand-in for a captured graph on the CPU: a replay reruns the step."""

    def __init__(self, run):
        self.replay = run


@pytest.mark.parametrize("kv_int8,read_limit", [(False, None), (True, None), (True, 64)])
def test_step_graph_bookkeeping_matches_eager_steps(rng, monkeypatch, kv_int8, read_limit):
    """StepGraphs.decode with the capture replaced by a rerun of the step:
    the static inputs (latent chained frame to frame, BOS flags cleared
    after the first frame, positions and write index uploaded per frame)
    and the host mirrors give the eager decode_step's latents, EOS flags and
    caches exactly, over two segments of one key."""

    def capture(self, step, run):
        run()
        self.eager_steps += 1
        step.graph = _Rerun(run)
        self.captures += 1

    monkeypatch.setattr(StepGraphs, "_capture", capture)
    monkeypatch.setattr(StepGraphs, "_replay", staticmethod(lambda graph: graph.replay()))
    model = _model(param_dtype="int8", kv_int8=kv_int8)
    model.eos_threshold = 0.0
    fl, fp, B = model.flow_lm, model.params["flow_lm"], 3
    eager = fl.init_state(B, 96, dtype=model.flow_state_dtype)
    emb = torch.from_numpy(rng.standard_normal((B, 20, fl.dim)).astype(np.float32))
    eager = fl.prefill(fp, eager, emb, [20, 17, 12])
    graphed = copy.deepcopy(eager)
    latent = torch.from_numpy(rng.standard_normal((B, fl.ldim)).astype(np.float32))
    is_bos = torch.tensor([True, False, True])
    graphs = StepGraphs()
    for _ in range(2):
        noise = torch.from_numpy(rng.standard_normal((5, B, fl.ldim)).astype(np.float32))
        lats, flags = [], []
        lat = latent
        for i in range(5):
            eager, lat, eos = fl.decode_step(fp, eager, lat, is_bos if i == 0 else False, noise[i], 1, 0.0,
                                             read_limit=read_limit)
            lats.append(lat)
            flags.append(eos)
        got_lat, got_eos, replayed = graphs.decode(fl, fp, graphed, latent, is_bos, noise, 1, 0.0, read_limit)
        assert torch.equal(got_lat, torch.stack(lats)) and torch.equal(got_eos, torch.stack(flags))
        assert graphed["pos"] == eager["pos"] and graphed["transformer"]["widx"] == eager["transformer"]["widx"]
        for (name, a), (_, b) in zip(_leaves(graphed["transformer"]), _leaves(eager["transformer"])):
            assert torch.equal(a, b), name
        latent, is_bos = lats[-1], torch.zeros_like(is_bos)
    assert (graphs.captures, graphs.replays, graphs.eager_steps, replayed) == (1, 9, 1, 5)


def test_cpu_and_single_stream_paths_capture_nothing(rng):
    """On the CPU no step is captured or replayed, and no eager step on the
    card is counted, whatever the batch: generate_audio (B=1),
    generate_audio_batch and an engine of two slots; every `segment.flow`
    span says it replayed no frame."""
    model = _model()
    voice = model._state_from_prompt(torch.from_numpy(rng.standard_normal((1, 10, model.flow_lm.dim))
                                                      .astype(np.float32)))
    records = []
    trace.enable(records.append)
    try:
        model.generate_audio(voice, "One two three.")
        model.generate_audio_batch(voice, ["One two.", "Three four five."])
        engine = TTSEngine(model, slots=2, segment_frames=4, capacity=256, text_pad=32)
        engine.submit("Six seven.", voice)
        engine.run()
    finally:
        trace.disable()
    graphs = model.step_graphs
    assert (graphs.captures, graphs.replays, graphs.eager_steps) == (0, 0, 0)
    flows = [r for r in records if r.name == "segment.flow"]
    assert flows and all(r.attrs == {"replayed": 0} for r in flows)
    state = model.flow_lm.init_state(2, 32)
    assert not step_graph_ok(model.flow_lm, model.params["flow_lm"], state, 1, 8)


# ---------------------------------------------------------------- the card

CARD_CASES = [(B, kv, C, R) for B in (4, 64) for kv in ("bf16", "int8") for C, R in ((256, None), (256, 128),
                                                                                   (384, None), (384, 256))]


@pytest.fixture(scope="module")
def card_models():
    """int8 models at head size 64 on the card, bf16 and int8 KV (built at
    first use)."""
    return {}


def _card_model(card_models, kv: str) -> TTSModel:
    if kv not in card_models:
        card_models[kv] = _model("cuda", d_model=128, num_heads=2, param_dtype="int8", kv_int8=kv == "int8")
    return card_models[kv]


def _card_state(model: TTSModel, B: int, C: int, seed: int) -> dict:
    """A state of B streams at C rows, prefilled with 60 rows of seeded
    conditioning, some streams shorter."""
    fl, dev = model.flow_lm, model.device
    gen = torch.Generator().manual_seed(seed)
    state = fl.init_state(B, C, dtype=model.flow_state_dtype, device=dev)
    lengths = [60 - (b % 5) for b in range(B)]
    emb = (torch.randn(B, 60, fl.dim, generator=gen) * 0.5).to(dev)
    return fl.prefill(model.params["flow_lm"], state, emb, lengths)


def _eager_frames(model, state, latent, is_bos, noise_seq, read_limit):
    fl, fp = model.flow_lm, model.params["flow_lm"]
    lats, eos = [], []
    for i in range(noise_seq.shape[0]):
        state, latent, flags = fl.decode_step(fp, state, latent, is_bos if i == 0 else False, noise_seq[i], 1,
                                              model.eos_threshold, read_limit=read_limit)
        lats.append(latent)
        eos.append(flags)
    return torch.stack(lats), torch.stack(eos)


def _assert_same_state(a: dict, b: dict) -> None:
    assert a["pos"] == b["pos"] and a["transformer"]["widx"] == b["transformer"]["widx"]
    for (name, x), (_, y) in zip(_leaves(a["transformer"]), _leaves(b["transformer"])):
        assert torch.equal(x, y), name


@pytest.mark.card
@pytest.mark.parametrize("B,kv,C,R", CARD_CASES)
def test_replay_matches_eager_bit_for_bit(card, card_models, B, kv, C, R):
    """Two 4-frame segments (BOS on some streams in the first): the first
    frame warms up and captures, the other seven replay; latents, EOS flags,
    caches and the attention kernel's launch count equal the eager steps'."""
    model = _card_model(card_models, kv)
    model.eos_threshold = 0.0  # some streams flag EOS, some do not
    fp = model.params["flow_lm"]
    eager, graphed = _card_state(model, B, C, seed=B + C), _card_state(model, B, C, seed=B + C)
    gen = torch.Generator().manual_seed(7)
    latent = torch.randn(B, model.flow_lm.ldim, generator=gen).to(card)
    is_bos = (torch.arange(B) % 3 == 0).to(card)
    graphs = StepGraphs()
    for segment in range(2):
        noise = torch.randn(4, B, model.flow_lm.ldim, generator=gen).to(card)
        n = batch_decode_attention.launches
        want_lat, want_eos = _eager_frames(model, eager, latent, is_bos, noise, R)
        eager_launches = batch_decode_attention.launches - n
        n = batch_decode_attention.launches
        assert step_graph_ok(model.flow_lm, fp, graphed, 1, 4)
        got_lat, got_eos, replayed = graphs.decode(model.flow_lm, fp, graphed, latent, is_bos, noise, 1,
                                                   model.eos_threshold, R)
        torch.cuda.synchronize()
        assert batch_decode_attention.launches - n == eager_launches == 4 * 2  # a launch per layer and frame
        assert replayed == (3 if segment == 0 else 4)
        assert torch.equal(got_lat, want_lat) and torch.equal(got_eos, want_eos)
        _assert_same_state(graphed, eager)
        latent, is_bos = want_lat[-1], torch.zeros_like(is_bos)
    assert (graphs.captures, graphs.replays, graphs.eager_steps) == (1, 7, 1)


@pytest.mark.card
def test_in_place_compaction_replays_without_capture(card, card_models):
    """A compaction between segments rewrites the caches in place: the
    steps replay with no new capture, and stay the eager steps' bits."""
    model = _card_model(card_models, "int8")
    fp, B, C = model.params["flow_lm"], 8, 256
    eager, graphed = _card_state(model, B, C, seed=3), _card_state(model, B, C, seed=3)
    for state in (eager, graphed):  # holes in the written rows: compaction has rows to move
        model.flow_lm.invalidate_after(state, [40 + b for b in range(B)])
    gen = torch.Generator().manual_seed(11)
    latent = torch.randn(B, model.flow_lm.ldim, generator=gen).to(card)
    is_bos = torch.zeros(B, dtype=torch.bool, device=card)
    graphs = StepGraphs()
    for segment in range(3):
        noise = torch.randn(4, B, model.flow_lm.ldim, generator=gen).to(card)
        want_lat, want_eos = _eager_frames(model, eager, latent, is_bos, noise, None)
        got_lat, got_eos, _ = graphs.decode(model.flow_lm, fp, graphed, latent, is_bos, noise, 1,
                                            model.eos_threshold, None)
        assert torch.equal(got_lat, want_lat) and torch.equal(got_eos, want_eos)
        _assert_same_state(graphed, eager)
        latent = want_lat[-1]
        new_written = -(-(max(eager["pos"]) + 1) // 8) * 8
        ptrs = [leaf.data_ptr() for _, leaf in _leaves(graphed["transformer"])]
        model.flow_lm.compact_state(eager, new_written)
        model.flow_lm.compact_state(graphed, new_written)
        assert [leaf.data_ptr() for _, leaf in _leaves(graphed["transformer"])] == ptrs
    assert (graphs.captures, graphs.replays) == (1, 11)


@pytest.mark.card
def test_engine_captures_only_at_growth(card, card_models, rng):
    """A 4-slot engine decodes at 160 rows, then grows to 256 for a long
    text and compacts: one capture at its first segment and one at the
    growth, none at a compaction; every batch attention launch is counted."""
    model = _card_model(card_models, "int8")
    model.eos_threshold = 1e9  # every request runs to its max_gen
    graphs = model.step_graphs
    voice = model._state_from_prompt(torch.from_numpy(rng.standard_normal((1, 10, model.flow_lm.dim))
                                                      .astype(np.float32)))
    engine = TTSEngine(model, slots=4, segment_frames=4, capacity=160, text_pad=32, max_capacity=512)
    captures, n = graphs.captures, batch_decode_attention.launches
    for text in ["One two three four.", "Five six seven.", "Eight nine ten eleven twelve."]:
        engine.submit(text, voice)
    engine.run(max_ticks=3)
    assert (engine.capacity, graphs.captures - captures) == (160, 1)
    long = " ".join(f"w{i}" for i in range(26)) + "."
    for text in [long, "Thirteen fourteen.", long, "Fifteen sixteen seventeen."]:
        engine.submit(text, voice)
    engine.run()
    assert (engine.capacity, engine.growths) == (256, 1) and engine.compactions >= 1
    assert graphs.captures - captures == 1 + engine.growths
    assert batch_decode_attention.launches - n == 2 * engine.frames_dispatched


@pytest.mark.card
def test_generate_audio_batch_captures_once_per_key(card, card_models):
    """Two generate_audio_batch calls of the same sizes: the second captures
    nothing, replays every frame but none of the first's warm-ups, and its
    audio is the first's (temperature 0); launches count every frame."""
    model = _card_model(card_models, "int8")
    model.eos_threshold, model.temp = 1e9, 0.0
    voice = model._state_from_prompt(torch.randn(1, 10, model.flow_lm.dim, generator=torch.Generator()
                                                 .manual_seed(5)))
    texts = [f"Word {'a b c ' * (i % 7)}end." for i in range(16)]
    graphs = model.step_graphs
    outs, deltas = [], []
    for _ in range(2):
        before = (graphs.captures, graphs.replays, graphs.eager_steps, batch_decode_attention.launches)
        outs.append(model.generate_audio_batch(voice, texts))
        frames = model.last_generation["frames"]
        deltas.append((graphs.captures - before[0], graphs.replays - before[1], graphs.eager_steps - before[2],
                       batch_decode_attention.launches - before[3], frames))
    first, second = deltas
    assert first[0] >= 1 and first[0] == first[2] and first[1] + first[2] == first[4]
    assert second[:3] == (0, second[4], 0)
    assert first[3] == second[3] == 2 * first[4]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
