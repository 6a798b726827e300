"""The benchmark's arithmetic on known inputs: percentiles, rates, the
traffic's schedule, the roofline byte counts, the FLOP count, and the
reference against the program at a tiny size."""

import copy
import math
import time
import types

import numpy as np
import pytest
import torch

from common import HERE, Context, load_json, load_module, percentile, poisson_gaps, rate, texts

B6369A24 = load_json(HERE / "configs" / "b6369a24-int8-bf16kv.json")
TINY = load_json(HERE / "tests" / "tiny.json")


def ctx_for(seed, workload=None, config=None):
    return Context(workload or {"params": {}}, config or B6369A24, seed, 10.0, False, torch.device("cpu"),
                   time.monotonic())


def test_percentile_over_all_samples():
    values = list(range(1, 101))
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile(values, 50) == pytest.approx(50.5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1001)
    assert percentile(x, 95) == pytest.approx(float(np.percentile(x, 95)))
    assert percentile([3.0], 95) == 3.0


def test_rate_over_the_whole_window():
    assert rate(10.0, (2.0, 7.0)) == pytest.approx(2.0)
    assert rate(0.0, (0.0, 1.0)) == 0.0


def test_poisson_schedule_from_the_seed():
    a = poisson_gaps(ctx_for(3_000_000_001), 1000, 8.0)
    b = poisson_gaps(ctx_for(3_000_000_001), 1000, 8.0)
    c = poisson_gaps(ctx_for(2**31 + 7), 1000, 8.0)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))  # every seed: the same gaps, in another order
    assert a.mean() == pytest.approx(1 / 8.0, rel=0.01)
    assert (a > 0).all()


def test_texts_every_seed_the_same_lengths():
    a = texts(ctx_for(5), 82, 6, 46)
    b = texts(ctx_for(6), 82, 6, 46)
    assert a != b
    assert sorted(len(t.split()) for t in a) == sorted(len(t.split()) for t in b)
    assert sorted(len(t.split()) for t in a) == sorted(list(range(6, 47)) * 2)
    assert all(t[0].isupper() and t.endswith(".") for t in a)


def test_phases_send_the_same_work_for_every_seed():
    from common import arrivals

    a = arrivals(ctx_for(1), 100.0, 30.0, 17.6, "window")
    b = arrivals(ctx_for(2**31 + 3), 100.0, 30.0, 17.6, "window")
    assert len(a) == len(b) == 528
    assert a[0] == b[0] == 100.0 and a.max() < 130.0 and b.max() < 130.0
    assert (np.diff(a) > 0).all()
    x = texts(ctx_for(1), 50, 6, 46, "window")
    y = texts(ctx_for(2), 50, 6, 46, "window")
    assert sorted(len(t.split()) for t in x) == sorted(len(t.split()) for t in y)


def test_segment_roofline_bytes_of_b6369a24():
    roof = load_module(HERE / "rooflines" / "fused_segment_decode.py")
    model = B6369A24["model"]
    # Hand count: int8 backbone 6 x (4 x 1024^2 + 2 x 1024 x 4096) + 1024 x 32; float32 row scales
    # 4 x (6 x 9216 + 1024); norm, EOS and BOS rows 4 x 27681; bf16 flow head 2 x 8945664; its
    # float32 rows 4 x 24096.
    assert roof.weight_bytes(model) == 75_530_240 + 225_280 + 110_724 + 17_891_328 + 96_384
    assert roof.frame_bytes(model, 300) == roof.weight_bytes(model) + 300 * 24_576


def test_batch_attention_valid_row_bytes():
    roof = load_module(HERE / "rooflines" / "batch_decode_attention.py")
    model = B6369A24["model"]
    assert roof.row_bytes(model, True) == 2 * (1024 + 4)
    assert roof.row_bytes(model, False) == 4096
    assert roof.call_bytes(model, True, 1000) == 2_056_000


def test_batch_attention_roofline_reader_counts_valid_rows():
    reader = load_module(HERE / "metrics" / "kern.batch_attn_roofline.py")
    ref = load_module(HERE / "references" / "pocket_tts.py")
    tok = ref.HashTokenizer(4000)
    cfg = copy.deepcopy(B6369A24)
    cfg["serving"]["kv_int8"] = True
    ctx = ctx_for(1, config=cfg)
    texts_ = ["One two three four five six.", " ".join(["word"] * 40) + "."]
    own = [ref.max_frames(len(tok.encode(t))) for t in texts_]
    assert own[0] < own[1]  # the short text needs fewer frames than the call decodes
    frames, layers = own[1], 6
    ctx.counters["attn_calls"] = [(texts_, layers * frames, False), (texts_, layers * frames, True)]
    ctx.device_name = "NVIDIA H100 80GB HBM3"
    ctx.tracer = types.SimpleNamespace(kernel_times=lambda name: [1e-5, 3e-5])
    # Each stream's rows up to its own frames: none for the frames the call decodes past them.
    rows = sum(125 + len(tok.encode(t)) + f + 1 for t, n in zip(texts_, own) for f in range(n))
    expected = 100 * rows / frames * 2056 / 3.35e12 / 2e-5  # the mean call's bytes over the mean record
    assert reader.read(ctx) == pytest.approx(expected)


def test_flops_per_frame_of_b6369a24():
    flops = load_module(HERE / "flops" / "pocket_tts.py")
    model = B6369A24["model"]
    # Hand count (2 FLOPs a multiply-add). FlowLM at 300 valid rows: input 65536, six layers of
    # 25165824 + 4096 x 300, EOS 2048. Flow head: 19464192. Mimi, frame 100 (window full, 250 rows):
    # 65536 + 217710592 (transformer) + 58720256 + 50331648 + 25165824 + 62914560 + 31457280
    # + 62914560 + 31457280 + 737280 (SEANet).
    step = 65_536 + 6 * (25_165_824 + 4096 * 300) + 2048
    assert flops.flowlm_flops(model, 300) == step + 19_464_192
    assert flops.mimi_flops(model, 100) == 541_474_816
    assert flops.frame_flops(model, 300, 100) == step + 19_464_192 + 541_474_816


def test_reference_layout_is_the_programs():
    from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
    from pocket_tts_tpu_torch.models.mimi import MimiModel
    from pocket_tts_tpu_torch.config.schema import Config

    ref = load_module(HERE / "references" / "pocket_tts.py")
    cfg = Config(**TINY["model"])
    fl = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(0)
    theirs = {"flow_lm": fl.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    ours = ref.make_params(TINY["model"], 0, "cpu")

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in shapes(sub, f"{path}.{key}").items()} or {path: "{}"}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree) for k, v in shapes(sub, f"{path}.{i}").items()} or {path: "[]"}
        return {path: tuple(tree.shape)}

    assert shapes(ours) == shapes(theirs)


@pytest.mark.parametrize("api", ["stream", "batch"])
def test_reference_equals_the_program_in_float32(api):
    """At float32 weights the program and the reference compute the same
    function: the gap is float32 rounding."""
    from pocket_tts_tpu_torch.config.schema import Config
    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    ref = load_module(HERE / "references" / "pocket_tts.py")
    cfg = copy.deepcopy(TINY)
    cfg["serving"]["param_dtype"] = "float32"
    cfg["numerics"] = {"gemm_inputs": "float32", "flow_head": "float32", "mimi_decoder": "float32",
                       "kv_cache": "float32", "attention": "float32", "stream_kernels": None}
    model = TTSModel.from_params(Config(**cfg["model"]), ref.make_params(cfg["model"], 77, "cpu"),
                                 ref.HashTokenizer(4000), "float32", device="cpu", temp=0.0, eos_threshold=1e9)
    model.random_init = True
    voice = model.get_state_for_audio_prompt("alba")
    text = "The quick brown fox jumps over the lazy dog while a bright cold day in april."
    if api == "stream":
        got = np.concatenate(list(model.generate_audio_stream(voice, text)))
    else:
        got = model.generate_audio_batch(voice, [text, "Past mills and bridges under a grey sky."])[0]
    want = ref.Reference(cfg, 77, "cpu").audio("alba", text, chunked=api == "stream")
    assert ref.audio_gap(got, want) < 1e-5
    assert math.isfinite(float(np.abs(want).max())) and np.abs(want).max() > 0
