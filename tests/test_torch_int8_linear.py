"""The int8 weight-only linear (ops/linear.int8_linear, csrc/int8_linear.cu).

The CPU tests hold the route of an int8 leaf on a CPU tensor to the plain
form it has always had, bit for bit, and the wrapper's tiling rule
(`launch_config`, pure Python) at every shape the models serve. The tests
marked `card` need an NVIDIA card and skip without one: there the kernel is
held against its plain version at every served shape, the wrapper's refusals
are checked, a captured replay must give the eager call's bits, and the
launch counter must count 25 launches per decoded batch frame of a 6-layer
model. This file imports no JAX, so it also runs on the card:
`python -m pytest --noconftest tests/test_torch_int8_linear.py -m card`.
"""

import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.models.weights import quantize_int8
from pocket_tts_tpu_torch.ops import _cuda
from pocket_tts_tpu_torch.ops.linear import (
    MAX_SHARED,
    MAX_SPLIT,
    ROWS_WARPS_K,
    TILES,
    UNIT,
    int8_linear,
    int8_linear_reference,
    launch_config,
    linear,
    qkv_proj,
    rows_shared_bytes,
)

# (N, K) of the b6369a24 FlowLM's int8 linears: QKV, out_proj, linear1,
# linear2, input_linear.
SERVED = [(3072, 1024), (1024, 1024), (4096, 1024), (1024, 4096), (1024, 32)]
ROWS = [1, 3, 64, 65, 8192]
H100_SMS = 132


@pytest.fixture
def rng(request):
    """Each test draws the same inputs however the tests are selected."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _leaf(rng, N, K, device="cpu"):
    """An int8 leaf as quantize_int8 makes it, from seeded float weights."""
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)) / K ** 0.5
    leaf = quantize_int8({"flow_lm": {"input_linear": {"weight": w}}}, ("input_linear",))["flow_lm"]
    return {k: v.to(device) for k, v in leaf["input_linear"]["weight"].items()}


def _plain_form(x, leaf):
    """The int8 branch of ops/linear.linear written out: the bf16 round trip
    of x, a float32 GEMM on the codes, the scale, x's dtype."""
    y = F.linear(x.to(torch.bfloat16).float(), leaf["q"].float())
    return (y * leaf["s"]).to(x.dtype)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("shape", [(5, 32), (2, 3, 64), (1, 1, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_plain_form(rng, shape, dtype):
    """On the CPU linear() takes the plain version, bit for bit the form it
    had; the unscaled route is the float32 accumulator; no launch."""
    K, N = shape[-1], 48
    leaf = _leaf(rng, N, K)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    before = int8_linear.launches
    assert torch.equal(linear(x, leaf), _plain_form(x, leaf))
    unscaled = int8_linear(x, leaf["q"])
    assert unscaled.dtype == torch.float32
    assert torch.equal(unscaled, F.linear(x.to(torch.bfloat16).float(), leaf["q"].float()))
    assert torch.equal(int8_linear_reference(x, leaf["q"], leaf["s"]), _plain_form(x, leaf))
    assert int8_linear.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_packed_qkv_and_broadcast_rows(rng, dtype):
    """The packed [3, E, E] leaf and a broadcast (stride-0) BOS row take the
    same plain form."""
    E = 32
    w = torch.from_numpy(rng.standard_normal((3, E, E)).astype(np.float32))
    leaf = quantize_int8({"flow_lm": {"input_linear": {"weight": w}}}, ("input_linear",))["flow_lm"]
    leaf = leaf["input_linear"]["weight"]
    x = torch.from_numpy(rng.standard_normal((2, 4, E)).astype(np.float32)).to(dtype)
    flat = {"q": leaf["q"].reshape(-1, E), "s": leaf["s"].reshape(-1)}
    assert torch.equal(qkv_proj(x, leaf), _plain_form(x, flat).reshape(2, 4, 3, E))
    bos = x[0, 0].expand(3, 1, E)
    assert torch.equal(linear(bos, flat), _plain_form(bos.contiguous(), flat))


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("N,K", SERVED)
def test_launch_config_fills_the_card(M, N, K):
    """Every served shape: at most 64 rows the rows kernel, in one wave of
    at least half the SMs (64) unless K has too few units, within a block's
    shared memory, 8-block clusters on at most 64 blocks; above 64 rows the
    tiles kernel on at least 64 blocks unless K has too few units; at most
    MAX_SPLIT slices of a unit of K or more."""
    tile, split = launch_config(M, N, K, H100_SMS)
    units = -(-K // UNIT)
    bm, bn = TILES[tile]
    blocks = -(-M // bm) * -(-N // bn) * split
    assert 1 <= split <= min(MAX_SPLIT, units)
    assert blocks >= 64 or split == min(MAX_SPLIT, units)
    if M <= 64:
        assert tile in ROWS_WARPS_K and blocks <= H100_SMS
        assert split < MAX_SPLIT or blocks <= 64
        assert rows_shared_bytes(-(-units // split), 4, bn, ROWS_WARPS_K[tile]) <= MAX_SHARED
    else:
        assert tile in (2, 3)


def test_launch_config_at_decode():
    """A b6369a24 decode frame at B=64: QKV and linear1 in 2 slices of
    64-wide tiles (96 and 128 blocks), out_proj in 4 (64), linear2 in 8
    slices of 128-wide tiles (64 blocks: 64-wide tiles would need 128 blocks
    in 8-block clusters), input_linear (one unit of K) unsplit; bf16
    activations fit linear1 unsplit. More rows take 128 x 256 tiles where
    those give 64 tiles, else 128 x 128 tiles and the slices to reach 64
    blocks; so does a row count whose slices would not fit shared memory."""
    got = [launch_config(64, N, K, H100_SMS) for N, K in SERVED]
    assert got == [(0, 2), (0, 4), (0, 2), (1, 8), (0, 1)]
    assert launch_config(64, 4096, 1024, H100_SMS, xbytes=2) == (0, 1)
    assert launch_config(8192, 4096, 1024, H100_SMS) == (3, 1)
    assert launch_config(1024, 1024, 1024, H100_SMS) == (2, 1)
    assert launch_config(128, 3072, 1024, H100_SMS) == (2, 3)
    assert launch_config(64, 1024, 65536, H100_SMS) == (2, 8)
    assert launch_config(64, 1024, 4096, 8) == (3, 1)


def test_captured_launches_tally_is_per_block():
    """Outside a capture the counters count; the tally of a capture block
    starts empty and the enclosing one comes back after it."""
    with _cuda.captured_launches() as outer:
        with _cuda.captured_launches() as inner:
            assert inner == {}
        assert _cuda._captured.counts is outer
    assert getattr(_cuda._captured, "counts", None) is None


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the int8 linear kernel runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rng, M, N, K, dtype, dev):
    leaf = _leaf(rng, N, K, dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, dtype)
    return x, leaf


def _bound(x, leaf, scaled, out_dtype):
    """Per element: the kernel and the plain version sum the same exact
    float32 products (bf16 x int8) in another order, so each lies within
    (K - 1) 2^-24 sum |products| of the exact sum: twice that apart. Scaled,
    the bound scales with s[n] and one rounding of the product is added; a
    bf16 output may round one ulp apart (2^-7 of its magnitude at most)."""
    K = x.shape[-1]
    absdot = F.linear(x.to(torch.bfloat16).float().abs(), leaf["q"].float().abs())
    tol = 2 * K * 2.0 ** -24 * absdot
    if not scaled:
        return tol
    ref = int8_linear_reference(x, leaf["q"], leaf["s"]).float().abs()
    return tol * leaf["s"] + ref * (2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -23) + 1e-30


@pytest.mark.card
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", SERVED)
@pytest.mark.parametrize("M", ROWS)
def test_kernel_matches_plain_version(card, rng, M, N, K, dtype, scaled):
    """The kernel against int8_linear_reference on the card at every served
    shape, both activation dtypes, scaled and unscaled (the mesh's) routes."""
    x, leaf = _inputs(rng, M, N, K, dtype, card)
    s = leaf["s"] if scaled else None
    before = int8_linear.launches
    y = int8_linear(x, leaf["q"], s)
    ref = int8_linear_reference(x, leaf["q"], s)
    torch.cuda.synchronize()
    assert int8_linear.launches == before + 1
    assert y.dtype == ref.dtype == (dtype if scaled else torch.float32) and y.shape == (M, N)
    err = (y.float() - ref.float()).abs()
    bound = _bound(x, leaf, scaled, dtype)
    assert bool((err <= bound).all()), f"max err {float(err.max())}, worst err/bound {float((err / bound).max())}"


@pytest.mark.card
def test_kernel_takes_leading_dims_and_odd_widths(card, rng):
    """x [B, T, K] flattens to B*T rows; K = 8 (the tiny configs' latent)
    and a misaligned x go through zero-padded copies."""
    x, leaf = _inputs(rng, 6, 384, 8, torch.float32, card)
    y = int8_linear(x.view(2, 3, 8), leaf["q"], leaf["s"])
    ref = int8_linear_reference(x, leaf["q"], leaf["s"])
    assert y.shape == (2, 3, 384)
    assert bool(((y.view(6, 384) - ref).abs() <= _bound(x, leaf, True, torch.float32)).all())
    x, leaf = _inputs(rng, 65, 256, 128, torch.float32, card)
    xs = torch.empty(65 * 128 + 1, device=card)[1:].view(65, 128).copy_(x)  # 4 bytes past an aligned start
    y = int8_linear(xs, leaf["q"], leaf["s"])
    assert bool(((y - int8_linear_reference(x, leaf["q"], leaf["s"])).abs()
                 <= _bound(x, leaf, True, torch.float32)).all())


REFUSALS = {
    "float16 x": lambda x, q, s: (x.half(), q, s),
    "float32 codes": lambda x, q, s: (x, q.float(), s),
    "K mismatch": lambda x, q, s: (x[:, :32].contiguous(), q, s),
    "strided x": lambda x, q, s: (x.t().contiguous().t(), q, s),
    "codes on the CPU": lambda x, q, s: (x, q.cpu(), s),
    "scale of another length": lambda x, q, s: (x, q, s[:-4]),
    "N % 4": lambda x, q, s: (x, q[:-2].contiguous(), s[:-2].contiguous()),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(card, rng, case):
    x, leaf = _inputs(rng, 64, 128, 64, torch.float32, card)
    args = REFUSALS[case](x, leaf["q"], leaf["s"])
    with pytest.raises(ValueError):
        int8_linear(*args)


@pytest.mark.card
def test_wrapper_refuses_gradients(card, rng):
    x, leaf = _inputs(rng, 4, 128, 64, torch.float32, card)
    with pytest.raises(RuntimeError, match="no gradient"):
        int8_linear(x.requires_grad_(), leaf["q"], leaf["s"])
    with torch.no_grad():
        int8_linear(x, leaf["q"], leaf["s"])


@pytest.mark.card
@pytest.mark.parametrize("M,N,K", [(64, 3072, 1024), (64, 1024, 4096), (1000, 4096, 1024)])
def test_captured_replay_equals_eager(card, rng, M, N, K):
    """A CUDA graph of the call gives the eager call's bits (the slices of a
    cluster are summed in rank order), and its capture tallies one launch."""
    x, leaf = _inputs(rng, M, N, K, torch.float32, card)
    eager = int8_linear(x, leaf["q"], leaf["s"])
    graph = torch.cuda.CUDAGraph()
    with _cuda.captured_launches() as launches, torch.cuda.graph(graph):
        out = int8_linear(x, leaf["q"], leaf["s"])
    assert launches == {int8_linear: 1}
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def _six_layer_model(dev) -> TTSModel:
    """A b6369a24-shaped FlowLM (6 layers, head size 64) at width 128, int8
    weights, bf16 KV; a miniature Mimi."""
    cfg = Config(**{
        "flow_lm": {
            "dtype": "float32",
            "flow": {"depth": 2, "dim": 32},
            "transformer": {"d_model": 128, "hidden_scale": 4, "max_period": 10000, "num_heads": 2,
                            "num_layers": 6},
            "lookup_table": {"dim": 128, "n_bins": 4000, "tokenizer": "sentencepiece",
                             "tokenizer_path": "unavailable://"},
        },
        "mimi": {
            "dtype": "float32", "sample_rate": 24000, "channels": 1, "frame_rate": 12.5,
            "seanet": {"dimension": 48, "channels": 1, "n_filters": 4, "n_residual_layers": 1, "ratios": [6, 5, 4],
                       "kernel_size": 7, "residual_kernel_size": 3, "last_kernel_size": 3, "dilation_base": 2,
                       "pad_mode": "constant", "compress": 2},
            "transformer": {"d_model": 48, "num_heads": 4, "num_layers": 1, "layer_scale": 0.01, "context": 32,
                            "dim_feedforward": 96, "input_dimension": 48, "output_dimensions": [48]},
            "quantizer": {"dimension": 32, "output_dimension": 48},
        },
    })
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(0)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    return TTSModel.from_params(cfg, params, FallbackWordTokenizer(4000), "int8", device=dev, temp=0.0,
                                lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9)


@pytest.mark.card
def test_launches_per_decoded_batch_frame(card, monkeypatch):
    """generate_audio_batch of a 6-layer int8 model twice: apart from the
    prefills, 25 int8_linear launches per decoded frame (6 x QKV, out_proj,
    linear1, linear2, and input_linear), the second call's frames all graph
    replays."""
    model = _six_layer_model(card)
    voice = model._state_from_prompt(torch.randn(1, 10, model.flow_lm.dim, generator=torch.Generator()
                                                 .manual_seed(5)))
    texts = [f"Word {'a b c ' * (i % 7)}end." for i in range(8)]
    prefill_launches = [0]
    prefill = FlowLMModel.prefill

    def counted(self, *args, **kwargs):
        n = int8_linear.launches
        out = prefill(self, *args, **kwargs)
        prefill_launches[0] += int8_linear.launches - n
        return out

    monkeypatch.setattr(FlowLMModel, "prefill", counted)
    graphs = model.step_graphs
    for call in range(2):
        before, replays, prefill_launches[0] = int8_linear.launches, graphs.replays, 0
        model.generate_audio_batch(voice, texts)
        frames = model.last_generation["frames"]
        assert prefill_launches[0] % 24 == 0 and prefill_launches[0] > 0
        assert int8_linear.launches - before - prefill_launches[0] == 25 * frames
        if call:
            assert graphs.replays - replays == frames
