"""The port's batch serving path against the JAX package, on the CPU at tiny
widths: int8 KV rows, the batch decode attention's plain version (the
kernel's CPU route), batch decode steps with read limits, the row-movers
with int8 scales, and generate_audio_batch end to end. Inputs come from
numpy seeds; every tolerance is stated with its reason beside it.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.text import FallbackWordTokenizer as JTokenizer
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu.ops import attention as jattn
from pocket_tts_tpu.ops import rope as jrope
from pocket_tts_tpu.ops.batch_attention import batch_decode_attention as jax_batch_attention
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.main import build_parser
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel, stack_states
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.ops import attention, batch_attention, rope
from pocket_tts_tpu_torch.ops.batch_attention import batch_decode_attention, batch_decode_attention_reference
from tiny_config import TINY, tiny_config

RNG = np.random.default_rng(2024)


@pytest.fixture(autouse=True)
def _reseed(request):
    """Each test draws the same inputs however the tests are selected."""
    global RNG
    RNG = np.random.default_rng(zlib.crc32(request.node.name.encode()))


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------- (a) int8 rows


def test_quantize_kv_rows_matches_jax():
    x = randn(3, 7, 4, 16, scale=3.0)
    x[1, 2] = 0.0  # an all-zero row: scale 1, codes 0
    x[2, 5, 1, 3] = 40.0  # an outlier sets its row's scale
    jq, js = jattn.quantize_kv_rows(jnp.asarray(x))
    tq, ts = attention.quantize_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 7)
    # Same float32 division and round-half-even on both sides: exact.
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 2]) == 1.0 and not tq[1, 2].any()


# ---------------------------------------------------------------- (b) batch attention


def _attn_case(B, C, H, d, R=None):
    """Random queries and caches; per-stream valid prefixes of different
    lengths with holes; query positions one past the prefix (as
    tests/test_batch_attention.py builds them)."""
    R = C if R is None else R
    q, k, v = randn(B, H, 1, d), randn(B, C, H, d), randn(B, C, H, d)
    lens = RNG.integers(max(1, R // 2), R + 1, B)
    sp = np.full((B, R), -1, np.int32)
    for b, n in enumerate(lens):
        sp[b, :n] = np.arange(n)
        sp[b, RNG.choice(n, size=n // 10, replace=False)] = -1  # holes in the history
    return q, k, v, sp, lens.astype(np.int32)


# JAX's own gates for its kernel against _sdpa_slots (tests/test_batch_attention.py:
# 2e-2 bf16, 3e-2 int8): the Pallas kernel rounds the unnormalised online-softmax
# weights to bf16, the port's plain version the normalised ones (as _sdpa_slots does).
@pytest.mark.parametrize(
    "kind,B,C,R",
    [("bf16", 4, 128, None), ("bf16", 3, 256, None), ("bf16", 8, 384, None), ("bf16", 2, 512, None),
     ("bf16", 3, 512, 256), ("int8", 3, 256, None), ("int8", 3, 512, 256)],
)
def test_batch_attention_reference_matches_jax_kernel(kind, B, C, R):
    H, d = 4, 64  # 128-lane geometry (H*d = 256), the Pallas kernel's
    q, k, v, sp, qpos = _attn_case(B, C, H, d, R)
    sp[0] = -1  # stream 0 has no valid row: both sides output exactly 0
    rows = C if R is None else R
    if R is not None:  # rows past read_rows are never read
        k[:, R:] = np.nan
        v[:, R:] = np.nan
    if kind == "int8":
        jk, jks = jattn.quantize_kv_rows(jnp.asarray(k))
        jv, jvs = jattn.quantize_kv_rows(jnp.asarray(v))
        jks, jvs = jks[:, :rows], jvs[:, :rows]
        tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))
        tks, tvs = torch.from_numpy(np.array(jks)), torch.from_numpy(np.array(jvs))
        tol = 3e-2
    else:
        jk, jv = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
        jks = jvs = tks = tvs = None
        tk, tv = torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)
        tol = 2e-2
    ref = jax_batch_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(sp), jnp.asarray(qpos), jks, jvs,
        num_heads=H, read_rows=R, block_rows=128, interpret=True,
    )
    launches = batch_decode_attention.launches
    out = batch_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(sp), torch.from_numpy(qpos),
                                 tks, tvs, read_rows=R)
    assert batch_decode_attention.launches == launches  # CPU tensors: the plain version, no launch
    assert out.shape == (B, H, 1, d) and out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    assert not out[0].any()


def test_batch_attention_reference_is_sdpa_slots_on_valid_streams():
    """Where a stream has valid rows the plain version is sdpa_slots over the
    first R rows (exactly: the same PyTorch ops)."""
    q, k, v, sp, qpos = _attn_case(3, 256, 2, 16, 128)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tsp, tqp = torch.from_numpy(sp), torch.from_numpy(qpos)
    out = batch_decode_attention_reference(tq, tk, tv, tsp, tqp, read_rows=128)
    valid = (tsp >= 0) & (tsp <= tqp[:, None])
    dense = attention.sdpa_slots(tq.transpose(1, 2), tk[:, :128], tv[:, :128], valid[:, None, None, :])
    torch.testing.assert_close(out, dense.transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_batch_attention_reference_matches_jax_sdpa_slots_at_a_ragged_read(kind):
    """R=200 lies off the 128-row grid that the Pallas kernel asserts, so the
    plain version (the kernel's CPU route) is held against the JAX package's
    XLA path _sdpa_slots over the first 200 rows. Rows past R are poisoned
    and never read; stream 0 has no valid row and outputs exactly 0 (a rule
    _sdpa_slots lacks, so that stream is left out of the comparison)."""
    B, C, H, d, R = 3, 384, 4, 64, 200
    q, k, v, sp, qpos = _attn_case(B, C, H, d, R)
    sp[0] = -1
    valid = jnp.asarray((sp >= 0) & (sp <= qpos[:, None]))[:, None, None, :]
    if kind == "int8":
        (jk, jks), (jv, jvs) = jattn.quantize_kv_rows(jnp.asarray(k)), jattn.quantize_kv_rows(jnp.asarray(v))
        tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))
        tks, tvs = torch.from_numpy(np.array(jks)), torch.from_numpy(np.array(jvs))
        tk[:, R:], tv[:, R:], tks[:, R:], tvs[:, R:] = 127, 127, float("nan"), float("nan")
        jks, jvs, tks, tvs = jks[:, :R], jvs[:, :R], tks[:, :R], tvs[:, :R]
    else:
        jk, jv = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
        tk, tv = torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)
        tk[:, R:], tv[:, R:] = float("nan"), float("nan")
        jks = jvs = tks = tvs = None
    ref = jattn._sdpa_slots(jnp.asarray(q), jk[:, :R], jv[:, :R], valid, jks, jvs)  # [B, H, 1, d]
    launches = batch_decode_attention.launches
    out = batch_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(sp), torch.from_numpy(qpos),
                                 tks, tvs, read_rows=R)
    assert batch_decode_attention.launches == launches
    assert np.isfinite(out.numpy()).all() and not out[0].any()
    # The same roundings on both sides (bf16 q and weights, float32 sums): a
    # bf16 rounding of q or of a weight that sum order flips moves an output
    # by at most ~1e-3, as in test_causal_attention_batch_decode_matches_jax.
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(ref[1:], np.float32), rtol=0, atol=2e-3)


def test_kernel_shared_memory_helper():
    """One block's shared memory: 128 bytes of mbarriers, the ring (an 8 KB
    bf16 tile a stage at 128 threads; 4 KB plus 64 row scales in int8), a
    [warps][64] float32 reduction buffer, per row of its chunk (padded to
    the tile and to 64) a float32 score and a validity bit, and 264 bytes of
    cluster exchange; a ValueError above the H100's 227 KB per block.
    launch_config widens the blocks where few share an SM, shrinks stages,
    then width, to fit a long read, and cuts an item's rows across a
    cluster of up to 8 blocks for a call of few items or a read that one
    block cannot hold."""
    ba, bf16, i8 = batch_attention, torch.bfloat16, torch.int8
    assert ba.shared_bytes(512) == 128 + 3 * 8192 + 1024 + 4 * 512 + 512 // 8 + 264 == 28104
    assert ba.shared_bytes(16384) == 128 + 3 * 8192 + 1024 + 4 * 16384 + 16384 // 8 + 264 == 93576
    assert ba.shared_bytes(512, i8) == 128 + 3 * (4096 + 256) + 1024 + 4 * 512 + 512 // 8 + 264 == 16584
    assert ba.shared_bytes(200) == ba.shared_bytes(256)
    assert [ba.tile_rows(bf16, 128), ba.tile_rows(i8, 512), ba.tile_rows(torch.float32, 512)] == [64, 256, 128]
    assert ba.MAX_SHARED_BYTES == 232448 and ba.MAX_BLOCK_ROWS == 52032 and ba.MAX_READ_ROWS == 8 * 52032
    assert ba.shared_bytes(ba.MAX_BLOCK_ROWS, bf16, 128, 2) <= ba.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        ba.shared_bytes(ba.MAX_BLOCK_ROWS + 1, bf16, 128, 2)
    # (threads, stages, split, chunk, bytes): the batch path's B=64 and the
    # 32-stream engine, one block per item
    assert ba.launch_config(64 * 16, 132, 512, bf16) == (128, 3, 1, 512, 28104)
    assert ba.launch_config(32 * 16, 132, 512, bf16)[:4] == (256, 3, 1, 512)
    # two 512-thread blocks per SM: three stages of 32 KB tiles would not fit both
    assert ba.launch_config(16 * 16, 132, 4096, bf16)[:4] == (512, 2, 1, 4096)
    # few items: cut across a cluster to about two blocks per SM, >= 512 rows
    # each; clusters of more than two blocks take 256 threads and two stages
    assert ba.launch_config(8 * 16, 132, 4096, i8) == (512, 3, 2, 2048, 65160)
    assert ba.launch_config(4 * 16, 132, 512, bf16)[:4] == (512, 3, 1, 512)
    assert ba.launch_config(2 * 16, 132, 16384, bf16) == (256, 2, 8, 2048, 43656)
    assert ba.launch_config(2 * 16, 132, 2600, torch.float32)[:4] == (256, 2, 5, 576)
    # a read one block cannot hold: split until the chunk fits
    assert ba.launch_config(64 * 16, 132, 60000, bf16) == (128, 2, 2, 30016, 141616)
    assert ba.launch_config(2 * 16, 132, ba.MAX_READ_ROWS, bf16)[2:4] == (8, ba.MAX_BLOCK_ROWS)
    with pytest.raises(ValueError, match="shared memory"):
        ba.launch_config(2 * 16, 132, ba.MAX_READ_ROWS + 1, bf16)
    for items, rows in ((32, 16384), (64, 512), (128, 4096), (1024, 60000), (32, 40000), (1024, 200)):
        _, _, split, chunk, _ = ba.launch_config(items, 132, rows, bf16)
        assert (split - 1) * chunk < rows <= split * chunk and split <= ba.MAX_SPLIT


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_batch_attention_cpu_tensors_take_the_plain_version(q_dtype):
    """On CPU tensors the wrapper is the plain version, bit for bit and in
    q's dtype, at any read limit (a ragged one, and one past what a single
    block of the kernel holds), and launches nothing."""
    B, C, H, d = 3, 52200, 2, 64
    q, k, v, sp, qpos = _attn_case(B, 384, H, d, 200)
    tq = torch.from_numpy(q).to(q_dtype)
    tk = torch.zeros(B, C, H, d, dtype=torch.bfloat16)
    tk[:, :384] = torch.from_numpy(k)
    tv = torch.zeros_like(tk)
    tv[:, :384] = torch.from_numpy(v)
    launches = batch_decode_attention.launches
    for R in (200, 52160):
        tsp = torch.full((B, R), -1, dtype=torch.int32)
        tsp[:, :200] = torch.from_numpy(sp)
        args = (tq, tk, tv, tsp, torch.from_numpy(qpos))
        out = batch_decode_attention(*args, read_rows=R)
        assert out.dtype == q_dtype and out.shape == (B, H, 1, d)
        torch.testing.assert_close(out, batch_decode_attention_reference(*args, read_rows=R), rtol=0, atol=0)
    assert batch_decode_attention.launches == launches


# ---------------------------------------------------------------- (c) attention module


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("read_limit", [None, 128])
def test_causal_attention_batch_decode_matches_jax(cache, read_limit, monkeypatch):
    """Prefill B=3 streams of different lengths, then batch decode steps
    (T=1) with a read limit; the JAX module runs its default _sdpa_slots."""
    E, H, C, B = 128, 2, 256, 3
    pnp = {"in_proj": {"weight": randn(3, E, E, scale=0.1)}, "out_proj": {"weight": randn(E, E, scale=0.1)}}
    aj, at = jattn.CausalKVAttention(E, H), attention.CausalKVAttention(E, H)
    pj, pt = jax.tree_util.tree_map(jnp.asarray, pnp), params_from_jax(pnp)
    jdt, tdt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    sj, st = aj.init_state(B, C, dtype=jdt), at.init_state(B, C, dtype=tdt)
    assert sorted(st) == sorted(sj)
    calls = []
    real = batch_attention.batch_decode_attention
    monkeypatch.setattr(batch_attention, "batch_decode_attention",
                        lambda *a, **kw: calls.append(kw["read_rows"]) or real(*a, **kw))

    def step(x, positions, widx):
        nonlocal sj
        pos_j = jnp.asarray(positions)
        yj, sj = aj(pj, jnp.asarray(x), sj, pos_j, widx=jnp.int32(widx),
                    rope_cache=jrope.rope_angles(jnp.maximum(pos_j, 0), E // H), read_limit=read_limit)
        pos_t = torch.from_numpy(positions)
        yt = at(pt, torch.from_numpy(x), st, pos_t, widx, rope.rope_angles(pos_t.clamp(min=0), E // H),
                read_limit=read_limit)
        # float32 activations on both sides; the cache rounds k/v (bf16 or
        # int8) identically, and a bf16 rounding of q or of a softmax weight
        # that sum order flips moves the output by at most ~1e-3.
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=2e-3)
        np.testing.assert_array_equal(st["slot_pos"].numpy(), np.asarray(sj["slot_pos"]))
        # The appended rows come from float32 projections whose sum order
        # differs: a bf16 row may move by one ulp, an int8 code by one step,
        # a scale (row absmax / 127) by float32 noise.
        for name in ("k", "v"):
            np.testing.assert_allclose(to_np(st[name]), np.asarray(sj[name], np.float32),
                                       rtol=2**-7, atol=1.0 if cache == "int8" else 0)
        for name in ("k_scale", "v_scale") if cache == "int8" else ():
            np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), rtol=1e-5, atol=0)

    lens = [40, 25, 33]
    pos = np.array([[i if i < n else -1 for i in range(40)] for n in lens], np.int32)
    step(randn(B, 40, E), pos, 0)
    assert not calls  # prefill stays on sdpa_slots
    for i in range(4):
        step(randn(B, 1, E), np.array([[n + i] for n in lens], np.int32), 40 + i)
    assert calls == [read_limit or C] * 4


# ---------------------------------------------------------------- (d) row movers


def test_expand_compact_invalidate_carry_int8_scales():
    cfg = tiny_config()
    jfl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    tfl = FlowLMModel(TConfig(**TINY).flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    jp = jfl.init_params(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    emb = randn(2, 9, jfl.dim, scale=0.3)
    js = jfl.prefill(jp, jfl.init_state(2, 16, dtype=jnp.int8), jnp.asarray(emb), jnp.array([9, 5], jnp.int32))
    ts = tfl.prefill(tp, tfl.init_state(2, 16, dtype=torch.int8), torch.from_numpy(emb), [9, 5])

    def same(j, t):
        assert t["transformer"]["widx"] == int(j["transformer"]["widx"])
        for lj, lt in zip(j["transformer"]["layers"], t["transformer"]["layers"]):
            assert sorted(lt) == ["k", "k_scale", "slot_pos", "v", "v_scale"]
            for name in lt:
                # Quantised codes may differ by one where float32 sum order
                # moves a value across a rounding boundary; scales are the
                # row absmax / 127, within float32 noise.
                np.testing.assert_allclose(to_np(lt[name]), np.asarray(lj[name], np.float32), rtol=1e-5, atol=1.0)
            np.testing.assert_array_equal(lt["slot_pos"].numpy(), np.asarray(lj["slot_pos"]))
        shared = t["transformer"]["layers"][0]["slot_pos"]
        assert all(l["slot_pos"] is shared for l in t["transformer"]["layers"])

    same(js, ts)
    js, ts = jfl.expand_state(js, 32), tfl.expand_state(ts, 32)
    same(js, ts)
    assert not ts["transformer"]["layers"][1]["v_scale"][:, 16:].any()
    js, ts = jfl.compact_state(js, 16), tfl.compact_state(ts, 16)
    same(js, ts)
    js = jfl.invalidate_after(js, jnp.array([7, 3], jnp.int32))
    ts = tfl.invalidate_after(ts, [7, 3])
    same(js, ts)
    assert ts["pos"] == [7, 3]

    # A batch decode step with a per-stream BOS flag and a read limit.
    latent, noise = randn(2, jfl.ldim), randn(2, jfl.ldim)
    for bos in ([True, False], [False, False]):
        js, jlat, jeos = jfl.decode_step(jp, js, jnp.asarray(latent), jnp.asarray(bos), None, 1.0, 1, None, 0.0,
                                         noise=jnp.asarray(noise), read_limit=16)
        ts, tlat, teos = tfl.decode_step(tp, ts, torch.from_numpy(latent), torch.tensor(bos),
                                         torch.from_numpy(noise), 1, 0.0, read_limit=16)
        # float32 activations over int8 rows: a code that sum order moves by
        # one step shifts an attention output by ~1e-4 of its scale.
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(teos.numpy(), np.asarray(jeos))
        same(js, ts)


# ---------------------------------------------------------------- (e) generate_audio_batch

TEXTS = ["One two three four.",
         "Five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty."]
PROMPTS = [randn(1, 12, TINY["flow_lm"]["transformer"]["d_model"], scale=0.3),
           randn(1, 140, TINY["flow_lm"]["transformer"]["d_model"], scale=0.3)]


@pytest.fixture(scope="module")
def jax_f32_params():
    cfg = tiny_config()
    fl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"flow_lm": fl.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}


def make_pair(jax_f32_params, param_dtype, kv_int8, eos_threshold):
    cfg = tiny_config()
    fl, mimi = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension), JMimi(config=cfg.mimi)
    jp = jax_f32_params
    if param_dtype == "int8":
        jp = jax_quantize_int8(jax_cast(jp, jnp.bfloat16))
    jm = JTTSModel(fl, mimi, jp, JTokenizer(4000), temp=0.0, lsd_decode_steps=1, noise_clamp=None,
                   eos_threshold=eos_threshold, config=cfg, kv_int8=kv_int8)
    if param_dtype == "int8":
        jm.state_dtype = jnp.bfloat16
    tm = TTSModel.from_params(
        TConfig(**TINY), params_from_jax(jax.tree_util.tree_map(np.asarray, jax_f32_params)),
        FallbackWordTokenizer(4000), param_dtype, device="cpu", temp=0.0, eos_threshold=eos_threshold,
        kv_int8=kv_int8,
    )
    return jm, tm


def _tensors(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.parametrize("param_dtype,kv_int8", [("float32", False), ("int8", False), ("int8", True)])
def test_generate_audio_batch_matches_jax(jax_f32_params, param_dtype, kv_int8):
    """Two voices of different prompt lengths stacked, two texts of different
    lengths, temperature 0 (zero flow noise on both sides). The port's batch
    steps attend through batch_decode_attention's plain version, JAX's
    through _sdpa_slots: the two differ only for a stream with no valid row,
    which this path never has."""
    jm, tm = make_pair(jax_f32_params, param_dtype, kv_int8, eos_threshold=1e9)
    jv = [jm._state_from_prompt(jnp.asarray(p)) for p in PROMPTS]
    tv = [tm._state_from_prompt(torch.from_numpy(p)) for p in PROMPTS]
    before = [[t.clone() for t in _tensors(v.tree)] for v in tv]
    ref = jm.generate_audio_batch(jv, TEXTS, frames_after_eos=2)
    got = tm.generate_audio_batch(tv, TEXTS, frames_after_eos=2)
    # 140 voice rows + 32 text rows + 64 + 32 frames fill a 384-slot cache;
    # the first segment reads only the 256 rows below its last write.
    assert tm.last_generation == {"batch": 2, "frames": 96, "capacity": 384, "read_limits": [256, None]}
    assert [g.shape for g in got] == [r.shape for r in ref] and got[0].shape != got[1].shape
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape[0] % 1920 == 0
        peak = np.abs(r).max()
        if param_dtype == "float32":
            # XLA and PyTorch differ in summation order only (test_torch_e2e.py's bound).
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * peak)
        else:
            # bf16 activations and caches: a bf16 rounding flipped by sum order
            # carries through ~100 autoregressive frames (test_torch_e2e.py's int8 bound).
            np.testing.assert_allclose(g, r, rtol=0, atol=0.05 * peak)
            e_got = np.sqrt((g.reshape(-1, 1920) ** 2).mean(1))
            e_ref = np.sqrt((r.reshape(-1, 1920) ** 2).mean(1))
            np.testing.assert_allclose(e_got, e_ref, rtol=0.05)
    for b, v in zip(before, tv):  # the voices are left as they were
        assert all(torch.equal(x, y) for x, y in zip(b, _tensors(v.tree)))


def test_generate_audio_batch_eos_per_stream_matches_jax(jax_f32_params):
    """A reachable EOS threshold (random logits fire at frame 0) with each
    stream's own frames_after_eos guess from its text: per-stream lengths,
    one shared voice."""
    jm, tm = make_pair(jax_f32_params, "float32", False, eos_threshold=-4.0)
    ref = jm.generate_audio_batch(jm._state_from_prompt(jnp.asarray(PROMPTS[0])), TEXTS, fade_in_ms=20)
    got = tm.generate_audio_batch(tm._state_from_prompt(torch.from_numpy(PROMPTS[0])), TEXTS, fade_in_ms=20)
    assert [g.shape for g in got] == [r.shape for r in ref] and got[0].shape != got[1].shape
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_stack_states_matches_jax(jax_f32_params):
    """Capacities equalised to the largest, write index the largest,
    positions concatenated, inputs untouched."""
    from pocket_tts_tpu.models.tts_model import stack_states as jax_stack

    jm, tm = make_pair(jax_f32_params, "float32", False, eos_threshold=1e9)
    jb = jax_stack(jm.flow_lm, [jm._state_from_prompt(jnp.asarray(p)) for p in PROMPTS])
    tb = stack_states(tm.flow_lm, [tm._state_from_prompt(torch.from_numpy(p)) for p in PROMPTS])
    assert tb.pos == list(jb.pos) and tb.written == jb.written == 140
    assert tb.tree["transformer"]["widx"] == int(jb.tree["transformer"]["widx"])
    for lj, lt in zip(jb.tree["transformer"]["layers"], tb.tree["transformer"]["layers"]):
        assert lt["k"].shape == (2, 256, 4, 16)
        np.testing.assert_array_equal(lt["slot_pos"].numpy(), np.asarray(lj["slot_pos"]))
        np.testing.assert_allclose(lt["k"].numpy(), np.asarray(lj["k"]), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- entry points run on the card


def test_entry_points_default_to_the_card(monkeypatch, jax_f32_params):
    """Without a GPU the entry points raise unless the caller asks for the
    CPU; the CLI defaults to cuda."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_f32_params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSModel.from_params(TConfig(**TINY), params, FallbackWordTokenizer(4000), "float32", device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSModel.load_model()
    assert build_parser().parse_args(["hi"]).device == "cuda"
    assert TTSModel.from_params(TConfig(**TINY), params, FallbackWordTokenizer(4000), device="cpu").device.type == "cpu"
