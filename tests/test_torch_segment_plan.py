"""The persistent segment kernel's work split (ops/fused_segment.segment_plan)
and the plain form of its two-phase attention (split_attention_reference),
on the CPU; and the same for the one-frame launch of fused_backbone_step
(segment_plan with no flow head: MC and depth None). The kernel itself runs only on the card, where chip_smoke.py
holds it against fused_segment_decode_reference; here the split it takes as
arguments is checked for ownership and fit, and its attention arithmetic is
held against the plain attention of backbone_frame_reference and, through
whole segments, against the JAX package's chained decode steps.

Tolerances: split_attention_reference rounds the softmax weights to bf16 at
the same point as the plain attention, but sums the denominator chunk by
chunk (sum of exp against each chunk's max, rescaled to the global max):
float32 rounding of a few ulps, which can move one weight across a bf16
rounding boundary, one bf16 ulp (2^-8 relative) of a weight below 1 times a
|v| below 4 -> 1e-2 on an attention output. Through a segment such flips
carry on through later layers and frames: the JAX segment test's 0.15 max /
2e-2 mean on latents against the oracle (tests/test_torch_fused_kernels.py).
A single frame through the split attention is held against the plain frame
and the JAX oracle at the JAX kernel test's 2e-2 on h, the EOS logit and the
caches (one flipped weight, 1e-2 on an attention output, damped by the
later layers and out_norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.config.schema import FlowLMConfig as JFlowLMConfig
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu.ops.linear import linear as jlinear
from pocket_tts_tpu.ops.norms import layer_norm as jlayer_norm
from pocket_tts_tpu_torch.config.schema import FlowLMConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.ops import fused_backbone
from pocket_tts_tpu_torch.ops.fused_backbone import attention_reference, fused_backbone_step_reference, pack_backbone
from pocket_tts_tpu_torch.ops.fused_segment import (
    KINDS,
    MAX_CHUNKS,
    MAX_SHARED_BYTES,
    STATIC_SHARED_BYTES,
    fused_segment_decode_reference,
    pack_flow,
    phase_list,
    segment_plan,
    split_attention_reference,
)
from pocket_tts_tpu_torch.ops.persistent import BACKBONE_KINDS

B6369A24 = {"L": 6, "E": 1024, "H": 16, "FF": 4096, "ldim": 32, "MC": 512, "depth": 6}
TINY = {"L": 2, "E": 64, "H": 4, "FF": 256, "ldim": 16, "MC": 32, "depth": 2}
H100_SMS = 132
MAX_B1_CAPACITY = fused_backbone.MAX_CAPACITY  # the largest C the B=1 kernels take (12288)
TOL_ATTN = 1e-2
TOL_SEG, TOL_SEG_MEAN = 0.15, 2e-2
TOL_STEP = 2e-2  # the JAX kernel test's gate on h and the caches (tests/test_fused_backbone.py)


@pytest.mark.parametrize("dims,C,blocks", [(B6369A24, 384, H100_SMS), (B6369A24, 224, 2 * H100_SMS),
                                           (B6369A24, 12288, H100_SMS), (TINY, 64, 7), (TINY, 96, 300)])
def test_every_weight_row_has_exactly_one_owner(dims, C, blocks):
    plan = segment_plan(**dims, C=C, blocks=blocks)
    assert set(plan["rows"]) == set(KINDS) == set(plan["kinds"])
    read = {k for _, kinds in phase_list(dims["L"], dims["depth"]) for k in kinds}
    assert read == set(KINDS)  # every matrix is read by some phase
    for kind, (n, K, _) in plan["kinds"].items():
        starts = np.asarray(plan["rows"][kind])
        assert len(starts) == blocks + 1 and starts[0] == 0 and starts[-1] == n, kind
        assert (np.diff(starts) >= 0).all(), kind
        owners = np.zeros(n, np.int64)
        for b in range(blocks):
            owners[starts[b]:starts[b + 1]] += 1
        assert (owners == 1).all(), kind
        # an even split: no block owns more than one row over another
        assert np.diff(starts).max() - np.diff(starts).min() <= 1, kind
    assert len(plan["table"]) == (len(KINDS) + 1) * (blocks + 1)


@pytest.mark.parametrize("C", [32, 64, 224, 256, 384, 512, 1056, 4096, 12288])
def test_every_attention_item_is_covered_once(C):
    for dims, blocks in ((B6369A24, H100_SMS), (TINY, 5)):
        plan = segment_plan(**dims, C=C, blocks=blocks)
        chunk, chunks = plan["chunk"], plan["chunks"]
        assert chunk % 32 == 0 and 1 <= chunks <= MAX_CHUNKS
        cover = np.zeros(C, np.int64)
        for c in range(chunks):
            cover[c * chunk:min(C, (c + 1) * chunk)] += 1
        assert (cover == 1).all()
        items = np.asarray(plan["items"])
        n_items = dims["H"] * chunks
        assert items[0] == 0 and items[-1] == n_items and (np.diff(items) >= 0).all()
        owners = np.zeros(n_items, np.int64)
        for b in range(blocks):
            owners[items[b]:items[b + 1]] += 1
        assert (owners == 1).all()
        assert plan["max_items"] == np.diff(items).max()
    # the engine's 200-row capacity (224 after rounding) ends on a part chunk
    assert 224 % segment_plan(**B6369A24, C=224, blocks=H100_SMS)["chunk"] != 0


def test_shared_memory_fits_up_to_the_largest_b1_capacity():
    for blocks in (H100_SMS, 2 * H100_SMS):
        for C in range(32, MAX_B1_CAPACITY + 1, 32):
            plan = segment_plan(**B6369A24, C=C, blocks=blocks)
            total = plan["shared_bytes"] + STATIC_SHARED_BYTES
            assert total <= MAX_SHARED_BYTES, (C, blocks, total)
            assert plan["xs_off"] % 128 == 0 and plan["xs2_off"] % 16 == 0 and plan["sc_off"] % 16 == 0
            # the activation holds the widest input of any matrix, the ring
            # the bytes of any weight phase of a block
            assert plan["xs2_off"] - plan["xs_off"] >= 2 * max(K for _, K, _ in plan["kinds"].values())
            # two ring slots, each the bytes of the largest weight phase of a block
            per_phase = [sum(-(-plan["block_bytes"][k] // 128) * 128 for k in ks)
                         for _, ks in phase_list(B6369A24["L"], B6369A24["depth"]) if ks]
            assert plan["xs_off"] == 2 * plan["slot_bytes"] and plan["slot_bytes"] == max(per_phase)


@pytest.mark.parametrize("L,depth", [(6, 6), (2, 2), (1, 3)])
def test_barriers_per_frame_match_the_phase_list(L, depth):
    plan = segment_plan(**{**B6369A24, "L": L, "depth": depth}, C=384, blocks=H100_SMS)
    phases = phase_list(L, depth)
    assert plan["phases"] == [name for name, _ in phases]
    assert plan["barriers_per_frame"] == len(phases) == 1 + 6 * L + 2 + 2 * depth + 1
    assert len(set(plan["phases"])) == len(phases)
    if (L, depth) == (6, 6):
        assert plan["barriers_per_frame"] == 52  # the TPU kernel's grid: (S, 52)
    # two attention phases a layer, which read no weights
    assert sum(1 for _, kinds in phases if not kinds) == 2 * L


def _attention_case(case, rng, H=4, d=64, C=96):
    """(q, k, v, kc, vc, valid) of one frame's attention at small widths."""
    sp = np.full(C, -1, np.int32)
    qpos, widx = 0, 0
    if case == "holes":  # a prefilled history with holes
        sp[:60] = np.arange(60)
        sp[rng.choice(60, 9, replace=False)] = -1
        qpos = widx = 60
    elif case == "minus_one_rows":  # rows never written, between written ones
        sp[:70] = np.arange(70)
        sp[10:30] = -1
        qpos = widx = 70
    elif case == "clamp":  # widx0 + s past C - 1: row C - 1 rewritten every frame
        sp[:] = np.arange(C)
        qpos, widx = C + 5, C - 1
    elif case == "future_rows":  # rows at or past qpos are masked
        sp[:] = np.arange(C)
        qpos = widx = 50
    valid = (sp >= 0) & (sp < qpos) & (np.arange(C) != widx)

    def bf16(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)

    q, k, v = (bf16((H, d), 1.0).float() for _ in range(3))
    return q, k, v, bf16((C, H, d), 1.0), bf16((C, H, d), 1.0), torch.from_numpy(valid)


@pytest.mark.parametrize("case", ["bos", "holes", "minus_one_rows", "clamp", "future_rows"])
@pytest.mark.parametrize("chunk", [32, 64])  # 96 rows: whole chunks, then a part chunk
def test_split_attention_matches_the_plain_attention(case, chunk):
    rng = np.random.default_rng(["bos", "holes", "minus_one_rows", "clamp", "future_rows"].index(case) * 100 + chunk)
    q, k, v, kc, vc, valid = _attention_case(case, rng)
    ref = attention_reference(q, k, v, kc, vc, valid)
    got = split_attention_reference(q, k, v, kc, vc, valid, chunk)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL_ATTN
    if case == "bos":  # no valid row: the new row alone, weight 1
        torch.testing.assert_close(got, v, rtol=0, atol=0)


# ---------------------------------------------------------------- segments
E, H, L, LDIM, C, PREFILL = 64, 4, 2, 16, 96, 9
CFG = {
    "dtype": "float32",
    "flow": {"depth": 2, "dim": 32},
    "transformer": {"d_model": E, "hidden_scale": 4, "max_period": 10000, "num_heads": H, "num_layers": L},
    "lookup_table": {"dim": E, "n_bins": 100, "tokenizer": "sentencepiece", "tokenizer_path": "unavailable://"},
}


@pytest.fixture(scope="module")
def setup():
    jfl = JFlowLM(config=JFlowLMConfig(**CFG), latent_dim=LDIM)
    params = jax_cast({"flow_lm": jfl.init_params(jax.random.PRNGKey(0))}, jnp.bfloat16)
    q = jax_quantize_int8(params)["flow_lm"]
    state = jfl.init_state(1, C, dtype=jnp.bfloat16)
    emb = jax.random.normal(jax.random.PRNGKey(1), (1, PREFILL, E), jnp.float32) * 0.3
    state = jfl.prefill(q, state, emb, jnp.full((1,), PREFILL, jnp.int32))
    layers = [dict(l, slot_pos=l["slot_pos"].at[0, 3].set(-1)) for l in state["transformer"]["layers"]]
    state = {"transformer": {**state["transformer"], "layers": layers}, "pos": state["pos"]}
    tfl = FlowLMModel(FlowLMConfig(**CFG), latent_dim=LDIM)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, q))
    return jfl, q, state, pack_backbone(tq, H, 10000.0), pack_flow(tfl.flow_net, tq["flow_net"])


def _port_caches(jstate):
    jl = jstate["transformer"]["layers"]
    ks = [torch.from_numpy(np.array(l["k"], np.float32)).to(torch.bfloat16) for l in jl]
    vs = [torch.from_numpy(np.array(l["v"], np.float32)).to(torch.bfloat16) for l in jl]
    return ks, vs, torch.from_numpy(np.array(jl[0]["slot_pos"]))


@pytest.mark.parametrize("S,bos,clamp", [(8, True, False), (12, False, True)])
def test_segment_with_split_attention_matches_jax_and_the_plain_segment(setup, monkeypatch, S, bos, clamp):
    """A whole segment through split_attention_reference (24-row chunks:
    96 = four whole chunks) against the plain segment and the JAX package's
    chained decode steps, at the BOS frame and with the write index clamped
    at C - 1 (widx0 + S > C - 1)."""
    jfl, q, state, packed, flow_packed = setup
    if clamp:  # the write index ran to within 5 rows of the capacity
        state = {"transformer": {**state["transformer"], "widx": jnp.int32(C - 5)}, "pos": state["pos"]}
    rng = np.random.default_rng(S)
    noise = (rng.standard_normal((S, LDIM)) * 0.6).astype(np.float32)
    latent0 = rng.standard_normal((1, LDIM)).astype(np.float32)
    s_ref, lat, ref_lat = state, jnp.asarray(latent0), []
    for i in range(S):
        s_ref, lat, _ = jfl.decode_step(
            q, s_ref, lat, jnp.full((1,), bos and i == 0), jax.random.PRNGKey(0), 0.7, 1, None, 0.0,
            noise=jnp.asarray(noise[i : i + 1]),
        )
        ref_lat.append(np.asarray(lat))
    qpos0, widx0 = int(state["pos"][0]), int(state["transformer"]["widx"])
    args = (packed, flow_packed, torch.from_numpy(latent0), bos, torch.from_numpy(noise))
    plain_caches = _port_caches(state)
    plain, plain_eos = fused_segment_decode_reference(*args, *plain_caches, qpos0, widx0)
    monkeypatch.setattr(fused_backbone, "attention_reference",
                        lambda *a: split_attention_reference(*a, chunk=24))
    split_caches = _port_caches(state)
    split, split_eos = fused_segment_decode_reference(*args, *split_caches, qpos0, widx0)
    err = np.abs(split.numpy() - np.concatenate(ref_lat))
    assert err.max() < TOL_SEG and err.mean() < TOL_SEG_MEAN, (err.max(), err.mean())
    torch.testing.assert_close(split, plain, rtol=0, atol=TOL_SEG)
    torch.testing.assert_close(split_eos, plain_eos, rtol=0, atol=TOL_SEG)
    for a, b in zip(split_caches[0] + split_caches[1], plain_caches[0] + plain_caches[1]):
        assert float((a.float() - b.float()).abs().max()) <= TOL_SEG
    assert torch.equal(split_caches[2], plain_caches[2])
    np.testing.assert_array_equal(split_caches[2].numpy(), np.asarray(s_ref["transformer"]["layers"][0]["slot_pos"]))


# ---------------------------------------------------------------- the one-frame launch
def _frame_plan(C, blocks, dims=B6369A24):
    """fused_backbone_step's plan: the segment's without the flow head."""
    return segment_plan(dims["L"], dims["E"], dims["H"], dims["FF"], dims["ldim"], None, None, C, blocks)


@pytest.mark.parametrize("dims,blocks", [(B6369A24, H100_SMS), (B6369A24, 2 * H100_SMS), (TINY, 7)])
def test_frame_plan_gives_every_weight_row_exactly_one_owner(dims, blocks):
    plan = _frame_plan(384, blocks, dims)
    assert tuple(plan["rows"]) == BACKBONE_KINDS == tuple(plan["kinds"])
    assert {k for _, kinds in phase_list(dims["L"], None) for k in kinds} == set(BACKBONE_KINDS)
    segment = segment_plan(**dims, C=384, blocks=blocks)
    for kind, (n, K, _) in plan["kinds"].items():
        # the segment's backbone matrices, split the same way
        assert (n, K) == segment["kinds"][kind][:2] and plan["rows"][kind] == segment["rows"][kind], kind
        starts = np.asarray(plan["rows"][kind])
        assert len(starts) == blocks + 1 and starts[0] == 0 and starts[-1] == n, kind
        owners = np.zeros(n, np.int64)
        for b in range(blocks):
            owners[starts[b]:starts[b + 1]] += 1
        assert (owners == 1).all(), kind
        assert np.diff(starts).max() - np.diff(starts).min() <= 1, kind
    assert len(plan["table"]) == (len(BACKBONE_KINDS) + 1) * (blocks + 1)
    assert plan["table"][len(BACKBONE_KINDS) * (blocks + 1):] == plan["items"]


@pytest.mark.parametrize("C,n_items", [(32, 16), (224, 64), (384, 96), (1024, 128), (12288, 128)])
def test_frame_plan_covers_every_attention_item_once(C, n_items):
    plan = _frame_plan(C, H100_SMS)
    chunk, chunks = plan["chunk"], plan["chunks"]
    assert chunk % 32 == 0 and chunk >= 64 and 1 <= chunks <= MAX_CHUNKS
    assert B6369A24["H"] * chunks == n_items  # 96 items at C=384 and 128 from C=512 up, over the whole grid
    cover = np.zeros(C, np.int64)
    for c in range(chunks):
        cover[c * chunk:min(C, (c + 1) * chunk)] += 1
    assert (cover == 1).all()
    items = np.asarray(plan["items"])
    assert items[0] == 0 and items[-1] == n_items and (np.diff(items) >= 0).all()
    owners = np.zeros(n_items, np.int64)
    for b in range(H100_SMS):
        owners[items[b]:items[b + 1]] += 1
    assert (owners == 1).all()
    assert plan["max_items"] == np.diff(items).max()
    segment = segment_plan(**B6369A24, C=C, blocks=H100_SMS)
    assert (chunk, chunks, plan["items"]) == (segment["chunk"], segment["chunks"], segment["items"])


def test_frame_plan_shared_memory_fits_up_to_the_largest_b1_capacity():
    for blocks in (H100_SMS, 2 * H100_SMS):
        for C in range(32, MAX_B1_CAPACITY + 1, 32):
            plan = _frame_plan(C, blocks)
            total = plan["shared_bytes"] + STATIC_SHARED_BYTES
            assert total <= MAX_SHARED_BYTES, (C, blocks, total)
            assert plan["xs_off"] % 128 == 0 and plan["sc_off"] % 16 == 0
            # one activation (no second one), as wide as the widest input; then the scores
            assert plan["sc_off"] == plan["xs2_off"]
            assert plan["xs2_off"] - plan["xs_off"] >= 2 * max(K for _, K, _ in plan["kinds"].values())
            assert plan["shared_bytes"] == plan["sc_off"] + plan["max_items"] * (plan["chunk"] + 4) * 4
            per_phase = [sum(-(-plan["block_bytes"][k] // 128) * 128 for k in ks)
                         for _, ks in phase_list(B6369A24["L"], None) if ks]
            assert plan["xs_off"] == 2 * plan["slot_bytes"] and plan["slot_bytes"] == max(per_phase)


@pytest.mark.parametrize("L", [6, 2, 1])
def test_frame_phase_list_is_in_six_per_layer_then_head(L):
    phases = phase_list(L, None)
    names = [name for name, _ in phases]
    layer = ["qkv", "scores", "pv", "o", "ff1_", "ff2_"]
    assert names == ["in"] + [f"{p}{l}" for l in range(L) for p in layer] + ["head"]
    assert dict(phases)["head"] == ()  # out_norm, the EOS logit and slot_pos: no weight matrix
    # the segment's frame up to its head, whose flow matrices the one-frame launch does not read
    assert phases[:-1] == phase_list(L, 2)[:6 * L + 1]
    plan = _frame_plan(384, H100_SMS, {**B6369A24, "L": L})
    assert plan["phases"] == names and len(names) == 6 * L + 2
    # one launch of one frame: a barrier after every phase but the last
    assert plan["barriers_per_frame"] - 1 == len(names) - 1 == 6 * L + 1
    if L == 6:
        assert len(names) == 38


def _oracle_step(jfl, q, state, latent, is_bos):
    """The XLA path of flow_lm.decode_step up to h and the EOS logit
    (tests/test_torch_fused_kernels.py's oracle)."""
    seq = q["bos_emb"][None, :].astype(jnp.float32) if is_bos else latent
    x = jlinear(seq[:, None, :], q["input_linear"]["weight"])
    h, ts = jfl.transformer(q["transformer"], x, state["transformer"], state["pos"][:, None])
    h = jlayer_norm(h, q["out_norm"]["weight"], q["out_norm"]["bias"], eps=1e-5).astype(jnp.float32)[:, -1]
    eos = jlinear(h, q["out_eos"]["weight"], q["out_eos"]["bias"])[:, 0]
    return h, eos, {"transformer": ts, "pos": state["pos"] + 1}


def _frame_state(state, case, rng):
    """The prefilled JAX state at C=96 with a longer history: rows past the
    prefill hold random bf16 K/V rows at their own positions, so that the
    valid rows span several 32-row chunks."""
    n = C if case == "clamp" else 80
    jl = state["transformer"]["layers"]
    sp = np.array(jl[0]["slot_pos"])
    sp[0, PREFILL:n] = np.arange(PREFILL, n)
    if case == "holes":
        sp[0, rng.choice(n, 11, replace=False)] = -1
    elif case == "minus_one_rows":  # rows never written, between written ones
        sp[0, 20:45] = -1
    layers = []
    for layer in jl:
        kv = {}
        for name in ("k", "v"):
            a = np.array(layer[name], np.float32)
            a[0, PREFILL:n] = rng.standard_normal(a[0, PREFILL:n].shape) * 0.5
            kv[name] = jnp.asarray(a, jnp.bfloat16)
        layers.append(dict(layer, **kv, slot_pos=jnp.asarray(sp)))
    # clamp: the write index ran past the capacity, so the append lands on row C - 1
    widx, pos = (C + 3, C + 5) if case == "clamp" else (n, n)
    return {"transformer": {**state["transformer"], "layers": layers, "widx": jnp.int32(widx)},
            "pos": jnp.full((1,), pos, jnp.int32)}


@pytest.mark.parametrize("case", ["bos", "holes", "minus_one_rows", "clamp"])
@pytest.mark.parametrize("chunk", [32, 64])  # 96 rows: three whole chunks, or a whole and a part chunk
def test_frame_with_split_attention_matches_jax_and_the_plain_frame(setup, monkeypatch, case, chunk):
    """One backbone frame with the one-frame kernel's attention split
    (split_attention_reference) against fused_backbone_step_reference and
    the JAX oracle: h, the EOS logit, the caches and slot_pos."""
    jfl, q, state, packed, _ = setup
    rng = np.random.default_rng(["bos", "holes", "minus_one_rows", "clamp"].index(case) * 100 + chunk)
    jstate = _frame_state(state, case, rng)
    latent = rng.standard_normal((1, LDIM)).astype(np.float32)
    is_bos = case == "bos"
    h_ref, eos_ref, s_ref = _oracle_step(jfl, q, jstate, jnp.asarray(latent), is_bos)
    qpos, widx = int(jstate["pos"][0]), int(jstate["transformer"]["widx"])
    plain_caches = _port_caches(jstate)
    h_plain, eos_plain = fused_backbone_step_reference(packed, torch.from_numpy(latent), is_bos, *plain_caches,
                                                       qpos, widx)
    monkeypatch.setattr(fused_backbone, "attention_reference",
                        lambda *a: split_attention_reference(*a, chunk=chunk))
    split_caches = _port_caches(jstate)
    h, eos = fused_backbone_step_reference(packed, torch.from_numpy(latent), is_bos, *split_caches, qpos, widx)
    assert h.shape == (1, E) and torch.isfinite(h).all()
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=TOL_STEP)
    np.testing.assert_allclose(eos.numpy(), np.asarray(eos_ref), atol=TOL_STEP)
    torch.testing.assert_close(h, h_plain, rtol=0, atol=TOL_STEP)
    torch.testing.assert_close(eos, eos_plain, rtol=0, atol=TOL_STEP)
    ref_layers = s_ref["transformer"]["layers"]
    for l in range(L):
        for got, plain, ref in ((split_caches[0][l], plain_caches[0][l], ref_layers[l]["k"]),
                                (split_caches[1][l], plain_caches[1][l], ref_layers[l]["v"])):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=TOL_STEP)
            assert float((got.float() - plain.float()).abs().max()) <= TOL_STEP
    assert torch.equal(split_caches[2], plain_caches[2])
    np.testing.assert_array_equal(split_caches[2].numpy(), np.asarray(ref_layers[0]["slot_pos"]))
    assert int(split_caches[2][0, min(widx, C - 1)]) == qpos
