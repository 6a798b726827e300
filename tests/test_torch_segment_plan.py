"""The persistent segment kernel's work split (ops/fused_segment.segment_plan)
and the plain form of its two-phase attention (split_attention_reference),
on the CPU. The kernel itself runs only on the card, where chip_smoke.py
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
from pocket_tts_tpu_torch.config.schema import FlowLMConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.ops import fused_backbone
from pocket_tts_tpu_torch.ops.fused_backbone import attention_reference, pack_backbone
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

B6369A24 = {"L": 6, "E": 1024, "H": 16, "FF": 4096, "ldim": 32, "MC": 512, "depth": 6}
TINY = {"L": 2, "E": 64, "H": 4, "FF": 256, "ldim": 16, "MC": 32, "depth": 2}
H100_SMS = 132
MAX_B1_CAPACITY = 12288  # the largest C the B=1 kernels take (ops/fused_backbone._backbone_args)
TOL_ATTN = 1e-2
TOL_SEG, TOL_SEG_MEAN = 0.15, 2e-2


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
