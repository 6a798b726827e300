"""The plain versions of the port's two CUDA kernels against the JAX
package's XLA oracle — chained flow_lm.decode_step calls on quantize_int8
params, the oracle the JAX kernel tests use — at narrow widths on the CPU.
(The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.)

Tolerances: the backbone rounds at the same points as the oracle (bf16
activations into int8 products, bf16 q/k/v, softmax weights and FF hidden,
float32 sums); sum order and one flipped bf16 rounding bound the difference
at the JAX kernel test's 2e-2. The segment's flow head multiplies bf16
weights and bf16 activations where the CPU oracle runs float32, compounded
through the latent recurrence: the JAX segment test's 0.15 max / 2e-2 mean.
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
from pocket_tts_tpu_torch.ops.fused_backbone import (
    fused_backbone_step,
    fused_backbone_step_reference,
    pack_backbone,
)
from pocket_tts_tpu_torch.ops.fused_segment import fused_segment_decode, pack_flow

E, H, L, LDIM, C, PREFILL = 64, 4, 2, 16, 64, 9
CFG = {
    "dtype": "float32",
    "flow": {"depth": 2, "dim": 32},
    "transformer": {"d_model": E, "hidden_scale": 4, "max_period": 10000, "num_heads": H, "num_layers": L},
    "lookup_table": {"dim": E, "n_bins": 100, "tokenizer": "sentencepiece", "tokenizer_path": "unavailable://"},
}
TOL_STEP = 2e-2
TOL_SEG, TOL_SEG_MEAN = 0.15, 2e-2


@pytest.fixture(scope="module")
def setup():
    jfl = JFlowLM(config=JFlowLMConfig(**CFG), latent_dim=LDIM)
    params = jax_cast({"flow_lm": jfl.init_params(jax.random.PRNGKey(0))}, jnp.bfloat16)
    q = jax_quantize_int8(params)["flow_lm"]
    state = jfl.init_state(1, C, dtype=jnp.bfloat16)
    emb = jax.random.normal(jax.random.PRNGKey(1), (1, PREFILL, E), jnp.float32) * 0.3
    state = jfl.prefill(q, state, emb, jnp.full((1,), PREFILL, jnp.int32))
    # A hole in the history, so masking by slot_pos is exercised.
    layers = [dict(l, slot_pos=l["slot_pos"].at[0, 3].set(-1)) for l in state["transformer"]["layers"]]
    state = {"transformer": {**state["transformer"], "layers": layers}, "pos": state["pos"]}
    tfl = FlowLMModel(FlowLMConfig(**CFG), latent_dim=LDIM)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, q))
    packed = pack_backbone(tq, H, 10000.0)
    flow_packed = pack_flow(tfl.flow_net, tq["flow_net"])
    return jfl, q, state, tfl, tq, packed, flow_packed


def port_state(jstate):
    """JAX flow state -> the port's (caches + one shared slot_pos, host ints)."""
    jl = jstate["transformer"]["layers"]
    sp = torch.from_numpy(np.array(jl[0]["slot_pos"]))
    layers = [
        {"k": torch.from_numpy(np.array(l["k"], np.float32)).to(torch.bfloat16),
         "v": torch.from_numpy(np.array(l["v"], np.float32)).to(torch.bfloat16), "slot_pos": sp}
        for l in jl
    ]
    return {"transformer": {"layers": layers, "widx": int(jstate["transformer"]["widx"])},
            "pos": [int(p) for p in np.asarray(jstate["pos"])]}


def assert_caches_close(tstate, jstate, tol):
    for lt, lj in zip(tstate["transformer"]["layers"], jstate["transformer"]["layers"]):
        np.testing.assert_allclose(lt["k"][0].float().numpy(), np.asarray(lj["k"][0], np.float32), atol=tol)
        np.testing.assert_allclose(lt["v"][0].float().numpy(), np.asarray(lj["v"][0], np.float32), atol=tol)
    np.testing.assert_array_equal(
        tstate["transformer"]["layers"][0]["slot_pos"].numpy(),
        np.asarray(jstate["transformer"]["layers"][0]["slot_pos"]),
    )


def oracle_step(jfl, q, state, latent, is_bos):
    """The XLA path of flow_lm.decode_step up to h and the EOS logit."""
    seq = q["bos_emb"][None, :].astype(jnp.float32) if is_bos else latent
    x = jlinear(seq[:, None, :], q["input_linear"]["weight"])
    h, ts = jfl.transformer(q["transformer"], x, state["transformer"], state["pos"][:, None])
    h = jlayer_norm(h, q["out_norm"]["weight"], q["out_norm"]["bias"], eps=1e-5).astype(jnp.float32)[:, -1]
    eos = jlinear(h, q["out_eos"]["weight"], q["out_eos"]["bias"])[:, 0]
    return h, eos, {"transformer": ts, "pos": state["pos"] + 1}


@pytest.mark.parametrize("case", ["bos", "latent", "widx_clamp"])
def test_backbone_step_reference_matches_xla_oracle(setup, case):
    jfl, q, state, tfl, tq, packed, _ = setup
    if case == "widx_clamp":  # the write index ran past the capacity: appends land at C - 1
        state = {"transformer": {**state["transformer"], "widx": jnp.int32(C + 3)}, "pos": state["pos"]}
    latent = jnp.asarray(np.random.default_rng(2).standard_normal((1, LDIM)).astype(np.float32))
    is_bos = case == "bos"
    h_ref, eos_ref, s_ref = oracle_step(jfl, q, state, latent, is_bos)
    ts = port_state(state)
    layers = ts["transformer"]["layers"]
    h, eos = fused_backbone_step(
        packed, torch.from_numpy(np.array(latent)), is_bos, [l["k"] for l in layers],
        [l["v"] for l in layers], layers[0]["slot_pos"], ts["pos"][0], ts["transformer"]["widx"],
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=TOL_STEP)
    np.testing.assert_allclose(eos.numpy(), np.asarray(eos_ref), atol=TOL_STEP)
    assert_caches_close(ts, s_ref, TOL_STEP)


@pytest.mark.parametrize("S,bos", [(8, True), (16, False)])
def test_segment_reference_matches_chained_decode_steps(setup, S, bos):
    jfl, q, state, tfl, tq, packed, flow_packed = setup
    rng = np.random.default_rng(S)
    noise = (rng.standard_normal((S, LDIM)) * 0.6).astype(np.float32)
    latent0 = rng.standard_normal((1, LDIM)).astype(np.float32)
    s_ref, lat = state, jnp.asarray(latent0)
    ref_lat, ref_eos = [], []
    for i in range(S):
        s_ref, lat, eos = jfl.decode_step(
            q, s_ref, lat, jnp.full((1,), bos and i == 0), jax.random.PRNGKey(0), 0.7, 1, None, 0.0,
            noise=jnp.asarray(noise[i : i + 1]),
        )
        ref_lat.append(np.asarray(lat))
        ref_eos.append(bool(eos[0]))
    ts = port_state(state)
    layers = ts["transformer"]["layers"]
    lats, logits = fused_segment_decode(
        packed, flow_packed, torch.from_numpy(latent0), bos, torch.from_numpy(noise),
        [l["k"] for l in layers], [l["v"] for l in layers], layers[0]["slot_pos"],
        ts["pos"][0], ts["transformer"]["widx"],
    )
    ref = np.concatenate(ref_lat)
    err = np.abs(lats.numpy() - ref)
    assert err.max() < TOL_SEG and err.mean() < TOL_SEG_MEAN, (err.max(), err.mean())
    clear = np.abs(logits.numpy()) > 0.05  # a logit at the threshold flips on rounding alone
    np.testing.assert_array_equal((logits.numpy() > 0.0)[clear], np.array(ref_eos)[clear])
    assert_caches_close(ts, s_ref, TOL_SEG)


def test_cpu_tensors_run_the_plain_version_without_launching(setup):
    """On CPU tensors the wrappers take the plain version only because the
    tensors lie on the CPU: no launch is counted and nothing is built."""
    _, _, state, _, _, packed, flow_packed = setup
    from pocket_tts_tpu_torch.ops import _cuda

    ts = port_state(state)
    layers = ts["transformer"]["layers"]
    b0, s0 = fused_backbone_step.launches, fused_segment_decode.launches
    latent = torch.zeros(1, LDIM)
    h1, _ = fused_backbone_step(packed, latent, True, [l["k"] for l in layers], [l["v"] for l in layers],
                                layers[0]["slot_pos"], 9, 9)
    ts2 = port_state(state)
    l2 = ts2["transformer"]["layers"]
    h2, _ = fused_backbone_step_reference(packed, latent, True, [l["k"] for l in l2], [l["v"] for l in l2],
                                          l2[0]["slot_pos"], 9, 9)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)
    fused_segment_decode(packed, flow_packed, latent, True, torch.zeros(8, LDIM), [l["k"] for l in layers],
                         [l["v"] for l in layers], layers[0]["slot_pos"], 10, 10)
    assert (fused_backbone_step.launches, fused_segment_decode.launches) == (b0, s0)
    assert not _cuda._LIBS
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check_cuda_tensor("slot_pos", layers[0]["slot_pos"], torch.int32)


def test_state_utils_match_jax(setup):
    """expand_state, compact_state and invalidate_after on the port's state
    layout (one slot_pos shared by every layer) against the JAX package."""
    jfl, _, state, tfl, *_ = setup
    ts = port_state(state)
    jx, tx = jfl.expand_state(state, 2 * C), tfl.expand_state(ts, 2 * C)
    assert_caches_close(tx, jx, 0.0)
    jc, tc = jfl.compact_state(jx, 16), tfl.compact_state(tx, 16)
    assert_caches_close(tc, jc, 0.0)
    assert tc["transformer"]["widx"] == int(jc["transformer"]["widx"])
    layers = tc["transformer"]["layers"]
    assert all(l["slot_pos"] is layers[0]["slot_pos"] for l in layers)
    ji, ti = jfl.invalidate_after(jc, jnp.asarray([5], jnp.int32)), tfl.invalidate_after(tc, [5])
    assert_caches_close(ti, ji, 0.0)
    assert ti["pos"] == [5]
