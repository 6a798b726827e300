"""The B=1 kernels' capacity gate (tiny config, CPU).

Both B=1 kernels take caches of C rows with C % 32 == 0 and C <= 12288
(ops/fused_backbone.capacity_ok, which their argument check also reads).
The routing rules, FlowLMModel.fused_step_ok and generate.segment_kernel_ok,
send any other B=1 cache down the plain path before a launch, as the JAX
package routes a cache its kernels cannot hold to XLA. Past the limit the
decode must then match the JAX package's XLA path; the test lowers the
limit to 64 rows, so a tiny cache stands for one past 12288.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pocket_tts_tpu_torch.models.flow_lm as flow_lm_module
import pocket_tts_tpu_torch.models.generate as generate_module
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.generate import initial_carry, run_segment, segment_kernel_ok
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.ops import fused_backbone
from tiny_config import TINY, tiny_config

PROMPT = 12  # prefilled rows
S = 8  # one segment: a whole 8-frame group, as the segment kernel takes


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    jfl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"flow_lm": jfl.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}
    jq = jax_quantize_int8(jax_cast(params, jnp.bfloat16))["flow_lm"]
    tm = TTSModel.from_params(TConfig(**TINY), params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                              FallbackWordTokenizer(4000), "int8", device="cpu", eos_threshold=1e9)
    return jfl, jq, tm


@pytest.mark.parametrize("C,ok", [(224, True), (12288, True), (12320, False), (12416, False), (12300, False)])
def test_routing_refuses_caches_past_the_kernels_limit(models, C, ok):
    """12320 is 12288 + 32, the next capacity the kernels' grid has; 12300
    is off the 32-row grid."""
    _, _, tm = models
    fl = tm.params["flow_lm"]
    state = tm.flow_lm.init_state(1, C, dtype=torch.bfloat16)
    assert fused_backbone.capacity_ok(C) is ok
    assert tm.flow_lm.fused_step_ok(fl, state, 1) is ok
    assert segment_kernel_ok(tm.flow_lm, fl, state, 1, S) is ok
    assert not segment_kernel_ok(tm.flow_lm, fl, state, 1, S - 4)  # the segment rule keeps its 8-frame groups


def _decode_segment(tm, capacity, noise):
    """Prefill PROMPT rows into a bf16 cache of `capacity` rows, then run one
    S-frame segment from BOS through run_segment, the decode loop's unit."""
    fl = tm.params["flow_lm"]
    emb = torch.from_numpy((np.random.default_rng(9).standard_normal((1, PROMPT, tm.flow_lm.dim)) * 0.3)
                           .astype(np.float32))
    state = tm.flow_lm.prefill(fl, tm.flow_lm.init_state(1, capacity, dtype=torch.bfloat16), emb, [PROMPT])
    carry = initial_carry(1, tm.flow_lm.ldim, [1000], [1000], "cpu")
    with torch.no_grad():
        state, _, carry, audio, _, _ = run_segment(tm.flow_lm, tm.mimi, tm.params, state,
                                                    tm._warm_mimi_state(1, S, 1), carry, noise, 1, 1e9)
    return state, carry["latent"], audio


def test_decode_past_the_limit_takes_the_plain_path_and_matches_jax(models, monkeypatch):
    jfl, jq, tm = models
    monkeypatch.setattr(fused_backbone, "MAX_CAPACITY", 64)
    noise = torch.from_numpy((np.random.default_rng(4).standard_normal((S, 1, tm.flow_lm.ldim)) * 0.7)
                             .astype(np.float32))

    def refuse(*args, **kwargs):
        raise AssertionError("a B=1 kernel was called for a cache past its limit")

    # At the limit the route is the kernels' (the wrappers are stubbed, so
    # reaching one raises); one 32-row step past it, the plain path's.
    monkeypatch.setattr(flow_lm_module, "fused_backbone_step", refuse)
    monkeypatch.setattr(generate_module, "fused_segment_decode", refuse)
    with pytest.raises(AssertionError, match="B=1 kernel"):
        _decode_segment(tm, 64, noise)
    state, latent, audio = _decode_segment(tm, 96, noise)
    assert np.isfinite(audio.numpy()).all()

    # The JAX package's XLA path on the same int8 weights, prompt and noise.
    emb = (np.random.default_rng(9).standard_normal((1, PROMPT, jfl.dim)) * 0.3).astype(np.float32)
    js = jfl.prefill(jq, jfl.init_state(1, 96, dtype=jnp.bfloat16), jnp.asarray(emb),
                     jnp.full((1,), PROMPT, jnp.int32))
    lat = jnp.zeros((1, jfl.ldim), jnp.float32)
    for i in range(S):
        js, lat, _ = jfl.decode_step(jq, js, lat, jnp.full((1,), i == 0), jax.random.PRNGKey(0), 0.7, 1, None, 1e9,
                                     noise=jnp.asarray(noise[i].numpy()))
    # Both are the same float32 path on the same bf16 cache and differ by
    # sum order alone; a cache row may flip one bf16 rounding (2^-7 relative).
    np.testing.assert_allclose(latent.numpy(), np.asarray(lat), rtol=0, atol=1e-5)
    assert state["pos"] == [PROMPT + S] and state["transformer"]["widx"] == PROMPT + S
    for lt, lj in zip(state["transformer"]["layers"], js["transformer"]["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(lt[name][0].float().numpy(), np.asarray(lj[name][0], np.float32),
                                       rtol=2**-7, atol=1e-6)
        np.testing.assert_array_equal(lt["slot_pos"].numpy(), np.asarray(lj["slot_pos"]))
