"""The port's engine against the JAX engine on the CPU at tiny widths: the
same float32 weights (params_from_jax), temperature 0 (no flow noise on
either side), the same voice and texts, one text submitted mid-flight, and
a preemption case. Both engines follow the same host schedule, so they must
emit the same frames per request, and the audio must agree within the gates
of tests/test_torch_batch.py."""

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
from pocket_tts_tpu.serving.engine import TTSEngine as JTTSEngine
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from tiny_config import TINY, tiny_config

PROMPT = np.random.default_rng(31).standard_normal((1, 12, TINY["flow_lm"]["transformer"]["d_model"])).astype(
    np.float32) * 0.3
TEXTS = ["One two three four five six.", "Seven eight nine.", "Ten eleven twelve thirteen fourteen."]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops run fastest on one thread, and the suite's parallel workers
    would otherwise oversubscribe the cores with torch's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_f32_params():
    cfg = tiny_config()
    fl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"flow_lm": fl.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}


def _pair(jax_f32_params, param_dtype, kv_int8):
    cfg = tiny_config()
    fl, mimi = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension), JMimi(config=cfg.mimi)
    jp = jax_f32_params
    if param_dtype == "int8":
        jp = jax_quantize_int8(jax_cast(jp, jnp.bfloat16))
    jm = JTTSModel(fl, mimi, jp, JTokenizer(4000), temp=0.0, lsd_decode_steps=1, noise_clamp=None,
                   eos_threshold=1e9, config=cfg, kv_int8=kv_int8)
    if param_dtype == "int8":
        jm.state_dtype = jnp.bfloat16
    tm = TTSModel.from_params(TConfig(**TINY), params_from_jax(jax.tree_util.tree_map(np.asarray, jax_f32_params)),
                              FallbackWordTokenizer(4000), param_dtype, device="cpu", temp=0.0, eos_threshold=1e9,
                              kv_int8=kv_int8)
    return (jm, jm._state_from_prompt(jnp.asarray(PROMPT))), (tm, tm._state_from_prompt(torch.from_numpy(PROMPT)))


def _serve(engine_cls, model, voice, texts, ticks_before_last, **kw):
    """Submit all texts but the last, tick, submit the last, run to the end."""
    engine = engine_cls(model, **kw)
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in texts[:-1]]
    for _ in range(ticks_before_last):
        engine.step()
    handles.append(engine.submit(texts[-1], voice, frames_after_eos=2))
    engine.run(stop_when_idle=True)
    return engine, [h.audio() for h in handles]


def _assert_close(got, ref, exact):
    assert [g.shape for g in got] == [r.shape for r in ref]  # same frames per request
    for g, r in zip(got, ref):
        assert g.shape[0] > 0 and g.shape[0] % 1920 == 0
        peak = np.abs(r).max()
        if exact:
            # float32 on both sides; XLA and PyTorch differ in summation order only.
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * peak)
        else:
            # bf16 activations and caches: a bf16 rounding flipped by sum order
            # carries through the autoregressive frames.
            np.testing.assert_allclose(g, r, rtol=0, atol=0.05 * peak)
            e_got = np.sqrt((g.reshape(-1, 1920) ** 2).mean(1))
            e_ref = np.sqrt((r.reshape(-1, 1920) ** 2).mean(1))
            np.testing.assert_allclose(e_got, e_ref, rtol=0.05)


@pytest.mark.parametrize("param_dtype,kv_int8", [("float32", False), ("int8", False), ("int8", True)])
def test_engine_matches_jax_engine(jax_f32_params, param_dtype, kv_int8):
    """slots=2, segment_frames=4: two texts start together, the third waits
    for a slot (submitted after three ticks). Preemption never fires (its
    lead threshold is out of reach), so the schedule does not depend on
    wall-clock time."""
    (jm, jv), (tm, tv) = _pair(jax_f32_params, param_dtype, kv_int8)
    kw = dict(slots=2, segment_frames=4, capacity=512, text_pad=32, preempt_min_lead_s=1e9)
    j_engine, ref = _serve(JTTSEngine, jm, jv, TEXTS, 3, **kw)
    t_engine, got = _serve(TTSEngine, tm, tv, TEXTS, 3, **kw)
    _assert_close(got, ref, exact=param_dtype == "float32")
    assert t_engine._written == j_engine._written and t_engine._pos == j_engine._pos


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_off_grid_capacity_matches_jax_engine(jax_f32_params, slots):
    """capacity=200 lies off the B=1 kernels' 32-row grid: the port rounds it
    up to 224 rows, which are never valid, while the JAX engine serves 200
    rows through XLA. The same frames per request, audio within float32 sum
    order, one slot (the B=1 path) and two (the batch path)."""
    (jm, jv), (tm, tv) = _pair(jax_f32_params, "float32", False)
    kw = dict(slots=slots, segment_frames=4, capacity=200, text_pad=32, preempt_min_lead_s=1e9)
    j_engine, ref = _serve(JTTSEngine, jm, jv, TEXTS[:2], 1, **kw)
    t_engine, got = _serve(TTSEngine, tm, tv, TEXTS[:2], 1, **kw)
    assert (t_engine.capacity, j_engine.capacity) == (224, 200) and t_engine.growths == 0
    _assert_close(got, ref, exact=True)


def test_engine_preemption_matches_jax_engine(jax_f32_params):
    """test_engine_preemption_exact_audio_at_temp_zero's setup on both
    sides: one slot, every running stream preemptable, no parked stream
    urgent; the long stream is parked for the short one and resumed."""
    (jm, jv), (tm, tv) = _pair(jax_f32_params, "float32", False)
    texts = ["A very long sentence with many many words to speak aloud.", "Quick interjection."]
    kw = dict(slots=1, segment_frames=2, capacity=512, text_pad=32, preempt_min_lead_s=-1e9,
              resume_urgent_lead_s=-1e9)
    j_engine, ref = _serve(JTTSEngine, jm, jv, texts, 3, **kw)
    t_engine, got = _serve(TTSEngine, tm, tv, texts, 3, **kw)
    assert t_engine.preemptions == j_engine.preemptions >= 1
    assert t_engine.resumes == j_engine.resumes >= 1
    _assert_close(got, ref, exact=True)
