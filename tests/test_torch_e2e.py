"""Text -> audio through the port against the JAX package, tiny config,
temperature 0 (the flow noise is zero, so both sides decode the same
trajectory), same weights via params_from_jax, same voice prompt.

float32: XLA and PyTorch differ only in summation order; through ~50
autoregressive frames and the vocoder that stays below 1e-4 of the
waveform's peak. int8: the port decodes through the plain versions of its
kernels (bf16 flow head in whole segments, algebraic self term), the JAX
package through its XLA path, so the float32-vs-bf16 flow head of the
segment frames sets the bound: 5% of the waveform's peak, with the
per-frame energy envelope within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.text import FallbackWordTokenizer as JTokenizer
from pocket_tts_tpu.models.text import split_into_best_sentences as jax_split
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer, split_into_best_sentences
from pocket_tts_tpu_torch.models.tts_model import ModelState, TTSModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from tiny_config import TINY, tiny_config

TEXT = "One two three four."
PROMPT = np.random.default_rng(9).standard_normal((1, 12, TINY["flow_lm"]["transformer"]["d_model"])).astype(
    np.float32
) * 0.3


@pytest.fixture(scope="module")
def jax_f32_params():
    cfg = tiny_config()
    fl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"flow_lm": fl.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}


def make_pair(jax_f32_params, param_dtype, eos_threshold):
    cfg = tiny_config()
    fl, mimi = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension), JMimi(config=cfg.mimi)
    jp = jax_f32_params
    if param_dtype == "int8":
        jp = jax_quantize_int8(jax_cast(jp, jnp.bfloat16))
    jm = JTTSModel(fl, mimi, jp, JTokenizer(4000), temp=0.0, lsd_decode_steps=1, noise_clamp=None,
                   eos_threshold=eos_threshold, config=cfg)
    if param_dtype == "int8":
        jm.state_dtype = jnp.bfloat16
    tm = TTSModel.from_params(
        TConfig(**TINY), params_from_jax(jax.tree_util.tree_map(np.asarray, jax_f32_params)),
        FallbackWordTokenizer(4000), param_dtype, device="cpu", temp=0.0, eos_threshold=eos_threshold,
    )
    return jm, tm


def assert_audio_close(got, ref, param_dtype):
    assert got.shape == ref.shape and got.dtype == np.float32
    peak = np.abs(ref).max()
    if param_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * peak)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.05 * peak)
        e_got = np.sqrt((got.reshape(-1, 1920) ** 2).mean(1))
        e_ref = np.sqrt((ref.reshape(-1, 1920) ** 2).mean(1))
        np.testing.assert_allclose(e_got, e_ref, rtol=0.05)


@pytest.mark.parametrize("param_dtype", ["float32", "int8"])
def test_generate_audio_and_stream_match_jax(jax_f32_params, param_dtype):
    jm, tm = make_pair(jax_f32_params, param_dtype, eos_threshold=1e9)
    jv = jm._state_from_prompt(jnp.asarray(PROMPT))
    tv = tm._state_from_prompt(torch.from_numpy(PROMPT))
    ref = jm.generate_audio(jv, TEXT, frames_after_eos=2)
    got = tm.generate_audio(tv, TEXT, frames_after_eos=2)
    assert_audio_close(got, ref, param_dtype)
    ref_frames = list(jm.generate_audio_stream(jv, TEXT, frames_after_eos=2))
    got_frames = list(tm.generate_audio_stream(tv, TEXT, frames_after_eos=2))
    assert all(f.shape == (1920,) for f in got_frames)
    assert_audio_close(np.concatenate(got_frames), np.concatenate(ref_frames), param_dtype)


def test_eos_cut_and_continuation_match_jax(jax_f32_params):
    """A reachable EOS threshold (random logits sit far above -4.0, so EOS
    fires at frame 0 on both sides): same emitted length and audio, and a
    copy_state=False continuation rewinds to the same stream position."""
    jm, tm = make_pair(jax_f32_params, "float32", eos_threshold=-4.0)
    jv = jm._state_from_prompt(jnp.asarray(PROMPT))
    tv = tm._state_from_prompt(torch.from_numpy(PROMPT))
    ref = jm.generate_audio(jv, TEXT, frames_after_eos=3, copy_state=False)
    got = tm.generate_audio(tv, TEXT, frames_after_eos=3, copy_state=False)
    assert got.shape[0] == ref.shape[0] == 3 * 1920
    assert_audio_close(got, ref, "float32")
    assert tv.pos == list(jv.pos)
    ref2 = jm.generate_audio(jv, TEXT, frames_after_eos=3)
    got2 = tm.generate_audio(tv, TEXT, frames_after_eos=3)
    assert_audio_close(got2, ref2, "float32")


def _tensors(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_copy_state_reuse_leaves_the_voice_bit_identical(jax_f32_params):
    """The kernels append into the caches in place; copy_state=True must
    decode on a clone, so a reused voice state stays bit-identical and two
    generations from it agree exactly. copy_state=False advances it."""
    _, tm = make_pair(jax_f32_params, "int8", eos_threshold=1e9)
    voice = tm._state_from_prompt(torch.from_numpy(PROMPT))
    before = [t.clone() for t in _tensors(voice.tree)]
    a1 = tm.generate_audio(voice, TEXT, frames_after_eos=2)
    a2 = tm.generate_audio(voice, TEXT, frames_after_eos=2)
    np.testing.assert_array_equal(a1, a2)
    assert all(torch.equal(x, y) for x, y in zip(before, _tensors(voice.tree)))
    assert voice.pos == [12]
    work = ModelState(voice.tree, voice.pos, voice.written)
    tm.generate_audio(work, TEXT, frames_after_eos=2, copy_state=False)
    assert work.pos[0] > 12


def test_text_chunking_matches_jax():
    text = "Hello there. This is a longer text! Does it split? Yes, it does. " * 3
    for max_tokens in (5, 12, 50):
        assert split_into_best_sentences(FallbackWordTokenizer(4000), text, max_tokens) == jax_split(
            JTokenizer(4000), text, max_tokens
        )
    assert FallbackWordTokenizer(4000).encode(text) == JTokenizer(4000).encode(text)


def test_transfer_pcm16_rounds_like_a_16_bit_writer(jax_f32_params):
    """transfer_pcm16 moves int16 PCM off the device; the host widens it, so
    audio differs from the float path by the 16-bit rounding only."""
    _, tm = make_pair(jax_f32_params, "float32", eos_threshold=1e9)
    voice = tm._state_from_prompt(torch.from_numpy(PROMPT))
    ref = tm.generate_audio(voice, TEXT, frames_after_eos=2)
    tm.transfer_pcm16 = True
    got = tm.generate_audio(voice, TEXT, frames_after_eos=2)
    expect = (np.clip(ref, -1, 1) * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
    np.testing.assert_allclose(got, expect, rtol=0, atol=1.5 / 32767.0)
