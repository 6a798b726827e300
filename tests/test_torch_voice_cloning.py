"""Voice cloning of the port against the JAX package (tiny config, float32,
CPU): WAV file -> audio_read -> convert_audio -> Mimi encoder -> speaker
projection -> prefill -> TTS, on the same weights (params_from_jax).

Ports tests/test_voice_cloning.py. Its test of the encoder's jit cache
(test_encode_bucketing_stable_jit_cache) has no counterpart: the port runs
eagerly and encodes at the exact length. In its place the port's
exact-length encode is held against JAX `_encode_audio` (which pads to a
power-of-2 frame bucket and returns the valid frames), and each part of
the encode, and the prefilled state, against JAX.

Tolerance: float32 on both sides; XLA and PyTorch sum the convolutions and
matmuls in another order, through ~15 encoder layers, so conditioning and
cache rows agree to 1e-4 absolute (values of order 1e-2 to 1).
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.data.audio import audio_read as jax_audio_read
from pocket_tts_tpu.data.audio_utils import convert_audio as jax_convert_audio
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.text import FallbackWordTokenizer as JTokenizer
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.data.audio import audio_read, audio_write
from pocket_tts_tpu_torch.data.audio_utils import convert_audio
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import VOICE_CLONING_UNSUPPORTED, TTSModel
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.ops.rope import rope_angles
from tiny_config import TINY, tiny_config

RNG = np.random.default_rng(31)
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) on the same weights, with a non-zero speaker
    projection so cloning actually conditions the model."""
    cfg = tiny_config()
    flow_lm = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension,
                      speaker_dim=cfg.mimi.seanet.dimension)
    mimi = JMimi(config=cfg.mimi)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"flow_lm": flow_lm.init_params(k1), "mimi": mimi.init_params(k2)}
    params["flow_lm"]["speaker_proj_weight"] = (
        jax.random.normal(jax.random.PRNGKey(3), (flow_lm.dim, flow_lm.speaker_dim)) * 0.02
    )
    jm = JTTSModel(flow_lm=flow_lm, mimi=mimi, params=params, tokenizer=JTokenizer(4000), temp=0.7,
                   lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9, config=cfg, seed=0)
    tm = TTSModel.from_params(TConfig(**TINY), params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                              FallbackWordTokenizer(4000), "float32", device="cpu", temp=0.7, lsd_decode_steps=1,
                              noise_clamp=None, eos_threshold=1e9)
    return jm, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _write_wav(path, seconds=1.0, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    audio_write(path, wav, rate)
    return path


def test_audio_read_roundtrip(tmp_path):
    path = _write_wav(tmp_path / "ref.wav", seconds=0.5)
    audio, sr = audio_read(path)
    assert sr == 16000
    assert audio.shape[0] == 1 and audio.shape[1] == 8000
    assert np.abs(audio).max() <= 0.31
    want, want_sr = jax_audio_read(path)
    assert sr == want_sr and audio.dtype == want.dtype
    np.testing.assert_array_equal(audio, want)


def test_audio_read_stereo_downmix_matches_jax(tmp_path):
    path = tmp_path / "stereo.wav"
    pcm = RNG.integers(-20000, 20000, (4000, 2), dtype=np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes(pcm.tobytes())
    audio, sr = audio_read(path)
    want, _ = jax_audio_read(path)
    assert audio.shape == (1, 4000) and sr == 22050
    np.testing.assert_array_equal(audio, want)


def test_convert_audio_resamples():
    wav = RNG.standard_normal((1, 16000)).astype(np.float32)
    out = convert_audio(wav, 16000, 24000, 1)
    assert out.shape == (1, 24000)
    np.testing.assert_array_equal(out, jax_convert_audio(wav, 16000, 24000, 1))
    stereo = RNG.standard_normal((2, 8000)).astype(np.float32)
    out = convert_audio(stereo, 24000, 24000, 1)
    assert out.shape == (1, 8000)
    np.testing.assert_array_equal(out, jax_convert_audio(stereo, 24000, 24000, 1))
    mono = RNG.standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(convert_audio(mono, 44100, 24000, 2), jax_convert_audio(mono, 44100, 24000, 2))


def _encoder_input(jm, frames_200hz=40):
    return (RNG.standard_normal((2, 1, frames_200hz * jm.mimi.encoder.hop_length)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("part", ["encoder", "encoder_transformer", "downsample", "project_speaker"])
def test_encode_parts_match_jax(pair, part):
    """Each stage of the encode, alone, on the same input and weights."""
    jm, tm = pair
    jp, tp = jm.params, tm.params
    if part == "encoder":
        x = _encoder_input(jm)
        want = jm.mimi.encoder.forward(jp["mimi"]["encoder"], jnp.asarray(x))
        got = tm.mimi.encoder.forward(tp["mimi"]["encoder"], torch.from_numpy(x))
    elif part == "encoder_transformer":
        x = (RNG.standard_normal((2, jm.mimi.config.seanet.dimension, 70))).astype(np.float32)
        (want,) = jm.mimi.encoder_transformer.forward(jp["mimi"]["encoder_transformer"], jnp.asarray(x))
        (got,) = tm.mimi.encoder_transformer.forward(tp["mimi"]["encoder_transformer"], torch.from_numpy(x))
    elif part == "downsample":
        x = (RNG.standard_normal((2, jm.mimi.config.seanet.dimension, 48))).astype(np.float32)
        want = jm.mimi.downsample.forward(jp["mimi"]["downsample"]["conv"]["conv"], jnp.asarray(x))
        got = tm.mimi.downsample.forward(tp["mimi"]["downsample"]["conv"]["conv"], torch.from_numpy(x))
    else:
        x = (RNG.standard_normal((2, 9, jm.flow_lm.speaker_dim))).astype(np.float32)
        want = jm.flow_lm.project_speaker(jp["flow_lm"], jnp.asarray(x))
        got = tm.flow_lm.project_speaker(tp["flow_lm"], torch.from_numpy(x))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_windowed_attention_forward_equals_the_streaming_ring(model):
    """The whole-sequence attention equals the streaming ring fed the same
    sequence in one chunk from position 0 (the window predicate and RoPE
    positions of both forms agree)."""
    layer = model.mimi.encoder_transformer.transformer.layer
    attn, p = layer.self_attn, model.params["mimi"]["encoder_transformer"]["transformer"]["layers"][0]["self_attn"]
    T = 70  # longer than the tiny context (32): the window cuts
    x = torch.from_numpy(RNG.standard_normal((1, T, attn.embed_dim)).astype(np.float32))
    state = attn.init_state(1, attn.context + T)
    positions = torch.arange(T, dtype=torch.int32)[None]
    streamed = attn(p, x, state, positions, 0, rope_angles(positions, attn.head_dim, attn.max_period))
    np.testing.assert_allclose(attn.forward(p, x).numpy(), streamed.numpy(), rtol=0, atol=1e-5)


def test_encode_exact_length_matches_jax_bucketed_encode(pair):
    """The port encodes at the exact length; JAX pads to a power-of-2 frame
    bucket and keeps the valid frames. Both give the same conditioning."""
    jm, tm = pair
    frame = tm.frame_size
    for t in (5 * frame + 311, 3 * frame, 7):
        wav = (RNG.standard_normal((1, 1, t)) * 0.1).astype(np.float32)
        want = np.asarray(jm._encode_audio(wav))
        got = tm._encode_audio(wav)
        assert tuple(got.shape) == want.shape == (1, -(-t // frame), tm.flow_lm.dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _assert_states_close(got, want):
    assert got.pos == list(want.pos) and got.written == want.written
    gl, wl = got.tree["transformer"]["layers"], want.tree["transformer"]["layers"]
    sp = np.asarray(wl[0]["slot_pos"])
    np.testing.assert_array_equal(gl[0]["slot_pos"].numpy(), sp)
    rows = sp[0] >= 0
    for g, w in zip(gl, wl):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == tuple(w[name].shape)
            np.testing.assert_allclose(g[name].numpy()[:, rows], np.asarray(w[name])[:, rows], rtol=0, atol=ATOL)


def test_state_from_wav_matches_jax(pair, tmp_path):
    jm, tm = pair
    path = _write_wav(tmp_path / "speaker.wav", seconds=0.7, rate=22050)
    _assert_states_close(tm.get_state_for_audio_prompt(path), jm.get_state_for_audio_prompt(path))


def test_clone_from_wav_and_generate(model, tmp_path):
    path = _write_wav(tmp_path / "speaker.wav", seconds=1.2, rate=16000)
    state = model.get_state_for_audio_prompt(path)
    # 1.2 s -> ~15 latent frames at 12.5 Hz (+1 from replicate-padded resampler)
    assert 14 <= state.pos[0] <= 17
    audio = model.generate_audio(state, "Cloned voice says hello world.", frames_after_eos=2)
    assert audio.shape[0] % 1920 == 0 and audio.shape[0] > 0
    assert np.isfinite(audio).all()


def test_clone_truncates_long_audio(model, tmp_path):
    # 35 s at 4 kHz keeps the test fast; truncate=True caps at 30 s.
    rate = 4000
    t = np.arange(int(35 * rate)) / rate
    wav = (0.2 * np.sin(2 * np.pi * 110 * t)).astype(np.float32)
    path = tmp_path / "long.wav"
    audio_write(path, wav, rate)
    state = model.get_state_for_audio_prompt(path, truncate=True)
    # 30 s at 12.5 Hz ~ 375 frames
    assert state.pos[0] <= 380


def test_clone_from_array(model):
    wav = RNG.standard_normal((1, 24000)).astype(np.float32) * 0.1
    state = model.get_state_for_audio_prompt(wav)
    assert state.pos[0] >= 12
    # [T] and a tensor are the same voice as [1, T].
    for same in (wav[0], torch.from_numpy(wav)):
        other = model.get_state_for_audio_prompt(same)
        assert other.pos == state.pos
        assert torch.equal(other.tree["transformer"]["layers"][0]["k"], state.tree["transformer"]["layers"][0]["k"])


def test_clone_refused_without_voice_cloning_weights(model, tmp_path):
    path = _write_wav(tmp_path / "x.wav")
    model.has_voice_cloning = False
    try:
        with pytest.raises(ValueError, match="voice cloning") as err:
            model.get_state_for_audio_prompt(path)
        assert str(err.value) == VOICE_CLONING_UNSUPPORTED
        with pytest.raises(ValueError, match="voice cloning"):
            model.get_state_for_audio_prompt(str(path))
        # A waveform array is not refused, as in the JAX package.
        model.get_state_for_audio_prompt(np.zeros(4000, np.float32))
    finally:
        model.has_voice_cloning = True


def test_local_uri_and_the_two_entry_cache(model, tmp_path):
    """A voice file named by a string clones like its Path; the cache holds
    the last two (voice, truncate) keys and evicts the oldest."""
    paths = [_write_wav(tmp_path / f"v{i}.wav", seconds=0.3 + 0.1 * i) for i in range(3)]
    by_path = model.get_state_for_audio_prompt(paths[0])
    by_str = model.get_state_for_audio_prompt(str(paths[0]))
    assert by_str.pos == by_path.pos
    assert torch.equal(by_str.tree["transformer"]["layers"][0]["k"], by_path.tree["transformer"]["layers"][0]["k"])
    first = model._cached_get_state_for_audio_prompt(str(paths[0]))
    assert model._cached_get_state_for_audio_prompt(str(paths[0])) is first
    model._cached_get_state_for_audio_prompt(str(paths[1]))
    model._cached_get_state_for_audio_prompt(str(paths[2]))
    assert list(model._voice_state_cache) == [(str(paths[1]), False), (str(paths[2]), False)]
    assert model._cached_get_state_for_audio_prompt(str(paths[0])) is not first
    with pytest.raises(FileNotFoundError):
        model.get_state_for_audio_prompt(str(tmp_path / "missing.wav"))
