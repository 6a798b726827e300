"""The port's weight-loading fallback cascade and the voice-asset shape
contract, against a checkpoint written by the JAX package's
save_checkpoint (ports tests/test_weight_fallback.py).

Reference semantics: voice-cloning weights -> without-voice-cloning weights
(has_voice_cloning=False) -> error (pocket_tts_mlx/models/tts_model.py:145-151);
the repo adds a last random-init step for machines without the checkpoint
(allow_random_init). Voice embedding files hold a [1, T, d_model]
'audio_prompt' tensor (pocket_tts_mlx/utils/weight_conversion.py:78-89).
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.weights import save_checkpoint
from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import PREDEFINED_VOICES, TTSModel, _load_weights
from pocket_tts_tpu_torch.models.weights import load_state_dict
from pocket_tts_tpu_torch.utils.safetensors import load_safetensors, save_safetensors
from tiny_config import TINY, tiny_config


def _fresh_params(seed=0) -> dict:
    cfg = Config(**TINY)
    gen = torch.Generator().manual_seed(seed)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension,
                          speaker_dim=cfg.mimi.seanet.dimension)
    return {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}


def _fresh_model(seed=0) -> TTSModel:
    return TTSModel.from_params(Config(**TINY), _fresh_params(seed), FallbackWordTokenizer(4000), "float32",
                                device="cpu", temp=0.7, lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A combined checkpoint written by the JAX package from a
    differently-seeded JAX model (its Mimi encoder side included)."""
    cfg = tiny_config()
    fl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(123))
    params = {"flow_lm": fl.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}
    path = tmp_path_factory.mktemp("ckpt") / "weights.safetensors"
    save_checkpoint(params, path)
    return path, jax.tree_util.tree_map(np.asarray, params)


def _cfg_with(weights_path, without=None) -> Config:
    return Config(**{**TINY, "weights_path": weights_path, "weights_path_without_voice_cloning": without})


def _yaml_with(tmp_path, weights_path, without=None):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({**TINY, "weights_path": weights_path,
                                    "weights_path_without_voice_cloning": without}))
    return path


def test_primary_weights_load(checkpoint):
    path, donor = checkpoint
    params = _fresh_params(seed=0)
    assert _load_weights(params, _cfg_with(str(path)), allow_random_init=False) == (False, True)
    np.testing.assert_allclose(params["flow_lm"]["input_linear"]["weight"].numpy(),
                               donor["flow_lm"]["input_linear"]["weight"], rtol=1e-6)
    # The encoder side loads too: every key of the file has a place in the tree.
    skipped = []
    load_state_dict(_fresh_params(seed=1), load_safetensors(path), skipped_keys=skipped)
    assert skipped == []
    mimi = params["mimi"]
    for got, want in (
        (mimi["encoder"]["model"][0]["conv"]["weight"], donor["mimi"]["encoder"]["model"][0]["conv"]["weight"]),
        (mimi["encoder_transformer"]["transformer"]["layers"][0]["linear1"]["weight"],
         donor["mimi"]["encoder_transformer"]["transformer"]["layers"][0]["linear1"]["weight"]),
        (mimi["downsample"]["conv"]["conv"]["weight"], donor["mimi"]["downsample"]["conv"]["conv"]["weight"]),
    ):
        np.testing.assert_array_equal(got.numpy(), want)


def test_fallback_to_without_voice_cloning(checkpoint, tmp_path):
    path, _ = checkpoint
    params = _fresh_params(seed=0)
    cfg = _cfg_with(str(tmp_path / "missing.safetensors"), without=str(path))
    assert _load_weights(params, cfg, allow_random_init=False) == (False, False)

    # load_model records it, and the voice-cloning API is then refused,
    # mirroring the reference's error path (tts_model.py:490-491 / :44-51).
    model = TTSModel.load_model(_yaml_with(tmp_path, str(tmp_path / "missing.safetensors"), str(path)),
                                device="cpu", allow_random_init=False)
    assert model.has_voice_cloning is False and model.random_init is False
    with pytest.raises(ValueError, match="voice cloning"):
        model.get_state_for_audio_prompt(str(tmp_path / "somebody.wav"))


def test_random_init_degradation(tmp_path):
    params = _fresh_params(seed=0)
    before = params["flow_lm"]["input_linear"]["weight"].clone()
    cfg = _cfg_with(str(tmp_path / "a.safetensors"), without=str(tmp_path / "b.safetensors"))
    assert _load_weights(params, cfg, allow_random_init=True) == (True, False)
    assert torch.equal(params["flow_lm"]["input_linear"]["weight"], before)
    model = TTSModel.load_model(_yaml_with(tmp_path, str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")),
                                device="cpu")
    assert model.random_init is True and model.has_voice_cloning is False


def test_both_missing_raises_without_random_init(tmp_path):
    with pytest.raises(FileNotFoundError):
        _load_weights(_fresh_params(), _cfg_with(str(tmp_path / "a.safetensors"), without=str(tmp_path / "b.safetensors")),
                      allow_random_init=False)


# ------------------------------------------------------------- voice contract

def _voice_file(tmp_path, array):
    path = tmp_path / "voice.safetensors"
    save_safetensors(path, {"audio_prompt": array})
    return str(path)


def test_predefined_voice_fixture_roundtrip(tmp_path, monkeypatch):
    model = _fresh_model()
    T = 9
    prompt = np.random.default_rng(0).standard_normal((1, T, model.flow_lm.dim)).astype(np.float32)
    monkeypatch.setitem(PREDEFINED_VOICES, "testvoice", _voice_file(tmp_path, prompt))
    state = model.get_state_for_audio_prompt("testvoice")
    assert state.batch_size == 1 and state.pos == [T]
    direct = model._state_from_prompt(torch.from_numpy(prompt))
    assert torch.equal(state.tree["transformer"]["layers"][0]["k"], direct.tree["transformer"]["layers"][0]["k"])


def test_voice_shape_contract_rejected(tmp_path, monkeypatch):
    model = _fresh_model()
    bad_rank = np.zeros((5, model.flow_lm.dim), np.float32)
    monkeypatch.setitem(PREDEFINED_VOICES, "badvoice", _voice_file(tmp_path, bad_rank))
    with pytest.raises(ValueError, match="audio_prompt"):
        model.get_state_for_audio_prompt("badvoice")

    bad_dim = np.zeros((1, 5, model.flow_lm.dim + 1), np.float32)
    monkeypatch.setitem(PREDEFINED_VOICES, "badvoice2", _voice_file(tmp_path, bad_dim))
    with pytest.raises(ValueError, match="audio_prompt"):
        model.get_state_for_audio_prompt("badvoice2")

    bad_kind = np.zeros((1, 5, model.flow_lm.dim), np.int32)
    monkeypatch.setitem(PREDEFINED_VOICES, "badvoice3", _voice_file(tmp_path, bad_kind))
    with pytest.raises(ValueError, match="floating point"):
        model.get_state_for_audio_prompt("badvoice3")


def test_missing_audio_prompt_key(tmp_path, monkeypatch):
    model = _fresh_model()
    path = tmp_path / "empty.safetensors"
    save_safetensors(path, {"something_else": np.zeros((1,), np.float32)})
    monkeypatch.setitem(PREDEFINED_VOICES, "keyless", str(path))
    with pytest.raises(KeyError, match="audio_prompt"):
        model.get_state_for_audio_prompt("keyless")
