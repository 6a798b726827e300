"""The port's model API for export and inspection against the JAX package's,
tiny config on the CPU: save_checkpoint (the file JAX writes from the same
weights, a round trip through load_state_dict and load_model, the refusal
of an int8 model), ModelState.size_bytes and TTSModel.profile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.text import FallbackWordTokenizer as JTokenizer
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import save_checkpoint as jax_save_checkpoint
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.models.weights import (
    cast_serving_dtype,
    load_state_dict,
    named_leaves,
    params_from_jax,
    quantize_int8,
    save_checkpoint,
)
from pocket_tts_tpu_torch.utils.safetensors import load_safetensors
from pocket_tts_tpu_torch.utils.timing import size_of_dict
from tiny_config import TINY, tiny_config

INT8_REFUSAL = "Cannot save an int8-quantized model as a checkpoint"


@pytest.fixture(scope="module")
def jax_params():
    cfg = tiny_config()
    flow_lm = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension,
                      speaker_dim=cfg.mimi.seanet.dimension)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"flow_lm": flow_lm.init_params(k1), "mimi": JMimi(config=cfg.mimi).init_params(k2)}


def _port(jax_params) -> dict:
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _model(params, param_dtype="float32") -> TTSModel:
    return TTSModel.from_params(TConfig(**TINY), params, FallbackWordTokenizer(4000), param_dtype, device="cpu",
                                eos_threshold=1e9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_checkpoint_writes_the_file_jax_writes(jax_params, tmp_path, dtype):
    jp, tp = jax_params, _port(jax_params)
    if dtype == "bfloat16":
        jp, tp = jax_cast(jp, jnp.bfloat16), cast_serving_dtype(tp, torch.bfloat16)
    n_jax = jax_save_checkpoint(jp, tmp_path / "jax.safetensors")
    n_port = save_checkpoint(tp, tmp_path / "port.safetensors")
    ref, got = load_safetensors(tmp_path / "jax.safetensors"), load_safetensors(tmp_path / "port.safetensors")
    assert n_port == n_jax == len(ref) and sorted(got) == sorted(ref)
    assert any(".convtr." in k for k in ref) and any(k.endswith("in_proj.weight") for k in ref)
    for key, arr in ref.items():
        assert got[key].dtype == arr.dtype == np.float32 and got[key].shape == arr.shape, key
        assert got[key].tobytes() == arr.tobytes(), key


def test_checkpoint_round_trips_through_load_state_dict(jax_params, tmp_path):
    tp = _port(jax_params)
    path = tmp_path / "weights.safetensors"
    n = save_checkpoint(tp, path)
    cfg = TConfig(**TINY)
    gen = torch.Generator().manual_seed(99)  # other weights, overwritten by the file
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    fresh = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    loaded, skipped = load_state_dict(fresh, load_safetensors(path))
    assert (loaded, skipped) == (n, 0)
    ref = dict(named_leaves(tp))
    for name, leaf in named_leaves(fresh):
        torch.testing.assert_close(leaf, ref[name], rtol=0, atol=0)


def test_exported_model_loads_through_load_model(jax_params, tmp_path):
    """TTSModel.save_checkpoint -> a YAML with that weights_path ->
    TTSModel.load_model gives back the same weights, with voice cloning."""
    model = _model(_port(jax_params))
    path = tmp_path / "weights.safetensors"
    model.save_checkpoint(path)
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump({**TINY, "weights_path": str(path)}))
    loaded = TTSModel.load_model(config, device="cpu")
    assert not loaded.random_init and loaded.has_voice_cloning
    ref = dict(named_leaves(model.params))
    got = dict(named_leaves(loaded.params))
    assert sorted(got) == sorted(ref)
    for name, leaf in got.items():
        torch.testing.assert_close(leaf, ref[name], rtol=0, atol=0)


def test_int8_model_refuses_to_save(jax_params, tmp_path):
    """As the JAX package (tests/test_int8.py:131): quantization is lossy."""
    model = _model(_port(jax_params), "int8")
    with pytest.raises(ValueError, match=INT8_REFUSAL):
        model.save_checkpoint(tmp_path / "int8.safetensors")
    with pytest.raises(ValueError, match=INT8_REFUSAL):
        save_checkpoint(quantize_int8(_port(jax_params)), tmp_path / "int8.safetensors")
    assert not (tmp_path / "int8.safetensors").exists()


def test_state_size_bytes_matches_jax(jax_params):
    """The same voice's state holds the same tensors on both sides, one
    slot_pos per layer as the JAX tree counts it (the port's layers share
    one tensor); JAX keeps the stream positions and the write index as
    int32 device arrays, the port as host ints, which count nothing."""
    cfg = tiny_config()
    jm = JTTSModel(JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension), JMimi(config=cfg.mimi),
                   jax_params, JTokenizer(4000), temp=0.7, lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9,
                   config=cfg)
    tm = _model(_port(jax_params))
    prompt = np.random.default_rng(9).standard_normal((1, 12, TINY["flow_lm"]["transformer"]["d_model"]))
    jv = jm._state_from_prompt(jnp.asarray(prompt, jnp.float32))
    tv = tm._state_from_prompt(torch.from_numpy(prompt.astype(np.float32)))
    host_mirrors = jv.tree["pos"].nbytes + jv.tree["transformer"]["widx"].nbytes
    assert tv.size_bytes() == jv.size_bytes() - host_mirrors > 0
    assert size_of_dict(tv.tree) == tv.size_bytes()
    layers = tm.flow_lm.config.transformer.num_layers
    k = tv.tree["transformer"]["layers"][0]["k"]
    assert tv.size_bytes() == layers * (2 * k.numel() * k.element_size() + 4 * k.shape[1])


def test_profile_writes_a_trace(jax_params, tmp_path):
    model = _model(_port(jax_params))
    voice = model._state_from_prompt(torch.zeros(1, 4, model.flow_lm.dim))
    with model.profile(tmp_path / "trace"):
        audio = model.generate_audio(voice, "One two.")
    assert audio.shape[0] > 0
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "aten::" in traces[0].read_text()  # host operators were recorded
