"""The port's weights bridge against the JAX package: params_from_jax, the
ConvTranspose layout, cast_serving_dtype, quantize_int8 (codes and scales
equal to JAX's) and load_state_dict on a file written by JAX
save_checkpoint (tiny config, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.config.schema import Config as JConfig
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import convtr_weight_to_torch
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu.models.weights import save_checkpoint
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.tts_model import _load_weights
from pocket_tts_tpu_torch.models.weights import (
    cast_serving_dtype,
    load_state_dict,
    params_from_jax,
    quantize_int8,
)
from tiny_config import TINY, tiny_config


@pytest.fixture(scope="module")
def jax_params():
    cfg = tiny_config()
    flow_lm = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension,
                      speaker_dim=cfg.mimi.seanet.dimension)
    mimi = JMimi(config=cfg.mimi)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"flow_lm": flow_lm.init_params(k1), "mimi": mimi.init_params(k2)}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def _get(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def test_params_from_jax_is_exact_and_converts_convtr(jax_params):
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    n_convtr = 0
    for path, leaf in _leaves(jax_params):
        expect = np.asarray(leaf)
        if path.endswith("convtr.weight"):
            cout, cin_per_g, _ = expect.shape
            expect = convtr_weight_to_torch(expect, groups=cout if cin_per_g == 1 else 1)
            n_convtr += 1
        np.testing.assert_array_equal(_get(port, path).numpy(), expect)
    assert n_convtr >= 4  # SEANet decoder upsamplers + the depthwise Mimi upsampler


def test_cast_serving_dtype_matches_jax(jax_params):
    port = cast_serving_dtype(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), torch.bfloat16)
    ref = jax_cast(jax_params, jnp.bfloat16)
    for path, leaf in _leaves(ref):
        got = _get(port, path)
        assert (got.dtype == torch.bfloat16) == (leaf.dtype == jnp.bfloat16), path
        if not path.endswith("convtr.weight"):
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("serving", ["float32", "bfloat16"])
def test_quantize_int8_codes_and_scales_equal_jax(jax_params, serving):
    jp = jax_params if serving == "float32" else jax_cast(jax_params, jnp.bfloat16)
    ref = jax_quantize_int8(jp)
    port = quantize_int8(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    n = 0
    for path, leaf in _leaves(ref["flow_lm"]):
        got = _get(port["flow_lm"], path)
        if path.endswith("weight.q"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
            n += 1
        elif path.endswith("weight.s"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert n == 2 * 4 + 1  # 2 layers x (in_proj, out_proj, linear1, linear2) + input_linear


def test_load_state_dict_reads_a_jax_checkpoint(jax_params, tmp_path):
    path = tmp_path / "tiny.safetensors"
    save_checkpoint(jax_params, path)
    from pocket_tts_tpu_torch.utils.safetensors import load_safetensors

    cfg = TConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    port = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    skipped = []
    loaded, n_skipped = load_state_dict(port, load_safetensors(path), skipped_keys=skipped)
    expect = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    n_leaves = 0
    for p, leaf in _leaves(port):
        np.testing.assert_array_equal(leaf.numpy(), _get(expect, p).numpy())
        n_leaves += 1
    assert loaded == n_leaves
    # Every key has a place in the port's tree, the Mimi encoder side
    # (voice cloning) included.
    assert n_skipped == len(skipped) == 0, skipped
    assert any(p.startswith("mimi.encoder.") for p, _ in _leaves(port))


def test_load_state_dict_renames_and_skips():
    port = {
        "conditioner": {"embed": {"weight": torch.zeros(3, 2)}},
        "speaker_proj_weight": torch.zeros(2, 4),
        "transformer": {"layers": [{"self_attn": {"in_proj": {"weight": torch.zeros(3, 2, 2)}}}]},
    }
    flat = {
        "condition_provider.conditioners.transcript_in_segment.embed.weight": np.ones((3, 2), np.float32),
        "condition_provider.conditioners.speaker_wavs.output_proj.weight": np.ones((2, 4), np.float32),
        "condition_provider.conditioners.transcript_in_segment.learnt_padding": np.ones(2, np.float32),
        "flow.w_s_t.weight": np.ones(2, np.float32),
        "transformer.layers.0.self_attn.in_proj.weight": np.arange(12, dtype=np.float32).reshape(6, 2),
    }
    loaded, skipped = load_state_dict(port, flat)
    assert (loaded, skipped) == (3, 2)
    assert port["conditioner"]["embed"]["weight"].sum() == 6
    assert port["speaker_proj_weight"].sum() == 8
    np.testing.assert_array_equal(
        port["transformer"]["layers"][0]["self_attn"]["in_proj"]["weight"].numpy(),
        np.arange(12, dtype=np.float32).reshape(3, 2, 2),
    )


def test_flow_lm_weights_without_mimi_weights_names_the_missing_key(tmp_path):
    """flow_lm.weights_path set without mimi.weights_path raises the JAX
    package's ValueError, naming the missing key, before any file opens."""
    raw = {**TINY, "flow_lm": {**TINY["flow_lm"], "weights_path": str(tmp_path / "flow_lm.safetensors")}}
    with pytest.raises(ValueError) as jax_error:
        JTTSModel._load_weights(None, JConfig(**raw), None, True)
    with pytest.raises(ValueError, match="mimi.weights_path") as port_error:
        _load_weights({}, TConfig(**raw), allow_random_init=True)
    assert str(port_error.value) == str(jax_error.value)
