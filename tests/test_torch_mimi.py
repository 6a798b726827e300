"""Mimi decode of the port against the JAX package (tiny config, CPU):
quantize + decode_from_latent, streamed in chunks, on the same weights.

Tolerance: float32 end to end; XLA and PyTorch sum convolutions and matmuls
in another order, and the SEANet chain compounds that over ~20 layers, so
waveform samples (|x| ~ 1e-2) agree to 1e-5 absolute. The bf16 serving
form rounds activations at the same points in both (one bf16 ulp relative
to the waveform scale bounds a flipped rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu_torch.config.schema import MimiConfig
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.weights import cast_serving_dtype, params_from_jax
from tiny_config import TINY, tiny_config


@pytest.fixture(scope="module")
def models():
    jm = JMimi(config=tiny_config().mimi)
    jp = jm.init_params(jax.random.PRNGKey(3))
    return jm, jp, MimiModel(MimiConfig(**TINY["mimi"]))


@pytest.mark.parametrize("serving", ["float32", "bfloat16"])
def test_decode_from_latent_streamed_matches_jax(models, serving):
    jm, jp, tm = models
    if serving == "bfloat16":
        jp = jax_cast({"mimi": jp}, jnp.bfloat16)["mimi"]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    dtype_j = jnp.bfloat16 if serving == "bfloat16" else jnp.float32
    dtype_t = torch.bfloat16 if serving == "bfloat16" else torch.float32
    sj = jm.init_decode_state(1, kv_dtype=dtype_j, max_chunk_frames=3)
    st = tm.init_decode_state(1, kv_dtype=dtype_t, max_chunk_frames=3)
    rng = np.random.default_rng(5)
    q_dim = TINY["mimi"]["quantizer"]["dimension"]
    decode_j = jax.jit(lambda p, lat, s: jm.decode_from_latent(p, jm.quantize(p, lat), s))
    outs_j, outs_t = [], []
    for frames in (1, 3, 3, 1):
        lat = rng.standard_normal((1, q_dim, frames)).astype(np.float32)
        wj, sj = decode_j(jp, jnp.asarray(lat), sj)
        wt, st = tm.decode_from_latent(tp, tm.quantize(tp, torch.from_numpy(lat)), st)
        assert wt.dtype == torch.float32 and tuple(wt.shape) == (1, 1, frames * tm.frame_size)
        outs_j.append(np.asarray(wj, np.float32))
        outs_t.append(wt.numpy())
    ref, got = np.concatenate(outs_j, -1), np.concatenate(outs_t, -1)
    scale = np.abs(ref).max()
    atol = 1e-5 if serving == "float32" else 2.0**-8 * scale * 4
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert st["pos"] == int(sj["pos"][0])


def test_streamed_chunks_equal_one_chunk(models):
    """Chunk invariance of the port's streaming decode."""
    jm, jp, tm = models
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(6)
    lat = torch.from_numpy(rng.standard_normal((1, TINY["mimi"]["quantizer"]["dimension"], 6)).astype(np.float32))
    whole, _ = tm.decode_from_latent(tp, tm.quantize(tp, lat), tm.init_decode_state(1, max_chunk_frames=6))
    st = tm.init_decode_state(1, max_chunk_frames=6)
    parts = []
    for lo, hi in ((0, 1), (1, 3), (3, 6)):
        w, st = tm.decode_from_latent(tp, tm.quantize(tp, lat[:, :, lo:hi]), st)
        parts.append(w)
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), whole.numpy(), atol=1e-6)
