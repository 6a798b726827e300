"""The PyTorch port's primitives against their JAX twins on the CPU, at
narrow widths, on the same numpy-seeded inputs and weights.

Tolerances: float32 paths differ only by summation order between XLA and
PyTorch (atol 1e-5 on O(1) values); bf16/int8 paths round at the same points
in both, and a float32 sum-order difference can flip one bf16 rounding
(one bf16 ulp of an O(1) value, 2**-8, bounds those cases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu.ops import adaln as jadaln
from pocket_tts_tpu.ops import attention as jattn
from pocket_tts_tpu.ops import conv as jconv
from pocket_tts_tpu.ops import linear as jlinear
from pocket_tts_tpu.ops import norms as jnorms
from pocket_tts_tpu.ops import rope as jrope
from pocket_tts_tpu.ops import sampling as jsampling
from pocket_tts_tpu.ops import transformer as jtransformer
from pocket_tts_tpu_torch.models.weights import params_from_jax, quantize_int8
from pocket_tts_tpu_torch.ops import adaln, attention, conv, linear, norms, rope, sampling, transformer

F32_TOL = 1e-5
BF16_ULP = 2.0**-8

RNG = np.random.default_rng(1234)


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def jparams(np_tree):
    """numpy tree -> jnp tree (JAX twin's params)."""
    if isinstance(np_tree, dict):
        return {k: jparams(v) for k, v in np_tree.items()}
    if isinstance(np_tree, list):
        return [jparams(v) for v in np_tree]
    return jnp.asarray(np_tree)


def np_tree(jtree):
    if isinstance(jtree, dict):
        return {k: np_tree(v) for k, v in jtree.items()}
    if isinstance(jtree, (list, tuple)):
        return [np_tree(v) for v in jtree]
    return np.asarray(jtree)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_jax(eps):
    x, w, b = randn(3, 5, 48), randn(48), randn(48)
    ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=eps)
    out = norms.layer_norm(t(x), t(w), t(b), eps=eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL)
    ref0 = jnorms.layer_norm(jnp.asarray(x), eps=eps)
    np.testing.assert_allclose(norms.layer_norm(t(x), eps=eps).numpy(), np.asarray(ref0), atol=F32_TOL)


def test_rms_norm_ddof1_matches_jax():
    x, a = randn(4, 32) + 0.5, randn(32)
    ref = jnorms.rms_norm_ddof1(jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_allclose(norms.rms_norm_ddof1(t(x), t(a)).numpy(), np.asarray(ref), atol=F32_TOL)


def test_rope_matches_jax():
    q, k = randn(2, 5, 4, 16), randn(2, 5, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 300]], dtype=np.int32)
    rq, rk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    cache = rope.rope_angles(torch.from_numpy(pos), 16)
    oq, ok = rope.apply_rope(t(q), t(k), cache)
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), atol=1e-4)  # angle up to 300 rad
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), atol=1e-4)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_linear_matches_jax(mode):
    x, w, b = randn(3, 64), randn(48, 64, scale=0.2), randn(48)
    if mode == "int8":
        jw = jax_quantize_int8({"flow_lm": {"transformer": {"weight": jnp.asarray(w)}}}, ("transformer",))
        jw = jw["flow_lm"]["transformer"]["weight"]
        tw = quantize_int8({"flow_lm": {"transformer": {"weight": t(w)}}}, ("transformer",))
        tw = tw["flow_lm"]["transformer"]["weight"]
    elif mode == "bfloat16":
        jw, tw = jnp.asarray(w).astype(jnp.bfloat16), t(w).to(torch.bfloat16)
    else:
        jw, tw = jnp.asarray(w), t(w)
    ref = jlinear.linear(jnp.asarray(x), jw, jnp.asarray(b))
    out = linear.linear(t(x), tw, t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_causal_kv_attention_prefill_holes_and_widx_clamp():
    """Prefill with right padding, decode with invalidated history slots,
    then a decode at a write index past the capacity (clamped to C - 1)."""
    E, H, C = 32, 4, 16
    attn_j = jattn.CausalKVAttention(E, H)
    params_np = {
        "in_proj": {"weight": randn(3, E, E, scale=0.2)},
        "out_proj": {"weight": randn(E, E, scale=0.2)},
    }
    pj, pt = jparams(params_np), params_from_jax(params_np)
    attn_t = attention.CausalKVAttention(E, H)
    sj = attn_j.init_state(1, C)
    st = attn_t.init_state(1, C)

    def step(x, positions, widx):
        nonlocal sj
        xj = jnp.asarray(x)
        pos_j = jnp.asarray(positions)
        rope_j = jrope.rope_angles(jnp.maximum(pos_j, 0), E // H)
        yj, sj = attn_j(pj, xj, sj, pos_j, jnp.int32(widx), rope_cache=rope_j)
        pos_t = torch.from_numpy(positions)
        yt = attn_t(pt, t(x), st, pos_t, widx, rope.rope_angles(pos_t.clamp(min=0), E // H))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=F32_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), atol=F32_TOL)
        np.testing.assert_array_equal(st["slot_pos"].numpy(), np.asarray(sj["slot_pos"]))

    step(randn(1, 6, E), np.array([[0, 1, 2, 3, -1, -1]], np.int32), 0)
    # Holes in the history, in both states alike.
    sj = {**sj, "slot_pos": sj["slot_pos"].at[0, 1].set(-1)}
    st["slot_pos"][0, 1] = -1
    for i in range(3):
        step(randn(1, 1, E), np.array([[4 + i]], np.int32), 6 + i)
    step(randn(1, 1, E), np.array([[7]], np.int32), C + 5)  # widx clamps to C - 1


@pytest.mark.parametrize("chunk", [16, 128])
def test_windowed_ring_attention_matches_jax(chunk):
    """Streamed chunks through the shift-append ring; chunk 128 takes the
    banded (query-block) form on both sides."""
    E, H, ctx = 32, 4, 24
    attn_j = jattn.WindowedRingAttention(E, H, ctx)
    attn_t = attention.WindowedRingAttention(E, H, ctx)
    params_np = {
        "in_proj": {"weight": randn(3, E, E, scale=0.2)},
        "out_proj": {"weight": randn(E, E, scale=0.2)},
    }
    pj, pt = jparams(params_np), params_from_jax(params_np)
    cap = ((ctx + chunk + 127) // 128 + 1) * 128
    sj, st = attn_j.init_state(1, cap), attn_t.init_state(1, cap)
    pos0 = 0
    for _ in range(3):
        x = randn(1, chunk, E)
        positions = (pos0 + np.arange(chunk, dtype=np.int32))[None]
        yj, sj = attn_j(pj, jnp.asarray(x), sj, jnp.asarray(positions),
                        rope_cache=jrope.rope_angles(jnp.asarray(positions), E // H))
        pt_ = torch.from_numpy(positions)
        yt = attn_t(pt, t(x), st, pt_, pos0, rope.rope_angles(pt_, E // H))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
        pos0 += chunk


def _transformer_params(layer_scale):
    E, FF = 32, 64

    def layer():
        p = {
            "self_attn": {
                "in_proj": {"weight": randn(3, E, E, scale=0.2)},
                "out_proj": {"weight": randn(E, E, scale=0.2)},
            },
            "norm1": {"weight": 1 + randn(E, scale=0.1), "bias": randn(E, scale=0.1)},
            "norm2": {"weight": 1 + randn(E, scale=0.1), "bias": randn(E, scale=0.1)},
            "linear1": {"weight": randn(FF, E, scale=0.2)},
            "linear2": {"weight": randn(E, FF, scale=0.2)},
        }
        if layer_scale:
            p["layer_scale_1"] = {"scale": randn(E, scale=0.1)}
            p["layer_scale_2"] = {"scale": randn(E, scale=0.1)}
        return p

    return {"layers": [layer(), layer()]}


def test_flow_lm_transformer_prefill_and_decode_match_jax():
    E, H = 32, 4
    kw = dict(d_model=E, num_heads=H, num_layers=2, dim_feedforward=64, kind="flow_lm")
    tj, tt = jtransformer.StreamingTransformer(**kw), transformer.StreamingTransformer(**kw)
    params_np = _transformer_params(layer_scale=False)
    pj, pt = jparams(params_np), params_from_jax(params_np)
    sj, st = tj.init_state(1, 32), tt.init_state(1, 32)
    for x, positions in (
        (randn(1, 5, E), np.array([[0, 1, 2, 3, 4]], np.int32)),
        (randn(1, 1, E), np.array([[5]], np.int32)),
        (randn(1, 1, E), np.array([[6]], np.int32)),
    ):
        yj, sj = tj(pj, jnp.asarray(x), sj, jnp.asarray(positions))
        yt = tt(pt, t(x), st, torch.from_numpy(positions))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
        assert st["widx"] == int(sj["widx"])


def test_projected_transformer_matches_jax_streamed():
    E = 32
    kw = dict(input_dimension=E, output_dimensions=(E,), d_model=E, num_heads=4, num_layers=2,
              layer_scale=0.01, context=20, max_period=10_000.0, dim_feedforward=64)
    pj_, pt_ = jtransformer.ProjectedTransformer(**kw), transformer.ProjectedTransformer(**kw)
    params_np = {"transformer": _transformer_params(layer_scale=True), "output_projs": [{}]}
    pj, pt = jparams(params_np), params_from_jax(params_np)
    sj, st = pj_.init_state(1, 256), pt_.init_state(1, 256)
    pos0 = 0
    for T in (16, 16, 32):
        x = randn(1, E, T)
        positions = (pos0 + np.arange(T, dtype=np.int32))[None]
        (yj,), sj = pj_(pj, jnp.asarray(x), sj, jnp.asarray(positions))
        (yt,) = pt_(pt, t(x), st, torch.from_numpy(positions), pos0)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
        pos0 += T


def test_simple_mlp_adaln_and_lsd_decode_match_jax():
    import jax

    net_j = jadaln.SimpleMLPAdaLN(8, 32, 8, 16, 2)
    net_t = adaln.SimpleMLPAdaLN(8, 32, 8, 16, 2)
    params_np = np_tree(net_j.init_params(jax.random.PRNGKey(3)))
    pj, pt = jparams(params_np), params_from_jax(params_np)
    c, x0 = randn(2, 16), randn(2, 8)
    for steps in (1, 2):
        ref = jsampling.lsd_decode(lambda s, tt, x: net_j(pj, jnp.asarray(c), s, tt, x), jnp.asarray(x0), steps)
        out = sampling.lsd_decode(lambda s, tt, x: net_t(pt, t(c), s, tt, x), t(x0), steps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_timestep_embedder_matches_jax():
    import jax

    emb_j, emb_t = jadaln.TimestepEmbedder(32), adaln.TimestepEmbedder(32)
    params_np = np_tree(emb_j.init_params(jax.random.PRNGKey(4)))
    tv = np.array([[0.0], [0.5], [1.0]], np.float32)
    ref = emb_j(jparams(params_np), jnp.asarray(tv))
    out = emb_t(params_from_jax(params_np), t(tv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize(
    "kw",
    [
        dict(in_channels=6, out_channels=5, kernel_size=7),
        dict(in_channels=6, out_channels=6, kernel_size=3, dilation=2, pad_mode="replicate"),
        dict(in_channels=6, out_channels=4, kernel_size=8, stride=4, pad_mode="replicate", bias=False),
    ],
)
def test_streaming_conv1d_chunks_match_jax(kw):
    cj, ct = jconv.StreamingConv1d(**kw), conv.StreamingConv1d(**kw)
    params_np = {"weight": randn(kw["out_channels"], kw["in_channels"], kw["kernel_size"], scale=0.3)}
    if kw.get("bias", True):
        params_np["bias"] = randn(kw["out_channels"])
    pj, pt = jparams(params_np), params_from_jax(params_np)
    sj, st = cj.init_state(1), ct.init_state(1)
    stride = kw.get("stride", 1)
    x = randn(1, kw["in_channels"], 12 * stride)
    outs_j, outs_t = [], []
    for lo, hi in ((0, 4), (4, 5), (5, 12)):
        chunk = x[:, :, lo * stride : hi * stride]
        yj, sj = cj(pj, jnp.asarray(chunk), sj)
        yt, st = ct(pt, t(chunk), st)
        outs_j.append(np.asarray(yj))
        outs_t.append(yt.numpy())
    np.testing.assert_allclose(np.concatenate(outs_t, -1), np.concatenate(outs_j, -1), atol=F32_TOL)
    whole_t, _ = ct(pt, t(x), ct.init_state(1))
    np.testing.assert_allclose(np.concatenate(outs_t, -1), whole_t.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("groups", [1, 6])
def test_streaming_conv_transpose1d_chunks_match_jax(groups):
    """Overlap-add across chunks; groups=6 is the depthwise Mimi upsampler
    form. The port keeps torch layout, the JAX twin its converted layout."""
    kw = dict(in_channels=6, out_channels=6, kernel_size=8, stride=4, groups=groups)
    cj, ct = jconv.StreamingConvTranspose1d(**kw), conv.StreamingConvTranspose1d(**kw)
    w_torch = randn(6, 6 // groups, 8, scale=0.3)
    b = randn(6)
    pj = {"weight": jnp.asarray(jconv.convtr_weight_from_torch(w_torch, groups)), "bias": jnp.asarray(b)}
    pt = {"weight": t(w_torch), "bias": t(b)}
    sj, st = cj.init_state(1), ct.init_state(1)
    x = randn(1, 6, 9)
    outs_j, outs_t = [], []
    for lo, hi in ((0, 1), (1, 4), (4, 9)):
        yj, sj = cj(pj, jnp.asarray(x[:, :, lo:hi]), sj)
        yt, st = ct(pt, t(x[:, :, lo:hi]), st)
        outs_j.append(np.asarray(yj))
        outs_t.append(yt.numpy())
    np.testing.assert_allclose(np.concatenate(outs_t, -1), np.concatenate(outs_j, -1), atol=F32_TOL)
    whole_t, _ = ct(pt, t(x), ct.init_state(1))
    np.testing.assert_allclose(np.concatenate(outs_t, -1), whole_t.numpy(), atol=F32_TOL)
