"""The port's fine-tuning path (pocket_tts_tpu_torch/training) against the
JAX package's, tiny config on the CPU, JAX params carried across by
params_from_jax.

JAX threefry cannot be reproduced in torch, so the JAX rng is split as the
JAX loss splits it and the same tau, U and eps go to the port as `noise`.
Both sides then compute the same float32 function and differ by summation
order alone: forward outputs within 1e-5, the loss within rel 1e-5, each
gradient leaf within atol 1e-5 + rtol 1e-4. AdamW is compared on the same
gradients (within 1e-6 after 3 steps): whole train steps are not compared
leaf by leaf, because Adam turns a near-zero gradient whose sign differs by
rounding into a full +-lr step. The four tests after that port
tests/test_training.py; the last two add a template of another shape and
the train state's layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.training.flow_matching import flow_matching_loss as jax_loss
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.weights import named_leaves, params_from_jax
from pocket_tts_tpu_torch.training import (
    TrainState,
    adamw,
    flow_matching_loss,
    init_train_state,
    make_train_step,
    restore_train_state,
    save_train_state,
)
from tiny_config import TINY, tiny_config

RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    jfl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    jp = jfl.init_params(jax.random.PRNGKey(0))
    tfl = FlowLMModel(TConfig(**TINY).flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jfl, jp, tfl, tp


def _batch(ldim, B=2, Tt=6, Tl=5):
    tokens = RNG.integers(0, 4000, (B, Tt)).astype(np.int32)
    latents = RNG.standard_normal((B, Tl, ldim)).astype(np.float32)
    eos = np.zeros((B, Tl), np.float32)
    eos[:, -1] = 1.0
    return tokens, latents, eos


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, f"{path}.{i}")
    else:
        yield path, np.asarray(tree)


def _jax_noise(rng, B, Tl, ldim):
    """tau, U and eps as jax flow_matching_loss draws them from rng."""
    k_tau, k_t, k_eps = jax.random.split(rng, 3)
    return (jax.random.uniform(k_tau, (B, Tl, 1), dtype=jnp.float32),
            jax.random.uniform(k_t, (B, Tl, 1), dtype=jnp.float32),
            jax.random.normal(k_eps, (B, Tl, ldim), dtype=jnp.float32))


@pytest.mark.parametrize("what", ["attention", "transformer"])
def test_causal_forward_matches_jax(setup, what):
    jfl, jp, tfl, tp = setup
    x = (RNG.standard_normal((2, 11, jfl.dim)) * 0.5).astype(np.float32)
    if what == "attention":
        jattn, tattn = jfl.transformer.layers[0].self_attn, tfl.transformer.layer.self_attn
        ref = jattn.forward(jp["transformer"]["layers"][0]["self_attn"], jnp.asarray(x))
        got = tattn.forward(tp["transformer"]["layers"][0]["self_attn"], torch.from_numpy(x))
    else:
        ref = jfl.transformer.forward(jp["transformer"], jnp.asarray(x))
        got = tfl.transformer.forward(tp["transformer"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_eos", [True, False])
def test_loss_matches_jax(setup, with_eos):
    jfl, jp, tfl, tp = setup
    tokens, latents, eos = _batch(jfl.ldim)
    rng = jax.random.PRNGKey(7)
    loss, metrics = jax_loss(jfl, jp, rng, jnp.asarray(tokens), jnp.asarray(latents),
                             jnp.asarray(eos) if with_eos else None)
    noise = _torch(*_jax_noise(rng, *latents.shape))
    tloss, tmetrics = flow_matching_loss(tfl, tp, None, *_torch(tokens, latents),
                                         torch.from_numpy(eos) if with_eos else None, noise=tuple(noise))
    assert sorted(tmetrics) == sorted(metrics)
    for name in metrics:
        assert tmetrics[name].shape == () and not tmetrics[name].requires_grad
        np.testing.assert_allclose(float(tmetrics[name]), float(metrics[name]), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)


def test_gradients_match_jax(setup):
    jfl, jp, tfl, tp = setup
    tokens, latents, eos = _batch(jfl.ldim)
    rng = jax.random.PRNGKey(11)
    grads = jax.grad(lambda p: jax_loss(jfl, p, rng, jnp.asarray(tokens), jnp.asarray(latents),
                                        jnp.asarray(eos))[0])(jp)
    state = init_train_state(tfl, tp, adamw(1e-3))
    loss, _ = flow_matching_loss(tfl, state.params, None, *_torch(tokens, latents, eos),
                                 noise=tuple(_torch(*_jax_noise(rng, *latents.shape))))
    loss.backward()
    port = dict(named_leaves(state.params))
    ref = dict(_jax_leaves(grads))
    assert sorted(port) == sorted(ref)
    for path, g in ref.items():
        np.testing.assert_allclose(port[path].grad.numpy(), g, rtol=1e-4, atol=1e-5, err_msg=path)
    assert np.abs(ref["conditioner.embed.weight"]).max() > 0  # the comparison covers live gradients


def test_adamw_matches_optax_on_the_same_gradients(setup):
    _, jp, _, _ = setup
    params = {"flow_net": jax.tree_util.tree_map(np.asarray, jp["flow_net"]), "bos_emb": np.asarray(jp["bos_emb"])}
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), params)
             for _ in range(3)]
    grads[1]["bos_emb"] = np.zeros_like(grads[1]["bos_emb"])  # a step where a leaf gets no gradient
    opt = optax.adamw(1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = opt.init(jparams)
    state = init_train_state(None, params_from_jax(params), adamw(1e-3))
    for g in grads:
        updates, opt_state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grad = dict(named_leaves(params_from_jax(g)))  # jax tree_map sorts dict keys: match by path
        for path, leaf in named_leaves(state.params):
            leaf.grad.copy_(grad[path])
        state.optimizer.step()
    for path, ref in _jax_leaves(jparams):
        np.testing.assert_allclose(dict(named_leaves(state.params))[path].detach().numpy(), ref, rtol=0,
                                   atol=1e-6, err_msg=path)


# ---------------------------------------------------------------- ports of tests/test_training.py


def test_loss_finite_and_composed(setup):
    _, _, tfl, tp = setup
    tokens, latents, eos = _torch(*_batch(tfl.ldim))
    loss, metrics = flow_matching_loss(tfl, tp, torch.Generator().manual_seed(1), tokens, latents, eos)
    assert np.isfinite(float(loss))
    assert float(metrics["loss"]) == pytest.approx(float(metrics["mse"]) + float(metrics["eos_bce"]), rel=1e-5)


def test_train_step_descends(setup):
    _, _, tfl, tp = setup
    state = init_train_state(tfl, tp, adamw(1e-3))
    step = make_train_step(tfl)
    tokens, latents, eos = _torch(*_batch(tfl.ldim, B=4))
    rng = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(12):
        state, metrics = step(state, rng, tokens, latents, eos)
        losses.append(float(metrics["loss"]))
    assert state.step == 12
    # Overfitting a fixed tiny batch must reduce the loss substantially.
    assert losses[-1] < losses[0] * 0.9, losses


def test_gradients_reach_all_components(setup):
    _, _, tfl, tp = setup
    state = init_train_state(tfl, tp, adamw(1e-3))
    tokens, latents, eos = _torch(*_batch(tfl.ldim))
    loss, _ = flow_matching_loss(tfl, state.params, torch.Generator().manual_seed(3), tokens, latents, eos)
    loss.backward()
    grads = dict(named_leaves(state.params))
    for path in ("flow_net.input_proj.weight", "transformer.layers.0.linear1.weight", "input_linear.weight",
                 "out_eos.weight", "conditioner.embed.weight"):
        assert float(grads[path].grad.abs().max()) > 0.0, path


def test_checkpoint_roundtrip(setup, tmp_path):
    _, _, tfl, tp = setup
    state = init_train_state(tfl, tp, adamw(1e-3))
    step = make_train_step(tfl)
    tokens, latents, eos = _torch(*_batch(tfl.ldim))
    state, _ = step(state, torch.Generator().manual_seed(0), tokens, latents, eos)

    path = tmp_path / "ckpt" / "state.pt"
    save_train_state(state, path)
    assert [p.name for p in path.parent.iterdir()] == ["state.pt"]  # the temporary file was moved into place
    restored = restore_train_state(path, init_train_state(tfl, tp, adamw(1e-3)))
    assert restored.step == 1
    for (pa, a), (pb, b) in zip(named_leaves(state.params), named_leaves(restored.params)):
        assert pa == pb
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    saved_opt, got_opt = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert saved_opt.keys() == got_opt.keys()
    for i in saved_opt:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got_opt[i][name], saved_opt[i][name], rtol=0, atol=0)

    # training continues from the restored state, with every leaf in the optimizer
    restored, metrics = step(restored, torch.Generator().manual_seed(1), tokens, latents, eos)
    assert restored.step == 2
    assert np.isfinite(float(metrics["loss"]))
    assert all(int(s["step"]) == 2 for s in restored.optimizer.state_dict()["state"].values())


def test_restore_refuses_a_template_of_another_shape(setup, tmp_path):
    _, _, tfl, tp = setup
    path = tmp_path / "state.pt"
    save_train_state(init_train_state(tfl, tp, adamw(1e-3)), path)
    wrong = dict(tp, input_linear={"weight": torch.zeros(tfl.dim, tfl.ldim + 1)})
    with pytest.raises(ValueError, match="input_linear.weight"):
        restore_train_state(path, init_train_state(tfl, wrong, adamw(1e-3)))
    missing = {k: v for k, v in tp.items() if k != "bos_emb"}
    with pytest.raises(ValueError, match="bos_emb"):
        restore_train_state(path, init_train_state(tfl, missing, adamw(1e-3)))


def test_train_state_holds_float32_leaves_with_gradients(setup):
    """init_train_state copies the params (the caller's tree is untouched)
    into float32 leaves that require grad, each with a zero gradient, and
    puts every leaf in the optimizer, whose defaults are optax's."""
    _, _, tfl, tp = setup
    bf16 = {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v for k, v in tp.items()}
    state = init_train_state(tfl, bf16, adamw(1e-3))
    assert isinstance(state, TrainState) and state.step == 0
    leaves = [leaf for _, leaf in named_leaves(state.params)]
    assert all(l.dtype == torch.float32 and l.requires_grad and not l.grad.any() for l in leaves)
    assert bf16["bos_emb"].dtype == torch.bfloat16 and not bf16["bos_emb"].requires_grad
    group = state.optimizer.param_groups[0]
    assert len(group["params"]) == len(leaves)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)
