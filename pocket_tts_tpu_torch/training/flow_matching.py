"""Flow-matching training for FlowLM, the fine-tuning utility
(port of pocket_tts_tpu/training/flow_matching.py).

Objective: teacher-forced backbone conditioning c_i for each latent frame i
(causal transformer over [text ⊕ BOS-shifted latents]), then
    x_tau = (1 - tau) * eps + tau * z_i,   eps ~ N(0, I), tau ~ U(0, 1)
    t ~ U(tau, 1)
    L = ||v(x_tau; s=tau, t=t, c_i) - (z_i - eps)||^2  (+ BCE on the EOS head)
On the straight conditional path the average velocity over any interval
[tau, t] equals z - eps, so supervising random (s, t) intervals with that
constant target covers the endpoint pairs the inference solver queries
(ops/sampling.lsd_decode).

JAX threefry cannot be reproduced in torch, so the loss draws tau, the
uniform U of t = tau + (1 - tau) U and eps from a torch.Generator on the
parameters' device (`flow_noise`), or takes them as `noise`, as
FlowLMModel.decode_step takes its flow noise.

The step runs in float32 wherever the params live, with torch.optim over
the params tree's leaves; it reads nothing back to the host, so the host
never waits on the card within a step.

On a mesh (a FlowLMModel built with `mesh`, whose params are this rank's
shards) every rank takes the whole batch and the same rng, as the JAX
package's single controller does: the step draws the whole batch's noise,
trains on its dp slice of the streams (the tp-sharded leaves take their
gradients through parallel/collectives' copy_to_tp and reduce_from_tp),
averages every leaf's gradient and the metrics over dp, and AdamW updates
the rank's shards in place. The sharded step is the unsharded one.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.weights import map_tensors, named_leaves
from pocket_tts_tpu_torch.ops.linear import linear
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.parallel.collectives import mean_over_dp
from pocket_tts_tpu_torch.parallel.mesh import dp_range

Optimizer = Callable[[list], torch.optim.Optimizer]  # params' leaves -> optimizer over them


class TrainState(NamedTuple):
    params: dict  # float32 leaves that require grad (on a mesh: this rank's shards)
    optimizer: torch.optim.Optimizer  # over the leaves of params, in named_leaves order
    step: int
    mesh: Optional[object] = None  # the model's parallel.mesh.Mesh, or None


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Optimizer:
    """AdamW with optax.adamw's defaults (torch.optim.AdamW's weight decay
    would be 0.01), decaying every leaf. The update is optax's:
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def flow_noise(rng: torch.Generator, B: int, Tl: int, ldim: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tau [B, Tl, 1], U [B, Tl, 1], eps [B, Tl, ldim]), float32, drawn
    from rng on its device: tau and U uniform in [0, 1), eps standard
    normal."""
    kw = {"generator": rng, "device": rng.device, "dtype": torch.float32}
    return torch.rand((B, Tl, 1), **kw), torch.rand((B, Tl, 1), **kw), torch.randn((B, Tl, ldim), **kw)


def _backbone_conditioning(
    flow_lm: FlowLMModel,
    params: dict,
    text_emb: torch.Tensor,  # [B, Tt, dim]
    latents: torch.Tensor,  # [B, Tl, ldim] ground-truth acoustic latents
) -> torch.Tensor:
    """Teacher-forced conditioning vectors for each latent frame [B, Tl, dim]."""
    B, Tl, _ = latents.shape
    bos = params["bos_emb"][None, None, :].expand(B, 1, flow_lm.ldim).to(latents.dtype)
    shifted = torch.cat([bos, latents[:, :-1]], dim=1)
    latent_emb = linear(shifted, params["input_linear"]["weight"])
    x = torch.cat([text_emb, latent_emb], dim=1)
    h = flow_lm.transformer.forward(params["transformer"], x)
    h = layer_norm(h, params["out_norm"]["weight"], params["out_norm"]["bias"], eps=1e-5)
    return h[:, -Tl:].float()


def flow_matching_loss(
    flow_lm: FlowLMModel,
    params: dict,
    rng: Optional[torch.Generator],
    tokens: torch.Tensor,  # [B, Tt] int text tokens
    latents: torch.Tensor,  # [B, Tl, ldim]
    eos_labels: Optional[torch.Tensor] = None,  # [B, Tl] float {0, 1}
    eos_weight: float = 1.0,
    noise: Optional[tuple] = None,  # (tau, U, eps) as flow_noise gives them; rng then unused
) -> tuple[torch.Tensor, dict]:
    """CFM MSE (+ eos_weight x the EOS BCE) over all latent frames ->
    (loss, {"mse", "eos_bce" with labels, "loss"}), 0-d tensors."""
    B, Tl, ldim = latents.shape
    if noise is None:
        if rng is None:
            raise ValueError("flow_matching_loss needs a torch.Generator or the noise (tau, U, eps)")
        noise = flow_noise(rng, B, Tl, ldim)
    tau, u, eps = noise
    text_emb = flow_lm.embed_text(params, tokens)
    cond = _backbone_conditioning(flow_lm, params, text_emb, latents)  # [B, Tl, dim]

    t_end = tau + (1.0 - tau) * u
    z = latents.float()
    x_tau = (1.0 - tau) * eps + tau * z
    v_target = z - eps

    def flat(a):
        return a.reshape(B * Tl, *a.shape[2:])

    v_pred = flow_lm.flow_net(params["flow_net"], flat(cond), flat(tau), flat(t_end), flat(x_tau)).reshape(B, Tl, ldim)
    mse = torch.mean(torch.square(v_pred - v_target))
    metrics = {"mse": mse}
    loss = mse
    if eos_labels is not None:
        eos_logits = linear(cond, params["out_eos"]["weight"], params["out_eos"]["bias"])[..., 0]
        bce = F.binary_cross_entropy_with_logits(eos_logits, eos_labels.float())
        metrics["eos_bce"] = bce
        loss = loss + eos_weight * bce
    metrics["loss"] = loss
    return loss, {name: value.detach() for name, value in metrics.items()}


def make_train_step(flow_lm: FlowLMModel):
    """A train step (state, rng, tokens, latents, eos_labels=None, noise=None)
    -> (state, metrics): zero the gradients, the loss, backward, one
    optimizer step over the state's params (in place), step + 1. The
    metrics are 0-d tensors on the params' device. On a mesh the inputs
    and the noise are the whole batch's, and the metrics are too."""
    mesh = flow_lm.mesh

    def train_step(state: TrainState, rng, tokens, latents, eos_labels=None, noise=None):
        if mesh is not None:
            B, Tl, ldim = latents.shape
            if noise is None and rng is not None:
                noise = flow_noise(rng, B, Tl, ldim)  # the whole batch's draw, as unsharded
            lo, hi = dp_range(mesh, B)
            tokens, latents = tokens[lo:hi], latents[lo:hi]
            eos_labels = None if eos_labels is None else eos_labels[lo:hi]
            noise = None if noise is None else tuple(t[lo:hi] for t in noise)
        state.optimizer.zero_grad(set_to_none=False)
        loss, metrics = flow_matching_loss(flow_lm, state.params, rng, tokens, latents, eos_labels, noise=noise)
        loss.backward()
        if mesh is not None:  # the mean over dp slices of equal size is the whole batch's
            mean_over_dp(mesh, [leaf.grad for _, leaf in named_leaves(state.params)])
            mean_over_dp(mesh, list(metrics.values()))
        state.optimizer.step()
        return TrainState(state.params, state.optimizer, state.step + 1, state.mesh), metrics

    return train_step


def init_train_state(flow_lm: FlowLMModel, params: dict, optimizer: Optimizer) -> TrainState:
    """A state at step 0 over float32 copies of params's leaves. Each leaf
    starts with a zero gradient that the steps keep (zero_grad without
    set_to_none), so every leaf takes every optimizer step, as in optax: a
    leaf the loss does not reach still decays."""
    params = map_tensors(params, lambda t: t.detach().to(torch.float32, copy=True).requires_grad_())
    leaves = [leaf for _, leaf in named_leaves(params)]
    for leaf in leaves:
        leaf.grad = torch.zeros_like(leaf)
    return TrainState(params, optimizer(leaves), 0, getattr(flow_lm, "mesh", None))
