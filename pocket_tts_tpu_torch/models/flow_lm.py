"""FlowLM, the autoregressive latent language model
(port of pocket_tts_tpu/models/flow_lm.py; reference:
pocket_tts_mlx/models/flow_lm.py:31-142).

  - prefill():     run the backbone over conditioning embeddings (voice
                   prompt or text tokens) to fill the KV cache;
  - decode_step(): embed the previous latent (or BOS), run the backbone at
                   one position, read the EOS logit, integrate the
                   flow-matching ODE from the given noise.

State is {"transformer": {"layers": [{"k", "v", "slot_pos"}], "widx": int},
"pos": [int per stream]}: the slot-major caches and the one `slot_pos`
tensor all layers share live on the device and update in place; the write
index and the stream positions are host integers. An int8 cache adds
per-layer `k_scale` / `v_scale` [B, C], moved like `slot_pos`. Int8 models
carry packed kernel weights under params["fused_backbone"] (and
"fused_flow"), and B=1 decode steps over a bf16 cache of a capacity the
kernel takes then run ops/fused_backbone.fused_backbone_step; batch steps
(B > 1) attend through ops/batch_attention.batch_decode_attention.

On a mesh (`mesh`, parallel/mesh.py) the backbone runs this rank's heads and
feed-forward units, its caches hold those heads, and the state holds this
rank's streams; the B=1 kernels, which take the whole weights, stay off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from pocket_tts_tpu_torch.config.schema import FlowLMConfig
from pocket_tts_tpu_torch.ops.adaln import SimpleMLPAdaLN
from pocket_tts_tpu_torch.ops.attention import _uniform
from pocket_tts_tpu_torch.ops.fused_backbone import capacity_ok, fused_backbone_step
from pocket_tts_tpu_torch.ops.linear import linear
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.sampling import lsd_decode
from pocket_tts_tpu_torch.ops.transformer import StreamingTransformer
from pocket_tts_tpu_torch.parallel.mesh import Mesh
from pocket_tts_tpu_torch.utils.transfer import host_to_device

Params = dict
State = dict


@dataclass(frozen=True)
class FlowLMModel:
    """Static description of FlowLM; params/state are explicit dicts."""

    config: FlowLMConfig
    latent_dim: int
    speaker_dim: int = 512
    mesh: Optional[Mesh] = None

    @property
    def dim(self) -> int:
        return self.config.transformer.d_model

    @property
    def ldim(self) -> int:
        return self.latent_dim

    @property
    def n_bins(self) -> int:
        return self.config.lookup_table.n_bins

    @property
    def transformer(self) -> StreamingTransformer:
        t = self.config.transformer
        return StreamingTransformer(
            d_model=t.d_model,
            num_heads=t.num_heads,
            num_layers=t.num_layers,
            dim_feedforward=int(t.d_model * t.hidden_scale),
            max_period=float(t.max_period),
            kind="flow_lm",
            mesh=self.mesh,
        )

    @property
    def flow_net(self) -> SimpleMLPAdaLN:
        return SimpleMLPAdaLN(
            in_channels=self.latent_dim,
            model_channels=self.config.flow.dim,
            out_channels=self.latent_dim,
            cond_channels=self.dim,
            num_res_blocks=self.config.flow.depth,
        )

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        dim, ldim = self.dim, self.ldim
        return {
            "conditioner": {
                "embed": {"weight": (torch.randn(self.n_bins + 1, dim, generator=gen) * 0.02).to(dtype)}
            },
            "flow_net": self.flow_net.init_params(gen, dtype),
            "transformer": self.transformer.init_params(gen, dtype),
            "input_linear": {"weight": _uniform(gen, (dim, ldim), 1 / math.sqrt(ldim), dtype)},
            "out_norm": {"weight": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)},
            "out_eos": {
                "weight": _uniform(gen, (1, dim), 1 / math.sqrt(dim), dtype),
                "bias": torch.zeros(1, dtype=dtype),
            },
            "bos_emb": torch.randn(ldim, generator=gen).to(dtype),
            "emb_std": torch.ones(ldim, dtype=dtype),
            "emb_mean": torch.zeros(ldim, dtype=dtype),
            "speaker_proj_weight": torch.zeros(dim, self.speaker_dim, dtype=dtype),
        }

    def init_state(self, batch_size: int, capacity: int, dtype=torch.float32, device="cpu") -> State:
        transformer = self.transformer.init_state(batch_size, capacity, dtype, device)
        shared = transformer["layers"][0]["slot_pos"]
        for layer in transformer["layers"]:
            layer["slot_pos"] = shared  # every layer appends in lockstep
        return {"transformer": transformer, "pos": [0] * batch_size}

    def embed_text(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] -> conditioning embeddings [B, T, d_model]."""
        return params["conditioner"]["embed"]["weight"][tokens.long()]

    def project_speaker(self, params: Params, latents: torch.Tensor) -> torch.Tensor:
        """Mimi encoder latents [B, T, speaker_dim] -> conditioning [B, T,
        d_model], in float32 (reference: pocket_tts_mlx/models/tts_model.py:271-276)."""
        return torch.matmul(latents.float(), params["speaker_proj_weight"].float().T)

    def prefill(self, params: Params, state: State, embeddings: torch.Tensor, lengths: list[int]) -> State:
        """Fill the KV cache with right-padded conditioning [B, T, d_model];
        padded positions are -1 and never valid."""
        B, T, _ = embeddings.shape
        offsets = torch.arange(T, dtype=torch.int32)[None, :]
        pos = torch.tensor(state["pos"], dtype=torch.int32)[:, None]
        lens = torch.tensor(lengths, dtype=torch.int32)[:, None]
        positions = torch.where(offsets < lens, pos + offsets, torch.full_like(offsets, -1))
        self.transformer(params["transformer"], embeddings, state["transformer"],
                         host_to_device(positions, embeddings.device))
        state["pos"] = [p + n for p, n in zip(state["pos"], lengths)]
        return state

    def decode_step(
        self,
        params: Params,
        state: State,
        latent: torch.Tensor,  # [B, ldim] previous latent (ignored where is_bos)
        is_bos,  # bool for the whole batch, or bool tensor [B]
        noise: torch.Tensor,  # [B, ldim] flow starting noise (temperature applied)
        lsd_decode_steps: int,
        eos_threshold: float,
        read_limit: Optional[int] = None,
    ) -> tuple[State, torch.Tensor, torch.Tensor]:
        """One autoregressive step -> (state, next_latent [B, ldim], is_eos [B]).

        read_limit bounds the cache rows the attention reads (every valid
        row, this step's included, lies below it)."""
        B = latent.shape[0]
        tstate = state["transformer"]
        layers = tstate["layers"]
        if self.fused_step_ok(params, state, B):
            h, eos_logits = fused_backbone_step(
                params["fused_backbone"], latent.float(), bool(is_bos),
                [l["k"] for l in layers], [l["v"] for l in layers], layers[0]["slot_pos"],
                state["pos"][0], tstate["widx"],
            )
            tstate["widx"] += 1
        else:
            bos = params["bos_emb"][None, :].to(latent.dtype)
            if isinstance(is_bos, torch.Tensor):
                seq = torch.where(is_bos.to(latent.device)[:, None], bos, latent)
            else:
                seq = bos.expand(B, -1) if is_bos else latent
            x = linear(seq[:, None, :], params["input_linear"]["weight"])
            positions = host_to_device(torch.tensor(state["pos"], dtype=torch.int32), latent.device)[:, None]
            h = self.transformer(params["transformer"], x, tstate, positions, read_limit=read_limit)
            h = layer_norm(h, params["out_norm"]["weight"], params["out_norm"]["bias"], eps=1e-5).float()[:, -1]
            eos_logits = linear(h, params["out_eos"]["weight"], params["out_eos"]["bias"])[:, 0]
        state["pos"] = [p + 1 for p in state["pos"]]
        flow, fparams = self.flow_net, params["flow_net"]
        next_latent = lsd_decode(lambda s, t, x: flow(fparams, h, s, t, x), noise, lsd_decode_steps)
        return state, next_latent, eos_logits > eos_threshold

    def fused_step_ok(self, params: Params, state: State, B: int) -> bool:
        """The JAX package's dispatch rule for the per-frame kernel: no mesh
        (the kernel takes the whole weights), B == 1, packed int8 weights, a
        bf16 cache (the kernel carries no int8-KV scales) whose capacity the
        kernel takes (larger caches decode on the plain path, as the JAX
        package's fall back to XLA)."""
        k = state["transformer"]["layers"][0]["k"]
        return (self.mesh is None and "fused_backbone" in params and B == 1 and k.dtype != torch.int8
                and capacity_ok(k.shape[1]))

    # ------------------------------------------------------------------ state utils

    @staticmethod
    def _map_rows(state: State, fn, widx: int) -> State:
        """New state whose every per-row leaf ([B, C, ...]: k, v, the int8
        scales, slot_pos) is fn(name, leaf); the one shared slot_pos is
        mapped once and stays shared."""
        layers = state["transformer"]["layers"]
        slot_pos = fn("slot_pos", layers[0]["slot_pos"])
        new_layers = [
            {name: slot_pos if name == "slot_pos" else fn(name, leaf) for name, leaf in layer.items()}
            for layer in layers
        ]
        return {"transformer": {"layers": new_layers, "widx": widx}, "pos": state["pos"]}

    def expand_state(self, state: State, capacity: int) -> State:
        """Grow KV capacity to `capacity` (k/v and the int8 scales pad with
        zeros, slot_pos with -1)."""
        cur = self.state_capacity(state)
        if cur >= capacity:
            return state
        pad = capacity - cur

        def grow(name, a):
            return torch.cat([a, torch.full((a.shape[0], pad) + tuple(a.shape[2:]), -1 if name == "slot_pos" else 0,
                                            dtype=a.dtype, device=a.device)], dim=1)

        return self._map_rows(state, grow, state["transformer"]["widx"])

    def compact_state(self, state: State, new_written: int) -> State:
        """Gather each stream's valid cache rows (with their int8 scales) to
        the front in position order; `new_written` must bound max(valid
        positions) + 1."""
        sp = state["transformer"]["layers"][0]["slot_pos"]
        order = torch.argsort(torch.where(sp >= 0, sp, torch.full_like(sp, 2**30)), dim=1, stable=True)

        def g(_, a):
            idx = order.reshape(order.shape + (1,) * (a.ndim - 2)).expand(a.shape)
            return torch.gather(a, 1, idx)

        return self._map_rows(state, g, int(new_written))

    def state_capacity(self, state: State) -> int:
        return state["transformer"]["layers"][0]["k"].shape[1]

    def invalidate_after(self, state: State, pos_target: list[int]) -> State:
        """Mark slots at positions >= pos_target[b] invalid (in place) and
        rewind the stream positions to pos_target."""
        sp = state["transformer"]["layers"][0]["slot_pos"]
        target = torch.tensor(pos_target, dtype=sp.dtype, device=sp.device)[:, None]
        sp.masked_fill_(sp >= target, -1)
        state["pos"] = list(pos_target)
        return state
