"""Mimi codec: 32-d latent frames -> 24 kHz waveform, and a waveform ->
512-d latent frames for voice cloning
(port of pocket_tts_tpu/models/mimi.py; reference:
pocket_tts_mlx/models/mimi.py:17-85).

Decode (streaming, explicit state):

    [B, 32, T] --quantizer 1x1 conv--> [B, 512, T]
      --depthwise ConvTranspose stride 16--> [B, 512, 16 T]  (200 Hz)
      --2-layer windowed transformer (ring, context 250)--> [B, 512, 16 T]
      --SEANet decoder (x6, x5, x4 transposed convs)--> [B, 1, 1920 T]

Encode (`encode_to_latent`, non-streaming over the whole prompt): the
waveform, end-padded to whole 1920-sample frames, through the SEANet encoder
(200 Hz), the encoder transformer and the stride-16 downsampling conv
(12.5 Hz).

On a mesh (`mesh`) both transformers run this rank's heads and feed-forward
units (ops/transformer.py), and the decoder's ring buffers hold those heads;
the convolutions run whole on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pocket_tts_tpu_torch.config.schema import MimiConfig
from pocket_tts_tpu_torch.models.seanet import SEANetDecoder, SEANetEncoder
from pocket_tts_tpu_torch.ops.attention import _uniform
from pocket_tts_tpu_torch.ops.conv import StreamingConv1d, StreamingConvTranspose1d, conv1d, pad_for_conv1d
from pocket_tts_tpu_torch.ops.transformer import ProjectedTransformer
from pocket_tts_tpu_torch.parallel.mesh import Mesh

Params = dict
State = dict


@dataclass(frozen=True)
class MimiModel:
    """Static description of the codec; params/state are explicit dicts."""

    config: MimiConfig
    mesh: Mesh | None = None

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def frame_size(self) -> int:
        return int(self.config.sample_rate / self.config.frame_rate)

    def _seanet(self, cls):
        s = self.config.seanet
        return cls(
            channels=s.channels,
            dimension=s.dimension,
            n_filters=s.n_filters,
            n_residual_layers=s.n_residual_layers,
            ratios=tuple(s.ratios),
            kernel_size=s.kernel_size,
            last_kernel_size=s.last_kernel_size,
            residual_kernel_size=s.residual_kernel_size,
            dilation_base=s.dilation_base,
            pad_mode=s.pad_mode,
            compress=s.compress,
        )

    @property
    def encoder(self) -> SEANetEncoder:
        return self._seanet(SEANetEncoder)

    @property
    def decoder(self) -> SEANetDecoder:
        return self._seanet(SEANetDecoder)

    @property
    def encoder_transformer(self) -> ProjectedTransformer:
        return self.decoder_transformer  # the same shape; its own weights

    @property
    def decoder_transformer(self) -> ProjectedTransformer:
        t = self.config.transformer
        return ProjectedTransformer(
            input_dimension=t.input_dimension,
            output_dimensions=tuple(t.output_dimensions),
            d_model=t.d_model,
            num_heads=t.num_heads,
            num_layers=t.num_layers,
            layer_scale=t.layer_scale,
            context=t.context,
            max_period=t.max_period,
            dim_feedforward=t.dim_feedforward,
            mesh=self.mesh,
        )

    @property
    def encoder_frame_rate(self) -> float:
        return self.config.sample_rate / math.prod(self.config.seanet.ratios)

    @property
    def downsample_stride(self) -> int:
        """Encoder frames per latent frame (16 at 200 Hz / 12.5 Hz); the
        upsampler of the decode path has the same stride."""
        stride = self.encoder_frame_rate / self.config.frame_rate
        if stride != int(stride):
            raise ValueError("encoder rate must be an integer multiple of the frame rate")
        return int(stride)

    @property
    def has_resample(self) -> bool:
        return self.downsample_stride != 1

    @property
    def downsample(self) -> StreamingConv1d:
        s = self.downsample_stride
        dim = self.config.seanet.dimension
        return StreamingConv1d(dim, dim, kernel_size=2 * s, stride=s, bias=False, pad_mode="replicate")

    @property
    def upsample(self) -> StreamingConvTranspose1d:
        s = self.downsample_stride
        dim = self.config.seanet.dimension
        return StreamingConvTranspose1d(dim, dim, kernel_size=2 * s, stride=s, groups=dim, bias=False)

    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        q_dim = self.config.quantizer.dimension
        q_out = self.config.quantizer.output_dimension
        params: Params = {
            "decoder": self.decoder.init_params(gen, dtype),
            "decoder_transformer": self.decoder_transformer.init_params(gen, dtype),
            "quantizer": {
                "output_proj": {"weight": _uniform(gen, (q_out, q_dim, 1), 1 / math.sqrt(q_dim), dtype)}
            },
        }
        if self.has_resample:
            params["upsample"] = {"convtr": {"convtr": self.upsample.init_params(gen, dtype)}}
        # The encoder side draws after the decoder side, so a seed gives the
        # decode path the same weights as before the encoder was ported.
        params["encoder"] = self.encoder.init_params(gen, dtype)
        params["encoder_transformer"] = self.encoder_transformer.init_params(gen, dtype)
        if self.has_resample:
            params["downsample"] = {"conv": {"conv": self.downsample.init_params(gen, dtype)}}
        return params

    def init_decode_state(
        self, batch_size: int, kv_dtype=torch.float32, max_chunk_frames: int = 1, device="cpu"
    ) -> State:
        """Streaming decode state; the transformer ring retains a full window
        plus the largest chunk decoded in one call. Conv carries stay float32.
        `pos` is each stream's 200 Hz step count (the serving engine moves
        streams between slots with their own count)."""
        chunk = max(1, max_chunk_frames) * self.downsample_stride
        ring = ((self.config.transformer.context + chunk + 127) // 128 + 1) * 128
        state: State = {
            "decoder_transformer": self.decoder_transformer.init_state(batch_size, ring, kv_dtype, device),
            "decoder": self.decoder.init_state(batch_size, torch.float32, device),
            "pos": torch.zeros(batch_size, dtype=torch.int32, device=device),
        }
        if self.has_resample:
            state["upsample"] = self.upsample.init_state(batch_size, torch.float32, device)
        return state

    def quantize(self, params: Params, latent: torch.Tensor) -> torch.Tensor:
        """'DummyQuantizer' 1x1 conv [B, 32, T] -> [B, 512, T] in the weight's
        dtype (reference: pocket_tts_mlx/modules/dummy_quantizer.py:7-19)."""
        w = params["quantizer"]["output_proj"]["weight"]
        return conv1d(latent, w, out_dtype=w.dtype)

    def decode_from_latent(self, params: Params, latent: torch.Tensor, state: State):
        """Quantized latent frames [B, 512, T] -> waveform [B, 1, T*frame],
        advancing all streaming state. Activations follow the decoder's
        weight dtype; the waveform is float32."""
        new_state = dict(state)
        emb = latent.to(params["decoder"]["model"][0]["conv"]["weight"].dtype)
        if self.has_resample:
            emb, new_state["upsample"] = self.upsample(
                params["upsample"]["convtr"]["convtr"], emb, state["upsample"]
            )
        pos0 = state["pos"]  # [B]
        T = emb.shape[-1]
        positions = pos0[:, None] + torch.arange(T, dtype=torch.int32, device=emb.device)[None, :]
        (emb,) = self.decoder_transformer(
            params["decoder_transformer"], emb, state["decoder_transformer"], positions, pos0
        )
        out, new_state["decoder"] = self.decoder(params["decoder"], emb, state["decoder"])
        new_state["pos"] = pos0 + T
        return out, new_state

    def encode_to_latent(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Waveform [B, C, T] -> latent [B, 512, T'] at the frame rate,
        non-streaming (voice cloning; reference: pocket_tts_mlx/models/mimi.py:77-85).
        T' = ceil(T / frame_size): the waveform is end-padded to whole
        frames."""
        if x.ndim != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        x = pad_for_conv1d(x, self.frame_size, self.frame_size)
        emb = self.encoder.forward(params["encoder"], x)
        (emb,) = self.encoder_transformer.forward(params["encoder_transformer"], emb)
        if self.has_resample:
            emb = self.downsample.forward(params["downsample"]["conv"]["conv"], emb)
        return emb
