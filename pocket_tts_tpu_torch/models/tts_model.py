"""End-to-end TTS pipeline, single stream: text -> FlowLM decode -> Mimi
(port of the B=1 path of pocket_tts_tpu/models/tts_model.py; reference:
pocket_tts_mlx/models/tts_model.py:54-518).

`load_model`, `get_state_for_audio_prompt`, `generate_audio` and
`generate_audio_stream` keep the JAX package's defaults, text chunking,
segment schedules (streaming ramp 1, 2, 4, ... to 32 frames; bulk 64-frame
segments with a power-of-2 tail), capacity buckets, Mimi warmup, and the
post-EOS rewind. Frames decode in segments (models/generate.run_segment);
the host reads audio and EOS once per streamed segment and once per bulk
utterance.

Offline (no reachable checkpoint) the model starts from seeded random
weights, the hash tokenizer and a synthetic voice prompt, like the JAX
package.
"""

from __future__ import annotations

import copy
import logging
import time
from pathlib import Path
from typing import Generator, Optional, Union

import numpy as np
import torch

from pocket_tts_tpu_torch.conditioners.text import LUTConditioner
from pocket_tts_tpu_torch.config.schema import Config, builtin_config_path, load_config
from pocket_tts_tpu_torch.default_parameters import (
    DEFAULT_EOS_THRESHOLD,
    DEFAULT_LSD_DECODE_STEPS,
    DEFAULT_NOISE_CLAMP,
    DEFAULT_SEGMENT_FRAMES,
    DEFAULT_TEMPERATURE,
    DEFAULT_VARIANT,
    KV_CAPACITY_BUCKET,
    MAX_TOKEN_PER_CHUNK,
)
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.generate import decode_mimi_chunk, initial_carry, run_segment
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import (
    estimate_max_gen_len,
    make_tokenizer,
    prepare_text_prompt,
    split_into_best_sentences,
)
from pocket_tts_tpu_torch.models.weights import cast_serving_dtype, load_state_dict, map_tensors, quantize_int8
from pocket_tts_tpu_torch.ops.fused_backbone import pack_backbone
from pocket_tts_tpu_torch.ops.fused_segment import pack_flow
from pocket_tts_tpu_torch.ops.sampling import sample_noise
from pocket_tts_tpu_torch.utils.assets import download_if_necessary
from pocket_tts_tpu_torch.utils.safetensors import load_safetensors

logger = logging.getLogger(__name__)

_BULK_SEGMENT_FRAMES = 64

_VOICE_NAMES = ["alba", "marius", "javert", "jean", "fantine", "cosette", "eponine", "azelma"]
PREDEFINED_VOICES = {
    name: (
        "hf://kyutai/pocket-tts-without-voice-cloning/embeddings/"
        f"{name}.safetensors@d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3"
    )
    for name in _VOICE_NAMES
}


def _stream_steady(segment_frames: int) -> int:
    """Steady-state streaming segment size (32 frames, capped at 64)."""
    return min(64, max(32, 1 << (max(1, segment_frames) - 1).bit_length()))


def _stream_schedule(max_gen_all: int, segment_frames: int) -> list[int]:
    """Streaming segments 1, 2, 4, ... doubling to the steady size, with the
    tail bucketed to a power of 2 (tts_model.py:84-104 of the JAX package)."""
    steady = _stream_steady(segment_frames)
    sched, total, s = [], 0, 1
    while total < max_gen_all:
        rem = max_gen_all - total
        if s > rem:
            s = 1 << (rem - 1).bit_length()
        sched.append(s)
        total += s
        s = min(s * 2, steady)
    return sched


def _bulk_schedule(max_gen_all: int) -> list[int]:
    """Bulk segments: 64-frame segments, then one power-of-2 tail (>= 8)."""
    n_big, rem = divmod(max(0, max_gen_all), _BULK_SEGMENT_FRAMES)
    sched = [_BULK_SEGMENT_FRAMES] * n_big
    if rem:
        sched.append(min(_BULK_SEGMENT_FRAMES, max(8, 1 << (rem - 1).bit_length())))
    return sched


def _bucket(n: int, bucket: int = KV_CAPACITY_BUCKET) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class ModelState:
    """A voice/continuation state: the FlowLM state tree, the host mirror of
    the stream positions, and the cache write index.

    The kernels append into the caches in place, so generation with
    copy_state=True works on a clone and leaves this state bit-identical."""

    def __init__(self, tree: dict, pos: list[int], written: int | None = None):
        self.tree = tree
        self.pos = list(pos)
        self.written = int(written) if written is not None else max(self.pos, default=0)

    @property
    def batch_size(self) -> int:
        return len(self.pos)


class TTSModel:
    """Text-to-speech pipeline: FlowLM + Mimi, one stream at a time."""

    _TOKENS_PER_SECOND_ESTIMATE = 3.0
    _GEN_SECONDS_PADDING = 2.0
    _MIMI_WARMUP_FRAMES = 1

    def __init__(self, flow_lm, mimi, params, tokenizer, config: Config, temp=DEFAULT_TEMPERATURE,
                 lsd_decode_steps=DEFAULT_LSD_DECODE_STEPS, noise_clamp=DEFAULT_NOISE_CLAMP,
                 eos_threshold=DEFAULT_EOS_THRESHOLD, seed: int = 0, device="cpu", state_dtype=torch.float32,
                 transfer_pcm16: bool = False):
        self.flow_lm = flow_lm
        self.mimi = mimi
        self.params = params
        self.tokenizer = tokenizer
        self.conditioner = LUTConditioner(
            n_bins=flow_lm.n_bins, tokenizer_path="", dim=flow_lm.dim,
            embed_weight=params["flow_lm"]["conditioner"]["embed"]["weight"], tokenizer=tokenizer,
        )
        self.temp = float(temp)
        self.lsd_decode_steps = int(lsd_decode_steps)
        self.noise_clamp = noise_clamp
        self.eos_threshold = float(eos_threshold)
        self.config = config
        self.device = torch.device(device)
        self.state_dtype = state_dtype  # KV caches and ring buffers
        self.transfer_pcm16 = bool(transfer_pcm16)
        self.random_init = False
        self._gen = torch.Generator().manual_seed(seed)
        self._warm_mimi: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.config.mimi.sample_rate

    @property
    def frame_size(self) -> int:
        return self.mimi.frame_size

    # ------------------------------------------------------------------ build

    @classmethod
    def load_model(
        cls,
        config: Union[str, Path] = DEFAULT_VARIANT,
        temp: float = DEFAULT_TEMPERATURE,
        lsd_decode_steps: int = DEFAULT_LSD_DECODE_STEPS,
        noise_clamp: Optional[float] = DEFAULT_NOISE_CLAMP,
        eos_threshold: float = DEFAULT_EOS_THRESHOLD,
        *,
        seed: int = 0,
        param_dtype: str = "float32",
        device: Union[str, torch.device, None] = None,
        allow_random_init: bool = True,
        transfer_pcm16: bool = False,
    ) -> "TTSModel":
        """Build the model and load weights (random init, seeded, when no
        checkpoint is reachable and allow_random_init).

        param_dtype "float32", "bfloat16", or "int8" (bf16 serving plus
        weight-only int8 FlowLM matmuls, decoded by the CUDA kernels)."""
        if str(config).endswith(".yaml"):
            cfg = load_config(Path(config))
        else:
            cfg = load_config(builtin_config_path(str(config)))
        flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
        mimi = MimiModel(cfg.mimi)
        gen = torch.Generator().manual_seed(seed)
        params = {"flow_lm": flow_lm.init_params(gen), "mimi": mimi.init_params(gen)}
        random_init = _load_weights(params, cfg, allow_random_init)
        tokenizer = make_tokenizer(cfg.flow_lm.lookup_table.n_bins, str(cfg.flow_lm.lookup_table.tokenizer_path))
        model = cls.from_params(cfg, params, tokenizer, param_dtype, device, temp=temp,
                                lsd_decode_steps=lsd_decode_steps, noise_clamp=noise_clamp,
                                eos_threshold=eos_threshold, seed=seed, transfer_pcm16=transfer_pcm16)
        model.random_init = random_init
        return model

    @classmethod
    def from_params(cls, cfg: Config, params: dict, tokenizer, param_dtype: str = "float32", device=None,
                    **kwargs) -> "TTSModel":
        """Build a model from a float32 params tree: apply the serving dtype
        (with its float32 islands), int8-quantize and pack the kernel weights
        for param_dtype "int8", and move everything to `device`."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
        quantize = param_dtype == "int8"
        serving = torch.bfloat16 if quantize else getattr(torch, param_dtype)
        if serving != torch.float32:
            params = cast_serving_dtype(params, serving)
        if quantize:
            params = quantize_int8(params)
        params = map_tensors(params, lambda t: t.to(device))
        if quantize:
            fl = params["flow_lm"]
            t = cfg.flow_lm.transformer
            fl["fused_backbone"] = pack_backbone(fl, t.num_heads, float(t.max_period))
            fl["fused_flow"] = pack_flow(flow_lm.flow_net, fl["flow_net"])
        return cls(flow_lm, MimiModel(cfg.mimi), params, tokenizer, config=cfg, device=device,
                   state_dtype=serving, **kwargs)

    # ------------------------------------------------------------------ voice state

    def get_state_for_audio_prompt(self, audio_conditioning: str) -> ModelState:
        """FlowLM state for a predefined voice name. An unreachable voice
        asset under random weights gives the JAX package's synthetic prompt
        recipe (seeded by the name; values differ from JAX's)."""
        if audio_conditioning not in PREDEFINED_VOICES:
            raise ValueError(
                f"voice '{audio_conditioning}' is not one of {list(PREDEFINED_VOICES)}; "
                "voice cloning is not part of the PyTorch port yet"
            )
        try:
            tensors = load_safetensors(download_if_necessary(PREDEFINED_VOICES[audio_conditioning]))
        except (ConnectionError, FileNotFoundError):
            if not self.random_init:
                raise
            logger.warning("Voice asset '%s' unreachable; using a synthetic prompt.", audio_conditioning)
            gen = torch.Generator().manual_seed(sum(audio_conditioning.encode()))
            return self._state_from_prompt(torch.randn(1, 125, self.flow_lm.dim, generator=gen) * 0.02)
        if "audio_prompt" not in tensors:
            raise KeyError("audio_prompt not found in voice embedding file")
        raw = np.asarray(tensors["audio_prompt"])
        if raw.ndim != 3 or raw.shape[0] != 1 or raw.shape[2] != self.flow_lm.dim:
            raise ValueError(f"voice embedding must be [1, T, {self.flow_lm.dim}], got {raw.shape}")
        return self._state_from_prompt(torch.from_numpy(raw.astype(np.float32)))

    def _state_from_prompt(self, prompt: torch.Tensor) -> ModelState:
        """Prefill a fresh KV cache with conditioning embeddings [1, T, dim]."""
        B, T, _ = prompt.shape
        state = self.flow_lm.init_state(B, _bucket(T), dtype=self.state_dtype, device=self.device)
        with torch.no_grad():
            state = self.flow_lm.prefill(self.params["flow_lm"], state, prompt.float().to(self.device), [T] * B)
        return ModelState(state, [T] * B, written=T)

    # ------------------------------------------------------------------ generation

    def generate_audio(
        self,
        model_state: ModelState,
        text_to_generate: str,
        max_tokens: int = MAX_TOKEN_PER_CHUNK,
        frames_after_eos: Optional[int] = None,
        copy_state: bool = True,
        trim_start_ms: int = 0,
        fade_in_ms: int = 0,
        warmup_frames: int = _MIMI_WARMUP_FRAMES,
    ) -> np.ndarray:
        """Generate a full utterance as a 1-D float32 waveform at 24 kHz."""
        chunks = list(
            self.generate_audio_stream(
                model_state, text_to_generate, max_tokens, frames_after_eos, copy_state, warmup_frames,
                _bulk=True,
            )
        )
        audio = np.concatenate(chunks, axis=0) if chunks else np.zeros(0, dtype=np.float32)
        return self._postprocess_audio_start(audio, trim_start_ms, fade_in_ms)

    def generate_audio_stream(
        self,
        model_state: ModelState,
        text_to_generate: str,
        max_tokens: int = MAX_TOKEN_PER_CHUNK,
        frames_after_eos: Optional[int] = None,
        copy_state: bool = True,
        warmup_frames: int = _MIMI_WARMUP_FRAMES,
        _bulk: bool = False,
    ) -> Generator[np.ndarray, None, None]:
        """Yield 80 ms frames (1920 float32 samples) as they decode."""
        if model_state.batch_size != 1:
            raise ValueError("the PyTorch port decodes one stream at a time")
        for chunk in split_into_best_sentences(self.tokenizer, text_to_generate, max_tokens):
            _, guess = prepare_text_prompt(chunk)
            fae = frames_after_eos if frames_after_eos is not None else guess + 2
            yield from self._generate_chunk(model_state, chunk, fae, copy_state, warmup_frames, _bulk)

    def _warm_mimi_state(self, max_chunk: int, warmup_frames: int) -> dict:
        """Mimi decode state after `warmup_frames` zero-latent frames (cached;
        voice-independent), cloned for each generation."""
        key = (max_chunk, warmup_frames)
        if key not in self._warm_mimi:
            state = self.mimi.init_decode_state(1, self.state_dtype, max_chunk, self.device)
            zero = torch.zeros(1, 1, self.flow_lm.ldim, device=self.device)
            for _ in range(warmup_frames):
                _, state = decode_mimi_chunk(self.params["flow_lm"], self.params["mimi"], self.mimi, zero, state)
            self._warm_mimi[key] = state
        return copy.deepcopy(self._warm_mimi[key])

    @torch.no_grad()
    def _generate_chunk(self, model_state: ModelState, text: str, frames_after_eos: int, copy_state: bool,
                        warmup_frames: int, bulk: bool) -> Generator[np.ndarray, None, None]:
        tokens = self.conditioner.prepare(text).tokens[0].tolist()
        n_tok = len(tokens)
        max_gen = estimate_max_gen_len(
            n_tok, self.config.mimi.frame_rate, self._TOKENS_PER_SECOND_ESTIMATE, self._GEN_SECONDS_PADDING
        )
        t_pad = _bucket(n_tok, 32)
        sched = _bulk_schedule(max_gen) if bulk else _stream_schedule(max_gen, DEFAULT_SEGMENT_FRAMES)
        budget = sum(sched)

        # deepcopy keeps the layers' one shared slot_pos tensor shared.
        tree = copy.deepcopy(model_state.tree) if copy_state else model_state.tree
        written = model_state.written
        capacity_now = self.flow_lm.state_capacity(tree)
        required = written + t_pad + budget
        if _bucket(required) > capacity_now:
            # Compact dead slots out before growing to a new bucket.
            compact_written = -(-(max(model_state.pos) + 1) // 8) * 8
            required_after = compact_written + t_pad + budget
            if compact_written < written and _bucket(required_after) < _bucket(required):
                tree = self.flow_lm.compact_state(tree, compact_written)
                written, required = compact_written, required_after
        tree = self.flow_lm.expand_state(tree, _bucket(required))
        if not copy_state:
            model_state.tree, model_state.written = tree, written

        max_chunk = max(sched, default=1) if bulk else _stream_steady(DEFAULT_SEGMENT_FRAMES)
        mimi_state = self._warm_mimi_state(max_chunk, warmup_frames)

        t0 = time.monotonic()
        tok = torch.zeros(1, t_pad, dtype=torch.long)
        tok[0, :n_tok] = torch.tensor(tokens, dtype=torch.long)
        fl = self.params["flow_lm"]
        tree = self.flow_lm.prefill(fl, tree, self.flow_lm.embed_text(fl, tok.to(self.device)), [n_tok])
        carry = initial_carry(1, self.flow_lm.ldim, [frames_after_eos], [max_gen], self.device)

        dispatched = 0
        pending = []  # bulk: (audio, emit) kept on the device until the end
        emitted_samples = 0
        for seg in sched:
            noise = sample_noise(self._gen, (seg, 1, self.flow_lm.ldim), self.temp, self.noise_clamp, self.device)
            tree, mimi_state, carry, audio, emit, done = run_segment(
                self.flow_lm, self.mimi, self.params, tree, mimi_state, carry, noise,
                self.lsd_decode_steps, self.eos_threshold, emit_pcm16=self.transfer_pcm16,
            )
            dispatched += seg
            if bulk:
                pending.append((audio, emit))
                continue
            audio_np, emit_np, done_np = audio.cpu().numpy(), emit.cpu().numpy(), bool(done)
            for frame in self._emitted(audio_np, emit_np):
                emitted_samples += frame.shape[-1]
                yield frame
            if done_np:
                break
        for audio, emit in pending:
            for frame in self._emitted(audio.cpu().numpy(), emit.cpu().numpy()):
                emitted_samples += frame.shape[-1]
                yield frame

        # Continuation semantics: FlowLM ran min(eos_step + frames_after_eos
        # + 1, max_gen) steps in the reference loop; rewind past the extra
        # masked steps and invalidate the cache slots they wrote.
        eos_step = int(carry["eos_step"][0])
        steps_entered = min(eos_step + frames_after_eos + 1, max_gen, dispatched)
        if not copy_state:
            new_pos = [model_state.pos[0] + n_tok + steps_entered]
            model_state.tree = self.flow_lm.invalidate_after(tree, new_pos)
            model_state.pos = new_pos
            model_state.written = written + t_pad + dispatched
        elapsed = time.monotonic() - t0
        logger.info(
            "Generated: %d ms of audio in %d ms so %.2fx faster than real-time",
            emitted_samples * 1000 // self.sample_rate, int(elapsed * 1000),
            emitted_samples / self.sample_rate / max(elapsed, 1e-9),
        )

    @staticmethod
    def _emitted(audio_np: np.ndarray, emit_np: np.ndarray):
        if audio_np.dtype == np.int16:  # transfer_pcm16: widen on the host
            audio_np = audio_np.astype(np.float32) / 32767.0
        for s in range(audio_np.shape[1]):
            if emit_np[0, s]:
                yield audio_np[0, s]

    def _postprocess_audio_start(self, audio: np.ndarray, trim_start_ms: int, fade_in_ms: int) -> np.ndarray:
        """Trim/fade the onset (reference: tts_model.py:446-462)."""
        sr = self.sample_rate
        if trim_start_ms > 0:
            trim = int(sr * trim_start_ms / 1000)
            if 0 < trim < audio.shape[0]:
                audio = audio[trim:]
        if fade_in_ms > 0 and audio.shape[0] > 1:
            fade = min(max(0, int(sr * fade_in_ms / 1000)), audio.shape[0])
            if fade > 1:
                ramp = np.linspace(0.0, 1.0, fade, dtype=audio.dtype)
                audio = np.concatenate([audio[:fade] * ramp, audio[fade:]], axis=0)
        return audio


def _load_weights(params: dict, cfg: Config, allow_random_init: bool) -> bool:
    """Checkpoint resolution of the JAX package (local files only in the
    port) -> True when the weights stay random."""
    if cfg.flow_lm.weights_path is not None:
        flat = load_safetensors(download_if_necessary(str(cfg.flow_lm.weights_path)))
        load_state_dict(params["flow_lm"], flat)
        flat = load_safetensors(download_if_necessary(str(cfg.mimi.weights_path)))
        load_state_dict(params["mimi"], flat, strip_prefix="model.")
    if cfg.weights_path is None:
        return cfg.flow_lm.weights_path is None
    for path in (cfg.weights_path, cfg.weights_path_without_voice_cloning):
        if path is None:
            continue
        try:
            weights_file = download_if_necessary(path)
        except (ConnectionError, FileNotFoundError):
            continue
        loaded, skipped = load_state_dict(params, load_safetensors(weights_file))
        logger.info("Loaded %d weights, skipped %d", loaded, skipped)
        return False
    if not allow_random_init:
        raise FileNotFoundError(f"no checkpoint reachable for {cfg.weights_path}")
    logger.warning("No checkpoint reachable (offline?). Using RANDOM weights — audio will be noise.")
    return True
