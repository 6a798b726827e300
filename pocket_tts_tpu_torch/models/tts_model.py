"""End-to-end TTS pipeline: text -> FlowLM decode -> Mimi
(port of pocket_tts_tpu/models/tts_model.py; reference:
pocket_tts_mlx/models/tts_model.py:54-518).

`load_model`, `get_state_for_audio_prompt` (a predefined voice, or voice
cloning from a WAV file or a waveform array through the Mimi encoder and
the speaker projection), `generate_audio`,
`generate_audio_stream` and `generate_audio_batch` keep the JAX package's
defaults, text chunking, segment schedules (streaming ramp 1, 2, 4, ... to
32 frames; bulk 64-frame segments with a power-of-2 tail), capacity
buckets, Mimi warmup, and the post-EOS rewind. One loop serves one stream
and B streams alike (`_generate_batch_frames`); frames decode in segments
(models/generate.run_segment), and the host reads audio and EOS once per
streamed segment and once per bulk generation. Batch segments read only the
128-bucketed front of the cache that holds written rows (`read_limit`).

On a mesh (`load_model(mesh=...)` or `dp=` / `tp=`; parallel/) every rank
holds its tp shard of the weights (Megatron feed-forward and attention
heads), every generation computes its schedule, token pad and capacity from
the whole batch, as the JAX package's single controller does, each rank
decodes its dp slice of the streams, and every rank returns the whole
batch's audio. The B=1 kernels stay off under a mesh, as in the JAX package.

`save_checkpoint` exports the params as a safetensors file that
`load_model` reads back (the end of fine-tuning, training/), `profile`
traces a block with torch.profiler, and `ModelState.size_bytes` sizes a
state.

Offline (no reachable checkpoint) the model starts from seeded random
weights, the hash tokenizer and a synthetic voice prompt, like the JAX
package.
"""

from __future__ import annotations

import copy
import logging
import time
from pathlib import Path
from typing import Generator, Optional, Sequence, Union

import numpy as np
import torch

from pocket_tts_tpu_torch.conditioners.text import LUTConditioner
from pocket_tts_tpu_torch.config.schema import Config, builtin_config_path, load_config
from pocket_tts_tpu_torch.data.audio import audio_read
from pocket_tts_tpu_torch.data.audio_utils import convert_audio
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
from pocket_tts_tpu_torch.models.weights import (
    cast_serving_dtype,
    load_state_dict,
    map_tensors,
    named_leaves,
    quantize_int8,
    save_checkpoint,
)
from pocket_tts_tpu_torch.ops.fused_backbone import pack_backbone
from pocket_tts_tpu_torch.ops.fused_segment import pack_flow
from pocket_tts_tpu_torch.ops.sampling import sample_noise
from pocket_tts_tpu_torch.parallel.collectives import all_gather_dp, barrier
from pocket_tts_tpu_torch.parallel.mesh import Mesh, dp_range, gather_params, shard_batch_tree, shard_params
from pocket_tts_tpu_torch.utils.assets import download_if_necessary
from pocket_tts_tpu_torch.utils.safetensors import load_safetensors
from pocket_tts_tpu_torch.utils.timing import size_of_pytree

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

VOICE_CLONING_UNSUPPORTED = (
    "We could not download the weights for the model with voice cloning, "
    "but you're trying to use voice cloning. "
    f"Without voice cloning, you can use our catalog of voices {list(PREDEFINED_VOICES)}. "
    "If you want access to the model with voice cloning, go to "
    "https://huggingface.co/kyutai/pocket-tts and accept the terms, "
    "then make sure you're logged in locally with `hf auth login`."
)
_PROMPT_MAX_SECONDS = 30  # truncate=True keeps this much of a voice file


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
    """A voice/continuation state of one or more streams: the FlowLM state
    tree, the host mirror of the stream positions, and the cache write index.

    The kernels append into the caches in place, so generation with
    copy_state=True works on a clone and leaves this state bit-identical.
    On a mesh the tree holds the whole batch on every rank, with this
    rank's heads."""

    def __init__(self, tree: dict, pos: list[int], written: int | None = None):
        self.tree = tree
        self.pos = list(pos)
        self.written = int(written) if written is not None else max(self.pos, default=0)

    @property
    def batch_size(self) -> int:
        return len(self.pos)

    def size_bytes(self) -> int:
        return size_of_pytree(self.tree)


def _resolve_device(device) -> torch.device:
    """The card unless the caller asks for another device; no silent CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class TTSModel:
    """Text-to-speech pipeline: FlowLM + Mimi, one stream or a batch."""

    _TOKENS_PER_SECOND_ESTIMATE = 3.0
    _GEN_SECONDS_PADDING = 2.0
    _MIMI_WARMUP_FRAMES = 1

    def __init__(self, flow_lm, mimi, params, tokenizer, config: Config, temp=DEFAULT_TEMPERATURE,
                 lsd_decode_steps=DEFAULT_LSD_DECODE_STEPS, noise_clamp=DEFAULT_NOISE_CLAMP,
                 eos_threshold=DEFAULT_EOS_THRESHOLD, seed: int = 0, device="cuda", state_dtype=torch.float32,
                 transfer_pcm16: bool = False, kv_int8: bool = False, mesh: Optional[Mesh] = None):
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
        self.device = _resolve_device(device)
        self.state_dtype = state_dtype  # KV caches and ring buffers
        # int8 FlowLM KV rows with per-row scales (batch serving): half the
        # bytes the batch decode attention reads. B=1 decodes over such a
        # cache leave the B=1 kernels (they carry no scales).
        self.kv_int8 = bool(kv_int8)
        self.transfer_pcm16 = bool(transfer_pcm16)
        self.mesh = mesh  # None: one device (parallel/mesh.py)
        self.random_init = False
        # False when the weights came from the checkpoint without voice
        # cloning (load_model's fallback): cloning from a file is refused.
        self.has_voice_cloning = True
        self._voice_state_cache: dict = {}
        self._gen = torch.Generator().manual_seed(seed)
        self._warm_mimi: dict = {}
        # Schedule of the last generation: batch size, decoded frames, cache
        # capacity and each segment's read limit (None: the whole capacity).
        self.last_generation: dict = {}

    @property
    def flow_state_dtype(self):
        """Dtype of the FlowLM KV caches this model creates (int8 with
        kv_int8, else state_dtype); Mimi's ring buffers use state_dtype."""
        return torch.int8 if self.kv_int8 else self.state_dtype

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
        device: Union[str, torch.device, None] = "cuda",
        allow_random_init: bool = True,
        transfer_pcm16: bool = False,
        kv_int8: bool = False,
        mesh: Optional[Mesh] = None,
        dp: int = 1,
        tp: int = 1,
    ) -> "TTSModel":
        """Build the model and load weights (random init, seeded, when no
        checkpoint is reachable and allow_random_init).

        param_dtype "float32", "bfloat16", or "int8" (bf16 serving plus
        weight-only int8 FlowLM matmuls, decoded by the CUDA kernels).
        device: the card by default; without one this raises unless the
        caller passes device="cpu". kv_int8: int8 FlowLM KV cache.
        mesh (or dp= / tp=, which make one over the process group that is
        up, as parallel/launch.py starts it): build this rank's part of a
        sharded model (see from_params)."""
        device = _resolve_device(device)
        if mesh is None and (dp > 1 or tp > 1):
            from pocket_tts_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(dp, tp, device.type)
        if str(config).endswith(".yaml"):
            cfg = load_config(Path(config))
        else:
            cfg = load_config(builtin_config_path(str(config)))
        flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
        mimi = MimiModel(cfg.mimi)
        gen = torch.Generator().manual_seed(seed)
        params = {"flow_lm": flow_lm.init_params(gen), "mimi": mimi.init_params(gen)}
        random_init, has_voice_cloning = _load_weights(params, cfg, allow_random_init)
        tokenizer = make_tokenizer(cfg.flow_lm.lookup_table.n_bins, str(cfg.flow_lm.lookup_table.tokenizer_path))
        model = cls.from_params(cfg, params, tokenizer, param_dtype, device, temp=temp,
                                lsd_decode_steps=lsd_decode_steps, noise_clamp=noise_clamp,
                                eos_threshold=eos_threshold, seed=seed, transfer_pcm16=transfer_pcm16,
                                kv_int8=kv_int8, mesh=mesh)
        model.random_init = random_init
        model.has_voice_cloning = has_voice_cloning
        return model

    @classmethod
    def from_params(cls, cfg: Config, params: dict, tokenizer, param_dtype: str = "float32", device="cuda",
                    mesh: Optional[Mesh] = None, **kwargs) -> "TTSModel":
        """Build a model from a float32 params tree: apply the serving dtype
        (with its float32 islands), int8-quantize and pack the kernel weights
        for param_dtype "int8", and move everything to `device` (the card
        unless device="cpu"; raises when there is no card).

        On a mesh (its device of `device`'s type) the cast and quantized tree
        is cut to this rank's tp shard (parallel/mesh.shard_params) and no
        kernel weights are packed. tp must divide every head count: the port
        runs whole heads on each rank (ValueError otherwise)."""
        device = _resolve_device(device)
        if mesh is not None:
            _check_mesh(cfg, mesh, device)
            device = mesh.device
        flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension,
                              speaker_dim=cfg.mimi.seanet.dimension, mesh=mesh)
        quantize = param_dtype == "int8"
        serving = torch.bfloat16 if quantize else getattr(torch, param_dtype)
        if serving != torch.float32:
            params = cast_serving_dtype(params, serving)
        if quantize:
            params = quantize_int8(params)
        if mesh is not None:
            params = shard_params(mesh, params)
        else:
            params = map_tensors(params, lambda t: t.to(device))
        if quantize and mesh is None:
            fl = params["flow_lm"]
            t = cfg.flow_lm.transformer
            fl["fused_backbone"] = pack_backbone(fl, t.num_heads, float(t.max_period))
            fl["fused_flow"] = pack_flow(flow_lm.flow_net, fl["flow_net"])
            if kwargs.get("kv_int8"):
                logger.warning(
                    "kv_int8=True keeps single-stream decodes off the B=1 CUDA kernels (they carry no int8-KV "
                    "scales); use kv_int8 for batch serving, not for single-stream models."
                )
        return cls(flow_lm, MimiModel(cfg.mimi, mesh), params, tokenizer, config=cfg, device=device,
                   state_dtype=serving, mesh=mesh, **kwargs)

    def save_checkpoint(self, path) -> int:
        """Write the current params as a torch-layout safetensors file that
        load_model reads through a local weights_path (a model loaded with
        param_dtype "int8" is refused; export from "float32"). Returns the
        tensor count. On a mesh every rank takes part: the shards are
        gathered and rank 0 writes the same mesh-free file."""
        if self.mesh is None or any(name.endswith("weight.q") for name, _ in named_leaves(self.params)):
            return save_checkpoint(self.params, path)  # an int8 tree is refused on every rank, before a collective
        params = gather_params(self.mesh, self.params)
        count = save_checkpoint(params, path) if self.mesh.rank == 0 else sum(1 for _ in named_leaves(params))
        barrier(self.mesh)  # the file is whole before any rank returns
        return count

    def profile(self, log_dir: Union[str, Path]):
        """Context manager: a torch.profiler trace of everything run inside
        (host activity, and the card's kernels on a CUDA model), written on
        exit as a Chrome trace (`*.pt.trace.json`, TensorBoard's layout)
        into log_dir."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))

    # ------------------------------------------------------------------ voice state

    def get_state_for_audio_prompt(
        self, audio_conditioning: Union[Path, str, np.ndarray, torch.Tensor], truncate: bool = False
    ) -> ModelState:
        """FlowLM state for a voice: a predefined voice name, a WAV path or
        local URI (cloned: read, converted to mono at the model rate, kept to
        its first 30 s with truncate=True), or a waveform array [C, T] or
        [T] at the model rate (cloned as it is). Cloning encodes the
        waveform with Mimi, projects it to conditioning embeddings and
        prefills a fresh cache with them (reference: tts_model.py:484-518)."""
        if isinstance(audio_conditioning, str) and audio_conditioning in PREDEFINED_VOICES:
            return self._predefined_voice_state(audio_conditioning)
        if isinstance(audio_conditioning, (str, Path)):
            if not self.has_voice_cloning:
                raise ValueError(VOICE_CLONING_UNSUPPORTED)
            wav = self._read_audio_prompt(audio_conditioning, truncate)
        else:
            wav = audio_conditioning if isinstance(audio_conditioning, torch.Tensor) else np.asarray(audio_conditioning)
            if wav.ndim == 1:  # [T] -> [C=1, T] (arrays are taken as mono at the model rate)
                wav = wav[None, :]
        return self._state_from_prompt(self._encode_audio(wav[None]))

    def _predefined_voice_state(self, name: str) -> ModelState:
        """The prompt of a predefined voice. An unreachable voice asset under
        random weights gives the JAX package's synthetic prompt recipe
        (seeded by the name; values differ from JAX's)."""
        try:
            tensors = load_safetensors(download_if_necessary(PREDEFINED_VOICES[name]))
        except (ConnectionError, FileNotFoundError):
            if not self.random_init:
                raise
            logger.warning("Voice asset '%s' unreachable; using a synthetic prompt.", name)
            gen = torch.Generator().manual_seed(sum(name.encode()))
            return self._state_from_prompt(torch.randn(1, 125, self.flow_lm.dim, generator=gen) * 0.02)
        if "audio_prompt" not in tensors:
            raise KeyError("audio_prompt not found in voice embedding file")
        raw = np.asarray(tensors["audio_prompt"])
        # Shape contract of the published voice assets: [1, T, d_model] float.
        if raw.ndim != 3 or raw.shape[0] != 1 or raw.shape[2] != self.flow_lm.dim:
            raise ValueError(
                f"voice embedding 'audio_prompt' must be [1, T, {self.flow_lm.dim}], got {tuple(raw.shape)}"
            )
        if raw.dtype.kind != "f":
            raise ValueError(f"voice embedding 'audio_prompt' must be floating point, got {raw.dtype}")
        return self._state_from_prompt(torch.from_numpy(raw.astype(np.float32)))

    def _read_audio_prompt(self, path: Union[Path, str], truncate: bool = False) -> np.ndarray:
        """A voice file (local path or URI) -> float32 [1, T] mono at the
        model rate; truncate=True keeps the first 30 s of the file."""
        audio, sr = audio_read(download_if_necessary(str(path)))
        if truncate and audio.shape[-1] > int(_PROMPT_MAX_SECONDS * sr):
            audio = audio[..., : int(_PROMPT_MAX_SECONDS * sr)]
            logger.info("Audio truncated to %d seconds", _PROMPT_MAX_SECONDS)
        return convert_audio(audio, sr, self.sample_rate, 1)

    @torch.no_grad()
    def _encode_audio(self, audio: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """Waveform [B, C, T] -> speaker conditioning [B, T', d_model]
        float32 on the model's device, T' = ceil(T / frame_size). The
        port encodes at the exact length: the JAX package pads to a
        power-of-2 frame bucket only to bound its compiles, and the encode
        chain is causal, so its first T' frames are these."""
        x = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        latents = self.mimi.encode_to_latent(self.params["mimi"], x).transpose(1, 2)
        return self.flow_lm.project_speaker(self.params["flow_lm"], latents)

    def _cached_get_state_for_audio_prompt(self, audio_conditioning: Union[Path, str],
                                           truncate: bool = False) -> ModelState:
        """Two-entry cache of voice states (reference: tts_model.py:478-482)."""
        key = (str(audio_conditioning), truncate)
        if key not in self._voice_state_cache:
            if len(self._voice_state_cache) >= 2:
                self._voice_state_cache.pop(next(iter(self._voice_state_cache)))
            self._voice_state_cache[key] = self.get_state_for_audio_prompt(audio_conditioning, truncate)
        return self._voice_state_cache[key]

    def _state_from_prompt(self, prompt: torch.Tensor) -> ModelState:
        """Prefill a fresh KV cache with conditioning embeddings [B, T, dim]."""
        B, T, _ = prompt.shape
        state = self.flow_lm.init_state(B, _bucket(T), dtype=self.flow_state_dtype, device=self.device)
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
            raise ValueError("generate_audio_stream decodes one stream; use generate_audio_batch for batched states")
        for chunk in split_into_best_sentences(self.tokenizer, text_to_generate, max_tokens):
            _, guess = prepare_text_prompt(chunk)
            fae = frames_after_eos if frames_after_eos is not None else guess + 2
            for frames, _ in self._generate_batch_frames(model_state, [chunk], [fae], copy_state, warmup_frames,
                                                         _bulk):
                yield frames[0]

    def generate_audio_batch(
        self,
        model_states: Union[ModelState, Sequence[ModelState]],
        texts: Sequence[str],
        frames_after_eos: Optional[int] = None,
        warmup_frames: int = _MIMI_WARMUP_FRAMES,
        trim_start_ms: int = 0,
        fade_in_ms: int = 0,
    ) -> list[np.ndarray]:
        """Decode many utterances together, one 1-D float32 waveform each.

        Each text must fit in one chunk (use generate_audio for long
        scripts). model_states is one shared voice, one voice per stream, or
        an already stacked state; it is left as it was."""
        if isinstance(model_states, ModelState):
            if model_states.batch_size == len(texts):
                batched = model_states
            elif model_states.batch_size == 1:
                batched = stack_states(self.flow_lm, [model_states] * len(texts))
            else:
                raise ValueError(f"model_states has batch {model_states.batch_size} but got {len(texts)} texts")
        else:
            if len(model_states) != len(texts):
                raise ValueError(f"got {len(model_states)} voice states for {len(texts)} texts")
            batched = stack_states(self.flow_lm, list(model_states))
        fae = [frames_after_eos if frames_after_eos is not None else prepare_text_prompt(t)[1] + 2 for t in texts]
        per_stream: list[list[np.ndarray]] = [[] for _ in texts]
        for frames, emit in self._generate_batch_frames(batched, list(texts), fae, True, warmup_frames, True):
            for b in np.flatnonzero(emit):
                per_stream[b].append(frames[b])
        return [
            self._postprocess_audio_start(
                np.concatenate(chunks, axis=0) if chunks else np.zeros(0, dtype=np.float32), trim_start_ms, fade_in_ms
            )
            for chunks in per_stream
        ]

    def _warm_mimi_state(self, batch: int, max_chunk: int, warmup_frames: int) -> dict:
        """Mimi decode state of `batch` streams after `warmup_frames`
        zero-latent frames (cached; voice-independent), cloned for each
        generation."""
        key = (batch, max_chunk, warmup_frames)
        if key not in self._warm_mimi:
            state = self.mimi.init_decode_state(batch, self.state_dtype, max_chunk, self.device)
            zero = torch.zeros(batch, 1, self.flow_lm.ldim, device=self.device)
            for _ in range(warmup_frames):
                _, state = decode_mimi_chunk(self.params["flow_lm"], self.params["mimi"], self.mimi, zero, state)
            self._warm_mimi[key] = state
        return copy.deepcopy(self._warm_mimi[key])

    @torch.no_grad()
    def _generate_batch_frames(self, model_state: ModelState, texts: Sequence[str], frames_after_eos: Sequence[int],
                               copy_state: bool, warmup_frames: int, bulk: bool):
        """The decode loop of B = model_state.batch_size streams, one text
        each. Yields (frames [B, frame] float32, emit [B] bool) for every
        decoded step where some stream emits."""
        B = model_state.batch_size
        if len(texts) != B or len(frames_after_eos) != B:
            raise ValueError(f"model_state holds {B} stream(s) but got {len(texts)} text(s)")
        # On a mesh this rank decodes streams [lo, hi) (all B where dp does
        # not divide B); the schedule, token pad and capacity are the whole
        # batch's on every rank, so every rank runs the same collectives.
        lo, hi = dp_range(self.mesh, B)
        sharded = (lo, hi) != (0, B)
        if sharded and not (copy_state and bulk):
            raise ValueError("a batch split over dp decodes in bulk from a copy of its state (generate_audio_batch)")
        token_lists = [self.conditioner.prepare(t).tokens[0].tolist() for t in texts]
        n_tok = [len(t) for t in token_lists]
        max_gen = [
            estimate_max_gen_len(n, self.config.mimi.frame_rate, self._TOKENS_PER_SECOND_ESTIMATE,
                                 self._GEN_SECONDS_PADDING)
            for n in n_tok
        ]
        t_pad = _bucket(max(n_tok), 32)
        sched = _bulk_schedule(max(max_gen)) if bulk else _stream_schedule(max(max_gen), DEFAULT_SEGMENT_FRAMES)
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
        capacity = self.flow_lm.state_capacity(tree)
        if not copy_state:
            model_state.tree, model_state.written = tree, written
        if sharded:
            tree = shard_batch_tree(self.mesh, tree, B)

        max_chunk = max(sched, default=1) if bulk else _stream_steady(DEFAULT_SEGMENT_FRAMES)
        mimi_state = self._warm_mimi_state(hi - lo, max_chunk, warmup_frames)

        t0 = time.monotonic()
        tok = torch.zeros(B, t_pad, dtype=torch.long)
        for b, toks in enumerate(token_lists):
            tok[b, : len(toks)] = torch.tensor(toks, dtype=torch.long)
        fl = self.params["flow_lm"]
        tree = self.flow_lm.prefill(fl, tree, self.flow_lm.embed_text(fl, tok[lo:hi].to(self.device)), n_tok[lo:hi])
        carry = initial_carry(hi - lo, self.flow_lm.ldim, list(frames_after_eos)[lo:hi], max_gen[lo:hi], self.device)

        # Read-limit buckets (B > 1): each segment's attention reads only
        # the 128-bucketed front of the cache that holds written rows.
        written_host = written + t_pad
        read_limits = []
        dispatched = 0
        pending = []  # bulk: (audio, emit) kept on the device until the end
        emitted_samples = 0
        for seg in sched:
            read_limit = None
            if B > 1:
                r = _bucket(written_host + seg)
                read_limit = r if r < capacity else None
            read_limits.append(read_limit)
            written_host += seg
            noise = sample_noise(self._gen, (seg, B, self.flow_lm.ldim), self.temp, self.noise_clamp,
                                 self.device)[:, lo:hi]
            tree, mimi_state, carry, audio, emit, done = run_segment(
                self.flow_lm, self.mimi, self.params, tree, mimi_state, carry, noise,
                self.lsd_decode_steps, self.eos_threshold, emit_pcm16=self.transfer_pcm16, read_limit=read_limit,
            )
            dispatched += seg
            if bulk:
                pending.append((audio, emit))
                continue
            for frames, emit_s in self._emitted(*self._whole_batch(audio, emit, sharded)):
                emitted_samples += int(emit_s.sum()) * frames.shape[-1]
                yield frames, emit_s
            if bool(done):
                break
        for audio, emit in pending:
            for frames, emit_s in self._emitted(*self._whole_batch(audio, emit, sharded)):
                emitted_samples += int(emit_s.sum()) * frames.shape[-1]
                yield frames, emit_s
        self.last_generation = {"batch": B, "frames": dispatched, "capacity": capacity, "read_limits": read_limits}

        if not copy_state:
            # Continuation semantics: FlowLM ran min(eos_step +
            # frames_after_eos + 1, max_gen) steps per stream in the reference
            # loop; rewind past the extra masked steps and invalidate the
            # cache slots they wrote.
            eos_step = carry["eos_step"].cpu().numpy()
            steps_entered = np.minimum(np.minimum(eos_step + np.asarray(frames_after_eos) + 1, max_gen), dispatched)
            new_pos = [int(p + n + s) for p, n, s in zip(model_state.pos, n_tok, steps_entered)]
            model_state.tree = self.flow_lm.invalidate_after(tree, new_pos)
            model_state.pos = new_pos
            model_state.written = written + t_pad + dispatched
        elapsed = time.monotonic() - t0
        logger.info(
            "Generated: %d ms of audio in %d ms so %.2fx faster than real-time",
            emitted_samples / B * 1000 // self.sample_rate, int(elapsed * 1000),
            emitted_samples / B / self.sample_rate / max(elapsed, 1e-9),
        )

    def _whole_batch(self, audio: torch.Tensor, emit: torch.Tensor, sharded: bool) -> tuple[np.ndarray, np.ndarray]:
        """A segment's audio and emit flags on the host, for the whole batch
        (gathered over dp when this rank decoded a slice of it)."""
        audio_np, emit_np = audio.cpu().numpy(), emit.cpu().numpy()
        if sharded:
            parts = all_gather_dp(self.mesh, (audio_np, emit_np))
            audio_np, emit_np = (np.concatenate([p[i] for p in parts]) for i in (0, 1))
        return audio_np, emit_np

    @staticmethod
    def _emitted(audio_np: np.ndarray, emit_np: np.ndarray):
        """(frames [B, frame], emit [B]) of each step of a segment where some
        stream emits."""
        if audio_np.dtype == np.int16:  # transfer_pcm16: widen on the host
            audio_np = audio_np.astype(np.float32) / 32767.0
        for s in range(audio_np.shape[1]):
            if emit_np[:, s].any():
                yield audio_np[:, s], emit_np[:, s]

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


def stack_states(flow_lm: FlowLMModel, states: Sequence[ModelState]) -> ModelState:
    """Stack voice states into one batched state: capacities equalised to
    the largest, the write index aligned to the largest (rows between a
    stream's own writes and the common index are invalid and never read),
    positions concatenated. The inputs are left as they were."""
    if len(states) == 1 and states[0].batch_size > 1:
        return states[0]
    capacity = max(flow_lm.state_capacity(s.tree) for s in states)
    trees = [flow_lm.expand_state(s.tree, capacity)["transformer"] for s in states]
    slot_pos = torch.cat([t["layers"][0]["slot_pos"] for t in trees])  # shared by every layer
    layers = [
        {name: slot_pos if name == "slot_pos" else torch.cat([t["layers"][i][name] for t in trees])
         for name in layer}
        for i, layer in enumerate(trees[0]["layers"])
    ]
    pos = [p for s in states for p in s.pos]
    tree = {"transformer": {"layers": layers, "widx": max(t["widx"] for t in trees)}, "pos": list(pos)}
    return ModelState(tree, pos, written=max(s.written for s in states))


def _check_mesh(cfg: Config, mesh: Mesh, device: torch.device) -> None:
    """Raise ValueError unless the mesh sits on `device`'s type and its tp
    divides every head count (the port runs whole heads on each rank; the
    JAX package, through GSPMD, also runs where a head is split)."""
    if mesh.device.type != device.type:
        raise ValueError(f"the mesh's ranks sit on {mesh.device}, not on {device.type}")
    for name, heads in (("FlowLM", cfg.flow_lm.transformer.num_heads), ("Mimi", cfg.mimi.transformer.num_heads)):
        if heads % mesh.tp:
            raise ValueError(f"tp={mesh.tp} does not divide the {heads} {name} attention heads: the port runs whole "
                             "heads on each rank (the JAX package would split a head across devices)")


def _load_weights(params: dict, cfg: Config, allow_random_init: bool) -> tuple[bool, bool]:
    """Checkpoint resolution of the JAX package (local files only in the
    port): `weights_path`, else `weights_path_without_voice_cloning`, else
    random weights -> (random_init, has_voice_cloning). has_voice_cloning is
    False once `weights_path` could not be read, as in the JAX package."""
    if cfg.flow_lm.weights_path is not None:
        if cfg.mimi.weights_path is None:
            raise ValueError("If you specify flow_lm.weights_path you should specify mimi.weights_path")
        flat = load_safetensors(download_if_necessary(str(cfg.flow_lm.weights_path)))
        load_state_dict(params["flow_lm"], flat)
        flat = load_safetensors(download_if_necessary(str(cfg.mimi.weights_path)))
        load_state_dict(params["mimi"], flat, strip_prefix="model.")
    if cfg.weights_path is None:
        return cfg.flow_lm.weights_path is None, True
    has_voice_cloning = True
    for path in (cfg.weights_path, cfg.weights_path_without_voice_cloning):
        if path is not None:
            try:
                weights_file = download_if_necessary(path)
            except (ConnectionError, FileNotFoundError):
                weights_file = None
            if weights_file is not None:
                loaded, skipped = load_state_dict(params, load_safetensors(weights_file))
                logger.info("Loaded %d weights, skipped %d", loaded, skipped)
                return False, has_voice_cloning
        has_voice_cloning = False
    if not allow_random_init:
        raise FileNotFoundError(f"no checkpoint reachable for {cfg.weights_path}")
    logger.warning("No checkpoint reachable (offline?). Using RANDOM weights — audio will be noise.")
    return True, has_voice_cloning
