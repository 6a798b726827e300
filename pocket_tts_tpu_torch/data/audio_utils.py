"""Reference-audio preparation for voice cloning: channel and rate
conversion (copied from pocket_tts_tpu/data/audio_utils.py; reference:
pocket_tts_mlx/data/audio_utils.py:15-41).

The cloning path (models/tts_model.get_state_for_audio_prompt) takes any
recording; the Mimi encoder wants mono at the model rate (24 kHz): channels
are mean-downmixed or tiled, the rate changes by rational polyphase
resampling (scipy resample_poly). Host code, on numpy arrays.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
from scipy.signal import resample_poly


def _to_channels(wav: np.ndarray, to_channels: int) -> np.ndarray:
    have = wav.shape[0]
    if have == to_channels:
        return wav
    if to_channels == 1:
        return wav.mean(axis=0, keepdims=True)
    if have == 1:
        return np.tile(wav, (to_channels, 1))
    raise ValueError(f"Cannot convert from {have} channels to {to_channels} channels")


def _to_rate(wav: np.ndarray, from_rate: float, to_rate: float) -> np.ndarray:
    src, dst = int(round(from_rate)), int(round(to_rate))
    if src == dst:
        return wav
    g = math.gcd(src, dst)
    return resample_poly(wav, dst // g, src // g, axis=-1)


def convert_audio(wav: Any, from_rate: int | float, to_rate: int | float, to_channels: int) -> np.ndarray:
    """Convert [C, T] (or [T]) audio to `to_channels` channels at `to_rate`."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    return _to_rate(_to_channels(wav, to_channels), from_rate, to_rate).astype(np.float32)
