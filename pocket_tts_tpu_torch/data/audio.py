"""WAV output: 16-bit PCM conversion and a seekable WAV writer (stdlib only).

Copied from the JAX package's writer (pocket_tts_tpu/data/audio.py) so the
port needs no import of it.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Any

import numpy as np

_PCM16_BYTES = 2


def pcm16_bytes(chunk: Any) -> bytes:
    """Flatten a chunk to mono int16 PCM bytes; float input is clip-scaled
    from [-1, 1], int16 input passes through."""
    flat = np.asarray(chunk).reshape(-1)
    if flat.dtype != np.int16:
        flat = (np.clip(flat, -1.0, 1.0) * 32767).astype(np.int16)
    return flat.tobytes()


def audio_write(filepath: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write a finished waveform as a seekable 16-bit PCM WAV."""
    with wave.open(str(filepath), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(_PCM16_BYTES)
        f.setframerate(sample_rate)
        f.writeframes(pcm16_bytes(audio))
