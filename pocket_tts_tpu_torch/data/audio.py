"""Audio I/O: reading a voice prompt, 16-bit PCM conversion, a seekable WAV
writer and a streaming WAV writer for pipes and sockets.

Copied from the JAX package's reader and writers
(pocket_tts_tpu/data/audio.py) so the port needs no import of it. `.wav`
reads through the stdlib `wave` module (16-bit PCM); other formats need the
optional `soundfile` package. The streaming writer emits the header before any
audio exists, with a placeholder frame count that is never patched (a pipe
cannot be seeked back into); it may hold back the first
FIRST_CHUNK_LENGTH_SECONDS of audio and release it in one write; it pads the
end with 0.2 s of silence.
"""

from __future__ import annotations

import os
import wave
from pathlib import Path
from typing import Any

import numpy as np

# Hold back this many seconds of audio before the first PCM write reaches the
# output stream (0 = deliver every chunk immediately).
FIRST_CHUNK_LENGTH_SECONDS = float(os.environ.get("FIRST_CHUNK_LENGTH_SECONDS", "0"))

_PCM16_BYTES = 2
_TRAILING_SILENCE_SECONDS = 0.2
_STREAMING_FRAME_COUNT = 1_000_000_000  # placeholder; see the module docstring


def pcm16_bytes(chunk: Any) -> bytes:
    """Flatten a chunk to mono int16 PCM bytes; float input is clip-scaled
    from [-1, 1], int16 input passes through."""
    flat = np.asarray(chunk).reshape(-1)
    if flat.dtype != np.int16:
        flat = (np.clip(flat, -1.0, 1.0) * 32767).astype(np.int16)
    return flat.tobytes()


def _downmix_to_mono(samples: np.ndarray, n_channels: int) -> np.ndarray:
    if n_channels > 1:
        samples = samples.reshape(-1, n_channels).mean(axis=1)
    return samples


def audio_read(filepath: str | Path) -> tuple[np.ndarray, int]:
    """Read an audio file -> (float32 [1, T] in [-1, 1], sample_rate)."""
    filepath = Path(filepath)
    if filepath.suffix.lower() == ".wav":
        return _read_wav_stdlib(filepath)
    return _read_via_soundfile(filepath)


def _read_wav_stdlib(filepath: Path) -> tuple[np.ndarray, int]:
    with wave.open(str(filepath), "rb") as f:
        rate = f.getframerate()
        channels = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(-1)
    if width != _PCM16_BYTES:
        raise ValueError(f"Only 16-bit WAV supported by the stdlib reader, got {8 * width}-bit")
    mono = _downmix_to_mono(np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0, channels)
    return mono[None, :], rate


def _read_via_soundfile(filepath: Path) -> tuple[np.ndarray, int]:
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError(
            "soundfile is required to read non-WAV audio files. Install with: pip install soundfile"
        ) from e
    data, rate = sf.read(str(filepath), dtype="float32")
    mono = data if data.ndim == 1 else data.mean(axis=1)
    return mono[None, :], rate


def audio_write(filepath: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write a finished waveform as a seekable 16-bit PCM WAV."""
    with wave.open(str(filepath), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(_PCM16_BYTES)
        f.setframerate(sample_rate)
        f.writeframes(pcm16_bytes(audio))


class StreamingWAVWriter:
    """Incremental PCM16 WAV emitter for pipes and sockets: ``write_header``
    once, ``write_pcm_data`` per chunk, ``finalize`` at the end."""

    def __init__(self, output_stream, sample_rate: int):
        self.output_stream = output_stream
        self.sample_rate = sample_rate
        self.wave_writer = None
        # Bytes withheld until the hold-back target is reached; None once
        # passthrough mode is entered.
        self._held: bytearray | None = bytearray()
        self._hold_target = int(sample_rate * FIRST_CHUNK_LENGTH_SECONDS) * _PCM16_BYTES

    def write_header(self, sample_rate: int) -> None:
        """Set up the streaming header (placeholder frame count)."""
        self.wave_writer = wave.open(self.output_stream, "wb")
        self.wave_writer.setnchannels(1)
        self.wave_writer.setsampwidth(_PCM16_BYTES)
        self.wave_writer.setframerate(sample_rate)
        self.wave_writer.setnframes(_STREAMING_FRAME_COUNT)

    def write_pcm_data(self, audio_chunk: Any) -> None:
        """Append one chunk (float in [-1, 1] or ready int16 PCM)."""
        data = pcm16_bytes(audio_chunk)
        if self._held is None:
            self.wave_writer.writeframesraw(data)
            return
        self._held.extend(data)
        if len(self._held) >= self._hold_target:
            self._release_held()

    def _release_held(self) -> None:
        if self._held is not None:
            self.wave_writer.writeframesraw(bytes(self._held))
            self._held = None

    def finalize(self) -> None:
        """Release any held audio, pad with silence, close without seeking."""
        self._release_held()
        pad_samples = int(self.sample_rate * _TRAILING_SILENCE_SECONDS)
        self.wave_writer.writeframesraw(bytes(pad_samples * _PCM16_BYTES))
        # wave.close() would seek to offset 0 to patch the frame count; the
        # stream may be a pipe, so the placeholder count stands.
        self.wave_writer._patchheader = lambda: None
        self.wave_writer.close()
