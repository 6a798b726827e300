"""Default runtime parameters for TTS generation.

Values mirror the reference defaults (pocket_tts_mlx/default_parameters.py:1-10)
so users switching backends get identical behavior.
"""

DEFAULT_AUDIO_PROMPT = "alba"
DEFAULT_VARIANT = "b6369a24"
DEFAULT_TEMPERATURE = 0.7
DEFAULT_LSD_DECODE_STEPS = 1
DEFAULT_NOISE_CLAMP = None
DEFAULT_EOS_THRESHOLD = -4.0
DEFAULT_FRAMES_AFTER_EOS = None
MAX_TOKEN_PER_CHUNK = 50

# The decode loop runs in segments of frames; the host reads EOS flags once
# per segment instead of once per frame.
DEFAULT_SEGMENT_FRAMES = 8
# KV-cache capacities are bucketed to multiples of this (the slot-major cache
# contract shared with the JAX package; the reference grows its cache
# dynamically instead: pocket_tts_mlx/models/tts_model.py:278-295).
KV_CAPACITY_BUCKET = 128
