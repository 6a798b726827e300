"""pocket-tts-tpu-torch: the PyTorch + CUDA (Hopper) port of pocket-tts-tpu.

The JAX package `pocket_tts_tpu` is the reference; this package imports
neither it nor jax. The B=1 int8 decode path runs two hand-written CUDA
kernels (ops/fused_backbone.py, ops/fused_segment.py, sources in csrc/).
"""

__version__ = "0.1.0"

from pocket_tts_tpu_torch.models.tts_model import TTSModel

__all__ = ["TTSModel", "__version__"]
