"""Console entry point: synthesize one utterance to a WAV file with the
PyTorch port. Flags and defaults follow the JAX package's CLI
(pocket_tts_tpu/main.py, itself pinned to pocket_tts_mlx/main.py:21-44),
plus --param-dtype and --device."""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from pocket_tts_tpu_torch.data.audio import audio_write
from pocket_tts_tpu_torch.models.tts_model import TTSModel

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate speech from text using pocket-tts (PyTorch/CUDA port)")
    p.add_argument("text", help="Text to convert to speech")
    p.add_argument("--voice", "-v", default="marius",
                   help="Voice name, or a WAV file to clone the voice of (default: marius)")
    p.add_argument("--output", "-o", default="output.wav", help="Output WAV file")
    p.add_argument("--max-tokens", type=int, default=500, help="Max tokens per chunk")
    p.add_argument("--frames-after-eos", type=int, default=7, help="Frames after EOS")
    p.add_argument("--trim-start-ms", type=int, default=0,
                   help="Trim this many milliseconds from start of generated audio")
    p.add_argument("--fade-in-ms", type=int, default=0, help="Apply linear fade-in over this many milliseconds")
    p.add_argument("--warmup-frames", type=int, default=1,
                   help="Number of initial Mimi frames to decode and discard for cleaner onset")
    p.add_argument("--param-dtype", default="float32", choices=["float32", "bfloat16", "int8"],
                   help="Weight dtype; int8 decodes with the CUDA kernels (default: float32)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; fails without a GPU unless --device cpu is given)")
    p.add_argument("--verbose", "-V", action="store_true", help="Verbose logging")
    return p


def synthesize_to_file(args: argparse.Namespace) -> Path:
    """Run the full pipeline for one request and return the written path."""
    model = TTSModel.load_model(param_dtype=args.param_dtype, device=args.device)
    logger.info("Preparing voice state '%s'...", args.voice)
    voice_state = model.get_state_for_audio_prompt(args.voice)
    audio = model.generate_audio(
        voice_state,
        args.text,
        max_tokens=args.max_tokens,
        frames_after_eos=args.frames_after_eos,
        trim_start_ms=args.trim_start_ms,
        fade_in_ms=args.fade_in_ms,
        warmup_frames=args.warmup_frames,
    )
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    audio_write(out, audio, model.sample_rate)
    logger.info("Wrote %s (%.2fs)", out, audio.shape[-1] / model.sample_rate)
    return out


def main() -> int:
    args = build_parser().parse_args()
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO, format="%(message)s")
    try:
        synthesize_to_file(args)
    except Exception as exc:  # noqa: BLE001 — the CLI reports, not raises
        logger.error("Error: %s", exc)
        if args.verbose:
            logger.exception("Traceback:")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
