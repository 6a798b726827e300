"""Minimal streaming HTTP server over the continuous-batching engine
(port of pocket_tts_tpu/serving/server.py).

Stdlib only (http.server): GET /tts?text=...&voice=marius streams a chunked
WAV response whose frames are written as the engine decodes them; 404 for
another path, 400 for empty text or a voice that is not one of the
predefined voices, 500 when the request cannot be set up, and 503 +
Retry-After when the engine sheds load. Run:

    python -m pocket_tts_tpu_torch.serving.server --port 8080 --slots 8
"""

from __future__ import annotations

import argparse
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pocket_tts_tpu_torch.data.audio import StreamingWAVWriter
from pocket_tts_tpu_torch.models.tts_model import PREDEFINED_VOICES, TTSModel
from pocket_tts_tpu_torch.serving.engine import EngineOverloaded, TTSEngine

logger = logging.getLogger(__name__)


class _Chunked:
    """HTTP/1.1 chunked transfer encoding over the handler's socket file."""

    def __init__(self, wfile):
        self.wfile = wfile

    def write(self, data: bytes):
        self.wfile.write(f"{len(data):X}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")

    def close(self):
        pass

    def flush(self):
        self.wfile.flush()

    def tell(self):
        return 0

    def seek(self, *a):
        raise OSError("streaming")


def make_handler(model: TTSModel, engine: TTSEngine):
    """The request handler class of a server over `engine`. Handler threads
    build the states of predefined voices (one at a time, cached) and
    submit; the engine's thread does all the decoding."""
    voice_cache: dict = {}
    voice_lock = threading.Lock()

    def voice_state(name: str):
        with voice_lock:
            if name not in voice_cache:
                voice_cache[name] = model.get_state_for_audio_prompt(name)
            return voice_cache[name]

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802 — http.server API
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/tts":
                self.send_error(404, "use /tts?text=...&voice=...")
                return
            params = urllib.parse.parse_qs(parsed.query)
            text = (params.get("text") or [""])[0]
            voice = (params.get("voice") or ["marius"])[0]
            if not text.strip():
                self.send_error(400, "missing text")
                return
            if voice not in PREDEFINED_VOICES:
                # The model also clones a voice from a file or a local URI;
                # a client names only a predefined voice, so no request reads
                # a file on the server's host and the voice cache stays
                # bounded.
                self.send_error(400, f"unknown voice; use one of {list(PREDEFINED_VOICES)}")
                return
            try:
                handle = engine.submit(text, voice_state(voice))
            except EngineOverloaded as exc:
                # Backpressure, not failure: tell the client when a backlog's
                # worth of work will have drained.
                self.send_response(503, "engine saturated")
                self.send_header("Retry-After", str(max(1, round(exc.retry_after_s))))
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            except Exception as exc:  # noqa: BLE001 — reported to the client
                self.send_error(500, str(exc))
                return

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            writer = StreamingWAVWriter(_Chunked(self.wfile), model.sample_rate)
            try:
                writer.write_header(model.sample_rate)
                for frame in handle.frames():
                    writer.write_pcm_data(frame)
                writer.finalize()
                self.wfile.write(b"0\r\n\r\n")
            except ConnectionError:
                handle.cancel()  # stop decoding for a vanished client

        def log_message(self, fmt, *args):
            logger.info("http: " + fmt, *args)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pocket-tts streaming server (PyTorch/CUDA port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--segment-frames", type=int, default=4)
    parser.add_argument("--max-pending", type=int, default=None,
                        help="pending-queue bound before 503 (default: 2x slots; 0 = unbounded)")
    parser.add_argument("--param-dtype", default="float32", choices=["float32", "bfloat16", "int8"],
                        help="Weight dtype; int8 decodes with the CUDA kernels (default: float32)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 FlowLM KV cache with per-row scales (with --param-dtype int8: the all-int8 mode)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; fails without a GPU unless --device cpu is given)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    max_pending = 2 * args.slots if args.max_pending is None else (args.max_pending if args.max_pending > 0 else None)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger.info("loading model...")
    model = TTSModel.load_model(param_dtype=args.param_dtype, device=args.device, kv_int8=args.kv_int8)
    engine = TTSEngine(model, slots=args.slots, segment_frames=args.segment_frames, emit_pcm16=True,
                       max_pending=max_pending)
    engine.serve_forever_in_thread()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(model, engine))
    logger.info("serving on http://%s:%d/tts?text=hello", args.host, args.port)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
