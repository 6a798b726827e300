"""The port's HTTP streaming server over a real socket, on the CPU at tiny
widths: the cases of tests/test_server.py against the port's handler and
engine, the streaming WAV writer against the JAX package's, and the
handler's voice cache under concurrent first requests."""

import io
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from pocket_tts_tpu.data.audio import StreamingWAVWriter as JaxStreamingWAVWriter
from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.data.audio import StreamingWAVWriter
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.serving import server as server_module
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from pocket_tts_tpu_torch.serving.server import make_handler
from tiny_config import TINY


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops run fastest on one thread, and the suite's parallel workers
    would otherwise oversubscribe the cores with torch's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_model(seed: int, kv_int8: bool = False) -> TTSModel:
    cfg = Config(**TINY)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    gen = torch.Generator().manual_seed(seed)
    params = {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}
    model = TTSModel.from_params(cfg, params, FallbackWordTokenizer(4000), "float32", device="cpu", temp=0.7,
                                 lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9, kv_int8=kv_int8)
    model.random_init = True  # offline: the synthetic-voice fallback
    return model


def _serve(model, engine):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(model, engine))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def served():
    model = _tiny_model(0)
    calls = []
    real = model.get_state_for_audio_prompt

    def counted(name):
        calls.append(name)
        time.sleep(0.05)  # widen the window in which concurrent first requests race
        return real(name)

    model.get_state_for_audio_prompt = counted
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32, emit_pcm16=True)
    thread = engine.serve_forever_in_thread()
    httpd, url = _serve(model, engine)
    yield url, calls
    httpd.shutdown()
    engine.stop()
    thread.join(timeout=30)


def _pcm_samples(data: bytes) -> int:
    """Samples of audio in a streamed WAV (its header's frame count is a
    placeholder; the body runs to the end)."""
    return (len(data) - 44) // 2


def test_tts_endpoint_streams_wav(served):
    url, _ = served
    text = urllib.parse.quote("Server test sentence with words.")
    with urllib.request.urlopen(f"{url}/tts?text={text}&voice=marius", timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        data = r.read()
    w = wave.open(io.BytesIO(data))
    assert w.getframerate() == 24000 and w.getsampwidth() == 2 and w.getnchannels() == 1
    assert len(data) > 44 + 1920 * 2
    # whole 1920-sample frames plus the writer's 0.2 s of trailing silence
    assert (_pcm_samples(data) - 4800) % 1920 == 0


def test_concurrent_requests(served):
    url, calls = served
    results = {}

    def fetch(name):
        text = urllib.parse.quote(f"Concurrent request number {name} goes here.")
        with urllib.request.urlopen(f"{url}/tts?text={text}&voice=alba", timeout=300) as r:
            results[name] = r.read()

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 3
    assert all(len(v) > 44 for v in results.values())
    # Three concurrent first requests for one voice build its state once:
    # the handler's voice cache is guarded by a lock.
    assert calls.count("alba") == 1


def test_error_paths(served):
    url, _ = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{url}/tts?text=", timeout=30)
    assert exc.value.code == 400


@pytest.mark.parametrize("voice", ["/etc/hostname", "file:///etc/hostname", "prompt.wav", "no-such-voice"])
def test_voice_outside_the_predefined_set_is_refused(served, voice):
    """A voice names a predefined voice only: a path or URI that the model
    would read from the server's disk gets a 400 and is never loaded."""
    url, calls = served
    query = urllib.parse.urlencode({"text": "Hello there.", "voice": voice})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{url}/tts?{query}", timeout=30)
    assert exc.value.code == 400
    assert voice not in calls


def test_saturated_engine_returns_503():
    """Backpressure is HTTP 503 + Retry-After: a server whose engine bound is
    0 sheds every submit."""
    model = _tiny_model(3)
    engine = TTSEngine(model, slots=1, segment_frames=2, capacity=256, text_pad=32, emit_pcm16=True,
                       max_pending=0)
    httpd, url = _serve(model, engine)
    try:
        text = urllib.parse.quote("Shed me please.")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/tts?text={text}", timeout=60)
        assert exc.value.code == 503
        assert int(exc.value.headers["Retry-After"]) >= 1
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("frames", ["float32", "int16"])
def test_streaming_wav_writer_bytes_match_the_reference(frames):
    """The port's copy of the streaming writer emits the JAX package's bytes
    for the same frames (float frames are clip-scaled, int16 pass through)."""
    rng = np.random.default_rng(8)
    chunks = [rng.standard_normal(1920).astype(np.float32) * 0.6 for _ in range(5)]
    if frames == "int16":
        chunks = [(np.clip(c, -1, 1) * 32767).astype(np.int16) for c in chunks]
    outs = []
    for cls in (StreamingWAVWriter, JaxStreamingWAVWriter):
        buf = io.BytesIO()
        writer = cls(buf, 24000)
        writer.write_header(24000)
        for c in chunks:
            writer.write_pcm_data(c)
        writer.finalize()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0]) == 44 + 2 * (5 * 1920 + 4800)


def test_server_cli_keeps_the_reference_flags():
    """The reference's flags and defaults, plus --param-dtype and --device
    (default cuda)."""
    args = server_module.build_parser().parse_args([])
    assert (args.host, args.port, args.slots, args.segment_frames, args.max_pending) == (
        "127.0.0.1", 8080, 8, 4, None)
    assert args.device == "cuda" and args.param_dtype == "float32"


def test_server_kv_int8_flag_builds_an_int8_kv_model(monkeypatch):
    """--kv-int8, the counterpart of the JAX server's POCKET_TTS_KV_INT8,
    loads the model with kv_int8=True, so the engine's caches are int8 rows
    with per-row scales; without it the model keeps kv_int8=False."""
    assert not server_module.build_parser().parse_args([]).kv_int8
    loaded, engines = [], []

    def load_model(**kw):
        loaded.append(kw)
        return _tiny_model(5, kv_int8=kw["kv_int8"])

    class Engine(TTSEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    class NoServer:
        def __init__(self, address, handler):
            self.address = address

        def serve_forever(self):
            pass

    monkeypatch.setattr(TTSModel, "load_model", staticmethod(load_model))
    monkeypatch.setattr(server_module, "TTSEngine", Engine)
    monkeypatch.setattr(server_module, "ThreadingHTTPServer", NoServer)
    assert server_module.main(["--kv-int8", "--device", "cpu", "--slots", "2", "--param-dtype", "int8"]) == 0
    engines[0].stop()
    assert loaded == [{"param_dtype": "int8", "device": "cpu", "kv_int8": True}]
    assert engines[0].model.kv_int8
    layer = engines[0].flow_state["transformer"]["layers"][0]
    assert layer["k"].dtype == torch.int8 and layer["k_scale"].dtype == torch.float32
