"""Rank functions for tests/test_torch_engine_mesh.py's spawned worlds.

The ranks import this module by name, so it imports only the PyTorch port
(never jax, the JAX package or a test module); the test passes every input
and gets back numpy results. `serve` runs the engine cases on any model,
with or without a mesh, so the test's unsharded references take the same
steps.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from pocket_tts_tpu_torch.config.schema import Config
from pocket_tts_tpu_torch.models.text import FallbackWordTokenizer
from pocket_tts_tpu_torch.models.tts_model import TTSModel
from pocket_tts_tpu_torch.parallel.mesh import make_mesh
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from pocket_tts_tpu_torch.serving.server import make_handler

# The cases of tests/test_parallel.py's engine-on-a-mesh tests.
TICK = dict(slots=4, segment_frames=4, capacity=256, text_pad=16, warmup_frames=1)
TICK_TEXTS = ["alpha beta", "gamma delta epsilon", "zeta", "eta theta"]
PREEMPT = dict(slots=2, segment_frames=2, capacity=512, text_pad=32, warmup_frames=1, preempt_min_lead_s=-1e9,
               resume_urgent_lead_s=-1e9)
LONGS = ["A very long sentence with many many words to speak aloud today.",
         "Another equally long sentence that also has many words in it now."]
SHORTS = ["Quick interjection.", "Second interjection."]


def tiny_model(tiny: dict, params: dict, param_dtype="float32", mesh=None, kv_int8=False) -> TTSModel:
    """Temperature 0, one flow step, no clamp, EOS never (tests/test_parallel.py's
    _tiny_tts_model), random weights (so a predefined voice is synthetic)."""
    model = TTSModel.from_params(Config(**tiny), params, FallbackWordTokenizer(4000), param_dtype, device="cpu",
                                 mesh=mesh, temp=0.0, lsd_decode_steps=1, noise_clamp=None, eos_threshold=1e9,
                                 kv_int8=kv_int8)
    model.random_init = True
    return model


def _rank(engine) -> int:
    return 0 if engine.mesh is None else engine.mesh.rank


def tick_parity(model: TTSModel, prompt: np.ndarray) -> dict:
    """test_engine_mesh_tick_parity's run: the 4 texts, run(stop_when_idle=True)."""
    voice = model._state_from_prompt(torch.from_numpy(prompt))
    engine = TTSEngine(model, **TICK)
    k = engine.flow_state["transformer"]["layers"][0]["k"]
    if _rank(engine) != 0:
        engine.run()
        return {"k": tuple(k.shape)}
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in TICK_TEXTS]
    engine.run(stop_when_idle=True)
    return {"k": tuple(k.shape), "audio": [h.audio() for h in handles], "frames": engine.frames_dispatched}


def preemption_parity(model: TTSModel, prompt: np.ndarray) -> dict:
    """test_engine_mesh_preemption_parity's run: two long streams, three
    steps, two short arrivals that park both, then run to the end. Records
    each park's slot and each resume's slot by request."""
    voice = model._state_from_prompt(torch.from_numpy(prompt))
    engine = TTSEngine(model, **PREEMPT)
    store_k = tuple(engine._store_flow["transformer"]["layers"][0]["k"].shape)
    if _rank(engine) != 0:
        engine.run()
        return {"store_k": store_k}
    parked_from, moves = {}, []
    park, swap, restore = engine._execute_parks, engine._execute_swaps, engine._restore

    def parks(plan):
        parked_from.update({engine._slots[b].handle.request_id: b for b, _ in plan})
        park(plan)

    def swaps(plan):
        parked_from.update({engine._slots[b].handle.request_id: b for _, b, _ in plan})
        return swap(plan)

    def restored(parked, b):
        moves.append((parked.handle.request_id, parked_from[parked.handle.request_id], b))
        restore(parked, b)

    engine._execute_parks, engine._execute_swaps, engine._restore = parks, swaps, restored
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in LONGS]
    for _ in range(3):
        engine.step()
    handles += [engine.submit(t, voice, frames_after_eos=2) for t in SHORTS]
    engine.run(stop_when_idle=True)
    return {"store_k": store_k, "audio": [h.audio() for h in handles], "preemptions": engine.preemptions,
            "resumes": engine.resumes, "moves": moves}


def tick_counts(model: TTSModel, prompt: np.ndarray) -> dict:
    """Rank 0's collectives of an admission step and of two steady steps
    (4 frames each), by op:axis; the follower's of the whole session."""
    voice = model._state_from_prompt(torch.from_numpy(prompt))
    engine = TTSEngine(model, **TICK)
    mesh = engine.mesh
    if mesh.rank != 0:
        before = dict(mesh.counts)
        engine.step()  # follows until rank 0's stop()
        return {"session": {k: v - before.get(k, 0) for k, v in mesh.counts.items() if v - before.get(k, 0)}}
    engine.submit(TICK_TEXTS[1], voice, frames_after_eos=2)
    start = dict(mesh.counts)
    ticks = []
    for _ in range(3):
        before = dict(mesh.counts)
        engine.step()
        ticks.append({k: v - before.get(k, 0) for k, v in mesh.counts.items() if v - before.get(k, 0)})
    engine.stop()  # no run() under way: ends the followers' step()
    session = {k: v - start.get(k, 0) for k, v in mesh.counts.items() if v - start.get(k, 0)}
    return {"ticks": ticks, "session": session, "first_segment_frames": engine.first_segment_frames}


def follower_submit_raises(model: TTSModel, prompt: np.ndarray) -> bool:
    """submit() on a follower raises; rank 0's stop() then ends the
    followers' run() with nothing planned."""
    voice = model._state_from_prompt(torch.from_numpy(prompt))
    engine = TTSEngine(model, **TICK)
    if engine.mesh.rank == 0:
        engine.stop()
        return True
    try:
        engine.submit("hello", voice)
    except RuntimeError as exc:
        raised = "only rank 0" in str(exc)
    else:
        raised = False
    engine.run()
    return raised


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, b""


def server(model: TTSModel) -> dict:
    """Rank 0 serves 2 concurrent GETs for a predefined voice and one for an
    unknown voice through make_handler while every rank runs the engine;
    rank 0's stop() ends every rank's run()."""
    engine = TTSEngine(model, slots=2, segment_frames=4, capacity=512, text_pad=32, emit_pcm16=True)
    if engine.mesh.rank != 0:
        engine.run(stop_when_idle=False)
        return {"named": sorted(engine._named)}
    thread = engine.serve_forever_in_thread()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(model, engine))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}/tts?"
    results = {}

    def fetch(i):
        results[i] = _get(url + urllib.parse.urlencode({"text": f"Request number {i} is here.", "voice": "alba"}))

    fetchers = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in fetchers:
        t.start()
    for t in fetchers:
        t.join()
    unknown = _get(url + urllib.parse.urlencode({"text": "Hello there.", "voice": "nobody"}))[0]
    engine.stop()
    thread.join(timeout=120)
    httpd.shutdown()
    return {"responses": [results[i] for i in range(2)], "unknown": unknown, "named": sorted(engine._named),
            "stopped": not thread.is_alive()}


def world(tiny: dict, params: dict, prompt: np.ndarray) -> dict:
    """Every case of the test on one (dp=2, tp=2) world of 4 ranks."""
    mesh = make_mesh(2, 2, "cpu")
    model = tiny_model(tiny, params, mesh=mesh)
    out = {"tick": tick_parity(model, prompt), "preempt": preemption_parity(model, prompt),
           "counts": tick_counts(model, prompt), "submit_raises": follower_submit_raises(model, prompt),
           "server": server(model)}
    model8 = tiny_model(tiny, params, "int8", mesh=mesh, kv_int8=True)
    out["int8"] = tick_parity(model8, prompt)
    out["counts_int8"] = tick_counts(model8, prompt)
    return out


def fail_mid_tick(tiny: dict, params: dict, prompt: np.ndarray) -> None:
    """A (dp=1, tp=2) engine whose rank 1 raises in its second segment."""
    model = tiny_model(tiny, params, mesh=make_mesh(1, 2, "cpu"))
    voice = model._state_from_prompt(torch.from_numpy(prompt))
    engine = TTSEngine(model, **TICK)
    if engine.mesh.rank == 1:
        segment, calls = engine._op_segment, []

        def failing(*args):
            calls.append(1)
            if len(calls) == 2:
                raise ValueError("rank one fails mid-tick on purpose")
            segment(*args)

        engine._op_segment = failing
        engine.run()
        return
    engine.submit(TICK_TEXTS[0], voice)
    engine.run()
