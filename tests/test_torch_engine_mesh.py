"""The port's serving engine and HTTP server on a (dp=2, tp=2) mesh of 4
gloo ranks on the CPU, at the tiny config with the JAX engine's weights
(params_from_jax), temperature 0 and EOS disabled.

Every sharded case runs on one world (a module-scoped fixture; rank
functions in tests/torch_engine_mesh_worker.py); the unsharded references
run the same worker functions on a model without a mesh. Tolerances: the
sharded engine against the port's unsharded engine at JAX's own mesh gate
(rtol 1e-4, atol 2e-5; tests/test_parallel.py's engine-on-a-mesh tests),
against the JAX engine unsharded at tests/test_torch_engine_parity.py's
float32 gate (1e-4 of the peak); int8 weights and KV at that file's int8
gate (5% of the peak, frame energies within 5%).
"""

import io
import wave

import jax
import numpy as np
import pytest

import torch_engine_mesh_worker as worker
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.text import FallbackWordTokenizer as JTokenizer
from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel
from pocket_tts_tpu.serving.engine import TTSEngine as JTTSEngine
from pocket_tts_tpu_torch.models.weights import params_from_jax
from pocket_tts_tpu_torch.parallel.launch import launch
from tiny_config import TINY, tiny_config

PROMPT = np.random.default_rng(7).standard_normal((1, 8, TINY["flow_lm"]["transformer"]["d_model"])).astype(
    np.float32) * 0.02


@pytest.fixture(scope="module")
def jax_model():
    cfg = tiny_config()
    fl, mimi = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension), JMimi(config=cfg.mimi)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"flow_lm": fl.init_params(k1), "mimi": mimi.init_params(k2)}
    return JTTSModel(fl, mimi, params, JTokenizer(4000), temp=0.0, lsd_decode_steps=1, noise_clamp=None,
                     eos_threshold=1e9, config=cfg)


@pytest.fixture(scope="module")
def port_params(jax_model):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.params))


@pytest.fixture(scope="module")
def world(port_params):
    """Every rank's results of tests/torch_engine_mesh_worker.world."""
    return launch(worker.world, 4, (TINY, port_params, PROMPT), device_type="cpu", timeout=600)


def _unsharded(port_params, case, param_dtype="float32", kv_int8=False):
    return case(worker.tiny_model(TINY, port_params, param_dtype, kv_int8=kv_int8), PROMPT)


def _jax_serve(jax_model, kw, first, later=(), steps=0):
    import jax.numpy as jnp

    voice = jax_model._state_from_prompt(jnp.asarray(PROMPT))
    engine = JTTSEngine(jax_model, **kw)
    handles = [engine.submit(t, voice, frames_after_eos=2) for t in first]
    for _ in range(steps):
        engine.step()
    handles += [engine.submit(t, voice, frames_after_eos=2) for t in later]
    engine.run(stop_when_idle=True)
    return [np.asarray(h.audio()) for h in handles]


def _assert_mesh_close(got, unsharded, ref_jax=None):
    assert [g.shape for g in got] == [u.shape for u in unsharded]
    for g, u in zip(got, unsharded):
        assert g.shape[0] > 0 and g.shape[0] % 1920 == 0 and np.isfinite(g).all()
        np.testing.assert_allclose(g, u, rtol=1e-4, atol=2e-5)
    if ref_jax is not None:
        assert [g.shape for g in got] == [r.shape for r in ref_jax]
        for g, r in zip(got, ref_jax):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_engine_mesh_tick_parity(world, port_params, jax_model):
    """tests/test_parallel.py's test_engine_mesh_tick_parity: 4 slots over
    dp=2 (2 a rank), the 4 texts through run(stop_when_idle=True)."""
    got = world[0]["tick"]["audio"]
    ref = _unsharded(port_params, worker.tick_parity)["audio"]
    ref_jax = _jax_serve(jax_model, worker.TICK, worker.TICK_TEXTS)
    _assert_mesh_close(got, ref, ref_jax)


def test_engine_mesh_preemption_parity(world, port_params, jax_model):
    """test_engine_mesh_preemption_parity: 2 slots (one a dp rank), the two
    short arrivals park both long streams, which resume when a slot frees."""
    out = world[0]["preempt"]
    assert out["preemptions"] >= 2 and out["resumes"] >= 2
    ref = _unsharded(port_params, worker.preemption_parity)
    assert (ref["preemptions"], ref["resumes"]) == (out["preemptions"], out["resumes"])
    ref_jax = _jax_serve(jax_model, worker.PREEMPT, worker.LONGS, worker.SHORTS, steps=3)
    _assert_mesh_close(out["audio"], ref["audio"], ref_jax)


def test_engine_mesh_resumes_a_stream_on_the_other_dp_rank(world):
    """The parking store spans dp: a stream parked from a slot of one dp
    rank resumes into a slot of the other (slot b sits on dp rank b // 1)."""
    moves = world[0]["preempt"]["moves"]
    assert any(src != dst for _, src, dst in moves), moves


def test_engine_mesh_int8_kv_matches_unsharded(world, port_params):
    """int8 weights and int8 KV (the row scales' max over tp): the tick
    case against the same engine unsharded at the int8 gate."""
    got = world[0]["int8"]["audio"]
    ref = _unsharded(port_params, worker.tick_parity, "int8", kv_int8=True)["audio"]
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        peak = np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=0, atol=0.05 * peak)
        e_got, e_ref = (np.sqrt((a.reshape(-1, 1920) ** 2).mean(1)) for a in (g, r))
        np.testing.assert_allclose(e_got, e_ref, rtol=0.05)


def test_engine_mesh_state_holds_this_ranks_slots_and_heads(world):
    """Each rank's slot caches hold its 2 of 4 slots and 2 of 4 heads; its
    parking store every lane (replicated over dp) on its heads."""
    d = TINY["flow_lm"]["transformer"]["d_model"] // TINY["flow_lm"]["transformer"]["num_heads"]
    for rank in world:
        assert rank["tick"]["k"] == (2, 256, 2, d)
        assert rank["preempt"]["store_k"] == (2, 512, 2, d)


def test_engine_mesh_rules(world):
    """submit() on a follower raises; rank 0's stop() with no run() under way
    ends the followers' loops (the world returned)."""
    assert all(rank["submit_raises"] for rank in world[1:])


def test_a_rank_that_raises_mid_tick_fails_the_launch(port_params):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one fails mid-tick on purpose"):
        launch(worker.fail_mid_tick, 2, (TINY, port_params, PROMPT), device_type="cpu", timeout=120)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_engine_mesh_collectives_per_tick(world, kind):
    """Rank 0's collectives by op:axis: one plan broadcast per tick, one dp
    gather per delivery, per decode step 2 tp reduces a FlowLM layer (and,
    with int8 KV, one max for the rows' scales), 2 a Mimi layer per
    segment, and a prefill of 2 a FlowLM layer at the admission tick (the
    warmed-up Mimi row is the model's, made by the world's first engine).
    Every follower took part in the same collectives."""
    out = world[0]["counts" if kind == "float32" else "counts_int8"]
    flow = TINY["flow_lm"]["transformer"]["num_layers"]
    mimi = TINY["mimi"]["transformer"]["num_layers"]
    frames = [out["first_segment_frames"], worker.TICK["segment_frames"], worker.TICK["segment_frames"]]
    for i, (tick, S) in enumerate(zip(out["ticks"], frames)):
        steps = S + (i == 0)  # the admission tick's prefill runs the backbone once more
        want = {"broadcast:world": 1, "all_gather:dp": 1,
                "all_reduce_sum:tp": 2 * flow * steps + 2 * mimi}
        if kind == "int8":
            want["all_reduce_max:tp"] = flow * steps
        assert tick == want, (i, tick)
    assert all(rank["counts" if kind == "float32" else "counts_int8"]["session"] == out["session"]
               for rank in world[1:])


def test_server_on_the_mesh(world):
    """make_handler on rank 0 while every rank runs the engine: 2 concurrent
    GETs for a predefined voice return whole WAVs of finite frames; the
    voice was made on every rank."""
    out = world[0]["server"]
    assert out["stopped"]
    for status, body in out["responses"]:
        assert status == 200
        w = wave.open(io.BytesIO(body))
        assert w.getframerate() == 24000 and w.getsampwidth() == 2 and w.getnchannels() == 1
        # whole 1920-sample frames plus the writer's 0.2 s of trailing silence
        samples = (len(body) - 44) // 2
        assert samples > 4800 and (samples - 4800) % 1920 == 0
        assert np.abs(np.frombuffer(body[44:-9600], dtype=np.int16)).max() > 0
    assert all(rank["server"]["named"] == ["alba"] for rank in world)


def test_unknown_voice_on_the_mesh_is_refused_without_a_plan_item(world):
    assert world[0]["server"]["unknown"] == 400
    assert all("nobody" not in rank["server"]["named"] for rank in world)
