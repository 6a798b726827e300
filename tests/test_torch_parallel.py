"""The port's parallel/ (torch.distributed, one process per rank) against the
JAX package's parallel/ (GSPMD over the 8 virtual CPU devices), at the tiny
config in float32 unless stated.

The sharded cases run once, on one world of 4 ranks over gloo (dp=2, tp=2;
a module-scoped fixture that returns numpy results, rank functions in
tests/torch_parallel_worker.py); each test then reads its part. Tolerances:
the port sharded against the port unsharded at JAX's own mesh tolerance
(rtol 1e-4, atol 2e-5; tests/test_parallel.py:95, :189), against JAX at the
port-vs-JAX tolerance of the batch tests (float32: 1e-4 of the peak;
tests/test_torch_batch.py), the train step at tests/test_torch_training.py's
(loss rel 1e-5; gradients atol 1e-5 + rtol 1e-4).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_worker as worker
from pocket_tts_tpu.models.flow_lm import FlowLMModel as JFlowLM
from pocket_tts_tpu.models.generate import initial_carry as jax_initial_carry
from pocket_tts_tpu.models.generate import make_segment_fn
from pocket_tts_tpu.models.mimi import MimiModel as JMimi
from pocket_tts_tpu.models.weights import cast_serving_dtype as jax_cast
from pocket_tts_tpu.models.weights import quantize_int8 as jax_quantize_int8
from pocket_tts_tpu.parallel.mesh import _param_spec_for_path, make_mesh as jax_make_mesh
from pocket_tts_tpu.parallel.mesh import shard_batch_tree as jax_shard_batch_tree
from pocket_tts_tpu.parallel.mesh import shard_params as jax_shard_params
from pocket_tts_tpu.parallel.mesh import state_sharding_spec as jax_state_spec
from pocket_tts_tpu.training.flow_matching import flow_matching_loss as jax_loss
from pocket_tts_tpu_torch.config.schema import Config as TConfig
from pocket_tts_tpu_torch.models.flow_lm import FlowLMModel
from pocket_tts_tpu_torch.models.mimi import MimiModel
from pocket_tts_tpu_torch.models.weights import named_leaves, params_from_jax
from pocket_tts_tpu_torch.ops.attention import _project_qkv
from pocket_tts_tpu_torch.ops.norms import layer_norm
from pocket_tts_tpu_torch.ops.rope import apply_rope, rope_angles
from pocket_tts_tpu_torch.parallel.dryrun import DRYRUN_TEXTS, dryrun_multichip, summarize
from pocket_tts_tpu_torch.parallel.launch import launch
from pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_grid,
    param_spec_for_path,
    shard_batch_tree,
    shard_leaf,
    state_sharding_spec,
)
from pocket_tts_tpu_torch.serving.engine import TTSEngine
from tiny_config import TINY, tiny_config

TEXTS = ["hello world", "the quick brown fox", "one two three four", "ok"]  # tests/test_parallel.py:178
B, S = 4, 3


def _jax_models():
    cfg = tiny_config()
    fl = JFlowLM(config=cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    return fl, JMimi(config=cfg.mimi)


@pytest.fixture(scope="module")
def port_params():
    """The port's seeded init of the tiny model (the JAX init takes tens of
    seconds on one core: each op compiles)."""
    cfg = TConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    flow_lm = FlowLMModel(cfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension, speaker_dim=cfg.mimi.seanet.dimension)
    return {"flow_lm": flow_lm.init_params(gen), "mimi": MimiModel(cfg.mimi).init_params(gen)}


def _convtr_to_jax(w: np.ndarray) -> np.ndarray:
    """Torch ConvTranspose layout (in, out/g, k) -> the JAX package's (out,
    in/g, k), flipped: the inverse of weights._convtr_to_torch for a dense
    (in/g > 1) or depthwise (out/g == 1 == in/g) weight."""
    cin, cout_per_g, k = w.shape
    groups = cin if cout_per_g == 1 else 1
    w = np.transpose(w.reshape(groups, cin // groups, cout_per_g, k), (0, 2, 1, 3))
    return np.ascontiguousarray(w.reshape(groups * cout_per_g, cin // groups, k)[:, :, ::-1])


def _to_jax(tree, path=""):
    if isinstance(tree, dict):
        return {k: _to_jax(v, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v, f"{path}.{i}") for i, v in enumerate(tree)]
    arr = tree.numpy()
    return jnp.asarray(_convtr_to_jax(arr) if path.endswith("convtr.weight") else arr)


@pytest.fixture(scope="module")
def jax_params(port_params):
    """The same weights in the JAX package's tree (its init's structure)."""
    fl, mimi = _jax_models()
    tree = _to_jax(port_params)
    shapes = {"flow_lm": jax.eval_shape(fl.init_params, jax.random.PRNGKey(0)),
              "mimi": jax.eval_shape(mimi.init_params, jax.random.PRNGKey(0))}
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(shapes)))
    back = dict(named_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, tree))))
    assert all(torch.equal(back[name], leaf) for name, leaf in named_leaves(port_params))
    return tree


def _jax_tts_model(params, mesh):
    """tests/test_parallel.py's _tiny_tts_model(mesh) on these weights."""
    from pocket_tts_tpu.models.text import FallbackWordTokenizer
    from pocket_tts_tpu.models.tts_model import TTSModel as JTTSModel

    fl, mimi = _jax_models()
    return JTTSModel(flow_lm=fl, mimi=mimi, params=jax_shard_params(mesh, params),
                     tokenizer=FallbackWordTokenizer(4000), temp=0.0, lsd_decode_steps=1, noise_clamp=None,
                     eos_threshold=1e9, config=tiny_config(), seed=0, mesh=mesh)


def _inputs():
    dim, ldim = TINY["flow_lm"]["transformer"]["d_model"], TINY["mimi"]["quantizer"]["dimension"]
    rng = np.random.default_rng(12)
    key = jax.random.PRNGKey(13)
    k_tau, k_t, k_eps = jax.random.split(key, 3)  # as the JAX loss splits its rng
    Tl = 5
    eos = np.zeros((B, Tl), np.float32)
    eos[:, -1] = 1.0
    train = {
        "tokens": rng.integers(0, 4000, (B, 6)).astype(np.int64), "eos": eos,
        "latents": rng.standard_normal((B, Tl, ldim)).astype(np.float32),
        "tau": np.asarray(jax.random.uniform(k_tau, (B, Tl, 1))), "u": np.asarray(jax.random.uniform(k_t, (B, Tl, 1))),
        "eps": np.asarray(jax.random.normal(k_eps, (B, Tl, ldim))),
    }
    return {
        "wave": (rng.standard_normal(12000) * 0.1).astype(np.float32),  # 0.5 s to clone
        "emb": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, 6, dim), jnp.float32)),
        "voice": np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 8, dim), jnp.float32) * 0.02),  # _voice
        "texts": TEXTS, "train": train, "train_key": key,
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(port_params, tmp_path_factory):
    """One (dp=2, tp=2) world of 4 gloo ranks on the CPU: every rank's
    results (rank 0's hold the whole batch) and the directory it wrote in."""
    tmp = tmp_path_factory.mktemp("world")
    config = tmp / "tiny.yaml"
    config.write_text(yaml.safe_dump(TINY))
    inputs = {k: v for k, v in INPUTS.items() if k != "train_key"}
    inputs["config"] = str(config)
    ranks = launch(worker.world, 4, (TINY, port_params, inputs, str(tmp)), device_type="cpu", timeout=600)
    return ranks, tmp


# ---------------------------------------------------------------- layout and rules


@pytest.mark.parametrize("dp,tp", [(4, 2), (8, 1), (2, 2), (1, 4)])
def test_mesh_grid_matches_jax(dp, tp):
    """Rank d * tp + t sits at (d, t): jax's make_mesh reshapes the device
    list the same way (device i of the 8 virtual CPU devices is rank i)."""
    devices = jax_make_mesh(dp=dp, tp=tp).devices
    assert [[d.id for d in row] for row in devices] == mesh_grid(dp, tp)


@pytest.mark.parametrize("shape", worker.MESH_SHAPES)
def test_make_mesh_coordinates_and_groups(world, shape):
    """make_mesh's coordinates and process groups on each of the 4 ranks
    are mesh_grid's: a rank's tp group is its row, its dp group its column."""
    grid = mesh_grid(*shape)
    for rank, out in enumerate(world[0]):
        (d, t), dp_group, tp_group = out["layouts"][shape]
        assert grid[d][t] == rank
        assert tp_group == grid[d] and dp_group == [row[t] for row in grid]


def test_make_mesh_needs_a_world_of_dp_times_tp():
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_mesh(2, 2, "cpu")


def _jax_paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield [getattr(p, "key", getattr(p, "idx", None)) for p in path], leaf


@pytest.mark.parametrize("param_dtype", ["float32", "int8"])
def test_param_spec_matches_jax_on_every_leaf(jax_params, param_dtype):
    """FlowLM and Mimi, the float32 tree and its bf16 + int8 serving tree:
    the axis the port splits over tp is where JAX's spec puts "tp"."""
    jp = jax_params if param_dtype == "float32" else jax_quantize_int8(jax_cast(jax_params, jnp.bfloat16))
    port = dict(named_leaves(params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp))))
    n_split = 0
    for keys, leaf in _jax_paths(jp):
        spec = tuple(_param_spec_for_path([types.SimpleNamespace(key=k) for k in keys], leaf))
        want = spec.index("tp") if "tp" in spec else None
        got = param_spec_for_path(keys, port[".".join(map(str, keys))])
        assert got == want, (keys, spec)
        n_split += got is not None
    # in_proj, out_proj, linear1, linear2 of each layer: 2 FlowLM layers and
    # Mimi's decoder and encoder layers; int8 (FlowLM only) adds the split
    # scales of in_proj and linear1.
    flow, mimi = TINY["flow_lm"]["transformer"]["num_layers"], 2 * TINY["mimi"]["transformer"]["num_layers"]
    assert n_split == 4 * (flow + mimi) + (2 * flow if param_dtype == "int8" else 0)


def _states(batch):
    cfg = tiny_config()
    jfl, jmimi = _jax_models()
    tcfg = TConfig(**TINY)
    tfl = FlowLMModel(tcfg.flow_lm, latent_dim=cfg.mimi.quantizer.dimension)
    tmimi = MimiModel(tcfg.mimi)
    return [(jfl.init_state(batch, 64), tfl.init_state(batch, 64)),
            (jfl.init_state(batch, 64, dtype=jnp.int8), tfl.init_state(batch, 64, dtype=torch.int8)),
            (jmimi.init_decode_state(batch), tmimi.init_decode_state(batch))]


@pytest.mark.parametrize("batch,dp,tp", [(4, 2, 2), (1, 2, 2), (4, 4, 4), (3, 2, 1)])
def test_state_sharding_spec_matches_jax(batch, dp, tp):
    """Flow states (bf16 and int8 caches) and the Mimi state; B=1 and B=3
    on dp=2 fall back to whole batches, as in JAX. The port keeps `pos` and
    `widx` of the flow state on the host (not compared)."""
    jspec, tspec = jax_state_spec(batch, dp, tp), state_sharding_spec(batch, dp, tp)
    for jstate, tstate in _states(batch):
        port = dict(named_leaves(tstate))
        for keys, leaf in _jax_paths(jstate):
            name = ".".join(map(str, keys))
            if name in port:
                assert tspec(port[name]) == tuple(jspec(leaf)), name


def test_state_sharding_spec_raises_where_tp_splits_a_head():
    """tp=3 does not divide the 4 heads: JAX replicates the cache (GSPMD
    splits the heads' math), the port needs whole heads and raises."""
    jstate, tstate = _states(4)[0]
    assert tuple(jax_state_spec(4, 2, 3)(jstate["transformer"]["layers"][0]["k"])) == ("dp", None, None, None)
    with pytest.raises(ValueError, match="tp=3"):
        state_sharding_spec(4, 2, 3)(tstate["transformer"]["layers"][0]["k"])
    with pytest.raises(ValueError, match="whole heads"):
        worker.tiny_model(TINY, {}, mesh=Mesh(dp=1, tp=3))


def test_shard_leaf_parts_rebuild_every_leaf(port_params):
    """The tp=2 parts of every leaf, concatenated along its split axis, are
    the leaf; unsplit leaves are whole on both ranks."""
    meshes = [Mesh(dp=1, tp=2, tp_rank=t) for t in (0, 1)]
    for name, leaf in named_leaves(port_params):
        keys = name.split(".")
        parts = [shard_leaf(m, keys, leaf) for m in meshes]
        axis = param_spec_for_path(keys, leaf)
        whole = parts[0] if axis is None else torch.cat(parts, dim=axis)
        assert torch.equal(whole, leaf), name
        if axis is None:
            assert torch.equal(parts[1], leaf)


def test_shard_batch_tree_cuts_each_leaf_by_the_spec():
    """Rank (1, 1) of dp=2 x tp=2 takes streams 2-3 of a flow state built on
    its mesh (the caches hold its 2 heads already and keep them; the layers
    keep one shared slot_pos; the host positions are cut too) and of the
    Mimi state; B=3 does not split over dp=2 and stays whole."""
    mesh = Mesh(dp=2, tp=2, dp_rank=1, tp_rank=1)
    tcfg = TConfig(**TINY)
    fl = FlowLMModel(tcfg.flow_lm, latent_dim=8, mesh=mesh)
    tstate = fl.init_state(4, 64, dtype=torch.int8)
    for i, layer in enumerate(tstate["transformer"]["layers"]):
        for name in ("k", "v", "k_scale"):
            layer[name].copy_(torch.arange(layer[name].numel()).reshape(layer[name].shape) + i)
    tstate["pos"] = [5, 6, 7, 8]
    part = shard_batch_tree(mesh, tstate, 4)
    layers, whole = part["transformer"]["layers"], tstate["transformer"]["layers"]
    for name in ("k", "v"):
        assert whole[1][name].shape == (4, 64, 2, 16)
        assert torch.equal(layers[1][name], whole[1][name][2:4]) and layers[1][name].is_contiguous()
    assert torch.equal(layers[0]["k_scale"], whole[0]["k_scale"][2:4])
    assert layers[0]["slot_pos"] is layers[1]["slot_pos"] and part["pos"] == [7, 8]
    mimi = shard_batch_tree(mesh, MimiModel(tcfg.mimi, mesh).init_decode_state(4), 4)
    assert mimi["decoder_transformer"]["layers"][0]["k"].shape == (2, 256, 2, 12)
    odd = shard_batch_tree(mesh, fl.init_state(3, 64), 3)
    assert odd["transformer"]["layers"][0]["k"].shape == (3, 64, 2, 16) and odd["pos"] == [0, 0, 0]


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_shard_then_gather_is_bit_exact(world, kind):
    assert all(out[f"gather_exact_{kind}"] for out in world[0])


# ---------------------------------------------------------------- the sharded paths


def _jax_segment(jax_params, mesh):
    fl, mimi = _jax_models()
    emb = jnp.asarray(INPUTS["emb"])
    segment = make_segment_fn(fl, mimi, 1, None, S)
    params, flow_state, mimi_state = jax_params, fl.init_state(B, 128), mimi.init_decode_state(B)
    carry = jax_initial_carry(fl, B, [3] * B, [S] * B)
    with mesh:
        params = jax_shard_params(mesh, params)
        flow_state, mimi_state, carry = (jax_shard_batch_tree(mesh, t, B) for t in (flow_state, mimi_state, carry))
        flow_state = jax.jit(fl.prefill)(params["flow_lm"], flow_state, emb, jnp.full((B,), 6, jnp.int32))
        out = jax.jit(segment)(params, flow_state, mimi_state, carry, jax.random.PRNGKey(2), jnp.float32(0.0),
                               jnp.float32(1e9))
    return np.asarray(out[3])


def test_sharded_segment_matches_unsharded_and_jax(world, jax_params, port_params):
    """Prefill, a 3-frame segment and the Mimi vocode of 4 streams on dp=2
    x tp=2, against the port unsharded and JAX on make_mesh(dp=2, tp=2)."""
    got = world[0][0]["segment"]
    ref = worker.segment(TINY, port_params, INPUTS["emb"], S)
    assert got.shape == ref.shape == (B, S, 1920)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
    jax_ref = _jax_segment(jax_params, jax_make_mesh(dp=2, tp=2))
    np.testing.assert_allclose(got, jax_ref, rtol=0, atol=1e-4 * np.abs(jax_ref).max())


def test_generate_audio_batch_matches_jax_on_the_mesh(world, jax_params, port_params):
    """tests/test_parallel.py's four texts through TTSModel(mesh=) on both
    sides: the port on 4 ranks, JAX's _tiny_tts_model(mesh) (its voice,
    tests/test_parallel.py's _voice)."""
    jm = _jax_tts_model(jax_params, jax_make_mesh(dp=2, tp=2))
    ref = jm.generate_audio_batch(jm._state_from_prompt(jnp.asarray(INPUTS["voice"])), TEXTS)
    got = world[0][0]["batch"]
    model = worker.tiny_model(TINY, port_params)
    unsharded = model.generate_audio_batch(model._state_from_prompt(torch.tensor(INPUTS["voice"])), TEXTS)
    assert [g.shape for g in got] == [r.shape for r in ref] == [u.shape for u in unsharded]
    for g, r, u in zip(got, ref, unsharded):
        np.testing.assert_allclose(g, u, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


@pytest.fixture(scope="module")
def single_stream_ref(port_params):
    return worker.single_stream(worker.tiny_model(TINY, port_params), INPUTS)


@pytest.mark.parametrize("path", ["bulk", "stream", "clone"])
def test_single_stream_on_the_mesh_matches_unsharded(world, single_stream_ref, path):
    """generate_audio, generate_audio_stream and generate_audio from a cloned
    voice on a mesh model (one stream: whole on both dp ranks, its heads and
    feed-forward over tp) give the unsharded audio."""
    got, ref = world[0][0]["single"][path], single_stream_ref[path]
    assert got.shape == ref.shape and got.shape[0] % 1920 == 0 and got.shape[0] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)


def test_load_model_makes_the_mesh_from_dp_and_tp(world):
    """load_model(dp=2, tp=2) over the world that is up: the mesh, and
    linear1's rows split over tp (128 -> 64)."""
    assert all(out["load_model_dp_tp"] == ({"dp": 2, "tp": 2}, (64, 64)) for out in world[0])


def test_int8_kv_row_scales_span_every_head(world, port_params):
    """An int8-KV decode under tp=2: each row's scale is the absmax over all
    4 heads (the local maxima, then a max over tp), equal to the unsharded
    scales to float32 rounding. A rank-local max over its 2 heads misses
    that gate on every row whose max lies in the other rank's heads (about
    half of them), so the gate would catch one."""
    got = world[0][0]["int8_scales"]
    ref, _ = worker.decode(TINY, port_params, INPUTS["emb"], True)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-6, atol=0, err_msg=name)
    # Layer 0's prefill rows as one tp rank would scale them from its own heads.
    model = worker.tiny_model(TINY, port_params, "int8", kv_int8=True)
    fp, attn = model.params["flow_lm"], model.flow_lm.transformer.layer.self_attn
    lp = fp["transformer"]["layers"][0]
    x = layer_norm(torch.tensor(INPUTS["emb"]), lp["norm1"]["weight"], lp["norm1"]["bias"], eps=1e-5)
    _, k, _ = _project_qkv(lp["self_attn"], x, attn.num_heads, None)
    positions = torch.arange(6, dtype=torch.int32)[None].expand(B, 6)
    _, k = apply_rope(k, k, rope_angles(positions, attn.head_dim, attn.max_period))
    local = k.float().abs()[:, :, :2].amax(dim=(2, 3)).numpy() / 127.0
    full = ref["0.k_scale"][:, :6]
    np.testing.assert_allclose(k.float().abs().amax(dim=(2, 3)).numpy() / 127.0, full, rtol=2e-6)
    assert (np.abs(local - full) > 2e-6 * full).mean() > 0.25


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_decode_step_collectives(world, cache):
    """One FlowLM decode step on dp=2 x tp=2 (2 layers): the two reduces of
    each layer over tp (out_proj, linear2), plus one max over tp per layer
    for the int8 rows' scales (k and v together), and no all_gather: the
    port's form of tests/test_parallel.py's no-all-gather check."""
    counts = world[0][0][f"{cache}_counts"]
    layers = TINY["flow_lm"]["transformer"]["num_layers"]
    want = {"all_reduce_sum:tp": 2 * layers}
    if cache == "int8":
        want["all_reduce_max:tp"] = layers
    assert counts == want


def test_sharded_train_step_matches_unsharded_and_jax(world, jax_params, port_params):
    """One AdamW step with the noise passed in: the loss of the whole batch
    and each leaf's gathered gradient against the port unsharded, and the
    loss against JAX's with the same noise."""
    out, batch = world[0][0], INPUTS["train"]
    _, loss, grads = worker.train_step(TINY, port_params, batch)
    fl, _ = _jax_models()
    jloss, _ = jax_loss(fl, jax_params["flow_lm"], INPUTS["train_key"], jnp.asarray(batch["tokens"]),
                        jnp.asarray(batch["latents"]), jnp.asarray(batch["eos"]))
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(out["loss"], float(jloss), rtol=1e-5)
    assert out["grads"].keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(out["grads"][name], g, rtol=1e-4, atol=1e-5, err_msg=name)
    assert np.abs(grads["transformer.layers.0.linear1.weight"]).max() > 0


def test_train_state_saved_on_a_mesh_restores_unsharded(world, port_params):
    """save_train_state on 4 ranks writes one mesh-free file: restored into
    an unsharded template it gives the gathered params and Adam moments bit
    for bit; restored into a mesh template (on the ranks) it gives each
    rank's shards bit for bit."""
    from pocket_tts_tpu_torch.training import adamw, init_train_state, restore_train_state

    ranks, tmp = world
    assert all(out["restored_on_mesh_exact"] for out in ranks)
    model = worker.tiny_model(TINY, port_params)
    state = restore_train_state(tmp / "state.pt", init_train_state(model.flow_lm, model.params["flow_lm"],
                                                                   adamw(1e-3)))
    assert state.step == 1
    names = [n for n, _ in named_leaves(state.params)]
    for name, leaf in named_leaves(state.params):
        np.testing.assert_array_equal(leaf.detach().numpy(), ranks[0]["saved_params"][name], err_msg=name)
    for i, st in state.optimizer.state_dict()["state"].items():
        np.testing.assert_array_equal(st["exp_avg"].numpy(), ranks[0]["saved_exp_avg"][names[i]])


def test_model_checkpoint_export_on_a_mesh(world, port_params, tmp_path):
    """TTSModel.save_checkpoint on a mesh model gathers the shards and writes
    the unsharded model's file."""
    from pocket_tts_tpu_torch.utils.safetensors import load_safetensors

    ranks, tmp = world
    count = worker.tiny_model(TINY, port_params).save_checkpoint(tmp_path / "ref.safetensors")
    assert ranks[0]["export_count"] == count
    got, ref = load_safetensors(tmp / "export.safetensors"), load_safetensors(tmp_path / "ref.safetensors")
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(ref[name]), err_msg=name)


def test_no_collective_without_a_mesh(port_params, monkeypatch):
    """Unsharded, the model calls no collective."""
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called without a mesh")

    for name in ("all_reduce", "all_gather", "all_gather_object", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    model = worker.tiny_model(TINY, port_params, "int8", kv_int8=True)
    out = model.generate_audio_batch(model._state_from_prompt(torch.tensor(INPUTS["voice"])), TEXTS[:2])
    assert len(out) == 2


def test_engine_refuses_a_mesh_model():
    with pytest.raises(NotImplementedError, match="mesh"):
        TTSEngine(types.SimpleNamespace(mesh=Mesh(dp=2, tp=1), device=torch.device("cpu")))


# ---------------------------------------------------------------- launcher and dry run


def test_launch_and_dryrun_default_to_the_card(monkeypatch):
    """Without a card they raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        launch(worker.fail_on_rank_one, 2)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        dryrun_multichip(4)


@pytest.mark.parametrize("fn,message", [
    (worker.fail_on_rank_one, "rank 1 of 2 failed(.|\n)*rank one fails on purpose"),
    (worker.exit_on_rank_one, r"rank\(s\) \[1\] of 2 exited \(codes \[3\]\) without a result"),
])
def test_launch_raises_when_a_rank_fails_or_dies(fn, message):
    with pytest.raises(RuntimeError, match=message):
        launch(fn, 2, device_type="cpu", timeout=120)


def test_launch_names_the_ranks_of_a_hang():
    # Under load rank 0 may not have answered in 2 s either.
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[(0, )?1\] of 2 gave no result within 2 s"):
        launch(worker.sleep_on_rank_one, 2, device_type="cpu", timeout=2)


def test_dryrun_multichip_on_the_cpu(world):
    """dryrun_multichip's stages (dryrun_rank) on the module's world of 4 CPU
    ranks at the tiny config, and its summary: every stage runs on dp=2 x
    tp=2, no kernel launches (CPU tensors take the plain versions), and its
    batch audio equals the unsharded model's: at JAX's mesh tolerance with
    bf16 KV, within chip_smoke.py's TOL_MESH_AUDIO (3% of the stream's peak)
    with int8 KV."""
    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    ranks, tmp = world
    config = str(tmp / "tiny.yaml")
    out = summarize([r["dryrun"] for r in ranks], 2, 2, "cpu", config, 0.0)
    assert (out["dp"], out["tp"], out["backend"]) == (2, 2, "gloo")
    assert out["segment_audio"].shape == (4, 2, 1920) and np.isfinite(out["toy_loss"])
    assert all(n == 0 for rank in out["launches"] for kv in rank.values() for n in kv.values())
    for kv in ("bf16", "int8"):
        model = TTSModel.load_model(config, temp=0.0, eos_threshold=1e9, param_dtype="int8", device="cpu",
                                    kv_int8=kv == "int8")
        ref = model.generate_audio_batch(model.get_state_for_audio_prompt("alba"), DRYRUN_TEXTS)
        assert len(out["batch"][kv]) == len(ref)
        for g, r in zip(out["batch"][kv], ref):
            if kv == "bf16":
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=2e-5)
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=3e-2 * np.abs(r).max())
