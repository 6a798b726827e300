"""The probe kernels' plain versions (ops/probes.py, the wrappers' CPU
route) against the JAX kernel bodies of scripts/mosaic_probe.py, which run
here through pl.pallas_call(..., interpret=True) with the script's own grid
specs. Inputs: the script's, and seeded random ones."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pocket_tts_tpu_torch import probes
from pocket_tts_tpu_torch.ops.probes import (
    head_slice_weighted_sum,
    head_slice_weighted_sum_reference,
    row_write,
)

_SPEC = importlib.util.spec_from_file_location(
    "mosaic_probe", Path(__file__).resolve().parent.parent / "scripts" / "mosaic_probe.py")
mosaic_probe = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(mosaic_probe)
C, E = mosaic_probe.C, mosaic_probe.E


def jax_row_write(cache: np.ndarray, newrow: np.ndarray, qw: int) -> np.ndarray:
    """k_p1 with probe_p1's grid spec and aliasing, interpreted on the CPU."""
    grid = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.MemorySpace.ANY), pl.BlockSpec((1, E), lambda i, qw: (0, 0))],
        out_specs=[pl.BlockSpec(memory_space=pltpu.MemorySpace.ANY)],
        scratch_shapes=[pltpu.VMEM((8, E), jnp.bfloat16), pltpu.SemaphoreType.DMA],
    )
    fn = pl.pallas_call(mosaic_probe.k_p1, grid_spec=grid, out_shape=[jax.ShapeDtypeStruct((C, E), jnp.bfloat16)],
                        input_output_aliases={1: 0}, interpret=True)
    (out,) = fn(jnp.array([qw], jnp.int32), jnp.asarray(cache, jnp.bfloat16), jnp.asarray(newrow, jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32))


def jax_head_slice_weighted_sum(x: np.ndarray) -> np.ndarray:
    """k_p2 as probe_p2 calls it, interpreted on the CPU."""
    fn = pl.pallas_call(mosaic_probe.k_p2, out_shape=jax.ShapeDtypeStruct((C, 64), jnp.float32), interpret=True)
    return np.asarray(fn(jnp.asarray(x, jnp.bfloat16)))


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 values to bf16 (as float32), the inputs' precision."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _cases():
    rng = np.random.default_rng(404)
    script_cache = np.arange(C * E, dtype=np.float32).reshape(C, E) % 13
    script_row = np.arange(E, dtype=np.float32) % 31 + 100.0
    yield "script", script_cache, script_row, 13
    for qw in (0, 7, 8, 63):
        yield f"random-{qw}", _bf16(rng.standard_normal((C, E)).astype(np.float32) * 4), \
            _bf16(rng.standard_normal(E).astype(np.float32) * 4), qw


@pytest.mark.parametrize("name,cache,row,qw", list(_cases()), ids=lambda v: v if isinstance(v, str) else "")
def test_row_write_matches_jax_kernel(name, cache, row, qw):
    want = jax_row_write(cache, row[None, :], qw)
    t_cache = torch.from_numpy(cache).to(torch.bfloat16)
    before = t_cache.clone()
    launches = row_write.launches
    got = row_write(t_cache, torch.from_numpy(row).to(torch.bfloat16), torch.tensor([qw], dtype=torch.int32))
    assert row_write.launches == launches  # CPU tensors: the plain version, no launch
    assert got is t_cache  # in place: the wrapper returns the cache it wrote
    np.testing.assert_array_equal(got.float().numpy(), want)  # bit-equal: a copy of bf16 values
    others = torch.arange(C) != qw
    assert torch.equal(got[others], before[others])


@pytest.mark.parametrize("kind", ["script", "random"])
def test_head_slice_weighted_sum_matches_jax_kernel(kind):
    if kind == "script":
        x = np.arange(C * E, dtype=np.float32).reshape(C, E) % 97
    else:
        x = _bf16(np.random.default_rng(97).standard_normal((C, E)).astype(np.float32) * 3)
    want = jax_head_slice_weighted_sum(x)
    launches = head_slice_weighted_sum.launches
    got = head_slice_weighted_sum(torch.from_numpy(x).to(torch.bfloat16), 16, 64)
    assert head_slice_weighted_sum.launches == launches
    assert got.shape == (C, 64) and got.dtype == torch.float32
    # float32 sums of 16 bf16 x small-integer products (each exact); another
    # summation order could move the last bits only.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = head_slice_weighted_sum_reference(torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(ref, got)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: it drives the
    wrappers' kernel route with the library replaced by a stub."""

    @property
    def is_cuda(self):
        return True


def test_wrappers_launch_count_and_raise_on_the_kernel_route(monkeypatch):
    """On a CUDA tensor each wrapper calls its C entry point once, counts the
    launch, and raises when the entry point reports a CUDA error; it never
    falls back to the plain version. Bad shapes raise before any route."""
    from pocket_tts_tpu_torch.ops import _cuda

    class Lib:
        err = 0

        def ptt_row_write(self, *args):
            calls.append(("row_write", args[3:5]))
            return self.err

        def ptt_head_slice_weighted_sum(self, *args):
            calls.append(("head_slice_weighted_sum", args[2:5]))
            return self.err

    calls, lib = [], Lib()
    monkeypatch.setattr(_cuda, "check_device", lambda: None)
    monkeypatch.setattr(_cuda, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "library", lambda name: lib if name == "probes" else None)
    cache = torch.zeros(16, 64, dtype=torch.bfloat16).as_subclass(_OnCard)
    row = torch.ones(64, dtype=torch.bfloat16).as_subclass(_OnCard)
    index = torch.tensor([3], dtype=torch.int32).as_subclass(_OnCard)
    x = torch.zeros(16, 16 * 64, dtype=torch.bfloat16).as_subclass(_OnCard)
    n_row, n_sum = row_write.launches, head_slice_weighted_sum.launches
    assert row_write(cache, row, index) is cache
    assert head_slice_weighted_sum(x).shape == (16, 64)
    assert calls == [("row_write", (16, 64)), ("head_slice_weighted_sum", (16, 16, 64))]
    assert (row_write.launches, head_slice_weighted_sum.launches) == (n_row + 1, n_sum + 1)
    assert not cache.any()  # the stub wrote nothing: no plain version ran
    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        row_write(cache, row, index)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        head_slice_weighted_sum(x)
    with pytest.raises(ValueError, match="row_write takes"):
        row_write(cache, row[:7], index)
    with pytest.raises(ValueError, match="head_slice_weighted_sum takes"):
        head_slice_weighted_sum(x[:, :100])


def test_probe_entry_point_on_the_cpu(capsys):
    """python -m pocket_tts_tpu_torch.probes --device cpu runs both probes on
    the script's inputs through the plain versions; without --device it asks
    for the card."""
    launches = (row_write.launches, head_slice_weighted_sum.launches)
    assert probes.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["P2 per-head slice weighted sum: OK", "P1 in-place row write at a device index: OK"]
    assert (row_write.launches, head_slice_weighted_sum.launches) == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probes.main([])
