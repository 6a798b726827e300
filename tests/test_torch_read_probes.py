"""The read probes' plain versions (ops/read_probes.py, the wrappers' CPU
route) against the JAX kernel bodies of benchmarks/bw_probe.py
(`make_reader`) and benchmarks/attn_micro.py (`variant_pallas_read`), run
here through pl.pallas_call(..., interpret=True) with the scripts' own grid
specs; the wrappers' kernel route with a stub library; both entry points on
the CPU.

Tolerance: both sides sum in float32 in the TPU kernels' block order, so
stream_read agrees to the last bit; kv_read_sum's per-block column sums
may be taken in another order by XLA and PyTorch, so it agrees to 1e-5
relative to the largest output.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import attn_micro, bw_probe
from pocket_tts_tpu_torch.ops.read_probes import (
    kv_read_sum,
    kv_read_sum_reference,
    stream_read,
    stream_read_reference,
)

ROOT = Path(__file__).resolve().parent.parent
_INTERPRET = functools.partial(jpl.pallas_call, interpret=True)


def _load_bw_probe():
    """benchmarks/bw_probe.py with a `pl` whose pallas_call interprets."""
    spec = importlib.util.spec_from_file_location("bw_probe_script", ROOT / "benchmarks" / "bw_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pl = types.SimpleNamespace(pallas_call=_INTERPRET, BlockSpec=jpl.BlockSpec,
                                      program_id=jpl.program_id, when=jpl.when)
    return module


BW_PROBE = _load_bw_probe()


def _variant_pallas_read(B: int, C: int):
    """variant_pallas_read, the function nested in attn_micro.main, taken out
    of the script with ast and bound to B, C, H, D, jax and jnp."""
    tree = ast.parse((ROOT / "benchmarks" / "attn_micro.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body if isinstance(n, ast.FunctionDef) and n.name == "variant_pallas_read")
    namespace = {"B": B, "C": C, "H": 16, "D": 64, "jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "attn_micro.py", "exec"), namespace)
    return namespace["variant_pallas_read"]


def _tok(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((8, 128)).astype(np.float32)


def _array(dtype: str, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-128, 128, (rows, 1024), dtype=np.int8)
    x = (rng.standard_normal((rows, 1024)) * 3).astype(np.float32)
    if dtype == "bfloat16":  # round to bf16 values, kept as float32 here
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


# (dtype, rows_total, blk_rows): blocks of at least the TPU tile's rows
# (32 int8, 16 bf16, 8 float32), one case with a partial last block.
STREAM_CASES = [
    ("int8", 256, 32), ("int8", 512, 128), ("int8", 300, 64),
    ("bfloat16", 256, 16), ("bfloat16", 512, 64),
    ("float32", 128, 8), ("float32", 512, 128),
]


@pytest.mark.parametrize("dtype,rows_total,blk_rows", STREAM_CASES)
def test_stream_read_matches_make_reader(dtype, rows_total, blk_rows):
    x, tok = _array(dtype, rows_total, seed=rows_total + blk_rows), _tok(blk_rows)
    # The script's sweep skips a partial last block; its grid (rows // blk) leaves it unread.
    used = rows_total // blk_rows * blk_rows
    reader = BW_PROBE.make_reader(used, blk_rows, getattr(jnp, dtype))
    want = np.asarray(reader(jnp.asarray(tok), jnp.asarray(x[:used], getattr(jnp, dtype))))
    launches = stream_read.launches
    got = stream_read(torch.from_numpy(tok), _torch(x, dtype), blk_rows)
    assert stream_read.launches == launches  # CPU tensors: the plain version, no launch
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stream_read_tail_is_not_read():
    """Rows past the last whole block change nothing, even NaN."""
    x = _torch(_array("bfloat16", 300, 3), "bfloat16")
    tok = torch.from_numpy(_tok(4))
    before = stream_read_reference(tok, x, 64)
    x[256:] = float("nan")
    assert torch.equal(stream_read(tok, x, 64), before)


# (B, C): whole 512-row blocks, and B=3, C=200: 600 rows, one block, 88 rows unread.
KV_CASES = [(2, 512), (4, 384), (3, 200)]


@pytest.mark.parametrize("B,C", KV_CASES)
def test_kv_read_sum_matches_variant_pallas_read(B, C, monkeypatch):
    captured = []

    def pallas_call(*args, **kwargs):
        call = _INTERPRET(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            captured.append(out)
            return out
        return run

    monkeypatch.setattr(jpl, "pallas_call", pallas_call)
    rng = np.random.default_rng(B * 1000 + C)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q = bf16(rng.standard_normal((B, 16, 1, 64)))
    k = bf16(rng.standard_normal((B, C, 16, 64)) * 2)
    v = bf16(rng.standard_normal((B, C, 16, 64)) * 2)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    ret = _variant_pallas_read(B, C)(jq, jk.reshape(B, C, 1024), jv.reshape(B, C, 1024))
    (want,) = captured
    want = np.asarray(want)
    tok = torch.nn.functional.pad(q[0, :8, 0, :].float(), (0, 64))  # the script's tok: [8, 64] padded to 128 lanes
    launches = kv_read_sum.launches
    got = kv_read_sum(tok, k.view(B * C, 1024), v.view(B * C, 1024))
    assert kv_read_sum.launches == launches
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # The port's attn_micro variant returns what the script's variant returns.
    t = {"kflat": k.view(B, C, 1024), "vflat": v.view(B, C, 1024), "k": k}
    port = attn_micro.variants(t)["pallas_read"](q)
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ret.astype(jnp.float32)), rtol=0, atol=2 ** -7)


def test_kv_read_sum_tail_is_not_read():
    k = torch.randn(600, 1024).to(torch.bfloat16)
    v = torch.randn(600, 1024).to(torch.bfloat16)
    tok = torch.from_numpy(_tok(5))
    before = kv_read_sum(tok, k, v)
    k[512:], v[512:] = float("nan"), float("nan")
    assert torch.equal(kv_read_sum(tok, k, v), before)
    assert torch.equal(kv_read_sum_reference(tok, k[:100], v[:100]), tok * 1e-20)  # no whole block: the carry


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: it drives the
    wrappers' kernel route with the library replaced by a stub."""

    @property
    def is_cuda(self):
        return True


def test_wrappers_launch_count_and_raise_on_the_kernel_route(monkeypatch):
    """On a CUDA tensor each wrapper calls its C entry point once with the
    dtype code, rows, block rows and grid, counts the launch, and raises
    when the entry point reports a CUDA error; it never falls back to the
    plain version. Bad shapes raise before any route."""
    from pocket_tts_tpu_torch.ops import _cuda, read_probes

    class Lib:
        err = 0

        def ptt_stream_read(self, *args):
            calls.append(("stream_read", args[1:4], args[6]))
            return self.err

        def ptt_kv_read_sum(self, *args):
            calls.append(("kv_read_sum", args[2], args[5]))
            return self.err

    calls, lib = [], Lib()
    monkeypatch.setattr(_cuda, "check_device", lambda: None)
    monkeypatch.setattr(_cuda, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "library", lambda name: lib if name == "read_probes" else None)
    monkeypatch.setattr(read_probes, "sm_count", lambda device: 132)
    tok = torch.zeros(8, 128).as_subclass(_OnCard)
    x = torch.ones(64, 1024, dtype=torch.bfloat16).as_subclass(_OnCard)
    kv = torch.ones(600, 1024, dtype=torch.bfloat16).as_subclass(_OnCard)
    n_read, n_sum = stream_read.launches, kv_read_sum.launches
    assert stream_read(tok, x, 16).shape == (8, 128)
    assert stream_read(tok, x.view(torch.int8).view(128, 1024), 32, grid=132).shape == (8, 128)
    assert kv_read_sum(tok, kv, kv).shape == (8, 128)
    assert calls == [("stream_read", (1, 64, 16), 1056), ("stream_read", (2, 128, 32), 132),
                     ("kv_read_sum", 600, 528)]
    assert (stream_read.launches, kv_read_sum.launches) == (n_read + 2, n_sum + 1)
    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        stream_read(tok, x, 16)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kv_read_sum(tok, kv, kv)
    with pytest.raises(ValueError, match="blk_rows"):
        stream_read(tok, x, 4)
    with pytest.raises(ValueError, match="stream_read takes"):
        stream_read(tok, x[:, :512], 16)
    with pytest.raises(ValueError, match="kv_read_sum takes"):
        kv_read_sum(tok, kv, kv[:512])
    with pytest.raises(ValueError, match="tok"):
        kv_read_sum(tok[:4], kv, kv)


def test_a_launch_into_a_captured_graph_is_not_counted(monkeypatch):
    """Under CUDA graph capture the wrapper still records its kernel into
    the graph but counts no launch: the graph launches it at each replay,
    and utils/timing.best_seconds counts those."""
    from pocket_tts_tpu_torch.ops import _cuda, read_probes

    calls = []

    class Lib:
        def ptt_stream_read(self, *args):
            calls.append(args[1:4])
            return 0

    monkeypatch.setattr(_cuda, "check_device", lambda: None)
    monkeypatch.setattr(_cuda, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "library", lambda name: Lib())
    monkeypatch.setattr(read_probes, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    tok = torch.zeros(8, 128).as_subclass(_OnCard)
    x = torch.ones(64, 1024, dtype=torch.bfloat16).as_subclass(_OnCard)
    n = stream_read.launches
    stream_read(tok, x, 16)
    assert calls == [(1, 64, 16)] and stream_read.launches == n
    capturing[0] = False
    stream_read(tok, x, 16)
    assert len(calls) == 2 and stream_read.launches == n + 1


def test_bw_probe_entry_point_on_the_cpu(capsys):
    """python -m pocket_tts_tpu_torch.bw_probe --device cpu at a tiny size:
    one line per dtype and block size, through the plain version."""
    launches = stream_read.launches
    assert bw_probe.main(["--mb", "16", "--iters", "2", "--repeats", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    rows = [line for line in lines[1:] if line.startswith("dtype=")]
    assert len(rows) == 15 and all(line.endswith("GB/s") for line in rows)
    assert stream_read.launches == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bw_probe.main([])


def test_attn_micro_entry_point_on_the_cpu(capsys):
    """python -m pocket_tts_tpu_torch.attn_micro --device cpu at a tiny size:
    every variant prints its us/step and effective GB/s."""
    assert attn_micro.main(["--B", "2", "--C", "520", "--iters", "2", "--repeats", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and lines[1].startswith("B=2 C=520")
    assert [line.split()[0] for line in lines[2:]] == list(attn_micro.VARIANTS)
    assert all(line.endswith("GB/s effective") for line in lines[2:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            attn_micro.main([])


def test_attn_micro_variants_agree_on_the_cpu():
    """The attention forms compute one function: each matches the plain
    batch attention within the bf16 rounding of its output."""
    t = attn_micro.make_inputs(2, 96, torch.device("cpu"))
    fns = attn_micro.variants(t)
    want = fns["slots"](t["q"]).float()
    for name in ("indicator", "ind2", "hsd", "kernel"):
        torch.testing.assert_close(fns[name](t["q"]).float(), want, rtol=0, atol=2e-2, msg=name)
    for name in ("int8", "kernel_i8"):  # int8 rows: the quantisation error on top
        torch.testing.assert_close(fns[name](t["q"]).float(), want, rtol=0, atol=6e-2, msg=name)
