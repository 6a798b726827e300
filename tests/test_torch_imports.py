"""Importing the PyTorch port (its package root, every module and both kernel
modules) pulls in neither jax, the JAX package nor triton, and needs no
nvcc: kernels build only when a CUDA tensor first reaches a wrapper."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "pocket_tts_tpu_torch",
    "pocket_tts_tpu_torch.main",
    "pocket_tts_tpu_torch.ops.fused_backbone",
    "pocket_tts_tpu_torch.ops.fused_segment",
    "pocket_tts_tpu_torch.ops._cuda",
    "pocket_tts_tpu_torch.models.tts_model",
    "pocket_tts_tpu_torch.conditioners.text",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax_triton_or_nvcc(module, tmp_path):
    code = (
        f"import importlib, sys; importlib.import_module({module!r}); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pocket_tts_tpu', 'triton')); "
        "assert not bad, bad; "
        "from pocket_tts_tpu_torch.ops import _cuda; assert not _cuda._LIBS"
    )
    # A PATH with the interpreter only: no nvcc is reachable.
    env = {"PATH": str(Path(sys.executable).parent), "PYTHONPATH": str(ROOT), "HOME": str(tmp_path),
           "CUDA_HOME": str(tmp_path / "no-cuda")}
    if "SYSTEMROOT" in os.environ:
        env["SYSTEMROOT"] = os.environ["SYSTEMROOT"]
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cli_parser_keeps_the_reference_flags():
    from pocket_tts_tpu.main import build_parser as jax_parser
    from pocket_tts_tpu_torch.main import build_parser

    ref = {a.dest: a.default for a in jax_parser()._actions}
    port = {a.dest: a.default for a in build_parser()._actions}
    assert {k: port[k] for k in ref} == ref
