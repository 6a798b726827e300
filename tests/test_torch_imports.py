"""Importing the PyTorch port (its package root, its entry points and the
kernel modules) pulls in neither jax, the JAX package nor triton, and needs
no nvcc: kernels build only when a CUDA tensor first reaches a wrapper."""

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
    "pocket_tts_tpu_torch.ops.persistent",
    "pocket_tts_tpu_torch.ops.batch_attention",
    "pocket_tts_tpu_torch.ops.attention",
    "pocket_tts_tpu_torch.ops._cuda",
    "pocket_tts_tpu_torch.models.tts_model",
    "pocket_tts_tpu_torch.conditioners.text",
    "pocket_tts_tpu_torch.serving.engine",
    "pocket_tts_tpu_torch.serving.server",
    "pocket_tts_tpu_torch.ops.probes",
    "pocket_tts_tpu_torch.probes",
    "pocket_tts_tpu_torch.ops.read_probes",
    "pocket_tts_tpu_torch.bw_probe",
    "pocket_tts_tpu_torch.attn_micro",
    "pocket_tts_tpu_torch.data.audio",
    "pocket_tts_tpu_torch.data.audio_utils",
    "pocket_tts_tpu_torch.models.seanet",
    "pocket_tts_tpu_torch.models.mimi",
    "pocket_tts_tpu_torch.training",
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


def _c_entry_points():
    """(name, C parameter types) of every extern "C" function in csrc/*.cu."""
    import re

    found = {}
    for src in sorted((ROOT / "pocket_tts_tpu_torch" / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            found[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return found


@pytest.mark.parametrize("name", ["ptt_fused_backbone_step", "ptt_fused_backbone_occupancy", "ptt_fused_segment_decode",
                                  "ptt_fused_segment_occupancy",
                                  "ptt_batch_decode_attention",
                                  "ptt_row_write", "ptt_head_slice_weighted_sum", "ptt_stream_read",
                                  "ptt_kv_read_sum"])
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each kernel's ctypes argtypes have one entry per parameter of its C
    entry point, a pointer for a pointer and an int for an int: a missing
    or extra argument would pass garbage to the card."""
    import ctypes

    from pocket_tts_tpu_torch.ops import _cuda

    params = _c_entry_points()[name]
    argtypes, restype = _cuda._SIGNATURES[name]
    assert restype is ctypes.c_int
    assert [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params] == argtypes, params
    assert all("*" in p or p.split()[-1] == "int" for p in params), params
