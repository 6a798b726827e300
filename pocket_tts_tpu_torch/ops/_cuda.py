"""Build and load the port's CUDA kernels (sources in ../csrc/).

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. Builds land in `build/kernels/`
at the repository root (git-ignored), named by a hash of the sources and
flags, so a changed source rebuilds on its next use and an unchanged one
loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_LAYERS = 16  # PTT_MAX_LAYERS in decode_common.cuh

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library(name: str) -> ctypes.CDLL:
    """Build (if its sources changed) and load csrc/<name>.cu."""
    if name in _LIBS:
        return _LIBS[name]
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.monotonic()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources[0])],
            capture_output=True, text=True,
        )
        (so.with_suffix(".log")).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[0].name}:\n{proc.stderr[-4000:]}")
        tmp.replace(so)
        BUILD_SECONDS[name] = time.monotonic() - t0
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
    _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc/ptxas output of the newest build of csrc/<name>.cu (register and
    shared-memory use per kernel), or '' if none is on disk."""
    logs = sorted(BUILD_DIR.glob(f"{name}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_device() -> None:
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); this card is sm_{major}{minor}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def count_launch(wrapper) -> bool:
    """Add one to `wrapper.launches` for the kernel it just launched, and
    say whether it counted. Under CUDA graph capture a kernel is not
    launched but becomes a node of the graph, so nothing is counted; the
    graph launches it at each replay, and the code that replays the graph
    counts those launches (utils/timing.best_seconds)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return False
    wrapper.launches += 1
    return True


_P = ctypes.c_void_p


class PttBackbone(ctypes.Structure):
    """Mirror of struct PttBackbone (csrc/decode_common.cuh)."""

    _fields_ = [
        ("wqkv", _P), ("sqkv", _P), ("wo", _P), ("so", _P),
        ("w1", _P), ("s1", _P), ("w2", _P), ("s2", _P), ("ln", _P),
        ("win", _P), ("s_in", _P), ("bos", _P), ("out_norm", _P),
        ("eos_w", _P), ("eos_b", _P),
        ("k", _P * MAX_LAYERS), ("v", _P * MAX_LAYERS),
        ("slot_pos", _P),
        ("x", _P), ("qkv", _P), ("attn", _P), ("hidden", _P), ("h", _P),
        ("L", ctypes.c_int), ("E", ctypes.c_int), ("H", ctypes.c_int),
        ("FF", ctypes.c_int), ("ldim", ctypes.c_int), ("C", ctypes.c_int),
        ("rope_coef", ctypes.c_float),
    ]


class PttFlow(ctypes.Structure):
    """Mirror of struct PttFlow (csrc/decode_common.cuh)."""

    _fields_ = [
        ("wc", _P), ("bc", _P), ("tcomb", _P), ("win", _P), ("b_in", _P),
        ("wa", _P), ("ba", _P), ("w0", _P), ("b0", _P), ("w2", _P), ("b2", _P),
        ("lnw", _P), ("lnb", _P), ("wf", _P), ("bf", _P),
        ("y", _P), ("ada", _P), ("fx", _P), ("u", _P),
        ("MC", ctypes.c_int), ("depth", ctypes.c_int),
    ]


_I = ctypes.c_int
# C entry points: (argtypes, restype); each returns a cudaError_t.
_SIGNATURES = {
    # (PttBackbone*, latent, is_bos, qpos, widx, h_out, eos_out, stream)
    "ptt_fused_backbone_step": ([_P, _P, _I, _I, _I, _P, _P, _P], _I),
    # (PttBackbone*, PttFlow*, latent, is_bos, noise, S, qpos0, widx0, latents_out, eos_out, stream)
    "ptt_fused_segment_decode": ([_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P], _I),
    # (q, q_kind, q_sb, q_sh, k, v, kind, slot_pos, sp_stride, qpos, k_scale, v_scale, sc_stride,
    #  B, C, H, R, threads, stages, split, chunk, smem, out, stream)
    "ptt_batch_decode_attention": (
        [_P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    # (cache, row, index, C, E, stream)
    "ptt_row_write": ([_P, _P, _P, _I, _I, _P], _I),
    # (x, out, C, heads, width, stream)
    "ptt_head_slice_weighted_sum": ([_P, _P, _I, _I, _I, _P], _I),
    # (x, kind, rows_total, blk_rows, tok, out, grid, stream)
    "ptt_stream_read": ([_P, _I, _I, _I, _P, _P, _I, _P], _I),
    # (kflat, vflat, rows, tok, out, grid, stream)
    "ptt_kv_read_sum": ([_P, _P, _I, _P, _P, _I, _P], _I),
}
