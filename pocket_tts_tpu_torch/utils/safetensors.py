"""Dependency-free safetensors reader/writer.

Reads checkpoints saved by torch (the published pocket-tts checkpoints are
torch-layout safetensors; cf. reference parser at
pocket_tts_mlx/utils/weight_conversion.py:38-69). Tensors are returned as
numpy arrays; BF16 payloads are widened to float32 since numpy has no native
bfloat16.

The reader memory-maps the file so large checkpoints load without a second
copy in host RAM; each tensor is materialized lazily on first access.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Dict, Union

import numpy as np

_DTYPES = {
    "F64": np.dtype(np.float64),
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "I64": np.dtype(np.int64),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U64": np.dtype(np.uint64),
    "U32": np.dtype(np.uint32),
    "U16": np.dtype(np.uint16),
    "U8": np.dtype(np.uint8),
    "BOOL": np.dtype(np.bool_),
}

_INVERSE_DTYPES = {v: k for k, v in _DTYPES.items()}


def _decode_tensor(buf: memoryview, dtype: str, shape: list[int]) -> np.ndarray:
    if dtype == "BF16":
        # bfloat16 = top 16 bits of a float32; widen by shifting into place.
        u16 = np.frombuffer(buf, dtype=np.uint16)
        f32 = (u16.astype(np.uint32) << 16).view(np.float32)
        return f32.reshape(shape)
    if dtype not in _DTYPES:
        raise ValueError(f"Unsupported safetensors dtype: {dtype}")
    return np.frombuffer(buf, dtype=_DTYPES[dtype]).reshape(shape)


def load_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load every tensor in a safetensors file as {name: np.ndarray}."""
    path = Path(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        header_len = int.from_bytes(mm[:8], "little")
        header = json.loads(mm[8 : 8 + header_len].decode("utf-8"))
        data_start = 8 + header_len

        tensors: Dict[str, np.ndarray] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            start, end = info["data_offsets"]
            # mmap slicing returns bytes (one copy, no exported buffer), so
            # the map can be closed immediately after loading.
            buf = mm[data_start + start : data_start + end]
            tensors[name] = _decode_tensor(buf, info["dtype"], info["shape"])
    finally:
        mm.close()
    return tensors


def save_safetensors(path: Union[str, Path], tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: np.ndarray} as a safetensors file (little-endian)."""
    header: Dict[str, dict] = {}
    offset = 0
    blobs: list[bytes] = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _INVERSE_DTYPES:
            raise ValueError(f"Cannot serialize dtype {arr.dtype} for tensor {name}")
        blob = arr.tobytes()
        header[name] = {
            "dtype": _INVERSE_DTYPES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        offset += len(blob)
        blobs.append(blob)

    header_bytes = json.dumps(header).encode("utf-8")
    # Pad header to 8-byte alignment (spec recommendation).
    pad = (-len(header_bytes)) % 8
    header_bytes += b" " * pad

    with open(path, "wb") as f:
        f.write(len(header_bytes).to_bytes(8, "little"))
        f.write(header_bytes)
        for blob in blobs:
            f.write(blob)
