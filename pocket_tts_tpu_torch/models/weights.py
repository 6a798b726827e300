"""Weights: checkpoint loading and export, the JAX bridge, serving casts and
int8 (port of pocket_tts_tpu/models/weights.py).

Parameter trees are nested dicts/lists of tensors whose paths are the
checkpoint's torch module paths, as in the JAX package. Two layouts differ
from the checkpoint: the packed qkv `in_proj.weight` [3E, E] is viewed as
[3, E, E], and (only in the JAX package) ConvTranspose1d weights are stored
flipped in grad-conv layout; the port keeps them in torch layout.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

_SKIP_PREFIXES = (
    "flow.w_s_t.",
    "flow_lm.flow.w_s_t.",
    "quantizer.vq.",
    "model.quantizer.vq.",
    "mimi.quantizer.vq.",
)
_SKIP_EXACT = (
    "condition_provider.conditioners.transcript_in_segment.learnt_padding",
    "condition_provider.conditioners.speaker_wavs.learnt_padding",
    "quantizer.logvar_proj.weight",
    "model.quantizer.logvar_proj.weight",
)
_RENAMES = {
    "condition_provider.conditioners.transcript_in_segment.embed.weight": "conditioner.embed.weight",
    "condition_provider.conditioners.speaker_wavs.output_proj.weight": "speaker_proj_weight",
}


def _normalize_key(key: str) -> str | None:
    """Apply the reference loaders' skip rules and renames
    (pocket_tts_mlx/utils/weight_conversion.py:102-134); None drops the key."""
    prefix, bare = "", key
    for candidate in ("flow_lm.", "mimi."):
        if key.startswith(candidate):
            prefix, bare = candidate, key[len(candidate):]
            break
    if any(bare.startswith(p) for p in _SKIP_PREFIXES) or bare in _SKIP_EXACT:
        return None
    return prefix + _RENAMES.get(bare, bare)


def _resolve(tree, parts: list[str]):
    """Walk a params tree by dotted-path parts -> (parent, leaf key), or None
    when the path does not exist in the tree."""
    node = tree
    for part in parts[:-1]:
        if part.isdigit() and isinstance(node, list):
            if int(part) >= len(node):
                return None
            node = node[int(part)]
        elif isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    last = parts[-1]
    if last.isdigit() or not isinstance(node, dict) or last not in node:
        return None
    return node, last


def load_state_dict(
    params: dict,
    flat: Dict[str, np.ndarray],
    dtype=torch.float32,
    strip_prefix: str = "",
    skipped_keys: list | None = None,
) -> tuple[int, int]:
    """Assign a flat {torch_name: array} checkpoint into a params tree in
    place -> (loaded, skipped). Unknown keys and shape mismatches are
    skipped; pass a list as `skipped_keys` to collect their names."""
    loaded = skipped = 0
    for key, array in flat.items():
        name = key[len(strip_prefix):] if strip_prefix and key.startswith(strip_prefix) else key
        norm = _normalize_key(name)
        resolved = None if norm is None else _resolve(params, norm.split("."))
        tensor = np.asarray(array)
        if resolved is not None:
            parent, leaf = resolved
            target = tuple(parent[leaf].shape)
            if norm.endswith("in_proj.weight") and tensor.ndim == 2 and len(target) == 3:
                tensor = tensor.reshape(target)  # packed qkv rows [3E, E] -> [3, E, E]
            if tuple(tensor.shape) != target:
                logger.warning("Shape mismatch for %s: %s vs %s — skipped", norm, tensor.shape, target)
                resolved = None
        if resolved is None:
            skipped += 1
            if skipped_keys is not None:
                skipped_keys.append(key)
            continue
        t = torch.from_numpy(np.array(tensor))  # a writable copy of the file's bytes
        parent[leaf] = t.to(dtype) if t.is_floating_point() else t
        loaded += 1
    return loaded, skipped


def _np_to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array: exact via f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _convtr_to_torch(w: np.ndarray) -> np.ndarray:
    """JAX grad-conv layout (out, in/g, k), flipped -> torch (in, out/g, k).
    Groups follow from the shape: depthwise (in/g == 1) or dense, the only
    two cases in this model family (pocket_tts_tpu/models/weights.py:270)."""
    cout, cin_per_g, k = w.shape
    groups = cout if cin_per_g == 1 else 1
    w = np.ascontiguousarray(w[:, :, ::-1]).reshape(groups, cout // groups, cin_per_g, k)
    return np.transpose(w, (0, 2, 1, 3)).reshape(groups * cin_per_g, cout // groups, k)


def params_from_jax(tree, path: str = ""):
    """Turn a JAX parameter tree (leaves as numpy arrays) into the port's
    tree of tensors; ConvTranspose weights go back to torch layout."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, f"{path}.{k}" if path else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, f"{path}.{i}") for i, v in enumerate(tree)]
    arr = np.asarray(tree)
    if path.endswith("convtr.weight") and arr.ndim == 3:
        arr = _convtr_to_torch(arr)
    return _np_to_torch(arr)


def named_leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of every tensor leaf of a params/state tree, in
    tree order; other leaves (host ints, None) are left out."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from named_leaves(value, f"{prefix}.{key}" if prefix else key)
    elif isinstance(tree, (list, tuple)):
        for idx, value in enumerate(tree):
            yield from named_leaves(value, f"{prefix}.{idx}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Params tree -> flat {dotted_name: np.ndarray} in the tree's layout
    (bf16 leaves widened to float32, numpy having no bfloat16)."""
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in named_leaves(params, prefix):
        leaf = leaf.detach().cpu()
        flat[path] = (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return flat


def save_checkpoint(params: dict, path) -> int:
    """Write a params tree as a torch-layout safetensors checkpoint that
    load_model reads through a local weights_path (as the JAX package's
    save_checkpoint, pocket_tts_tpu/models/weights.py:250): bf16 leaves
    widened to float32, each packed qkv `in_proj.weight` [3, E, E] back to
    [3E, E]. ConvTranspose weights are in torch layout already. Returns the
    tensor count; an int8-quantized tree is refused."""
    from pocket_tts_tpu_torch.utils.safetensors import save_safetensors

    flat = flatten_params(params)
    if any(key.endswith("weight.q") for key in flat):
        raise ValueError(
            "Cannot save an int8-quantized model as a checkpoint (quantization "
            "is lossy); load with param_dtype='float32' to export."
        )
    for key, tensor in flat.items():
        if key.endswith("in_proj.weight") and tensor.ndim == 3:
            flat[key] = tensor.reshape(-1, tensor.shape[-1])
    save_safetensors(path, flat)
    logger.info("Saved %d tensors to %s", len(flat), path)
    return len(flat)


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_tensors(tree, fn):
    """Apply fn to every tensor leaf of a params/state tree (other leaves,
    such as host-side ints, pass through)."""
    return _map_tree(tree, lambda _, leaf: fn(leaf) if isinstance(leaf, torch.Tensor) else leaf)


def cast_serving_dtype(params: dict, dtype) -> dict:
    """Cast float32 matmul/conv weights (>= 2-D) to a serving dtype, keeping
    the float32 islands: the flow-matching head and the EOS / out-norm
    outputs, plus every 1-D tensor."""
    islands = {"flow_net", "out_eos", "out_norm"}

    def cast(path, leaf):
        if islands & set(path) or leaf.ndim < 2 or leaf.dtype != torch.float32:
            return leaf
        return leaf.to(dtype)

    return _map_tree(params, cast)


def quantize_int8(params: dict, subtrees=("transformer", "input_linear")) -> dict:
    """Weight-only int8 for the FlowLM decode hot path: every 2-D/3-D float
    `weight` under params["flow_lm"][subtree] becomes {"q": int8 codes,
    "s": float32 per-output-channel scale} with s = max|w| / 127 (floored
    at 1e-12 / 127) and q = clip(round(w / s), -127, 127)."""

    def q(tree):
        if isinstance(tree, dict):
            out = {}
            for k, leaf in tree.items():
                if k == "weight" and isinstance(leaf, torch.Tensor) and leaf.ndim in (2, 3) and leaf.is_floating_point():
                    w = leaf.float()
                    scale = w.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
                    codes = torch.round(w / scale[..., None]).clamp(-127, 127).to(torch.int8)
                    out[k] = {"q": codes, "s": scale}
                else:
                    out[k] = q(leaf)
            return out
        if isinstance(tree, list):
            return [q(x) for x in tree]
        return tree

    new_flow = dict(params["flow_lm"])
    for name in subtrees:
        new_flow[name] = q(new_flow[name])
    return {**params, "flow_lm": new_flow}
