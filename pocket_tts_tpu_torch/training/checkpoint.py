"""Train-state checkpoints: save and resume a fine-tuning run
(port of pocket_tts_tpu/training/checkpoint.py, which uses orbax).

A checkpoint is one file: a torch.save of the params tree, the optimizer's
state_dict and the step, written to a temporary file in the target
directory and moved into place with os.replace, so a reader sees the old
file or the new one, never a partial one.

A train state on a mesh saves the same mesh-free file: every rank takes
part, the tp shards of the params and of Adam's moments are gathered, and
rank 0 writes. Restoring into a template on a mesh cuts the whole tree to
the template's shards, so a file restores across meshes (and unsharded),
as the JAX package's orbax checkpoints do.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path

import torch

from pocket_tts_tpu_torch.models.weights import map_tensors, named_leaves
from pocket_tts_tpu_torch.parallel.collectives import barrier
from pocket_tts_tpu_torch.parallel.mesh import gather_leaf, gather_params, shard_leaf
from pocket_tts_tpu_torch.training.flow_matching import TrainState

logger = logging.getLogger(__name__)


def _map_moments(optimizer_state: dict, names: list[str], fn) -> dict:
    """An optimizer state_dict whose per-leaf tensors shaped like their leaf
    (Adam's moments; not the 0-d step counts) are fn(path, tensor)."""
    return {**optimizer_state, "state": {
        i: {k: fn(names[i].split("."), v) if isinstance(v, torch.Tensor) and v.ndim else v for k, v in st.items()}
        for i, st in optimizer_state["state"].items()
    }}


def save_train_state(state: TrainState, path: str | Path) -> None:
    """Atomically save a TrainState to the file `path` (on a mesh: every
    rank calls it; rank 0 writes the gathered state)."""
    path = Path(path).absolute()
    params, optimizer = map_tensors(state.params, lambda t: t.detach()), state.optimizer.state_dict()
    mesh = state.mesh
    if mesh is not None:
        names = [name for name, _ in named_leaves(params)]
        params = gather_params(mesh, params)
        optimizer = _map_moments(optimizer, names, lambda p, t: gather_leaf(mesh, p, t))
        if mesh.rank != 0:
            barrier(mesh)
            return
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"params": params, "optimizer": optimizer, "step": int(state.step)}
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    if mesh is not None:
        barrier(mesh)  # the file is in place before any rank returns
    logger.info("Saved train state (step %d) to %s", payload["step"], path)


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore a TrainState saved by save_train_state into `template` (build
    it with init_train_state on params of the same model): its leaves take
    the saved values in place and its optimizer the saved state, on the
    template's device. The file is read onto the host (map_location="cpu"),
    where torch.optim keeps Adam's step counts, so a resumed step reads no
    count back from the card. A template on a mesh takes its shards of the
    saved tree. Raises ValueError when the saved tree's paths, shapes or
    dtypes differ from the template's."""
    path = Path(path).absolute()
    leaves = dict(named_leaves(template.params))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    saved = dict(named_leaves(payload["params"]))
    optimizer = payload["optimizer"]
    mesh = template.mesh
    if mesh is not None and saved.keys() == leaves.keys():
        saved = {name: shard_leaf(mesh, name.split("."), leaf) for name, leaf in saved.items()}
        optimizer = _map_moments(optimizer, list(leaves), lambda p, t: shard_leaf(mesh, p, t))
    if saved.keys() != leaves.keys():
        raise ValueError(f"{path}: the saved params tree differs from the template's: missing "
                         f"{sorted(leaves.keys() - saved.keys())}, unexpected {sorted(saved.keys() - leaves.keys())}")
    for name, leaf in leaves.items():
        if saved[name].shape != leaf.shape or saved[name].dtype != leaf.dtype:
            raise ValueError(f"{path}: {name} is {saved[name].dtype} {tuple(saved[name].shape)}, the template's "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
    with torch.no_grad():
        for name, leaf in leaves.items():
            leaf.copy_(saved[name])
    template.optimizer.load_state_dict(optimizer)
    restored = TrainState(template.params, template.optimizer, int(payload["step"]), mesh)
    logger.info("Restored train state (step %d) from %s", restored.step, path)
    return restored
