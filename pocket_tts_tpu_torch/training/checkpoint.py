"""Train-state checkpoints: save and resume a fine-tuning run
(port of pocket_tts_tpu/training/checkpoint.py, which uses orbax).

A checkpoint is one file: a torch.save of the params tree, the optimizer's
state_dict and the step, written to a temporary file in the target
directory and moved into place with os.replace, so a reader sees the old
file or the new one, never a partial one.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path

import torch

from pocket_tts_tpu_torch.models.weights import map_tensors, named_leaves
from pocket_tts_tpu_torch.training.flow_matching import TrainState

logger = logging.getLogger(__name__)


def save_train_state(state: TrainState, path: str | Path) -> None:
    """Atomically save a TrainState to the file `path`."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": map_tensors(state.params, lambda t: t.detach()),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
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
    logger.info("Saved train state (step %d) to %s", payload["step"], path)


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore a TrainState saved by save_train_state into `template` (build
    it with init_train_state on params of the same model): its leaves take
    the saved values in place and its optimizer the saved state, on the
    template's device. The file is read onto the host (map_location="cpu"),
    where torch.optim keeps Adam's step counts, so a resumed step reads no
    count back from the card. Raises ValueError when the saved tree's
    paths, shapes or dtypes differ from the template's."""
    path = Path(path).absolute()
    leaves = dict(named_leaves(template.params))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    saved = dict(named_leaves(payload["params"]))
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
    template.optimizer.load_state_dict(payload["optimizer"])
    restored = TrainState(template.params, template.optimizer, int(payload["step"]))
    logger.info("Restored train state (step %d) from %s", restored.step, path)
    return restored
