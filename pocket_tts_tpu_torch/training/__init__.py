from pocket_tts_tpu_torch.training.checkpoint import restore_train_state, save_train_state
from pocket_tts_tpu_torch.training.flow_matching import (
    TrainState,
    adamw,
    flow_matching_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "flow_matching_loss",
    "init_train_state",
    "make_train_step",
    "save_train_state",
    "restore_train_state",
    "adamw",
]
