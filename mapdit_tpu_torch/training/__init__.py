"""Training, port of ``mapdit_tpu/training``: the train state and step, the
learning-rate schedule, the power EMA and the latent datasets."""

from mapdit_tpu_torch.training.data import LatentDataset, SyntheticLatentDataset, batch_index_stream, save_dataset
from mapdit_tpu_torch.training.lr import default_schedule_steps, warmup_flat_invsqrt
from mapdit_tpu_torch.training.state import (
    EMA_STDS,
    TrainState,
    create_optimizer,
    create_train_state,
    ema_key,
    make_train_step,
)

__all__ = [
    "EMA_STDS",
    "LatentDataset",
    "SyntheticLatentDataset",
    "TrainState",
    "batch_index_stream",
    "create_optimizer",
    "create_train_state",
    "default_schedule_steps",
    "ema_key",
    "make_train_step",
    "save_dataset",
    "warmup_flat_invsqrt",
]
