from repro_torch.train.train_step import (TrainOptions, init_params, make_train_step,
                                          shard_batch, shard_train_state, train_shardings)
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

__all__ = ["TrainOptions", "make_train_step", "init_params", "train_shardings",
           "shard_train_state", "shard_batch", "StragglerMonitor", "Trainer", "TrainerConfig"]
