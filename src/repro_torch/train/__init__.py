from repro_torch.train.train_step import TrainOptions, init_params, make_train_step
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

__all__ = ["TrainOptions", "make_train_step", "init_params", "StragglerMonitor",
           "Trainer", "TrainerConfig"]
