from repro_torch.training.optimizer import TrainConfig, lr_schedule  # noqa: F401
from repro_torch.training.train_step import make_train_step, init_train_state  # noqa: F401
