from repro_torch.train.optimizer import adafactor, adamw, get_optimizer  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step  # noqa: F401
