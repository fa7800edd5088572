"""Training plane of the port: the dense train step on one device."""

from .evaluate import evaluate_lm
from .runner import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "evaluate_lm", "make_train_step"]
