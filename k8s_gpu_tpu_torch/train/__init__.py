"""Training plane of the port: the dense train step on one device and
LoRA fine-tuning."""

from .evaluate import evaluate_lm
from .lora import LoraAdapter, LoraConfig, LoraModel
from .runner import TrainConfig, Trainer, make_train_step

__all__ = ["LoraAdapter", "LoraConfig", "LoraModel", "TrainConfig",
           "Trainer", "evaluate_lm", "make_train_step"]
