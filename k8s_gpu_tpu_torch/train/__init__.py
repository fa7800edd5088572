"""Training plane of the port: the train step on one device with its
telemetry, checkpoints and resume, LoRA fine-tuning and the TrainJob
workload registry."""

from .checkpoint import CheckpointManager, attach_to_trainer
from .evaluate import evaluate_lm
from .lora import LoraAdapter, LoraConfig, LoraModel
from .registry import get_workload, known_workloads, register_workload
from .runner import TrainConfig, Trainer, make_train_step

__all__ = ["CheckpointManager", "LoraAdapter", "LoraConfig", "LoraModel",
           "TrainConfig", "Trainer", "attach_to_trainer", "evaluate_lm",
           "get_workload", "known_workloads", "make_train_step",
           "register_workload"]
