"""Models of the port."""

from .cnn import CnnConfig, SmallCnn
from .transformer import TransformerConfig, TransformerLM

__all__ = ["CnnConfig", "SmallCnn", "TransformerConfig", "TransformerLM"]
