"""Models of the port."""

from .transformer import TransformerConfig, TransformerLM

__all__ = ["TransformerConfig", "TransformerLM"]
