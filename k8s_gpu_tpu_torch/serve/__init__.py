"""Serving plane of the port: engine, batcher and HTTP server on the
dense or the paged KV pool, speculative decoding and int8 weights."""

from .batcher import ContinuousBatcher, Overloaded, RequestHandle
from .engine import InferenceEngine, SamplingConfig
from .executor import ngram_propose
from .quant import quantize_params
from .server import LmServer
from .speculative import distill_draft, int8_draft, rejection_sample

__all__ = ["ContinuousBatcher", "InferenceEngine", "LmServer",
           "Overloaded", "RequestHandle", "SamplingConfig",
           "distill_draft", "int8_draft", "ngram_propose",
           "quantize_params", "rejection_sample"]
