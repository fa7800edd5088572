"""Serving plane of the port: engine, batcher and HTTP server on the
dense or the paged KV pool."""

from .batcher import ContinuousBatcher, Overloaded, RequestHandle
from .engine import InferenceEngine, SamplingConfig
from .server import LmServer

__all__ = ["ContinuousBatcher", "InferenceEngine", "LmServer",
           "Overloaded", "RequestHandle", "SamplingConfig"]
