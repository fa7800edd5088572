"""Serving plane of the port: engine, batcher and HTTP server on the
dense or the paged KV pool, speculative decoding and int8 weights,
multi-LoRA serving, regex and JSON-schema constrained decoding, the
in-process disaggregated prefill pool and servable bundles."""

from .batcher import ContinuousBatcher, Overloaded, RequestHandle
from .bundle import (
    export_servable, export_servable_dir, load_servable, load_servable_dir,
)
from .constrain import ConstraintBank, RegexError, compile_constraint
from .disagg import DisaggregatedLm
from .engine import InferenceEngine, SamplingConfig
from .executor import ngram_propose
from .jsonschema import SchemaError, schema_to_regex
from .lora_bank import AdapterBank
from .quant import quantize_params
from .server import LmServer
from .speculative import distill_draft, int8_draft, rejection_sample

__all__ = ["AdapterBank", "ConstraintBank", "ContinuousBatcher",
           "DisaggregatedLm", "InferenceEngine", "LmServer", "Overloaded",
           "RegexError", "RequestHandle", "SamplingConfig", "SchemaError",
           "compile_constraint", "distill_draft", "export_servable",
           "export_servable_dir", "int8_draft", "load_servable",
           "load_servable_dir", "ngram_propose", "quantize_params",
           "rejection_sample", "schema_to_regex"]
