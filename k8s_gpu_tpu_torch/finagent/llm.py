"""LLM clients for the agent suite: the port of
``k8s_gpu_tpu/finagent/llm.py``.

The reference application calls Ollama's OpenAI-compatible API with
``qwen:72b`` (智能风控解决方案.md:196, 218-223, 250-254).  Here the LLM
seam is a one-method protocol with three implementations:

- ``HttpLMClient``: the reference's service topology, pointed at the
  platform's own ``LmServer`` (the port's, on the card's paged pool, or
  the reference's): the agents' ``/generate`` calls are served by the
  batcher and, on the paged pool, the paged-attention kernel;
- ``TorchLMClient``: the counterpart of the reference's ``TpuLMClient``,
  the port's ``InferenceEngine`` in process over a byte-level
  tokenizer;
- ``TemplateLM``: a deterministic canned completion for tests and demos
  (the reference's acceptance script only checks routing and that a
  reply came back, :500-520).
"""

from __future__ import annotations

import itertools
import json
import threading
import urllib.error
import urllib.request
from collections import deque
from typing import Protocol

import torch

from ..models import TransformerConfig, TransformerLM
from ..serve import InferenceEngine, SamplingConfig

BYTE_VOCAB = 259  # 256 bytes + BOS/EOS/PAD
BOS, EOS, PAD = 256, 257, 258


class LMClient(Protocol):
    def chat(self, prompt: str) -> str: ...


def encode_bytes(text: str, max_len: int) -> list[int]:
    return [BOS] + list(text.encode("utf-8"))[: max_len - 1]


def decode_bytes(ids) -> str:
    out = bytearray()
    for i in ids:
        i = int(i)
        if i == EOS:
            break
        if i < 256:
            out.append(i)
    return out.decode("utf-8", errors="replace")


class TorchLMClient:
    """``serve.InferenceEngine`` over byte-level tokens, on ``device`` (the
    card unless the caller asks for the CPU).

    ``model`` defaults to the reference's: byte vocabulary 259, d_model
    256, 4 layers, 8 heads of 32, d_ff 704, max_seq 1024; ``params`` to
    its fresh init from ``seed`` (the decode path is real, the prose is
    not).  Pass restored or converted params
    (``convert.params_from_numpy`` of the reference's) for trained
    output."""

    def __init__(self, model=None, params=None, max_new_tokens: int = 128,
                 temperature: float = 0.7, top_k: int = 40, seed: int = 0,
                 device="cuda"):
        if model is None:
            model = TransformerLM(
                TransformerConfig(
                    vocab_size=BYTE_VOCAB, d_model=256, n_layers=4,
                    n_heads=8, d_head=32, d_ff=704, max_seq=1024,
                ),
                device=device,
            )
        self.model = model
        self.params = params if params is not None else model.init(seed)
        self.engine = InferenceEngine(model, device=model.device)
        self.sampling = SamplingConfig(
            temperature=temperature, top_k=top_k, eos_id=EOS, pad_id=PAD
        )
        self.max_new_tokens = max_new_tokens
        # A seed a call, drawn under a lock (/chat is served by many
        # threads): the reference splits a key a call.
        self._seeds = torch.Generator().manual_seed(seed + 1)
        self._seed_lock = threading.Lock()

    def chat(self, prompt: str) -> str:
        budget = self.model.cfg.max_seq - self.max_new_tokens
        ids = encode_bytes(prompt, budget)
        # The prompt's power-of-two bucket (at least 64), left-padded, as
        # the reference buckets it.
        bucket = min(budget, max(64, 1 << (len(ids) - 1).bit_length()))
        pad = bucket - len(ids)
        toks = torch.tensor([[PAD] * pad + ids], dtype=torch.int32,
                            device=self.engine.device)
        with self._seed_lock:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._seeds))
        out = self.engine.generate(
            self.params, toks, max_new_tokens=self.max_new_tokens,
            sampling=self.sampling, seed=seed, pad_left=pad,
        )
        return decode_bytes(out.tokens[0].tolist())


class TemplateLM:
    """Deterministic completion that restates the prompt's bracketed
    sections: enough for routing and context checks, no compute."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        # Bounded: the demo server's default LM runs for a long time.
        self.calls: deque[str] = deque(maxlen=256)

    def chat(self, prompt: str) -> str:
        self.calls.append(prompt)
        lines = [ln.strip() for ln in prompt.splitlines() if ln.strip()]
        gist = " / ".join(lines[-3:])[:400]
        return f"{self.prefix}{gist}"


class HttpLMClient:
    """The agents call their LLM over HTTP, as the reference's call
    Ollama (智能风控解决方案.md:218-223), at the platform's own
    ``LmServer``'s ``/generate``.  ``adapter``/``constraint``: the
    server's multi-LoRA and regex-constraint fields, per client."""

    def __init__(self, base_url: str, max_new_tokens: int = 128,
                 temperature: float = 0.7, seed: int | None = None,
                 adapter: str | None = None,
                 constraint: str | None = None, timeout: float = 120.0):
        """``seed``: None (the default) sends a new seed a request, so a
        sampling temperature samples across retries; an int pins the
        outputs."""
        self.base_url = base_url.rstrip("/")
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.seed = seed
        # next() on itertools.count is atomic under the GIL: concurrent
        # chat() calls never share a seed.
        self._counter = itertools.count(1)
        self.adapter = adapter
        self.constraint = constraint
        self.timeout = timeout

    def chat(self, prompt: str) -> str:
        seed = next(self._counter) if self.seed is None else self.seed
        payload = {
            "prompt": prompt,
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "seed": seed,
        }
        if self.adapter:
            payload["adapter"] = self.adapter
        if self.constraint:
            payload["constraint"] = self.constraint
        req = urllib.request.Request(
            f"{self.base_url}/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())["text"]
        except urllib.error.HTTPError as e:
            detail = e.read()[:200].decode(errors="replace")
            raise RuntimeError(
                f"LM server {self.base_url} rejected the request "
                f"({e.code}): {detail}"
            ) from None
        except OSError as e:
            raise RuntimeError(
                f"LM server {self.base_url} unreachable: {e}"
            ) from None
