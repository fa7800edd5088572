"""Text embedder: hashed character-ngram features -> a projection on the
card.  The port of ``k8s_gpu_tpu/finagent/embed.py``.

The reference's application embeds with ``bge-large-zh-v1.5`` (1024-d,
智能风控解决方案.md:25, 36, 75); with no downloaded encoder, the embedder
is a deterministic feature-hashing pipeline whose heavy step runs on the
embedder's device:

1. character n-grams (1..3) of the normalized text hash (blake2b, signed
   buckets) into an ``n_features``-dim count vector, L2-normalized, on
   the host (the reference's code, as it is);
2. one product with a fixed seeded Gaussian projection ``[n_features,
   dim]`` (f32, on the device), then an L2 normalisation, so
   inner-product and L2 ranking agree.

The reference draws its projection with ``jax.random.normal``, which
torch cannot reproduce; the port draws its own from a
``torch.Generator(seed)`` at the same scale, ``n_features ** -0.5``.  A
corpus embedded by one package is therefore searchable by the other only
when the projection was carried across
(``k8s_gpu_tpu_torch.convert.embedder_from_numpy`` builds a port
embedder from the reference's ``_proj``).

``encode(texts) -> [N, dim]`` numpy float32 (a single string ->
``[dim]``), as in the reference; ``encode_tensor`` keeps the result on
the device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import resolve_device

EMBEDDING_DIM = 1024  # parity: 智能风控解决方案.md:25


def _ngrams(text: str, lo: int = 1, hi: int = 3):
    t = " ".join(text.lower().split())
    for n in range(lo, hi + 1):
        for i in range(len(t) - n + 1):
            yield t[i: i + n]


class TextEmbedder:
    """On ``device`` (the card unless the caller asks for the CPU);
    ``proj`` (optional, ``[n_features, dim]``) replaces the seeded
    projection."""

    def __init__(self, dim: int = EMBEDDING_DIM, n_features: int = 8192,
                 seed: int = 0, device="cuda", proj=None):
        self.dim = dim
        self.n_features = n_features
        self.device = resolve_device(device)
        if proj is None:
            gen = torch.Generator().manual_seed(seed)
            proj = torch.randn(n_features, dim, generator=gen) * (
                n_features ** -0.5)
        if tuple(proj.shape) != (n_features, dim):
            raise ValueError(f"projection must be [{n_features}, {dim}], "
                             f"got {tuple(proj.shape)}")
        self._proj = proj.to(self.device, torch.float32)

    def _hash_features(self, text: str) -> np.ndarray:
        v = np.zeros((self.n_features,), np.float32)
        for g in _ngrams(text):
            h = int.from_bytes(
                hashlib.blake2b(g.encode(), digest_size=8).digest(), "little"
            )
            # Signed hashing keeps E[collision noise] at zero.
            v[h % self.n_features] += 1.0 if (h >> 63) & 1 else -1.0
        n = np.linalg.norm(v)
        return v / n if n else v

    def features(self, texts: list[str]) -> np.ndarray:
        """The host half: ``[N, n_features]`` hashed counts."""
        return np.stack([self._hash_features(t) for t in texts])

    def project(self, counts: np.ndarray) -> torch.Tensor:
        """The device half: ``[N, n_features]`` counts -> ``[N, dim]``
        unit rows on the device."""
        x = torch.from_numpy(counts).to(self.device) @ self._proj
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + 1e-9)

    def encode_tensor(self, texts: list[str]) -> torch.Tensor:
        """texts -> ``[N, dim]`` float32 on the device."""
        return self.project(self.features(list(texts)))

    def encode(self, texts: str | list[str]) -> np.ndarray:
        """texts -> ``[N, dim]`` float32 (a single string -> ``[dim]``)."""
        single = isinstance(texts, str)
        out = self.encode_tensor([texts] if single else texts).cpu().numpy()
        return out[0] if single else out
