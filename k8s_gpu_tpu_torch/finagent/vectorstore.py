"""Vector store on the card — the Milvus role.  The port of
``k8s_gpu_tpu/finagent/vectorstore.py``.

The reference application stands up a Milvus collection (id/text/1024-d
schema, drop-if-exists, an IVF_FLAT/L2 index, 智能风控解决方案.md:38-97)
and searches it over the network (:240-248, limit 3, L2).  Here a
collection's corpus is one device-resident ``[N, dim]`` float32 tensor,
and a search is one product against it plus ``torch.topk``: exact, not
approximate.  The product stays float32 (PyTorch's default, with TF32
off): with ``torch.backends.cuda.matmul.allow_tf32`` set, distances are
no longer exact.

The API is the reference's: named collections with drop-if-exists,
``insert``/``flush``/``num_entities``/``create_index`` (a no-op with
metadata), and ``search(query, limit, metric)`` for ``"L2"`` and
``"IP"``.  L2 ranks by ``2 q·e - ||e||²`` and returns
``sqrt(max(||q||² - top, 0))``; each row's ``||e||²`` is computed once,
at flush.  ``flush`` concatenates the pending rows on the device (the
reference pulls the corpus back to the host on every flush), and
``insert`` takes a tensor already on the store's device as well as
numpy, with no host round trip.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class Hit:
    id: int
    text: str
    distance: float


@dataclass
class _CollectionData:
    dim: int
    description: str = ""
    texts: list[str] = field(default_factory=list)
    pending: list = field(default_factory=list)   # [n, dim] on the device
    emb: torch.Tensor | None = None                # [N, dim] after flush
    sq: torch.Tensor | None = None                 # [N]: ||e||²
    indexed: bool = False


class Collection:
    def __init__(self, store: "VectorStore", name: str):
        self._store = store
        self.name = name

    @property
    def _d(self) -> _CollectionData:
        return self._store._collections[self.name]

    @property
    def num_entities(self) -> int:
        return len(self._d.texts)

    def insert(self, texts: list[str], embeddings) -> None:
        """``embeddings``: ``[N, dim]`` numpy or a tensor (one already on
        the store's device is kept as it is)."""
        dev = self._store.device
        if isinstance(embeddings, torch.Tensor):
            emb = embeddings.to(dev, torch.float32)
        else:
            emb = torch.from_numpy(
                np.asarray(embeddings, np.float32)).to(dev)
        if emb.ndim != 2 or emb.shape[1] != self._d.dim:
            raise ValueError(
                f"embeddings must be [N, {self._d.dim}], got "
                f"{tuple(emb.shape)}"
            )
        if len(texts) != emb.shape[0]:
            raise ValueError("texts/embeddings length mismatch")
        self._d.texts.extend(texts)
        self._d.pending.append(emb)

    def flush(self) -> None:
        """Append the pending rows to the corpus: one ``cat`` on the
        device (the old corpus and the new one coexist only during it)."""
        d = self._d
        if not d.pending:
            return
        parts, d.pending = d.pending, []
        sqs = [(p * p).sum(-1) for p in parts]
        if d.emb is not None:
            parts, sqs = [d.emb] + parts, [d.sq] + sqs
        d.emb = torch.cat(parts) if len(parts) > 1 else parts[0].contiguous()
        d.sq = torch.cat(sqs)

    def create_index(self, metric: str = "L2") -> None:
        """A no-op with metadata: the exact product needs no index (the
        reference's Milvus builds IVF_FLAT here, :88-96)."""
        self._d.indexed = True

    def search(self, query, limit: int = 3, metric: str = "L2") -> list[Hit]:
        self.flush()
        d = self._d
        if d.emb is None or len(d.texts) == 0:
            return []
        dev = self._store.device
        if isinstance(query, torch.Tensor):
            q = query.to(dev, torch.float32)
        else:
            q = torch.from_numpy(np.asarray(query, np.float32)).to(dev)
        q = q.reshape(1, d.dim)
        k = min(limit, len(d.texts))
        idx, score = VectorStore._topk(q, d.emb, d.sq, k, metric)
        # One fetch: ids below 2^53 are exact in float64.
        got = torch.stack([idx[0].double(), score[0].double()]).cpu()
        return [Hit(int(i), d.texts[int(i)], float(s))
                for i, s in zip(got[0].tolist(), got[1].tolist())]


class VectorStore:
    """Collections on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._collections: dict[str, _CollectionData] = {}

    # -- collection lifecycle (reference :47-53) ---------------------------
    def has_collection(self, name: str) -> bool:
        return name in self._collections

    def create_collection(self, name: str, dim: int,
                          description: str = "") -> Collection:
        if name in self._collections:
            raise ValueError(f"collection {name} exists")
        self._collections[name] = _CollectionData(dim=dim,
                                                  description=description)
        return Collection(self, name)

    def drop_collection(self, name: str) -> None:
        self._collections.pop(name, None)

    def collection(self, name: str) -> Collection:
        if name not in self._collections:
            raise KeyError(f"no collection {name}")
        return Collection(self, name)

    # -- search ------------------------------------------------------------
    @staticmethod
    def _topk(q, emb, sq, k: int, metric: str):
        """``q`` [Q, dim] against ``emb`` [N, dim] (``sq`` its rows'
        squared norms) -> (ids [Q, k], distances or scores [Q, k])."""
        if metric.upper() == "L2":
            # ||q - e||² = ||q||² - 2 q·e + ||e||²; rank by 2 q·e - ||e||².
            top, idx = torch.topk(2.0 * (q @ emb.T) - sq, k, dim=-1)
            qsq = (q * q).sum(-1, keepdim=True)
            return idx, torch.sqrt(torch.clamp(qsq - top, min=0.0))
        if metric.upper() == "IP":
            top, idx = torch.topk(q @ emb.T, k, dim=-1)
            return idx, top
        raise ValueError(f"unknown metric {metric}")
