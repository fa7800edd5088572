"""Byte-level BPE tokenizer: the port's own copy of the pure-Python half
of ``k8s_gpu_tpu/data/tokenizer.py``.  Same deterministic algorithm
(most frequent pair, ties to the smallest pair, left-to-right greedy
application), so a vocabulary trained here gives the ids the reference's
Python fallback gives.  The native (C++) backend is not ported."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _train_merges(data: bytes, vocab_size: int) -> list[tuple[int, int]]:
    toks = list(data)
    merges: list[tuple[int, int]] = []
    next_id = 256
    while next_id < vocab_size:
        counts: dict[tuple[int, int], int] = {}
        for a, b in zip(toks, toks[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
        best, best_n = None, 1
        for p in sorted(counts):   # ties resolve to the smallest pair
            if counts[p] > best_n:
                best, best_n = p, counts[p]
        if best is None:
            break
        merges.append(best)
        toks = _apply_merge(toks, best, next_id)
        next_id += 1
    return merges


def _apply_merge(toks: list[int], pair: tuple[int, int],
                 new_id: int) -> list[int]:
    out = []
    i = 0
    while i < len(toks):
        if i + 1 < len(toks) and (toks[i], toks[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(toks[i])
            i += 1
    return out


def _encode(data: bytes, rank: dict[tuple[int, int], int]) -> list[int]:
    toks = list(data)
    while True:
        best_rank, best = None, None
        for p in zip(toks, toks[1:]):
            r = rank.get(p)
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best = r, p
        if best is None:
            return toks
        toks = _apply_merge(toks, best, 256 + best_rank)


class BpeTokenizer:
    """vocab = 256 byte tokens + one token per merge."""

    def __init__(self, merges: list[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        # A merge may only reference bytes or earlier merges; anything
        # else (a corrupted vocabulary file) would make decode() loop.
        for i, (a, b) in enumerate(self.merges):
            if not (0 <= a < 256 + i and 0 <= b < 256 + i):
                raise ValueError(
                    f"invalid merge table: merges[{i}]=({a},{b}) references "
                    f"ids >= {256 + i}"
                )
        self.rank = {p: i for i, p in enumerate(self.merges)}

    @classmethod
    def train(cls, text: str | bytes, vocab_size: int) -> "BpeTokenizer":
        data = text.encode() if isinstance(text, str) else text
        return cls(_train_merges(data, vocab_size))

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode() if isinstance(text, str) else text
        if not data:
            return np.empty(0, dtype=np.int32)
        return np.asarray(_encode(data, self.rank), dtype=np.int32)

    def decode(self, tokens) -> str:
        toks = np.asarray(tokens, dtype=np.int64).ravel()
        if toks.size and (toks.min() < 0 or toks.max() >= self.vocab_size):
            raise ValueError(
                f"token ids outside [0, {self.vocab_size}): "
                f"[{toks.min()}, {toks.max()}]"
            )
        out = bytearray()
        for t in toks.tolist():
            stack = [t]
            while stack:
                cur = stack.pop()
                if cur < 256:
                    out.append(cur)
                else:
                    left, right = self.merges[cur - 256]
                    stack.append(right)
                    stack.append(left)
        return bytes(out).decode(errors="replace")

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"merges": self.merges}))
        return path

    @classmethod
    def load(cls, path: str | Path) -> "BpeTokenizer":
        merges = json.loads(Path(path).read_text())["merges"]
        return cls([tuple(m) for m in merges])
