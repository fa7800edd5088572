"""Byte-level BPE tokenizer: the port's counterpart of
``k8s_gpu_tpu/data/tokenizer.py``, its Python half and its native backend
(``native/tokenizer.cc``, bound in ``data/native.py``).  Both run the
same deterministic algorithm (most frequent pair, ties to the smallest
pair, left-to-right greedy application), so a vocabulary trained by
either encodes identically under both and as the reference's.
``backend="auto"`` takes the native library when it loads."""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np

from . import native


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


def _backend(backend: str) -> str:
    if backend == "auto":
        return "native" if native.available() else "python"
    if backend not in ("native", "python"):
        raise ValueError(f"unknown backend {backend!r}; expected "
                         "auto|native|python")
    return backend


class BpeTokenizer:
    """vocab = 256 byte tokens + one token per merge."""

    def __init__(self, merges: list[tuple[int, int]],
                 backend: str = "auto"):
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
        self.backend = _backend(backend)
        self._handle = None
        if self.backend == "native":
            self._lib = native.load()
            flat = np.asarray(self.merges, dtype=np.int32).reshape(-1)
            self._handle = self._lib.tok_from_merges(
                flat.ctypes.data_as(ctypes.c_void_p), len(self.merges))

    @classmethod
    def train(cls, text: str | bytes, vocab_size: int,
              backend: str = "auto") -> "BpeTokenizer":
        data = text.encode() if isinstance(text, str) else text
        backend = _backend(backend)
        if backend == "native":
            lib = native.load()
            h = lib.tok_train(data, len(data), vocab_size)
            try:
                n = lib.tok_num_merges(h)
                flat = np.empty(2 * n, dtype=np.int32)
                lib.tok_merges(h, flat.ctypes.data_as(ctypes.c_void_p))
            finally:
                lib.tok_free(h)
            merges = [tuple(p) for p in flat.reshape(-1, 2).tolist()]
        else:
            merges = _train_merges(data, vocab_size)
        return cls(merges, backend=backend)

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode() if isinstance(text, str) else text
        if not data:
            return np.empty(0, dtype=np.int32)
        if self._handle is not None:
            out = np.empty(len(data), dtype=np.int32)
            n = self._lib.tok_encode(self._handle, data, len(data),
                                     out.ctypes.data_as(ctypes.c_void_p))
            return out[:n].copy()
        return np.asarray(_encode(data, self.rank), dtype=np.int32)

    def decode(self, tokens) -> str:
        toks = np.asarray(tokens, dtype=np.int64).ravel()
        if toks.size and (toks.min() < 0 or toks.max() >= self.vocab_size):
            raise ValueError(
                f"token ids outside [0, {self.vocab_size}): "
                f"[{toks.min()}, {toks.max()}]"
            )
        if self._handle is not None and toks.size:
            # A contiguous int32 copy: the library reads exactly n ids.
            ids = np.ascontiguousarray(toks, dtype=np.int32)
            cap = int(self._expansion_lengths()[ids].sum()) + 1
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.tok_decode(self._handle,
                                     ids.ctypes.data_as(ctypes.c_void_p),
                                     ids.size, buf, cap)
            if n < 0:
                raise ValueError("invalid token id or buffer too small")
            return buf.raw[:n].decode(errors="replace")
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

    def _expansion_lengths(self) -> np.ndarray:
        """Decoded byte length of each token id (the decode buffer's
        exact size)."""
        if not hasattr(self, "_exp_lens"):
            lens = np.ones(self.vocab_size, dtype=np.int64)
            for m, (a, b) in enumerate(self.merges):
                lens[256 + m] = lens[a] + lens[b]
            self._exp_lens = lens
        return self._exp_lens

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"merges": self.merges}))
        return path

    @classmethod
    def load(cls, path: str | Path, backend: str = "auto") -> "BpeTokenizer":
        merges = json.loads(Path(path).read_text())["merges"]
        return cls([tuple(m) for m in merges], backend=backend)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.tok_free(self._handle)
            self._handle = None
