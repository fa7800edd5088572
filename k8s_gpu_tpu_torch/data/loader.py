"""Tokenized-batch loader: the port's counterpart of
``k8s_gpu_tpu/data/loader.py``, its Python backend and the native C++
prefetcher (``native/dataloader.cc``, bound in ``data/native.py``).

A flat little-endian int32 token file is cut into samples of
``seq_len + 1`` tokens; each host reads its ``shard=(shard_id,
num_shards)`` of them, shuffled per epoch by the splitmix64 Fisher-Yates
permutation the reference draws, so both backends give the reference's
batches byte for byte.  ``backend="auto"`` takes the native library when
it builds and loads, else Python; ``backend="native"`` raises when it
cannot load.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from . import native

_MASK = (1 << 64) - 1


def write_tokens(path: str | Path, tokens) -> Path:
    """Write a flat little-endian int32 token file (the loader's format)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.asarray(tokens, dtype="<i4").tofile(path)
    return path


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The reference's per-epoch permutation of ``n`` samples."""
    perm = np.arange(n, dtype=np.uint64)
    state = (seed ^ ((epoch * 0xD1B54A32D192ED03 + 1) & _MASK)) & _MASK
    for i in range(n - 1, 0, -1):
        state, r = _splitmix64(state)
        j = r % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class TokenLoader:
    """Iterates (inputs, targets) int32 batches of shape (batch, seq_len),
    dropping the last partial batch of each epoch.

    ``backend``: ``"auto"`` (native when the library loads, else
    python), ``"native"`` or ``"python"``.  The native prefetcher keeps
    ``prefetch_depth`` batches ahead on ``n_threads`` threads."""

    def __init__(self, path: str | Path, seq_len: int, batch_size: int,
                 shard: tuple[int, int] = (0, 1), seed: int = 0,
                 shuffle: bool = True, backend: str = "auto",
                 prefetch_depth: int = 4, n_threads: int = 2):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}; expected "
                             "auto|native|python")
        self.path = Path(path)
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.shard_id, self.num_shards = shard
        self.seed = seed
        self.shuffle = shuffle
        self._handle = None
        self._mm = None
        self._epoch = 0
        self._next_epoch = 0
        self._cursor = 0
        self._perm = None

        n_samples = (self.path.stat().st_size // 4) // (seq_len + 1)
        self.num_local = max(0, (n_samples - self.shard_id + self.num_shards
                                 - 1) // self.num_shards)
        self.batches_per_epoch = self.num_local // batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(f"shard {shard} has {self.num_local} samples < "
                             f"one batch of {batch_size}")
        if backend == "auto":
            backend = "native" if native.available() else "python"
        if backend == "native":
            self._lib = native.load()
            self._handle = self._lib.dl_open(
                os.fsencode(str(self.path)), seq_len, batch_size,
                self.shard_id, self.num_shards, seed, int(shuffle),
                prefetch_depth, n_threads)
            if not self._handle:
                raise RuntimeError(f"dl_open failed for {self.path}")
        else:
            self._mm = np.memmap(self.path, dtype="<i4", mode="r")
        self.backend = backend

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        w = self.seq_len + 1
        if self._handle is not None:
            buf = np.empty(self.batch_size * w, dtype=np.int32)
            epoch = self._lib.dl_next_batch(
                self._handle, buf.ctypes.data_as(ctypes.c_void_p))
            if epoch < 0:
                raise StopIteration
            self._epoch = int(epoch)
            full = buf.reshape(self.batch_size, w)
            return full[:, :-1].copy(), full[:, 1:].copy()
        if self._cursor == 0 and self.shuffle:
            self._perm = epoch_permutation(self.num_local, self.seed,
                                           self._next_epoch)
        b = self._cursor
        rows = np.arange(b * self.batch_size, (b + 1) * self.batch_size,
                         dtype=np.uint64)
        if self.shuffle:
            rows = self._perm[rows]
        global_rows = (rows * np.uint64(self.num_shards)
                       + np.uint64(self.shard_id))
        full = np.stack([self._mm[int(g) * w:(int(g) + 1) * w]
                         for g in global_rows])
        # .epoch is the epoch of the batch just returned.
        self._epoch = self._next_epoch
        self._cursor += 1
        if self._cursor >= self.batches_per_epoch:
            self._cursor = 0
            self._next_epoch += 1
        return full[:, :-1].copy(), full[:, 1:].copy()

    @property
    def epoch(self) -> int:
        return self._epoch

    def close(self) -> None:
        """Stops the native prefetch threads and unmaps the file."""
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # A loader dropped without close() still stops its threads.
        if getattr(self, "_handle", None) is not None:
            self.close()
