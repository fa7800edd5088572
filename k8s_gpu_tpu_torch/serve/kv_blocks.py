"""Refcounted paged-KV block pool with content-hash prefix sharing: the
port's own copy of ``k8s_gpu_tpu/serve/kv_blocks.py`` (pure Python; the
port imports nothing of the JAX package).

Physical blocks of ``page_size`` positions are the unit of allocation
and reuse.  A prompt's page-aligned chunks are hashed as a chain (chunk
i's hash covers every token before it, since a block's K/V depend on the
whole prefix), full prompt blocks are registered ``hash -> block id``
after prefill, and a later request whose chain matches maps its page
table to the same physical blocks and computes only its suffix.

A block is free, pinned (refcount >= 1: in some live row's table, never
evicted) or cached (refcount 0 with a registered hash: kept in an LRU
until an allocation needs the space).  Host-side only; the batcher's
scheduler thread makes every call.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np


def chunk_hashes(ids: np.ndarray, page: int) -> list[bytes]:
    """Chained hashes of the FULL page-aligned chunks of ``ids``:
    h_i = H(h_{i-1} || tokens[i*page:(i+1)*page]).  Only full chunks —
    a partial tail block is never shared (its content would change as
    decode writes into it); the partial tail is instead recomputed into
    a private block, which is this cache's copy-on-write."""
    ids = np.ascontiguousarray(ids, np.int32)
    out: list[bytes] = []
    h = b""
    for i in range(int(ids.size) // page):
        m = hashlib.blake2b(digest_size=16)
        m.update(h)
        m.update(ids[i * page:(i + 1) * page].tobytes())
        h = m.digest()
        out.append(h)
    return out


def shareable_depth(n: int, page: int) -> int:
    """How many leading full pages of an ``n``-token prompt are
    SHAREABLE: full pages only, capped so at least one suffix token
    remains (the extend must produce first-token logits)."""
    return max(0, int(n) - 1) // max(1, int(page))


class BlockPool:
    """Block allocator: free list + refcounts + hash table + LRU.

    ``n_blocks`` counts the whole pool including block 0 — the trash
    block, which is never allocated (retired page-table rows point at
    it so in-flight garbage writes land somewhere harmless)."""

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._free: list[int] = list(range(1, self.n_blocks))
        self._ref: dict[int, int] = {}
        self._blk_of: dict[bytes, int] = {}       # hash -> block
        self._hash_of: dict[int, bytes] = {}      # block -> hash
        # refcount-0 registered blocks, oldest first (the eviction order)
        self._lru: "collections.OrderedDict[int, bool]" = (
            collections.OrderedDict()
        )

    # -- queries -----------------------------------------------------------
    def allocatable_blocks(self) -> list[int]:
        """Sorted ids of every block an alloc() could hand out — the
        post-shutdown leak-check surface (a clean pool returns all
        blocks here, whether plain-free or cached)."""
        return sorted(list(self._free) + list(self._lru))

    @property
    def pinned_count(self) -> int:
        """Blocks referenced by a live row (refcount >= 1)."""
        return len(self._ref)

    def contains(self, h: bytes) -> bool:
        """Whether ``h`` is registered (pinned or cached): the migration
        import's duplicate gate, read without touching refcounts or LRU
        order."""
        return h in self._blk_of

    def registered(self) -> list[tuple[bytes, int]]:
        """Every registered ``(hash, block)`` pair, sorted by hash: what
        a migration export sends."""
        return sorted(self._blk_of.items(), key=lambda kv: kv[0])

    def chain_hashes(self) -> list[bytes]:
        """Sorted registered hashes: the ``GET /debug/chains`` body the
        gateway's owner map is rebuilt from."""
        return sorted(self._blk_of)

    # -- sharing -----------------------------------------------------------
    def acquire(self, h: bytes) -> int | None:
        """Pin the block registered under ``h`` (refcount++), pulling it
        out of the LRU if it was resting there.  None on miss."""
        blk = self._blk_of.get(h)
        if blk is None:
            return None
        if self._ref.get(blk, 0) == 0:
            self._lru.pop(blk, None)
        self._ref[blk] = self._ref.get(blk, 0) + 1
        return blk

    def register(self, blk: int, h: bytes) -> None:
        """Record ``blk``'s content hash so later prompts can share it.
        First writer wins: a hash already mapped (or a block already
        registered) keeps its existing entry — admissions are serialized
        on the scheduler thread, so a would-be duplicate writer would
        have matched instead."""
        if h in self._blk_of or blk in self._hash_of:
            return
        self._blk_of[h] = blk
        self._hash_of[blk] = h

    # -- allocation --------------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` fresh blocks (refcount 1 each), evicting LRU
        cached blocks as needed.  None when even full eviction cannot
        cover — the caller defers (or fails) without side effects."""
        if n <= 0:
            return []
        if len(self._free) + len(self._lru) < n:
            return None
        while len(self._free) < n:
            blk, _ = self._lru.popitem(last=False)  # oldest first
            del self._blk_of[self._hash_of.pop(blk)]
            self._free.append(blk)
        taken = self._free[:n]
        del self._free[:n]
        for b in taken:
            self._ref[b] = 1
        return taken

    def release(self, blk: int) -> None:
        """Drop one reference.  At refcount 0 a registered block parks
        in the LRU (content kept for the next sharer); an unregistered
        one returns straight to the free list."""
        r = self._ref.get(blk, 0) - 1
        if r > 0:
            self._ref[blk] = r
            return
        self._ref.pop(blk, None)
        if blk in self._hash_of:
            self._lru[blk] = True
            self._lru.move_to_end(blk)
        else:
            self._free.append(blk)
