"""Paged-KV block planning for the batcher: the port of
``k8s_gpu_tpu/serve/allocator.py`` (``_blocks_needed``,
``_set_page_row``, ``_paged_plan``).  Block export/import over the
migration wire is not ported yet (ROADMAP queue 1 item 5)."""

from __future__ import annotations

import torch

from .kv_blocks import chunk_hashes, shareable_depth
from .scheduler import _Request, prompt_bucket


class AllocatorMixin:
    """BlockPool half of ``ContinuousBatcher``: page planning at
    admission and the host page table."""

    def _blocks_needed(self, n_tokens: int, max_new: int) -> int:
        """Blocks for ``n_tokens`` of prompt (or bucket) plus the budget."""
        return -(-(n_tokens + max_new) // self.page_size)

    def _set_page_row(self, slot: int, blocks: list[int]):
        """Install a slot's blocks in the host page table (entries past the
        allocation -> trash block 0); returns the row on the device."""
        self._pages[slot, :] = 0
        self._pages[slot, :len(blocks)] = blocks
        return torch.from_numpy(self._pages[slot].copy()).to(self.device)

    @property
    def _free_blocks(self) -> list[int]:
        """Allocatable block ids (free + refcount-0 cached)."""
        return self._pool.allocatable_blocks()

    def _paged_plan(self, req: _Request) -> bool:
        """Blocks for one admission, scheduler thread only.  Unshared
        (``prefix_cache=False``): fresh blocks for the left-padded
        bucket plus the budget, and ``req.prefix_tokens`` None, which
        sends the admission through the dense-row splice.  Shared:
        acquires the longest chain of cached full prompt pages (at least
        one suffix token must remain so the extend yields first-token
        logits), then allocates the private tail.  Acquire before alloc:
        the allocation may evict LRU blocks, and the refcount pins the
        matched prefix.  On success ``req.blocks`` holds shared-then-fresh
        ids and ``req.prefix_tokens`` the shared token count; False
        (block pressure) holds no references."""
        page = self.page_size
        n = int(req.ids.size)
        if not self._paged_share:
            bucket = prompt_bucket(n, self.engine.max_seq)
            blocks = self._pool.alloc(self._blocks_needed(bucket,
                                                          req.max_new))
            if blocks is None:
                return False
            req.blocks = blocks
            req.prefix_tokens = None
            return True
        hashes = chunk_hashes(req.ids, page)
        shared: list[int] = []
        for h in hashes[: shareable_depth(n, page)]:
            blk = self._pool.acquire(h)
            if blk is None:
                break
            shared.append(blk)
        s = len(shared)
        fresh = self._pool.alloc(self._blocks_needed(n, req.max_new) - s)
        if fresh is None:
            for blk in reversed(shared):
                self._pool.release(blk)
            return False
        req.blocks = shared + fresh
        req.prefix_tokens = s * page
        # Register the request's own full prompt pages (never the partial
        # tail, which decode writes into).  The admission dispatched right
        # after writes them; a sharer's read is queued later on the same
        # stream.
        for j in range(s, n // page):
            self._pool.register(req.blocks[j], hashes[j])
        return True
