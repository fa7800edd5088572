"""Paged-KV block planning and block migration for the batcher: the port
of ``k8s_gpu_tpu/serve/allocator.py`` (``_blocks_needed``,
``_set_page_row``, ``_paged_plan``, and ``migrate_export`` /
``migrate_import``, the block plane the migration wire and the
disaggregated prefill handover ride on).

On a serving mesh the wire carries whole heads, as a one-rank pool's
blocks hold them: the export's device program (``_export_dev``, on every
rank through the seam) gathers each block's KV heads over tp in rank
order, and the import's (``_import_dev``) hands every rank the wire
blocks, each writing its own heads.  The paged pool is whole on every
dp group, so every group writes.  The host half (which blocks, the
chain hashes, the manifest) runs on the leader only, so the payload is
byte for byte the one a one-rank pool holding the same values sends,
and the reference's gateway drives a meshed replica unchanged."""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_gather
from ..parallel.mesh import axis_rank, axis_size
from .kv_blocks import chunk_hashes, shareable_depth
from .migrate import from_host, to_host, wire_dtype, wire_name
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
        """Blocks for one admission, scheduler thread only.  A precomputed
        row (a disaggregated handover): fresh blocks for its length plus
        the budget, spliced, never shared.  Unshared
        (``prefix_cache=False``, or an adapter row, whose K/V are not the
        base model's): fresh blocks for the left-padded bucket plus the
        budget, and ``req.prefix_tokens`` None, which sends the admission
        through the dense-row splice.  Shared:
        acquires the longest chain of cached full prompt pages (at least
        one suffix token must remain so the extend yields first-token
        logits), then allocates the private tail.  Acquire before alloc:
        the allocation may evict LRU blocks, and the refcount pins the
        matched prefix.  On success ``req.blocks`` holds shared-then-fresh
        ids and ``req.prefix_tokens`` the shared token count; False
        (block pressure) holds no references."""
        page = self.page_size
        if req.precomputed is not None:
            blocks = self._pool.alloc(
                self._blocks_needed(int(req.precomputed[2]), req.max_new))
            if blocks is None:
                return False
            req.blocks = blocks
            req.prefix_tokens = None
            return True
        n = int(req.ids.size)
        if not (self._paged_share and req.aidx == 0):
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

    def _block_geometry(self) -> dict:
        """Per cache leaf, one block's contents (``arr[:, blk]``, whole
        heads on a mesh): wire dtype name and shape."""
        out = {}
        for name, arr in sorted(self._dev["cache"].items()):
            out[name] = {"dtype": wire_name(arr.dtype),
                         "shape": (int(arr.shape[0]),
                                   int(self.engine.cfg.kv_heads))
                         + tuple(int(x) for x in arr.shape[3:])}
        return out

    def _export_dev(self, blocks: list[int]) -> dict:
        """Blocks ``blocks`` of every cache leaf, [L, n, KH, ...] with
        whole heads (gathered over tp in rank order on a mesh)."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        tp = self.engine.tp_group
        out = {}
        for name, arr in self._dev["cache"].items():
            sel = arr.index_select(1, idx)
            if tp is not None:
                sel = torch.cat(all_gather(sel, tp), dim=2)
            out[name] = sel
        return out

    def _import_dev(self, blocks: list[int], leaves: dict) -> None:
        """Write the wire blocks ``leaves`` (name -> host [L, n, KH, ...],
        whole heads) into blocks ``blocks``: this rank's heads of them."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        tp = axis_size(self.mesh, "tp")
        for name, arr in self._dev["cache"].items():
            whole = from_host(leaves[name], arr.dtype)
            mine = whole.chunk(tp, dim=2)[axis_rank(self.mesh, "tp")]
            arr.index_copy_(1, idx, mine.to(self.device))

    def migrate_export(self, *, abort_live: bool = False,
                       include_blocks: bool = True, hashes=None) -> dict:
        """Snapshot every registered block (full prompt pages, content
        final) and the live-request manifest for ``migrate.pack``.  Run it
        under ``run_quiesced``.  One ``index_select`` per leaf and one
        copy to the host for the whole export.  ``abort_live`` also
        retires every live stream stamped migrated (a resumable handover:
        the server's summary tells the client to resume elsewhere);
        ``include_blocks=False`` skips the bodies; ``hashes`` (chain-hash
        bytes) exports exactly those blocks, as the disaggregated prefill
        handover does for one prompt.  ValueError on the dense pool."""
        if not self.paged:
            raise ValueError("block migration requires paged KV mode")
        geometry = self._block_geometry()
        blocks: list[tuple[bytes, dict]] = []
        if include_blocks:
            items = self._pool.registered()
            if hashes is not None:
                want = set(hashes)
                items = [(h, b) for h, b in items if h in want]
            if items:
                got = self._dev_call("_export_dev", [b for _, b in items])
                sel = {name: to_host(t) for name, t in got.items()}
                for j, (h, _) in enumerate(items):
                    blocks.append((h, {
                        name: np.ascontiguousarray(sel[name][:, j])
                        for name in sorted(sel)}))
        requests = [{
            "tenant": r.tenant,
            "trace_id": (r.trace_ctx.trace_id if r.trace_ctx is not None
                         else ""),
            "prompt_tokens": int(r.prompt_tokens),
            "emitted": int(r.emitted),
        } for r in self._active if r is not None]
        aborted = 0
        if abort_live:
            for slot, r in enumerate(self._active):
                if r is None:
                    continue
                r.migrated = True
                r.aborted = True
                self._retire(slot)
                aborted += 1
        return {"page_size": self.page_size, "geometry": geometry,
                "blocks": blocks, "requests": requests, "aborted": aborted}

    def migrate_import(self, parsed: dict) -> int:
        """Splice wire blocks (``migrate.unpack``'s output) into the pool
        through the path a retiring admission takes: alloc a block, write
        the wire bytes, register its hash, release it to refcount 0, so
        it parks in the LRU like a retired prompt's pages.  Run it under
        ``run_quiesced``.  Page size and every leaf's dtype and shape are
        checked before anything changes (ValueError).  Registered hashes
        are skipped; a pool too full stops early (a shorter chain is still
        a valid warm prefix).  One ``index_copy_`` per leaf.  Returns the
        blocks spliced."""
        if not self.paged:
            raise ValueError("block migration requires paged KV mode")
        if int(parsed.get("page_size", 0)) != self.page_size:
            raise ValueError(f"wire page_size {parsed.get('page_size')} != "
                             f"local {self.page_size}")
        local = self._block_geometry()
        geometry = parsed.get("geometry") or {}
        if sorted(geometry) != sorted(local):
            raise ValueError(f"wire cache leaves {sorted(geometry)} != "
                             f"local {sorted(local)}")
        for name, want in local.items():
            g = geometry[name]
            if (wire_dtype(g["dtype"])[0] != want["dtype"]
                    or tuple(g["shape"]) != want["shape"]):
                raise ValueError(f"leaf {name!r}: wire {g['dtype']}"
                                 f"{tuple(g['shape'])} != local "
                                 f"{want['dtype']}{want['shape']}")
        fresh: list[tuple[bytes, int, dict]] = []
        for h, leaves in parsed.get("blocks", []):
            if self._pool.contains(h):
                continue
            got = self._pool.alloc(1)
            if got is None:
                break
            fresh.append((h, got[0], leaves))
        if fresh:
            self._dev_call(
                "_import_dev", [b for _, b, _ in fresh],
                {name: np.stack([lv[name] for _, _, lv in fresh], axis=1)
                 for name in local})
            for h, blk, _ in fresh:
                self._pool.register(blk, h)
                self._pool.release(blk)
        return len(fresh)
