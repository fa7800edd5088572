"""KV-cache inference engine: the port of ``k8s_gpu_tpu/serve/engine.py``.

Two caches, the reference's layouts:

- the dense cache ``[L, B, KH, max_seq, Dh]``, one row a request:
  behind ``prefill``, ``decode_step`` and ``generate`` (one batch, one
  shared position), and behind ``decode_step_multi`` and
  ``extend_multi`` without page tables (every row at its own position);
- the paged pool ``[L, NB, KH, page, Dh]`` behind ``decode_step_multi``
  and ``extend_multi`` with page tables: physical blocks shared by all
  rows through per-row page tables, block 0 the trash block.

With ``kv_quant`` a cache holds int8 K/V plus one f32 scale per
(layer, row or block, head, position) in ``k_s``/``v_s``.

Where the reference returns an updated cache from a pure function, the
port writes into the cache tensors in place and returns the same dict:
a decode step never copies the pool.  Work on the card is ordered by its
stream, so a write a later step reads has landed by then.

``attn_impl`` picks the paged read: ``"gather"`` materializes the first
``t_hi`` positions of every row and runs ``_attend_cached``;
``"paged_kernel"`` runs the CUDA kernel of ``ops/paged_attention.py``,
which walks the page tables itself.

``int8_compute`` runs the q/k/v/o, MLP and head products of int8 ``{q,
s}`` leaves as int8 x int8 -> int32 (``quant.int8_dot``): the
speculative draft's engine, where quantization error moves only the
acceptance rate.

On a mesh (``mesh=``, dp and tp only, as the reference's engine) the
params are this rank's shards (``parallel.sharding.shard_params``): each
block runs on the rank's H/tp query heads and KH/tp KV heads, its cache
holds those KV heads, ``wo``'s and the MLP's partial sums and the
vocabulary-parallel embedding lookup are summed over tp, and the head's
vocabulary slices are gathered over tp in f32, so every rank of a tp
group ends a forward with the same logits.  An MoE block routes the
call's own tokens alike on every rank (at full capacity for decode and
verify windows, the training capacity with padding masked for a
prefill), each rank runs its F slice of every expert, and the outputs
are summed over tp.  Int8 weights are the whole tree's, quantized and
then cut (``quant.shard_quantized``); ``int8_compute`` adds the int32
partial sums of ``wo`` and ``wo_mlp`` over tp (``quant.int8_dot``).
The engine runs whatever rows it is given: the batcher cuts rows over
dp.

``adapters``/``adapter_idx`` (``prefill``, ``decode_step_multi``,
``extend_multi``): an ``AdapterBank``'s stacked tensors and each row's
adapter; the q/k/v deltas come from the normed block input before RoPE,
the wo delta from the flattened attention output
(``lora_bank.lora_delta``).  ``generate_constrained`` is the one-shot
regex-constrained generation (``constrain.RegexConstraint``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..models.transformer import TransformerLM, layer_params, wt
from ..ops.paged_attention import paged_attention
from ..parallel.collectives import gather_from, reduce_from
from ..parallel.mesh import SERVE_AXES, axis_group, axis_size, check_slice
from .lora_bank import layer_slice, lora_delta
from .quant import int8_dot


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = full vocab
    top_p: float = 0.0        # 0 or 1 = off; else nucleus sampling
    eos_id: int = -1          # -1 = never stop early
    pad_id: int = 0


@dataclass
class DecodeOutput:
    tokens: torch.Tensor         # [B, max_new_tokens] (pad after EOS)
    lengths: torch.Tensor        # [B] tokens generated before EOS/budget
    prompt_logits: torch.Tensor  # [B, V] logits at the last prompt position


def nucleus_mask(scaled, top_p):
    """Nucleus (top-p) mask on temperature-scaled logits.  ``top_p``
    scalar or [B]; values outside (0, 1) keep everything, and such rows
    come back bit-identical.  A token survives iff the mass of strictly
    better tokens is below top_p, so the nucleus always holds the argmax."""
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=scaled.device)
    eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p, 1.0)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep = before < eff[..., None]
    n_keep = keep.sum(dim=-1, keepdim=True)
    thresh = torch.gather(srt, -1, n_keep - 1)
    masked = torch.where(scaled < thresh, -torch.inf, scaled)
    return torch.where(eff[..., None] < 1.0, masked, scaled)


def gumbel_sample(logits, generator):
    """One categorical draw per row of ``logits`` [..., V] with the noise
    taken from ``generator`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() + g, dim=-1)


def _empty_cache(cfg, batch: int, max_seq: int, kv_quant: bool, device,
                 kv_heads: int | None = None):
    """Dense cache ``[L, batch, KH, max_seq, Dh]``; ``kv_heads``: a tp
    rank's KH/tp (all of them by default)."""
    shape = (cfg.n_layers, batch, kv_heads or cfg.kv_heads, max_seq,
             cfg.d_head)
    return _zeros_cache(shape, cfg.dtype, kv_quant, device)


def _empty_cache_paged(cfg, n_blocks: int, page: int, kv_quant: bool,
                       device, kv_heads: int | None = None):
    """Paged KV pool ``[L, NB, KH, page, Dh]``; block 0 is the trash block
    that retired rows' table entries point at.  ``kv_heads``: a tp rank's
    KH/tp."""
    shape = (cfg.n_layers, n_blocks, kv_heads or cfg.kv_heads, page,
             cfg.d_head)
    return _zeros_cache(shape, cfg.dtype, kv_quant, device)


def _zeros_cache(shape, dtype, kv_quant: bool, device):
    if kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _quantize_kv(x):
    """x [..., Dh] -> (int8 values, f32 scale [...]): symmetric
    per-vector absmax quantization, one scale per head-dim vector."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


class InferenceEngine:
    """Prefill + decode for a TransformerLM, on ``device`` (the card
    unless the caller asks for the CPU; must match the model's).
    ``int8_compute``: int8 x int8 products wherever a leaf is quantized
    (a dense draft model; MoE is refused, as in the reference: its int8
    experts dequantize through ``wt``).  An MoE model's prefill routes at
    the training forward's capacity; decode and ``extend_multi`` at full
    capacity.  ``mesh``: serve over dp x tp (module docstring)."""

    def __init__(self, model: TransformerLM, max_seq: int | None = None,
                 kv_quant: bool = False, attn_impl: str | None = None,
                 int8_compute: bool = False, mesh=None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model on {model.device}, engine asked for {self.device}"
            )
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        check_slice(mesh, "serving", SERVE_AXES,
                    reason="the reference serves on dp and tp only "
                           "(ROADMAP.md queue 1 item 11, step 4)")
        tp = axis_size(mesh, "tp")
        if tp > 1 and self.cfg.kv_heads % tp != 0:
            raise ValueError(
                f"n_kv_heads={self.cfg.kv_heads} must be a multiple of "
                f"tp={tp} — the KV cache's head axis shards over 'tp'"
            )
        # The group a rank's partial sums and vocabulary slices cross
        # (None off a tp mesh), and the KV heads its cache holds.
        self.tp_group = axis_group(mesh, "tp")
        self.kv_heads = self.cfg.kv_heads // tp
        self.max_seq = max_seq or self.cfg.max_seq
        self.kv_quant = bool(kv_quant)
        self.attn_impl = attn_impl or self.cfg.attn_impl
        if self.attn_impl not in ("gather", "paged_kernel"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r} — expected 'gather' or "
                "'paged_kernel'"
            )
        self.int8_compute = bool(int8_compute)
        if self.int8_compute and self.cfg.moe:
            raise ValueError(
                "int8_compute targets dense draft models - MoE dispatch "
                "keeps the wt() dequant path"
            )

    def _arange(self, n):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def empty_cache(self, batch: int, max_seq: int | None = None):
        """A zeroed dense cache of ``batch`` rows at this rank's KV
        heads."""
        return _empty_cache(self.cfg, batch, max_seq or self.max_seq,
                            self.kv_quant, self.device, self.kv_heads)

    def empty_pool(self, n_blocks: int, page: int):
        """A zeroed paged pool at this rank's KV heads."""
        return _empty_cache_paged(self.cfg, n_blocks, page, self.kv_quant,
                                  self.device, self.kv_heads)

    def _embed(self, params, tokens):
        """The embedding lookup (vocabulary-parallel on a tp mesh)."""
        return self.model._embed(params["embed"], tokens, self.mesh)

    # -- cache-aware blocks ------------------------------------------------
    def _attend_cached(self, q, k_cache, v_cache, kv_len_mask,
                       k_scale=None, v_scale=None):
        """q [B, Sq, H, Dh]; caches [B, KH, T, Dh]; kv_len_mask [B, Sq, T]
        True where attention is allowed.  GQA groups the query heads
        against their shared K/V head by a reshape."""
        if k_scale is not None:
            k_cache = k_cache.to(q.dtype) * k_scale[..., None].to(q.dtype)
            v_cache = v_cache.to(q.dtype) * v_scale[..., None].to(q.dtype)
        cfg = self.cfg
        scale = cfg.d_head ** -0.5
        H, KH = q.shape[2], k_cache.shape[1]
        if H == KH:
            s = torch.einsum("bqhd,bhkd->bhqk", q, k_cache) * scale
            s = torch.where(kv_len_mask[:, None], s, -1e30)
            p = torch.softmax(s.float(), dim=-1).to(q.dtype)
            return torch.einsum("bhqk,bhkd->bqhd", p, v_cache)
        B, Sq = q.shape[0], q.shape[1]
        qg = q.reshape(B, Sq, KH, H // KH, cfg.d_head)
        s = torch.einsum("bqhgd,bhtd->bhgqt", qg, k_cache) * scale
        s = torch.where(kv_len_mask[:, None, None], s, -1e30)
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhgqt,bhtd->bqhgd", p, v_cache)
        return o.reshape(B, Sq, H, cfg.d_head)

    @staticmethod
    def _cache_store(arr, val, start, layer: int):
        """Write ``val`` [B, KH, Sq, *rest] into the dense cache ``arr``
        [L, B, KH, T, *rest] at ``start``, in place, in the reference's
        three write geometries:

        - a host int: every row at one offset (prefill, uniform decode),
          clamped to [0, T - Sq] as ``dynamic_update_slice`` clamps;
        - a [B] tensor with Sq 1: one position a row (continuous
          batching);
        - a [B] tensor with Sq W: a window a row (``extend_multi``).

        Per-row positions at or past T are dropped, as the reference's
        scatter drops them: retired and over-budget rows keep advancing
        past ``max_seq``.  A dropped column c is sent to c mod T, which
        no in-range column of the row's window takes (W <= T), and
        writes back what it read there: nothing live moves, no index
        repeats, and the round needs no host-side test of positions."""
        sq, T = val.shape[2], arr.shape[3]
        if not torch.is_tensor(start):
            s = min(max(int(start), 0), T - sq)
            arr[layer, :, :, s:s + sq] = val.to(arr.dtype)
            return
        cols = start.long()[:, None] + torch.arange(sq, device=start.device)
        rows = torch.arange(val.shape[0], device=start.device)[:, None]
        idx = cols % T                                        # [B, Sq]
        keep = (cols < T).reshape(*cols.shape, *([1] * (arr.dim() - 3)))
        dest = arr[layer]
        cur = dest[rows, :, idx]                          # [B, Sq, KH, ...]
        dest[rows, :, idx] = torch.where(
            keep, val.transpose(1, 2).to(arr.dtype), cur)

    @staticmethod
    def _paged_store(arr, val, pages, pos, page: int, layer: int):
        """Scatter ``val`` [B, KH, Sq, *rest] into the paged pool ``arr``
        [L, NB, KH, page, *rest] through page tables ``pages`` [B, MP] at
        positions ``pos`` [B] (the window starts when Sq > 1), in place.
        Logical position p of row b lives at (pages[b, p // page],
        p % page).  Positions past the table (p >= MP * page) go to block
        0, the trash block, and are never clamped onto the table's last
        entry, which may be a live (shared) block."""
        B, sq = val.shape[0], val.shape[2]
        mp = pages.shape[1]
        if sq == 1:
            q_pos = pos.long()[:, None]                          # [B, 1]
        else:
            q_pos = pos.long()[:, None] + torch.arange(sq, device=pos.device)
        p_idx = q_pos // page
        rows = torch.arange(B, device=pos.device)[:, None]
        blk = torch.where(
            p_idx < mp, pages[rows, p_idx.clamp(max=mp - 1)].long(), 0
        )                                                        # [B, Sq]
        off = q_pos % page                                       # [B, Sq]
        arr[layer][blk, :, off] = val.transpose(1, 2).to(arr.dtype)

    @staticmethod
    def _paged_read(arr, tbl, layer: int):
        """Row-contiguous view [B, KH, P*page, *rest] of the pages in
        ``tbl`` [B, P]: the page table already cut to the read bound, so
        the four pool leaves gather through one operand."""
        sel = arr[layer][tbl]                        # [B, P, KH, page, ...]
        sel = sel.transpose(1, 2)                    # [B, KH, P, page, ...]
        return sel.reshape(sel.shape[0], sel.shape[1],
                           sel.shape[2] * sel.shape[3], *sel.shape[4:])

    def _block_cached(self, x, lp, cache, positions, start, mask, layer,
                      pages=None, page: int = 0, kv_start=None,
                      lp_ad=None, adapter_idx=None, moe_full_capacity=None):
        """One block over the query slice x [B, Sq, D], writing the
        slice's K/V into layer ``layer`` of ``cache`` at ``start`` (a host
        int for the dense cache, a [B] tensor for the paged pool).
        ``lp_ad``: this layer's adapter bank, rows picking theirs by
        ``adapter_idx`` [B].  ``moe_full_capacity``: None = full capacity
        only at Sq == 1 (decode); ``extend_multi`` passes True, so a
        verify window routes experts as the width-1 decodes it stands in
        for."""
        m = self.model
        dt = self.cfg.dtype
        h = m._rmsnorm(x, lp["ln1"])
        if self.int8_compute and isinstance(lp["wq"], dict):
            # Column-parallel: D is whole, the heads this rank's.
            q = int8_dot(h, lp["wq"], dt, 1)
            k = int8_dot(h, lp["wk"], dt, 1)
            v = int8_dot(h, lp["wv"], dt, 1)
        else:
            q = torch.einsum("bsd,dhk->bshk", h, wt(lp["wq"], dt))
            k = torch.einsum("bsd,dhk->bshk", h, wt(lp["wk"], dt))
            v = torch.einsum("bsd,dhk->bshk", h, wt(lp["wv"], dt))
        if lp_ad is not None:
            # Per-row LoRA deltas from the input the base products take.
            def delta(name, t):
                if name not in lp_ad:
                    return t
                d = lora_delta(h, lp_ad[name], adapter_idx, dt)
                return t + d.reshape(t.shape)

            q, k, v = delta("wq", q), delta("wk", k), delta("wv", v)
        q = m._rope(q, positions)
        k = m._rope(k, positions).transpose(1, 2)    # [B, KH, Sq, Dh]
        v = v.transpose(1, 2)
        if self.kv_quant:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            writes = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
        else:
            writes = {"k": k, "v": v}
        T_eff = mask.shape[-1]
        if pages is not None:
            for name, val in writes.items():
                self._paged_store(cache[name], val, pages, start, page,
                                  layer)
            if self.attn_impl == "paged_kernel":
                o = paged_attention(
                    q, cache["k"][layer], cache["v"][layer], pages, start,
                    kv_start, page=page, t_hi=T_eff,
                    k_scale=cache["k_s"][layer] if self.kv_quant else None,
                    v_scale=cache["v_s"][layer] if self.kv_quant else None,
                )
            else:
                tbl = pages[:, :T_eff // page].long()  # bound hoisted once
                reads = {name: self._paged_read(cache[name], tbl, layer)
                         for name in writes}
                o = self._attend_cached(q, reads["k"], reads["v"], mask,
                                        reads.get("k_s"), reads.get("v_s"))
        else:
            for name, val in writes.items():
                self._cache_store(cache[name], val, start, layer)
            reads = {name: cache[name][layer, :, :, :T_eff]
                     for name in writes}
            o = self._attend_cached(q, reads["k"], reads["v"], mask,
                                    reads.get("k_s"), reads.get("v_s"))
        return self._block_epilogue(x, o, lp, mask, lp_ad, adapter_idx,
                                    moe_full_capacity)

    def _block_epilogue(self, x, o, lp, mask, lp_ad=None, adapter_idx=None,
                        moe_full_capacity=None):
        """Attention output projection (with the row's wo delta) + MLP,
        shared by both caches.  An MoE MLP routes only query rows that
        attend somewhere (``mask.any(-1)``): left-pad rows take no expert
        capacity ahead of real tokens."""
        m = self.model
        dt = self.cfg.dtype
        tp = self.tp_group
        int8 = self.int8_compute and isinstance(lp["wo"], dict)
        # On a tp mesh each rank holds the partial sum of its heads (and
        # its share of the adapter's (o A) B); the int8 product is whole
        # already (its int32 sums are added over tp).
        delta = None
        if lp_ad is not None and "wo" in lp_ad:
            o_flat = o.reshape(o.shape[0], o.shape[1], -1)
            delta = lora_delta(o_flat, lp_ad["wo"], adapter_idx, dt)
        if int8:
            attn_out = int8_dot(o, lp["wo"], dt, 2, tp)
            if delta is not None:
                attn_out = attn_out + reduce_from(delta, tp)
        else:
            attn_out = torch.einsum("bshk,hkd->bsd", o, wt(lp["wo"], dt))
            if delta is not None:
                attn_out = attn_out + delta
            attn_out = reduce_from(attn_out, tp)
        x = x + attn_out
        h2 = m._rmsnorm(x, lp["ln2"])
        if self.cfg.moe:
            full = (x.shape[1] == 1 if moe_full_capacity is None
                    else moe_full_capacity)
            y, _ = m._moe_mlp(h2, lp, full_capacity=full,
                              token_mask=mask.any(-1), tp=tp)
            return x + y
        if not int8:
            return x + m._dense_mlp(h2, lp, self.mesh)
        g = int8_dot(h2, lp["wi_gate"], dt, 1)
        u = int8_dot(h2, lp["wi_up"], dt, 1)
        return x + int8_dot(torch.nn.functional.silu(g) * u, lp["wo_mlp"],
                            dt, 1, tp)

    def _run_blocks(self, params, x, cache, positions, start, mask,
                    pages=None, page: int = 0, kv_start=None,
                    adapters=None, adapter_idx=None, moe_full_capacity=None):
        for layer in range(self.cfg.n_layers):
            x = self._block_cached(
                x, layer_params(params["blocks"], layer), cache, positions,
                start, mask, layer, pages=pages, page=page,
                kv_start=kv_start, lp_ad=layer_slice(adapters, layer),
                adapter_idx=adapter_idx, moe_full_capacity=moe_full_capacity,
            )
        return self._head(params, x), cache

    def _head(self, params, x):
        """Final RMSNorm + vocabulary projection, logits in f32 (on a tp
        mesh the ranks' vocabulary slices gathered in f32)."""
        x = self.model._rmsnorm(x, params["final_norm"])
        if self.int8_compute and isinstance(params["head"], dict):
            logits = int8_dot(x, params["head"], self.cfg.dtype, 1).float()
        else:
            logits = torch.einsum(
                "bsd,dv->bsv", x, wt(params["head"], self.cfg.dtype)
            ).float()
        return gather_from(logits, self.tp_group, -1)

    # -- dense cache: one batch at one shared position --------------------
    @torch.no_grad()
    def prefill(self, params, tokens, pad_left: int = 0, cache=None,
                adapters=None, adapter_idx=None):
        """tokens [B, S] -> (cache, last_logits [B, V]).  ``pad_left``
        leading positions are padding: excluded from attention, and RoPE
        starts at the first real token.  ``cache``: a [L, B, KH, T, ...]
        cache (T >= S) to zero and write into, in place of a new one of
        ``max_seq`` positions (the batcher passes its slot's row)."""
        B, S = tokens.shape
        if cache is None:
            cache = self.empty_cache(B)
        else:
            for arr in cache.values():
                arr.zero_()
        x = self._embed(params, tokens)
        q_idx = self._arange(S)
        positions = (q_idx - pad_left).clamp_min(0)
        t = q_idx[None, :]
        mask = ((t <= q_idx[:, None]) & (t >= pad_left)).expand(B, S, S)
        logits, cache = self._run_blocks(params, x, cache, positions, 0, mask,
                                         adapters=adapters,
                                         adapter_idx=adapter_idx)
        return cache, logits[:, -1]

    @torch.no_grad()
    def decode_step(self, params, cache, pos: int, token, rope_pos=None,
                    kv_start: int = 0, t_hi: int | None = None):
        """token [B] at cache position ``pos`` -> (cache, logits [B, V]).
        ``rope_pos`` defaults to ``pos``; slots below ``kv_start`` are
        masked; ``t_hi`` bounds the attention read."""
        B = token.shape[0]
        x = self._embed(params, token)[:, None]
        rope = pos if rope_pos is None else rope_pos
        T = t_hi if t_hi is not None else self.max_seq
        t = self._arange(T)
        mask = ((t <= pos) & (t >= kv_start))[None, None].expand(B, 1, T)
        logits, cache = self._run_blocks(
            params, x, cache,
            torch.full((1,), rope, dtype=torch.int32, device=self.device),
            pos, mask,
        )
        return cache, logits[:, 0]

    # -- paged pool: every row at its own position -------------------------
    @torch.no_grad()
    def decode_step_multi(self, params, cache, token, pos, rope_pos,
                          kv_start, t_hi=None, pages=None, page: int = 0,
                          adapters=None, adapter_idx=None):
        """One decode step where row b sits at its own position: token,
        pos, rope_pos, kv_start [B] int32.  Row b attends to slots
        [kv_start[b], pos[b]] and writes its K/V at pos[b].  ``pages``
        [B, MP] int32 + ``page``: the paged pool, where ``t_hi`` rounds up
        to whole pages; without them ``cache`` is the dense [L, B, ...]
        cache.  ``t_hi`` bounds the read only: writes target the whole
        cache.  Returns (cache, logits [B, V])."""
        x = self._embed(params, token)[:, None]
        T = t_hi if t_hi is not None else self.max_seq
        if pages is not None:
            T = -(-T // page) * page
        t = self._arange(T)
        mask = ((t[None, :] <= pos[:, None])
                & (t[None, :] >= kv_start[:, None]))[:, None, :]  # [B,1,T]
        logits, cache = self._run_blocks(
            params, x, cache, rope_pos[:, None], pos, mask, pages=pages,
            page=page, kv_start=kv_start, adapters=adapters,
            adapter_idx=adapter_idx,
        )
        return cache, logits[:, 0]

    @torch.no_grad()
    def extend_multi(self, params, cache, tokens, start, rope_start,
                     kv_start, t_hi=None, pages=None, page: int = 0,
                     adapters=None, adapter_idx=None):
        """Multi-token forward where row b writes its own window: tokens
        [B, W]; start/rope_start/kv_start [B] int32.  Query start[b] + j
        attends to [kv_start[b], start[b] + j].  On the paged pool window
        writes scatter through the page tables (positions past the table
        land in the trash block); on the dense cache positions past
        ``max_seq`` are dropped.  An MoE model routes the window at full
        capacity: it stands in for W width-1 decode steps, which never
        drop a token.  Returns (cache, logits [B, W, V])."""
        B, W = tokens.shape
        q_pos = start[:, None] + self._arange(W)[None]            # [B, W]
        T = t_hi if t_hi is not None else self.max_seq
        if pages is not None:
            T = -(-T // page) * page
        t = self._arange(T)
        mask = ((t[None, None, :] <= q_pos[:, :, None])
                & (t[None, None, :] >= kv_start[:, None, None]))  # [B,W,T]
        x = self._embed(params, tokens)
        rope = rope_start[:, None] + self._arange(W)[None]
        logits, cache = self._run_blocks(
            params, x, cache, rope, start, mask, pages=pages, page=page,
            kv_start=kv_start, adapters=adapters, adapter_idx=adapter_idx,
            moe_full_capacity=True,
        )
        return cache, logits

    # -- sampling ----------------------------------------------------------
    @staticmethod
    def warp_logits(logits, sampling: SamplingConfig):
        """Temperature, top-k and top-p as one logits transform."""
        x = logits.float() / sampling.temperature
        if sampling.top_k > 0:
            top = torch.topk(x, sampling.top_k, dim=-1).values
            x = torch.where(x < top[..., -1:], -torch.inf, x)
        if 0.0 < sampling.top_p < 1.0:
            x = nucleus_mask(x, sampling.top_p)
        return x

    @staticmethod
    def _sample(logits, generator, sampling: SamplingConfig):
        if sampling.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        return gumbel_sample(
            InferenceEngine.warp_logits(logits, sampling), generator)

    # -- generate ----------------------------------------------------------
    @torch.no_grad()
    def generate(self, params, prompt, *, max_new_tokens: int = 32,
                 sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, pad_left: int = 0) -> DecodeOutput:
        """prompt [B, S] -> DecodeOutput on the dense cache.  Requires
        S + max_new_tokens <= max_seq; ``seed`` seeds the sampling
        generator."""
        B, S = prompt.shape
        if S + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt {S} + max_new {max_new_tokens} exceeds max_seq "
                f"{self.max_seq}"
            )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cache, last_logits = self.prefill(params, prompt, pad_left)
        first = self._sample(last_logits, gen, sampling)
        valid = first != sampling.eos_id
        done = ~valid
        toks = [torch.where(valid, first, sampling.pad_id)]
        lengths = valid.int()
        feed = torch.where(done, sampling.pad_id, first)
        t_hi = min(S + max_new_tokens, self.max_seq)
        for i in range(max_new_tokens - 1):
            cache, logits = self.decode_step(
                params, cache, S + i, feed, rope_pos=S + i - pad_left,
                kv_start=pad_left, t_hi=t_hi,
            )
            nxt = self._sample(logits, gen, sampling)
            valid = ~done & (nxt != sampling.eos_id)
            feed = torch.where(done, sampling.pad_id, nxt)
            done = done | (nxt == sampling.eos_id)
            toks.append(torch.where(valid, nxt, sampling.pad_id))
            lengths = lengths + valid.int()
        return DecodeOutput(tokens=torch.stack(toks, dim=1), lengths=lengths,
                            prompt_logits=last_logits)

    # -- constrained generation -------------------------------------------
    @torch.no_grad()
    def generate_constrained(self, params, prompt, constraint, *,
                             max_new_tokens: int = 32,
                             sampling: SamplingConfig = SamplingConfig(),
                             seed: int = 0, pad_left: int = 0) -> dict:
        """Generate under a ``constrain.RegexConstraint``.  Each row
        carries a DFA state; the state's ``allowed`` row masks the logits
        (-inf) and the chosen token gathers its next state.  A row stops
        at a dead end (no token keeps the string in the language) or on
        ``sampling.eos_id``, which is not emitted and leaves the state as
        it was: the batcher's constrained rows stop by the same rule.
        Greedy decoding is maximal munch (it goes on from accepting
        states that still have continuations).  Returns a dict of
        ``tokens`` [B, max_new] (pad after a stop), ``lengths``,
        ``prompt_logits`` and ``accepted`` [B]: whether each row stopped
        in an accepting state."""
        B, S = prompt.shape
        if S + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt {S} + max_new {max_new_tokens} exceeds max_seq "
                f"{self.max_seq}"
            )
        if constraint.allowed.shape[1] != self.cfg.vocab_size:
            raise ValueError(
                f"constraint built for vocab {constraint.allowed.shape[1]}, "
                f"model has {self.cfg.vocab_size}"
            )
        dev = self.device
        nxt_tab = torch.as_tensor(constraint.next_state, device=dev).long()
        allow_tab = torch.as_tensor(constraint.allowed, device=dev)
        accepting = torch.as_tensor(constraint.accepting, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pad, eos = sampling.pad_id, sampling.eos_id
        cache, last_logits = self.prefill(params, prompt, pad_left)

        def pick(logits, st, dn):
            mask = allow_tab[st] & ~dn[:, None]
            any_ok = mask.any(-1)
            masked = torch.where(mask, logits, -torch.inf)
            # A dead row's logits are all -inf: sample from zeros there (a
            # softmax over -inf is NaN), then pad it.
            tok = self._sample(torch.where(any_ok[:, None], masked, 0.0),
                               gen, sampling)
            tok = torch.where(any_ok, tok, pad)
            hit_eos = any_ok & ~dn & (tok == eos) if eos >= 0 else (
                torch.zeros_like(any_ok))
            valid = any_ok & ~dn & ~hit_eos
            emit = torch.where(valid, tok, pad)
            st = torch.where(valid, nxt_tab[st, emit], st)
            return emit, valid, st, dn | ~any_ok | hit_eos

        state = torch.full((B,), int(constraint.start), dtype=torch.long,
                           device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        tok, valid, state, done = pick(last_logits, state, done)
        toks, lengths = [tok], valid.int()
        t_hi = min(S + max_new_tokens, self.max_seq)
        for i in range(max_new_tokens - 1):
            cache, logits = self.decode_step(
                params, cache, S + i, tok, rope_pos=S + i - pad_left,
                kv_start=pad_left, t_hi=t_hi,
            )
            tok, valid, state, done = pick(logits, state, done)
            toks.append(tok)
            lengths = lengths + valid.int()
        return {"tokens": torch.stack(toks, dim=1), "lengths": lengths,
                "prompt_logits": last_logits, "accepted": accepting[state]}
