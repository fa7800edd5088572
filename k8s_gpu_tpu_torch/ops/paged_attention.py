"""Paged decode/window attention: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``k8s_gpu_tpu/ops/paged_attention.py``.  The kernel walks
each row's page table itself and streams physical K/V blocks with an
online softmax, so serving never materializes a gathered copy of the
pool; the plain version gathers the first ``t_hi // page`` table entries
and runs the engine's grouped attention (the same math as the engine's
``_paged_read`` + ``_attend_cached``).

The kernel has two routes, picked by ``plan`` from the folded row count
R = Sq * G (the G query heads sharing a KV head fold into rows):

- ``cuda-splitk`` (R <= 16, decode): the visible key range of each
  (batch row, KV head) is cut into splits of whole pages, one block each;
  each split writes f32 partials (m, l, acc) to a workspace, and the last
  split to finish merges them in split order.  float32 q with R > 16
  runs the same code on tiles of 16 rows (``cuda-fma``).
- ``cuda-mma`` (R > 16, bf16 q, admission windows): 64-row tiles on the
  tensor cores, the key range split the same way.

Both read only the pages between ``kv_start[b]`` and the tile's last
visible position (``split_ranges``).  A call is one launch.

``paged_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  On the CPU it keeps the reference's
two geometry fall-backs, each counted in ``fallback_count``: ``t_hi``
that is not a whole number of pages (or less than one), and a table
narrower than ``t_hi // page``.  A CUDA launch adds one to
``launch_count`` and one to ``launches_by_width[Sq]`` (decode steps at
1, verify windows at K + 1, admission windows at their bucket).  A
CUDA call the kernel cannot take (bad geometry included), or a kernel
that fails to build or launch, raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

NEG_INF = -1e30

# Kernel launches (in all and by the query width Sq) and geometry
# fall-backs since the last reset_counts(): a run reads them to show
# which path served it.
launch_count = 0
launches_by_width: dict[int, int] = {}
fallback_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def reset_counts() -> None:
    global launch_count, fallback_count
    launch_count = 0
    launches_by_width.clear()
    fallback_count = 0


def paged_attention_reference(q, k_pool, v_pool, pages, start, kv_start,
                              *, page: int, t_hi: int,
                              k_scale=None, v_scale=None):
    """q [B, Sq, H, Dh]; pools [NB, KH, page, Dh]; pages [B, MP] int;
    start/kv_start [B] int (query j of row b sits at start[b] + j).
    Returns [B, Sq, H, Dh] in q.dtype: GQA grouped, f32 softmax cast to
    q.dtype before the PV product, -1e30 mask fill."""
    B, Sq, H, Dh = q.shape
    KH = k_pool.shape[1]
    G = H // KH
    p_hi = t_hi // page
    tbl = pages[:, :p_hi].long()                          # hoisted bound
    k = k_pool[tbl].transpose(1, 2).reshape(B, KH, p_hi * page, Dh)
    v = v_pool[tbl].transpose(1, 2).reshape(B, KH, p_hi * page, Dh)
    if k_scale is not None:
        ks = k_scale[tbl].transpose(1, 2).reshape(B, KH, p_hi * page)
        vs = v_scale[tbl].transpose(1, 2).reshape(B, KH, p_hi * page)
        k = k.to(q.dtype) * ks[..., None].to(q.dtype)
        v = v.to(q.dtype) * vs[..., None].to(q.dtype)
    t = torch.arange(p_hi * page, device=q.device)
    q_pos = start.long()[:, None] + torch.arange(Sq, device=q.device)
    mask = (
        (t[None, None, :] <= q_pos[:, :, None])
        & (t[None, None, :] >= kv_start.long()[:, None, None])
    )                                                     # [B, Sq, T]
    qg = q.reshape(B, Sq, KH, G, Dh)
    s = torch.einsum("bqhgd,bhtd->bhgqt", qg, k) * Dh ** -0.5
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgqt,bhtd->bqhgd", p, v)
    return o.reshape(B, Sq, H, Dh)


def geometry_ok(*, page: int, t_hi: int, max_pages: int) -> bool:
    """Whole pages, at least one, and a table wide enough: the reference's
    geometry gate.  Outside it the CPU takes the counted fall-back and a
    CUDA call raises."""
    return t_hi % page == 0 and t_hi >= page and t_hi // page <= max_pages


def supported(q_shape, q_dtype, kv_dtype, *, page: int, t_hi: int,
              max_pages: int) -> bool:
    """Whether the CUDA kernel takes this call.  Besides the geometry
    gate: head width 64 or 128 (a lane's share of a row, 16-byte staging
    copies), pages a multiple of 16 positions (a group of 16 positions
    never straddles a page), q in f32 or bf16, and the pool in q's type or
    int8.  The TPU's (sublane, 128) tiling rules do not apply on the
    card."""
    _, _, H, Dh = q_shape
    return (
        geometry_ok(page=page, t_hi=t_hi, max_pages=max_pages)
        and Dh in (64, 128)
        and page % 16 == 0
        and q_dtype in (torch.float32, torch.bfloat16)
        and kv_dtype in (q_dtype, torch.int8)
    )


# Folded rows a block takes on each route, the window route's key tile,
# how many blocks an SM the split planner aims for, the fewest positions
# a split takes (shorter ranges take fewer splits), and the most splits
# a tile may have (the kernel keeps a weight per split and row).
DECODE_ROWS = 16
WINDOW_ROWS = 64
WINDOW_KEYS = 64
BLOCKS_PER_SM = 2
MIN_SPLIT_POSITIONS = 256
MAX_SPLITS = 64
# bf16's unit roundoff: the window route rounds p * v_scale to bf16 before
# the P V product (reference_p_rounding).
P_ROUNDING = 2.0 ** -8
_ROUTES = {"cuda-splitk": 0, "cuda-fma": 0, "cuda-mma": 1}


class Plan(NamedTuple):
    design: str      # cuda-splitk, cuda-mma or cuda-fma
    rows: int        # folded rows a block
    tiles: int       # row tiles a (batch row, KV head)
    splits: int      # blocks a row tile at most
    min_pages: int   # pages a split at least


def plan(q_shape, q_dtype, kv_heads: int, *, page: int, t_hi: int,
         n_sms: int) -> Plan:
    """How one call is cut into blocks.

    R = Sq * G <= 16 takes the decode route (``cuda-splitk``), a larger
    R the tensor cores in bf16 (``cuda-mma``, 64-row tiles) or the CUDA
    cores in float32 (``cuda-fma``, 16-row tiles, the decode route's
    code).  The grid gives every (batch row, KV head, row tile) ``splits``
    blocks, the count nearest BLOCKS_PER_SM blocks an SM, at least one,
    at most one a page of ``t_hi`` and at most MAX_SPLITS.  The positions
    are not known on the host, so each tile's own range decides on the
    card how many of them it uses (``split_ranges``): at least
    ``min_pages`` pages (MIN_SPLIT_POSITIONS positions) a split."""
    B, Sq, H, _ = q_shape
    R = Sq * (H // kv_heads)
    if R <= DECODE_ROWS:
        design, rows = "cuda-splitk", DECODE_ROWS
    elif q_dtype == torch.bfloat16:
        design, rows = "cuda-mma", WINDOW_ROWS
    else:
        design, rows = "cuda-fma", DECODE_ROWS
    tiles = -(-R // rows)
    blocks = B * kv_heads * tiles
    want = (BLOCKS_PER_SM * n_sms + blocks // 2) // blocks
    splits = max(1, min(want, t_hi // page, MAX_SPLITS))
    return Plan(design, rows, tiles, splits,
                max(1, MIN_SPLIT_POSITIONS // page))


def tile_pages(start: int, kv_start: int, r0: int, r_last: int, *, G: int,
               page: int, t_hi: int) -> tuple[int, int]:
    """Pages [p_lo, p_hi) that the tile of folded rows r0..r_last of one
    batch row reads: from ``kv_start`` to the last row's position, rounded
    out to whole pages.  When the tile's first row sees no position at
    all, the reference gives that row the uniform mean of V over every
    slot below ``t_hi``, so the tile then reads all of [0, t_hi).

    With ``split_ranges``, the mirror of the kernel's ``split_positions``
    (``csrc/paged_attention.cu``): a change to one is a change to both,
    and the ``gpu`` test ``test_cuda_splits_used_match_the_planner``
    holds the kernel's count of splits against ``tile_splits``."""
    lo = max(kv_start, 0)
    if lo > min(start + r0 // G, t_hi - 1):
        return 0, t_hi // page
    hi = min(t_hi, start + r_last // G + 1)
    return lo // page, -(-hi // page)


def split_ranges(p_lo: int, p_hi: int, splits: int,
                 min_pages: int = 1) -> list[tuple[int, int]]:
    """The kernel's cut of pages [p_lo, p_hi) into runs of whole pages, in
    order: ``splits`` of them, or fewer so that each has at least
    ``min_pages`` pages (one run when the range is shorter)."""
    n = p_hi - p_lo
    used = min(splits, max(1, n // min_pages))
    return [(p_lo + s * n // used, p_lo + (s + 1) * n // used)
            for s in range(used)]


def tile_splits(start, kv_start, *, Sq: int, G: int, rows: int,
                splits: int, min_pages: int, page: int,
                t_hi: int) -> list[list[int]]:
    """The splits each row tile of each batch row takes (the same for
    every KV head): ``len(split_ranges(tile_pages(...)))``, what the
    kernel writes to ``used`` (``_launch(count_splits=True)``)."""
    R = Sq * G
    return [[len(split_ranges(
        *tile_pages(int(st), int(kv), r0, min(R, r0 + rows) - 1, G=G,
                    page=page, t_hi=t_hi), splits, min_pages))
        for r0 in range(0, R, rows)]
        for st, kv in zip(start, kv_start)]


def reference_splitk(q, k_pool, v_pool, pages, start, kv_start, *,
                     page: int, t_hi: int, splits: int, rows: int,
                     min_pages: int = 1, k_scale=None, v_scale=None):
    """The kernel's split-K arithmetic in float32: each tile of ``rows``
    folded rows reads its ``tile_pages``, each of its ``split_ranges``
    gives
    partials (m, l, acc) (a split with no slot m = -1e30, l = 0), and
    the partials merge in split order: M = max m_s, l = sum l_s e^(m_s-M),
    acc = sum acc_s e^(m_s-M), out = acc / l.  Slots in a split's pages
    that a row does not see score -1e30, as in the reference.  Returns
    [B, Sq, H, Dh] float32."""
    B, Sq, H, Dh = q.shape
    KH = k_pool.shape[1]
    G = H // KH
    R = Sq * G
    qf = q.float().reshape(B, Sq, KH, G, Dh).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(B, KH, R, Dh)
    out = torch.empty(B, KH, R, Dh)
    for b in range(B):
        st, kv = int(start[b]), int(kv_start[b])
        for r0 in range(0, R, rows):
            r1 = min(R, r0 + rows)
            p_lo, p_hi = tile_pages(st, kv, r0, r1 - 1, G=G, page=page,
                                    t_hi=t_hi)
            q_pos = st + torch.arange(r0, r1) // G
            parts = []
            for s0, s1 in split_ranges(p_lo, p_hi, splits, min_pages):
                t = torch.arange(s0 * page, s1 * page)
                blk = pages[b, t // page].long()
                k = k_pool[blk, :, t % page].float()          # [T, KH, Dh]
                v = v_pool[blk, :, t % page].float()
                if k_scale is not None:
                    k = k * k_scale[blk, :, t % page][..., None]
                    v = v * v_scale[blk, :, t % page][..., None]
                s = torch.einsum("hrd,thd->hrt", qf[b, :, r0:r1], k)
                s = s * Dh ** -0.5
                seen = (t[None] <= q_pos[:, None]) & (t[None] >= kv)
                s = torch.where(seen[None], s, NEG_INF)
                m = s.amax(-1) if t.numel() else torch.full(
                    (KH, r1 - r0), NEG_INF)
                p = torch.exp(s - m[..., None])
                parts.append((m, p.sum(-1),
                              torch.einsum("hrt,thd->hrd", p, v)))
            m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            l_sum = torch.zeros(KH, r1 - r0)
            acc = torch.zeros(KH, r1 - r0, Dh)
            for m, l, a in parts:
                w = torch.exp(m - m_all)
                l_sum = l_sum + l * w
                acc = acc + a * w[..., None]
            out[b, :, r0:r1] = acc / l_sum[..., None]
    out = out.reshape(B, KH, Sq, G, Dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, Dh)


def reference_p_rounding(q, k_pool, v_pool, pages, start, kv_start, *,
                         page: int, t_hi: int, k_scale=None, v_scale=None):
    """[B, Sq, H, Dh] float32 bound of what the window route's one new
    rounding moves an output by: p * v_scale is rounded to bf16 before
    the P V product, bf16's unit roundoff 2^-8 on each factor, so an
    output moves by at most 2^-8 sum_t p_t |v_t| / l = 2^-8 (P.|V|), from
    the float32 plain softmax and the dequantized V.  (q is already bf16,
    and int8 -> bf16 and K's scale after the product are exact.)"""
    def wide(t):
        return t.float() if t.is_floating_point() else t

    return P_ROUNDING * paged_attention_reference(
        q.float(), wide(k_pool), wide(v_pool).abs(), pages, start, kv_start,
        page=page, t_hi=t_hi, k_scale=k_scale, v_scale=v_scale)


class _Dims(ctypes.Structure):
    """A launch's sizes and options (``Dims`` in the source), one a
    geometry: the wrapper passes its address, not 14 arguments."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "Sq", "H", "KH", "Dh", "page", "max_pages", "t_hi", "route",
        "splits", "min_pages", "q_dtype", "kv_dtype")] + [
        ("scale", ctypes.c_float)]


def _kernel():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("paged_attention")
        lib.paged_attention_forward.argtypes = [ctypes.c_void_p] * 14
        lib.paged_attention_forward.restype = ctypes.c_int
        lib.paged_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.paged_attention_smem.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# Per device and stream: the split partials' f32 workspace and the int32
# tickets (zeroed once; the last split of a tile sets its ticket back to
# 0).  Kernels on one stream take them in turn; two streams never share
# them.  Both only grow, to a new tensor: a captured CUDA graph keeps the
# old one, so capture must come after a call of the largest geometry it
# replays has sized them, and no larger call may follow it on that stream.
_scratch: dict = {}
_n_sms: dict = {}


def _scratch_for(key, n_work: int, n_tickets: int) -> tuple:
    """The workspace and tickets of ``key`` = (device, stream handle) and
    their addresses, at least this large."""
    got = _scratch.get(key)
    if got is None or got[0].numel() < n_work or got[1].numel() < n_tickets:
        if got is not None:
            n_work = max(n_work, got[0].numel())
            n_tickets = max(n_tickets, got[1].numel())
        work = torch.empty(n_work, dtype=torch.float32, device=key[0])
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=key[0])
        got = _scratch[key] = (work, tickets, work.data_ptr(),
                               tickets.data_ptr())
    return got


def sm_count(dev) -> int:
    if dev not in _n_sms:
        _n_sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _n_sms[dev]


@functools.lru_cache(maxsize=None)
def _call_for(q_shape, q_dtype, kv_dtype, kv_heads, page, max_pages, t_hi,
              dev, splits) -> tuple:
    """What a launch of this geometry passes besides its pointers, worked
    out once: serving calls the wrapper 16 times a decode step with the
    same few geometries, and is host-bound.  ``splits`` overrides the
    planner (that many for every tile, at least a page each).  Returns
    the row tiles, the workspace's and tickets' sizes, and the ``_Dims``
    (the cache keeps it alive) with its address."""
    cut = plan(q_shape, q_dtype, kv_heads, page=page, t_hi=t_hi,
               n_sms=sm_count(dev))
    n_split, min_pages = cut.splits, cut.min_pages
    if splits is not None:
        top = min(t_hi // page, MAX_SPLITS)
        if not 1 <= splits <= top:
            raise ValueError(f"splits {splits} outside 1..{top}")
        n_split, min_pages = splits, 1
    B, Sq, H, Dh = q_shape
    n_tiles = B * kv_heads * cut.tiles
    dims = _Dims(B, Sq, H, kv_heads, Dh, page, max_pages, t_hi,
                 _ROUTES[cut.design], n_split, min_pages,
                 _DTYPE_CODES[q_dtype], _DTYPE_CODES[kv_dtype], Dh ** -0.5)
    return (cut.tiles, n_tiles * n_split * cut.rows * (Dh + 2), n_tiles,
            dims, ctypes.addressof(dims))


def _check(name, t, dtype, shape):
    if t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(q, k_pool, v_pool, pages, start, kv_start, page, t_hi,
            k_scale, v_scale, splits=None, count_splits=False):
    """One launch.  ``splits`` overrides the planner: that many splits
    for every tile whatever its range (at least a page each).  With
    ``count_splits`` it returns (out, used): int32 [B, KH, row tiles],
    the splits each tile took, as the kernel counted them."""
    B, Sq, H, Dh = q.shape
    NB, KH = k_pool.shape[0], k_pool.shape[1]
    dev = q.device
    operands = [q, k_pool, v_pool, pages, start, kv_start]
    quant = k_scale is not None
    if quant:
        operands += [k_scale, v_scale]
    for t in operands:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    if H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of kv heads {KH}")
    _check("q", q, q.dtype, (B, Sq, H, Dh))
    _check("k_pool", k_pool, k_pool.dtype, (NB, KH, page, Dh))
    _check("v_pool", v_pool, k_pool.dtype, (NB, KH, page, Dh))
    _check("pages", pages, torch.int32, (B, pages.shape[1]))
    _check("start", start, torch.int32, (B,))
    _check("kv_start", kv_start, torch.int32, (B,))
    if quant:
        _check("k_scale", k_scale, torch.float32, (NB, KH, page))
        _check("v_scale", v_scale, torch.float32, (NB, KH, page))
    ptrs = [t.data_ptr() for t in operands]
    aligned = ptrs[0] | ptrs[1] | ptrs[2]
    if (aligned | ptrs[6] | ptrs[7] if quant else aligned) % 16:
        raise ValueError("q, pools and scales must be 16-byte aligned")
    tiles, n_work, n_tickets, _, dims = _call_for(
        q.shape, q.dtype, k_pool.dtype, KH, page, pages.shape[1], t_hi, dev,
        splits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, _, work, tickets = _scratch_for((dev, stream), n_work, n_tickets)
    used = (torch.zeros(B, KH, tiles, dtype=torch.int32, device=dev)
            if count_splits else None)
    out = torch.empty_like(q)
    lib = _kernel()
    rc = lib.paged_attention_forward(
        *ptrs[:3], *(ptrs[6:] if quant else (None, None)), *ptrs[3:6],
        out.data_ptr(), work, tickets,
        None if used is None else used.data_ptr(), dims, stream,
    )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    return (out, used) if count_splits else out


def paged_attention(q, k_pool, v_pool, pages, start, kv_start,
                    *, page: int, t_hi: int, k_scale=None, v_scale=None):
    """q [B, Sq, H, Dh] against the physical pool [NB, KH, page, Dh]
    through per-row page tables [B, MP] (int32 on the card); row b's
    query j attends logical positions [kv_start[b], start[b] + j] within
    the first ``t_hi`` slots."""
    global launch_count, fallback_count
    args = (q, k_pool, v_pool, pages, start, kv_start)
    kw = dict(page=page, t_hi=t_hi, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        if not geometry_ok(page=page, t_hi=t_hi, max_pages=pages.shape[1]):
            fallback_count += 1
        return paged_attention_reference(*args, **kw)
    if not supported(q.shape, q.dtype, k_pool.dtype, page=page, t_hi=t_hi,
                     max_pages=pages.shape[1]):
        raise ValueError(
            f"paged_attention kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} with a {k_pool.dtype} pool of page {page}, t_hi "
            f"{t_hi} and a table of {pages.shape[1]} pages (see supported())"
        )
    out = _launch(q, k_pool, v_pool, pages, start, kv_start, page, t_hi,
                  k_scale, v_scale)
    launch_count += 1
    width = q.shape[1]
    launches_by_width[width] = launches_by_width.get(width, 0) + 1
    return out
