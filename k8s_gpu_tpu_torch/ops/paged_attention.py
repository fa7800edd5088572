"""Paged decode/window attention: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``k8s_gpu_tpu/ops/paged_attention.py``.  The kernel walks
each row's page table itself and streams physical K/V blocks with an
online softmax, so serving never materializes a gathered copy of the
pool; the plain version gathers the first ``t_hi // page`` table entries
and runs the engine's grouped attention (the same math as the engine's
``_paged_read`` + ``_attend_cached``).

``paged_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  On the CPU it keeps the reference's
two geometry fall-backs, each counted in ``fallback_count``: ``t_hi``
that is not a whole number of pages (or less than one), and a table
narrower than ``t_hi // page``.  A CUDA launch adds one to
``launch_count``.  A CUDA call the kernel cannot take (bad geometry
included), or a kernel that fails to build or launch, raises.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# Kernel launches and geometry fall-backs since the last reset_counts():
# a run reads them to show which path served it.
launch_count = 0
fallback_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def reset_counts() -> None:
    global launch_count, fallback_count
    launch_count = 0
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
    gate: head width 64 or 128 (one column per thread of the 128-thread
    block, 16-byte loads), pages a multiple of 16 positions, q in f32 or
    bf16, and the pool in q's type or int8.  The TPU's (sublane, 128)
    tiling rules do not apply on the card."""
    _, _, H, Dh = q_shape
    return (
        geometry_ok(page=page, t_hi=t_hi, max_pages=max_pages)
        and Dh in (64, 128)
        and page % 16 == 0
        and q_dtype in (torch.float32, torch.bfloat16)
        and kv_dtype in (q_dtype, torch.int8)
    )


def _kernel():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("paged_attention")
        lib.paged_attention_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.paged_attention_forward.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(q, k_pool, v_pool, pages, start, kv_start, page, t_hi,
            k_scale, v_scale):
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
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _kernel()
    rc = lib.paged_attention_forward(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        pages.data_ptr(), start.data_ptr(), kv_start.data_ptr(),
        out.data_ptr(), B, Sq, H, KH, Dh, page, pages.shape[1], t_hi,
        Dh ** -0.5, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    return out


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
    return out
