"""Causal ring attention over the ``sp`` mesh axis, zigzag-balanced: the
port of ``k8s_gpu_tpu/parallel/ring_attention.py`` on
``torch.distributed``.

Each rank holds its contiguous sequence block [B, H, S/sp, D] and owns,
after the zigzag transform, two half-chunks: chunk ``my`` and chunk
``2n-1-my`` of the 2n half-chunks (``_zigzag_perms``; two ppermutes in,
two out).  Then every hop costs every rank two mask-free half-blocks:

- hop 0 is local: causal attention over the rank's own [lo; hi] pair,
  the only masked block of the schedule;
- on hop t > 0, holding the K/V that started at rank ``src``,
  ``q_hi x k_lo`` is always fully visible, and exactly one of
  ``q_lo x k_lo`` (src < my) or ``q_hi x k_hi`` (src > my) is.  A
  process knows its rank, so the choice is a Python branch.

K/V halves travel as one stacked tensor, one ppermute a hop.  Every
block attend is one call of the flash kernels, which return the
normalized output and its lse: matched heads take
``flash_attention_lse``, grouped K/V (fewer heads than q) ride the ring
at their KV heads and take ``flash_attention_v2_lse`` with rope outside.
The per-block results merge on their lse in f32 (``_fold``); the kernels
mask with -1e30, never -inf.  The backward is autograd's, through the
flash functions (with a non-zero lse cotangent) and the differentiable
ppermute.  On the CPU the hops take the plain versions, as every path
of the port does; on the card a hop the kernels do not take raises,
where the reference demotes to its einsum oracle.
"""

from __future__ import annotations

import torch

from ..ops.attention import flash_attention_lse, flash_attention_v2_lse
from .collectives import ppermute
from .mesh import axis_rank, axis_size

NEG_INF = -1e30


def _zigzag_perms(n: int):
    """Source-indexed ppermute tables moving contiguous half-chunks to their
    zigzag owners.  Contiguous device d holds half-chunks (2d, 2d+1); zigzag
    device e owns half-chunks (e, 2n-1-e).  holder(h) = h if h < n else
    2n-1-h."""
    holder = lambda h: h if h < n else 2 * n - 1 - h  # noqa: E731
    first = [(d, holder(2 * d)) for d in range(n)]        # even half-chunks
    second = [(d, holder(2 * d + 1)) for d in range(n)]   # odd half-chunks
    return first, second


def _to_zigzag(x, group, n: int, my: int):
    """[..., C, D] contiguous local chunk -> (lo, hi) zigzag half-chunks.
    Half-chunk ``my`` has ``my``'s parity, ``2n-1-my`` the other."""
    first, second = _zigzag_perms(n)
    c = x.shape[-2]
    r1 = ppermute(x[..., : c // 2, :], group, first)
    r2 = ppermute(x[..., c // 2:, :], group, second)
    return (r1, r2) if my % 2 == 0 else (r2, r1)


def _from_zigzag(lo, hi, group, n: int, my: int):
    """Inverse of _to_zigzag: (lo, hi) zigzag halves -> contiguous chunk."""
    first, second = _zigzag_perms(n)
    inv = lambda perm: [(dst, src) for (src, dst) in perm]  # noqa: E731
    s1, s2 = (lo, hi) if my % 2 == 0 else (hi, lo)
    r1 = ppermute(s1, group, inv(first))
    r2 = ppermute(s2, group, inv(second))
    return torch.cat([r1, r2], dim=-2)


def _block_attend(q, k, v, causal: bool, block_q, block_k):
    """One block attend -> (normalized out f32, lse f32), through the
    flash kernels: v2 for grouped K/V (rope outside), v1 otherwise."""
    if k.shape[1] != q.shape[1]:
        o, lse = flash_attention_v2_lse(q, k, v, causal=causal,
                                        block_q=block_q, block_k=block_k)
    else:
        o, lse = flash_attention_lse(q, k, v, causal, block_q, block_k)
    return o.float(), lse


def _fold(acc, block):
    """Merge a (normalized out, lse) block into the accumulator:
    merged = sum_i o_i exp(lse_i - lse_new), lse_new = logaddexp(lse_i)."""
    o, lse = acc
    bo, blse = block
    lse_new = torch.logaddexp(lse, blse)
    w_old = torch.exp(lse - lse_new)
    w_blk = torch.exp(blse - lse_new)
    return o * w_old[..., None] + bo * w_blk[..., None], lse_new


def _ring_attention_local(q, k, v, *, group, n: int, my: int,
                          block_q=None, block_k=None):
    """This rank's body: q, k, v its contiguous blocks [B, H, S/sp, D]."""
    if n == 1:
        return _block_attend(q, k, v, True, block_q, block_k)[0].to(q.dtype)
    c = q.shape[-2]
    if c % 2:
        raise ValueError(f"local seq {c} must be even for zigzag ring")
    q_lo, q_hi = _to_zigzag(q, group, n, my)
    k_lo, k_hi = _to_zigzag(k, group, n, my)
    v_lo, v_hi = _to_zigzag(v, group, n, my)

    # Hop 0 (local): causal over the [lo; hi] pair.  Chunk `my` precedes
    # chunk `2n-1-my` on every rank, so hi -> lo is visible, lo -> hi not.
    o0, lse0 = _block_attend(torch.cat([q_lo, q_hi], dim=-2),
                             torch.cat([k_lo, k_hi], dim=-2),
                             torch.cat([v_lo, v_hi], dim=-2), True,
                             block_q, block_k)
    half = c // 2
    acc_lo = (o0[..., :half, :], lse0[..., :half])
    acc_hi = (o0[..., half:, :], lse0[..., half:])

    kv = torch.stack([k_lo, k_hi, v_lo, v_hi])      # one collective a hop
    perm = [(i, (i + 1) % n) for i in range(n)]
    for step in range(1, n):
        kv = ppermute(kv, group, perm)
        kl, kh, vl, vh = kv.unbind(0)
        src = (my - step) % n
        # q_hi x k_lo: always fully visible.
        acc_hi = _fold(acc_hi, _block_attend(q_hi, kl, vl, False,
                                             block_q, block_k))
        # The visible one of (q_lo x k_lo) / (q_hi x k_hi).
        if src < my:
            acc_lo = _fold(acc_lo, _block_attend(q_lo, kl, vl, False,
                                                 block_q, block_k))
        else:
            acc_hi = _fold(acc_hi, _block_attend(q_hi, kh, vh, False,
                                                 block_q, block_k))
    # Cast before the transfer: the same values, half the bytes in bf16.
    return _from_zigzag(acc_lo[0].to(q.dtype), acc_hi[0].to(q.dtype),
                        group, n, my)


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp",
                   block_q: int | None = None, block_k: int | None = None):
    """Causal self-attention with the sequence sharded over *axis_name*.

    q: this rank's block [B, H, S/sp, D] (rank r of sp holds positions
    [r S/sp, (r+1) S/sp)); k, v: [B, H, S/sp, D] or grouped [B, KH,
    S/sp, D] with H % KH == 0.  Returns this rank's block of the output
    [B, H, S/sp, D].  Every rank of the sp group calls it with the same
    shapes."""
    n = axis_size(mesh, axis_name)
    return _ring_attention_local(
        q, k, v, group=mesh.get_group(axis_name) if n > 1 else None, n=n,
        my=axis_rank(mesh, axis_name), block_q=block_q, block_k=block_k)


def plain_causal_attention(q, k, v):
    """Single-shard reference path: same math, no ring; the oracle of the
    tests."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    mask = (torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(sk, device=q.device)[None, :])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
