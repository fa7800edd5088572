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

Under ``remat_policy="save_attn"`` the model keeps what the forward
made (``ring_attention_saving``: the merged output and lse of each
zigzag half) and its backward replays the ring around them
(``ring_attention_replay``): the zigzag moves of q, k and v run again,
but no hop's forward does.  The backward (``_RingReplay``) starts from
delta = rowsum(dO * O) of each half and rotates K/V around the ring
once more; each hop runs the flash backward kernels
(``ops.attention.hop_backward``) on the visible blocks against the
*final* lse, so a block's probabilities are the whole row's, and the
dK/dV accumulated for the K/V a rank holds travel with them, reaching
their owner after one last hop.
"""

from __future__ import annotations

import torch

from ..ops.attention import (
    _delta, flash_attention_lse, flash_attention_v2_lse, hop_backward,
)
from .collectives import _ppermute, ppermute
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


def _zigzag_qkv(q, k, v, group, n: int, my: int):
    """q, k and v's zigzag halves: (q_lo, q_hi, k_lo, k_hi, v_lo, v_hi)."""
    c = q.shape[-2]
    if c % 2:
        raise ValueError(f"local seq {c} must be even for zigzag ring")
    return (*_to_zigzag(q, group, n, my), *_to_zigzag(k, group, n, my),
            *_to_zigzag(v, group, n, my))


def _ring_attention_local(q, k, v, *, group, n: int, my: int,
                          block_q=None, block_k=None, keep: bool = False):
    """This rank's body: q, k, v its contiguous blocks [B, H, S/sp, D].
    ``keep``: also return (o_lo, o_hi, lse_lo, lse_hi), each half's
    merged output (in q's type) and lse."""
    if n == 1:
        return _block_attend(q, k, v, True, block_q, block_k)[0].to(q.dtype)
    q_lo, q_hi, k_lo, k_hi, v_lo, v_hi = _zigzag_qkv(q, k, v, group, n, my)
    c = q.shape[-2]

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
    o_lo, o_hi = acc_lo[0].to(q.dtype), acc_hi[0].to(q.dtype)
    o = _from_zigzag(o_lo, o_hi, group, n, my)
    return (o, (o_lo, o_hi, acc_lo[1], acc_hi[1])) if keep else o


class _RingReplay(torch.autograd.Function):
    """The zigzag halves' saved outputs as a function of q, k and v's
    halves; the backward is the ring's flash backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo, o_hi, lse_lo,
                lse_hi, group, n, my):
        ctx.save_for_backward(q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo,
                              o_hi, lse_lo, lse_hi)
        ctx.ring = (group, n, my)
        return o_lo.view_as(o_lo), o_hi.view_as(o_hi)

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        (q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo, o_hi, lse_lo,
         lse_hi) = ctx.saved_tensors
        group, n, my = ctx.ring
        # dO and delta = rowsum(dO * O) of each half; the lse is not an
        # output of the block, so it has no cotangent.
        g_lo, d_lo = _delta(o_lo, g_lo, None)
        g_hi, d_hi = _delta(o_hi, g_hi, None)
        half = q_lo.shape[-2]

        def cat(a, b, dim=-2):
            return torch.cat([a, b], dim)

        # Hop 0: the causal [lo; hi] pair against the rank's own K/V.
        dq, dk, dv = hop_backward(
            cat(q_lo, q_hi), cat(k_lo, k_hi), cat(v_lo, v_hi),
            cat(g_lo, g_hi), cat(lse_lo, lse_hi, -1), cat(d_lo, d_hi, -1),
            True)
        dq_lo, dq_hi = dq[..., :half, :].float(), dq[..., half:, :].float()
        # dK/dV of the K/V this rank holds, [k_lo, k_hi, v_lo, v_hi].
        dkv = torch.stack([dk[..., :half, :], dk[..., half:, :],
                           dv[..., :half, :], dv[..., half:, :]]).float()
        kv = torch.stack([k_lo, k_hi, v_lo, v_hi])
        perm = [(i, (i + 1) % n) for i in range(n)]
        for step in range(1, n):
            kv = _ppermute(kv, group, perm)
            dkv = _ppermute(dkv, group, perm)
            kl, kh, vl, vh = kv.unbind(0)
            src = (my - step) % n
            # q_hi x k_lo: always fully visible; then the visible one of
            # (q_lo x k_lo) / (q_hi x k_hi).
            blocks = [(q_hi, kl, vl, g_hi, lse_hi, d_hi, 1, 0)]
            if src < my:
                blocks.append((q_lo, kl, vl, g_lo, lse_lo, d_lo, 0, 0))
            else:
                blocks.append((q_hi, kh, vh, g_hi, lse_hi, d_hi, 1, 1))
            for bq_, bk_, bv_, bg, blse, bd, qi, ki in blocks:
                bq, bk, bv = hop_backward(bq_, bk_, bv_, bg, blse, bd, False)
                (dq_hi if qi else dq_lo).add_(bq.float())
                dkv[ki] += bk.float()
                dkv[2 + ki] += bv.float()
        # The accumulator held now is the K/V of rank my + 1: one more
        # hop takes every rank's home.
        dk_lo, dk_hi, dv_lo, dv_hi = _ppermute(dkv, group, perm).unbind(0)
        return (dq_lo.to(q_lo.dtype), dq_hi.to(q_hi.dtype),
                dk_lo.to(k_lo.dtype), dk_hi.to(k_hi.dtype),
                dv_lo.to(v_lo.dtype), dv_hi.to(v_hi.dtype),
                None, None, None, None, None, None, None)


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


def ring_attention_saving(q, k, v, mesh, *, axis_name: str = "sp",
                          block_q: int | None = None,
                          block_k: int | None = None):
    """``ring_attention`` without a graph -> (this rank's output block,
    what ``ring_attention_replay`` replays around: each zigzag half's
    merged output and lse)."""
    with torch.no_grad():
        return _ring_attention_local(
            q, k, v, group=mesh.get_group(axis_name),
            n=axis_size(mesh, axis_name), my=axis_rank(mesh, axis_name),
            block_q=block_q, block_k=block_k, keep=True)


def ring_attention_replay(q, k, v, saved, mesh, *, axis_name: str = "sp"):
    """``ring_attention``'s output block as a differentiable function of
    q, k and v, from what ``ring_attention_saving`` kept on the same
    inputs: the zigzag moves run again, no hop's forward does, and the
    backward runs the ring's flash backward (module docstring)."""
    group = mesh.get_group(axis_name)
    n, my = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    o_lo, o_hi = _RingReplay.apply(*_zigzag_qkv(q, k, v, group, n, my),
                                   *saved, group, n, my)
    return _from_zigzag(o_lo, o_hi, group, n, my)


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
