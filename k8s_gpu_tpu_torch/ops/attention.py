"""Flash attention v1 and v2: the plain PyTorch versions and the wrappers
of the hand-written CUDA kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_v2.cu``).

Counterpart of ``k8s_gpu_tpu/ops/attention.py``.  v1: the forward
(``_fwd_kernel``) emits the output and the per-row logsumexp, and the
backward recomputes probability tiles from (q, k, lse) in two kernels, one
for dq (``_bwd_dq_kernel``) and one for dk/dv (``_bwd_dkv_kernel``), tied
together by one ``torch.autograd.Function`` in place of the reference's
``custom_vjp``.  The lse is a differentiable output: its cotangent enters
the backward as ``delta - g_lse`` (ring attention merges hops on it).
v2 (``_fwd_kernel_v2``, ``_bwd_dq_kernel_v2``, ``_bwd_dkv_kernel_v2``)
computes the same with three knobs: RoPE applied in the kernels at
positions ``arange(S)`` (dq and dk leave through the transpose rotation,
in the unrotated basis), K/V at their own ``[B, KH, S, D]`` heads with the
G = H/KH query heads of a KV head sharing each staged K/V tile (dk/dv summed
over the group in one block), and a ``q_pipeline`` of P query tiles per
block.

``flash_attention_lse`` and ``flash_attention_v2_lse`` take the plain
versions only for tensors on the CPU (each such call adds one to
``plain_count``); on CUDA tensors they launch the kernels, or raise
``ValueError`` for a head width, type, tile or pipeline the kernels do not
take.  The kernels mask the tail of a sequence that does not fill a tile,
so the reference's ``seq_indivisible``, ``degenerate_seq``,
``sublane_misaligned`` and ``pipeline_indivisible`` fall-backs have no
counterpart on the card, and nothing demotes v2 to v1 or to the plain
version.  Each kernel launch adds one to its entry in ``launch_counts``;
the pre-pass that rotates q and k and splits them into bf16 halves for
the bf16 v2 kernels with rope (``flash_v2_rope_split``, once per forward
and once per backward) counts in ``prepass_counts``.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# The kernels' one compiled tile (query rows x key rows per block), the
# head widths they are instantiated for, and the input types they take.
KERNEL_TILE = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches and plain-version calls since the last reset_counts().
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                 "flash_v2_fwd": 0, "flash_v2_bwd_dq": 0,
                 "flash_v2_bwd_dkv": 0}
prepass_counts = {"flash_v2_rope_split": 0}
plain_count = 0
# The query-tile pipeline factors the v2 kernels are compiled for.
Q_PIPELINES = (1, 2)

_lib = None
_lib_v2 = None


def reset_counts() -> None:
    global plain_count
    for counts in (launch_counts, prepass_counts):
        for name in counts:
            counts[name] = 0
    plain_count = 0


# -- the plain version ------------------------------------------------------

def _scores(q, k, causal):
    """f32 scores q.k * D^-0.5 [B, H, S, S], masked with -1e30 (never
    -inf) above the diagonal when causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    return s


def reference_attention_lse(q, k, v, causal: bool = True):
    """q, k, v [B, H, S, D] -> (out [B, H, S, D] in q.dtype, lse [B, H, S]
    f32), differentiable by autograd: the forward kernel's plain version,
    and through autograd the plain version of all three kernels."""
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def reference_attention(q, k, v, causal: bool = True):
    return reference_attention_lse(q, k, v, causal)[0]


def _probs_ds(q, k, v, dout, lse, delta, causal):
    """p = exp(s - lse) and ds = p (dO v^T - delta) scale, both f32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def reference_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True):
    """The dq kernel's function in plain torch, from the same residuals:
    dq = ds k, in q's type."""
    _, ds = _probs_ds(q, k, v, dout, lse, delta, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def reference_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True):
    """The dk/dv kernel's function in plain torch: dk = ds^T q and
    dv = p^T dO, in k's and v's types."""
    p, ds = _probs_ds(q, k, v, dout, lse, delta, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def reference_bwd_rounding(q, k, v, dout, lse, delta, causal: bool = True):
    """(dq, dk, dv) f32 bounds of what the bf16 backward kernels' two
    roundings move each element by: p rounded to bf16 before dv = p^T dO
    and ds before dq = ds k and dk = ds^T q, each factor to bf16's unit
    roundoff 2^-8, so an element moves by at most 2^-8 times the same sum
    over absolute values: 2^-8 |ds| |k|, 2^-8 |ds|^T |q| and
    2^-8 p^T |dO| (p >= 0), from the same residuals."""
    p, ds = _probs_ds(q, k, v, dout, lse, delta, causal)
    ds = ds.abs()
    u = 2.0 ** -8
    return (u * torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs()),
            u * torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
            u * torch.einsum("bhqk,bhqd->bhkd", p, dout.float().abs()))


# -- the plain version of v2 --------------------------------------------------

def _rotate(x, cos, sin):
    """Half-split rotation of the last axis: (x1 cos - x2 sin,
    x1 sin + x2 cos)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope_rotate(x, theta, *, sign: float = 1.0):
    """Rotary embedding over the trailing ``[..., S, D]`` axes at positions
    ``arange(S)``, the reference's ``rope_rotate``: frequencies
    ``theta ** (-i / half)``, f32 compute, cast back to ``x``'s type.
    ``sign=-1`` applies the transpose rotation."""
    s, d = x.shape[-2], x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = theta ** (-ar / half)
    pos = torch.arange(s, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * freqs                               # [S, half]
    return _rotate(x.float(), torch.cos(angles),
                   torch.sin(angles) * sign).to(x.dtype)


def rope_block(x, pos0, theta, sign: float = 1.0):
    """The kernels' rotation of an f32 tile ``[..., rows, D]`` whose row
    ``i`` sits at sequence position ``pos0 + i`` (the reference's
    ``_rope_block``): frequencies ``exp(i * c)`` with ``c = -ln(theta) /
    half`` computed in double and rounded once to f32, as the Pallas
    constant is.  Returns f32."""
    angles = _rope_angles(x.shape[-2], x.shape[-1], pos0, theta, x.device)
    return _rotate(x, torch.cos(angles), torch.sin(angles) * sign)


def _rope_angles(rows, d, pos0, theta, device):
    """The kernels' angles [rows, D/2]: position ``pos0 + i`` times
    ``exp(i * c)``, all f32."""
    half = d // 2
    c = torch.tensor(-math.log(theta) / half, dtype=torch.float32,
                     device=device)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                      * c)
    pos = (pos0 + torch.arange(rows, device=device)).float()
    return pos[:, None] * freqs


def _v2_inputs(q, k, v, rope_theta):
    """The v1 plain version's inputs for v2: q and k widened to f32 and,
    with ``rope_theta``, rotated at positions ``arange(S)`` (never rounded
    back to the input type, as in the kernels); k and v repeated from the
    KH heads to the H = KH * G query heads (head h reads KV head h // G)."""
    grp = q.shape[1] // k.shape[1]
    qf, kf = q.float(), k.float()
    if rope_theta is not None:
        qf, kf = rope_block(qf, 0, rope_theta), rope_block(kf, 0, rope_theta)
    return (qf, kf.repeat_interleave(grp, dim=1),
            v.float().repeat_interleave(grp, dim=1))


def reference_rope_split(q, k, rope_theta):
    """The rotate-and-split pre-pass's plain version: q [B, H, S, D] and k
    [B, KH, S, D] rotated in f32 at positions ``arange(S)`` (``rope_block``)
    and split into bf16 halves hi = bf16(x), lo = bf16(x - hi), as one flat
    bf16 buffer: q's hi and lo planes, then k's."""
    planes = []
    for x in (q, k):
        r = rope_block(x.float(), 0, rope_theta)
        hi = r.to(torch.bfloat16)
        planes += [hi.reshape(-1), (r - hi.float()).to(torch.bfloat16)
                   .reshape(-1)]
    return torch.cat(planes)


def reference_attention_v2_lse(q, k, v, causal: bool = True,
                               rope_theta: float | None = None):
    """q [B, H, S, D], k and v [B, KH, S, D] -> (out [B, H, S, D] in
    q.dtype, lse [B, H, S] f32), differentiable by autograd: the v2
    forward kernel's plain version."""
    out, lse = reference_attention_lse(*_v2_inputs(q, k, v, rope_theta),
                                       causal)
    return out.to(q.dtype), lse


def reference_bwd_dq_v2(q, k, v, dout, lse, delta, causal: bool = True,
                        rope_theta: float | None = None):
    """The v2 dq kernel's function from the same residuals: dq in the
    rotated basis, then through the transpose rotation into the unrotated
    one, in q's type."""
    dq = reference_bwd_dq(*_v2_inputs(q, k, v, rope_theta), dout, lse,
                          delta, causal)
    if rope_theta is not None:
        dq = rope_block(dq, 0, rope_theta, sign=-1.0)
    return dq.to(q.dtype)


def reference_bwd_dkv_v2(q, k, v, dout, lse, delta, causal: bool = True,
                         rope_theta: float | None = None):
    """The v2 dk/dv kernel's function: dk and dv of the H query heads
    summed over the G heads of each KV head, dk through the transpose
    rotation, in k's and v's types."""
    dk, dv = reference_bwd_dkv(*_v2_inputs(q, k, v, rope_theta), dout, lse,
                               delta, causal)
    B, KH, S, D = k.shape
    dk = dk.view(B, KH, -1, S, D).sum(2)
    dv = dv.view(B, KH, -1, S, D).sum(2)
    if rope_theta is not None:
        dk = rope_block(dk, 0, rope_theta, sign=-1.0)
    return dk.to(k.dtype), dv.to(v.dtype)


def _rotate_bound(t, theta):
    """A bound on |R^T e| from a bound t on |e| element-wise: the transpose
    rotation at positions ``arange(S)`` mixes columns c and c + D/2, so
    (|cos| t1 + |sin| t2, |sin| t1 + |cos| t2)."""
    angles = _rope_angles(t.shape[-2], t.shape[-1], 0, theta, t.device)
    cos, sin = torch.cos(angles).abs(), torch.sin(angles).abs()
    t1, t2 = t.chunk(2, dim=-1)
    return torch.cat([cos * t1 + sin * t2, sin * t1 + cos * t2], dim=-1)


def reference_bwd_rounding_v2(q, k, v, dout, lse, delta, causal: bool = True,
                              rope_theta: float | None = None):
    """(dq [B, H, S, D], dk, dv [B, KH, S, D]) f32 bounds of what the bf16
    v2 backward kernels' roundings move each element by, from the same
    residuals:

    1. ``reference_bwd_rounding``'s terms on ``_v2_inputs`` (q, k rotated
       in f32 and k, v repeated to the query heads).  With rope, dS K and
       dS^T Q take the bf16 hi plane of the rotated operand, a second
       rounding to 2^-8, so their factor is 2^-7 + 2^-16; p (for dv) and,
       without rope, ds stay at 2^-8.
    2. With rope, the scores come from the hi + lo halves, off by at most
       delta = 3 2^-16 scale sum_i |q_i k_i| (taken at each row's largest),
       which moves each p and ds by a factor of up to e^delta - 1: per row,
       u + (e^delta - 1)(1 + u) in place of u.
    3. dq and dk leave through the transpose rotation, so their terms go
       through |R^T| (``_rotate_bound``).
    4. dk and dv are summed over the G query heads of each KV head.

    At G 1 without rope this is ``reference_bwd_rounding``."""
    qf, kf, vf = _v2_inputs(q, k, v, rope_theta)
    p, ds = _probs_ds(qf, kf, vf, dout, lse, delta, causal)
    ds = ds.abs()
    qa, ka, dout_a = qf.abs(), kf.abs(), dout.float().abs()
    u = 2.0 ** -8
    if rope_theta is None:
        terms = [u * torch.einsum("bhqk,bhkd->bhqd", ds, ka),
                 u * torch.einsum("bhqk,bhqd->bhkd", ds, qa),
                 u * torch.einsum("bhqk,bhqd->bhkd", p, dout_a)]
    else:
        u_hi = 2.0 ** -7 + 2.0 ** -16
        dlt = 3 * 2.0 ** -16 * q.shape[-1] ** -0.5 * torch.einsum(
            "bhqd,bhkd->bhqk", qa, ka).amax(-1, keepdim=True)
        grow = torch.expm1(dlt)                                  # [B, H, S, 1]
        ds_w = ds * (u_hi + grow * (1 + u_hi))
        p_w = p * (u + grow * (1 + u))
        terms = [torch.einsum("bhqk,bhkd->bhqd", ds_w, ka),
                 torch.einsum("bhqk,bhqd->bhkd", ds_w, qa),
                 torch.einsum("bhqk,bhqd->bhkd", p_w, dout_a)]
        terms[0] = _rotate_bound(terms[0], rope_theta)
    B, KH, S, D = k.shape
    dk_t, dv_t = (t.view(B, KH, -1, S, D).sum(2) for t in terms[1:])
    if rope_theta is not None:
        dk_t = _rotate_bound(dk_t, rope_theta)
    return terms[0], dk_t, dv_t


# -- the plan ---------------------------------------------------------------

def flash_plan(d_head: int, dtype, block_q: int | None = None,
               block_k: int | None = None):
    """(bq, bk, reason): the tile the kernels run this call with, and why
    they cannot (None when they can).

    The TPU's rules do not carry over: blocks there were 512x512 and had
    to meet Mosaic's (sublane, 128) tiling.  On the card every kernel
    walks 64-row query tiles against 64-row K/V tiles (the bf16 kernels
    on the tensor cores, 16 query or key rows a warp, dk/dv taking each
    query tile in two halves of 32; the float32 ones on the CUDA cores,
    4x4 scores a thread), and the ragged tail of a
    sequence is masked in-kernel, so any sequence length runs.
    ``block_q``/``block_k`` may name the tile, which must then be the
    compiled 64."""
    bq = block_q or KERNEL_TILE
    bk = block_k or KERNEL_TILE
    if (bq, bk) != (KERNEL_TILE, KERNEL_TILE):
        reason = (f"blocks {bq}x{bk}: the kernels are compiled for "
                  f"{KERNEL_TILE}x{KERNEL_TILE} tiles")
    elif d_head not in HEAD_DIMS:
        reason = f"head dim {d_head} not in {HEAD_DIMS}"
    elif dtype not in _DTYPE_CODES:
        reason = f"dtype {dtype} not float32 or bfloat16"
    else:
        reason = None
    return bq, bk, reason


def flash_v2_plan(d_head: int, dtype, q_pipeline: int = 1,
                  block_q: int | None = None, block_k: int | None = None):
    """(bq, bk, reason) for the v2 kernels: v1's tile, head width and type
    rules, plus a ``q_pipeline`` they are compiled for (``Q_PIPELINES``).
    The reference's further v2 rules do not carry over: a query tile never
    straddles two folded group members (each member's ragged last tile is
    masked on its own) and the items missing from the last block of P are
    masked, so any S, G and P in ``Q_PIPELINES`` run."""
    bq, bk, reason = flash_plan(d_head, dtype, block_q, block_k)
    if reason is None and q_pipeline not in Q_PIPELINES:
        reason = (f"q_pipeline {q_pipeline}: the kernels are compiled for "
                  f"P in {Q_PIPELINES}")
    return bq, bk, reason


def describe_train_attention(cfg, seq_sharded: bool = False) -> str:
    """One-line name of the attention path the training step of a
    ``TransformerConfig``-shaped config runs on the card, with the
    reference's knob list for v2 (duck-typed, as the reference's).
    ``seq_sharded``: the step runs on a mesh with sp > 1, through ring
    attention or Ulysses (the reference's names)."""
    if not getattr(cfg, "use_flash", False):
        return "plain-causal (use_flash off)"
    if seq_sharded:
        sp = getattr(cfg, "sp_attention", "ring")
        rope = bool(getattr(cfg, "flash_fuse_rope", False))
        return f"sp-{sp}" + (" (rope outside: sp_fused_rope)" if rope
                             else "")
    blocks = (getattr(cfg, "flash_block_q", 0) or None,
              getattr(cfg, "flash_block_k", 0) or None)
    heads = int(getattr(cfg, "n_heads", 1))
    kh = int(getattr(cfg, "kv_heads", heads) or heads)
    grp = heads // kh if getattr(cfg, "flash_kv_grouped", False) else 1
    rope = bool(getattr(cfg, "flash_fuse_rope", False))
    pipeline = max(1, int(getattr(cfg, "flash_q_pipeline", 0)))
    if grp > 1 or rope or pipeline > 1:
        bq, bk, reason = flash_v2_plan(cfg.d_head, cfg.dtype, pipeline,
                                       *blocks)
        if reason is not None:
            return f"flash-v2 rejected on the card ({reason})"
        knobs = ",".join(name for name, on in (
            ("rope", rope), (f"gqa={grp}", grp > 1),
            (f"pipeline={pipeline}", pipeline > 1)) if on)
        return f"flash-v2[{knobs}] blocks {bq}x{bk}"
    bq, bk, reason = flash_plan(cfg.d_head, cfg.dtype, *blocks)
    if reason is None:
        return f"flash-v1 blocks {bq}x{bk}"
    return f"flash-v1 rejected on the card ({reason})"


# -- the kernels ------------------------------------------------------------

def _load(name: str, tails: dict, ptrs: dict | None = None):
    """The ctypes handle of ``csrc/<name>.cu``: its ``<name>_fwd``,
    ``_bwd_dq`` and ``_bwd_dkv`` entries (and any other ``kind`` in
    ``ptrs``) take ``ptrs[kind]`` pointers (5, 7 and 8 by default), then
    the arguments in ``tails[kind]`` (the forward's where ``kind`` is
    missing), and return an int code that ``<name>_error_string``
    names."""
    from . import _build

    lib = _build.load(name)
    ptrs = ptrs or {"fwd": 5, "bwd_dq": 7, "bwd_dkv": 8}
    for kind, n_ptrs in ptrs.items():
        fn = getattr(lib, f"{name}_{kind}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + tails.get(kind, tails["fwd"]))
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _kernel():
    global _lib
    if _lib is None:
        # BH, S, D, causal, scale, dtype code, stream
        _lib = _load("flash_attention", {"fwd": [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]})
    return _lib


def _kernel_v2():
    global _lib_v2
    if _lib_v2 is None:
        # (pointers, planes,) BKH, G, S, D, causal, scale, rope, rope_c,
        # [pipeline,] dtype, stream; the pre-pass: (q, k, planes,) BKH, G,
        # S, D, rope_c, stream
        head = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_float]
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib_v2 = _load("flash_attention_v2", {
            "fwd": head + tail, "bwd_dkv": head + tail[1:],
            "rope_split": [ctypes.c_int] * 4 + [ctypes.c_float,
                                                ctypes.c_void_p]},
            {"fwd": 6, "bwd_dq": 8, "bwd_dkv": 9, "rope_split": 3})
    return _lib_v2


def _check(ref, named: dict, f32_rows: dict | None = None):
    """Same device, type and [B, H, S, D] shape as ``ref`` for the tensors
    in ``named``; [B, H, S] float32 for those in ``f32_rows``; every one
    contiguous and 16-byte aligned."""
    B, H, S, D = ref.shape
    if B * H > 2 ** 31 - 1 or S > 65535 * KERNEL_TILE:
        raise ValueError(f"shape {tuple(ref.shape)} exceeds the kernel grid")
    checks = [(n, t, ref.dtype, (B, H, S, D)) for n, t in named.items()]
    checks += [(n, t, torch.float32, (B, H, S))
               for n, t in (f32_rows or {}).items()]
    for name, t, dtype, shape in checks:
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_v2(q, k, q_like: dict, kv_like: dict, f32_rows=None):
    """``_check`` for the v2 kernels: the ``q_like`` tensors against q
    [B, H, S, D], the ``kv_like`` against k [B, KH, S, D] on q's device in
    q's type, with KH dividing H and the forward/dq grid in range."""
    _check(q, q_like, f32_rows)
    _check(k, kv_like)
    B, H, S, D = q.shape
    if k.device != q.device or k.dtype != q.dtype:
        raise ValueError(f"k is {k.dtype} on {k.device}, q {q.dtype} on "
                         f"{q.device}")
    if k.shape[0] != B or k.shape[2:] != q.shape[2:] or H % k.shape[1]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: [B, KH, S, D] with KH | H")
    if H // k.shape[1] * -(-S // KERNEL_TILE) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel grid")


def _raise_on(rc: int, what: str, errors) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{errors(rc).decode()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _common(q, causal):
    B, H, S, D = q.shape
    return (B * H, S, D, int(causal), D ** -0.5, _DTYPE_CODES[q.dtype],
            _stream(q))


def _common_v2(q, k, causal, rope_theta):
    """BKH, G, S, D, causal, scale, rope, rope_c: ``rope_c`` is
    -ln(theta) / (D / 2) in double, which ctypes rounds once to f32."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    rope_c = (-math.log(rope_theta) / (D // 2) if rope_theta is not None
              else 0.0)
    return (B * KH, H // KH, S, D, int(causal), D ** -0.5,
            int(rope_theta is not None), rope_c)


def flash_forward(q, k, v, causal: bool):
    """Forward kernel: contiguous q, k, v [B, H, S, D] on the card ->
    (out [B, H, S, D] in q.dtype, lse [B, H, S] f32)."""
    _check(q, {"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _kernel()
    rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), lse.data_ptr(),
                                 *_common(q, causal))
    _raise_on(rc, "flash_fwd", lib.flash_attention_error_string)
    launch_counts["flash_fwd"] += 1
    return out, lse


def flash_backward_dq(q, k, v, dout, lse, delta, causal: bool):
    """dq kernel: dq = sum_j ds_ij k_j with p recomputed from lse and
    ds = p (dp - delta) scale; dq in q.dtype."""
    _check(q, {"q": q, "k": k, "v": v, "dout": dout},
           {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    lib = _kernel()
    rc = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_common(q, causal))
    _raise_on(rc, "flash_bwd_dq", lib.flash_attention_error_string)
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, causal: bool):
    """dk/dv kernel: dk = sum_i ds_ij^T q_i, dv = sum_i p_ij^T dO_i."""
    _check(q, {"q": q, "k": k, "v": v, "dout": dout},
           {"lse": lse, "delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel()
    rc = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_common(q, causal))
    _raise_on(rc, "flash_bwd_dkv", lib.flash_attention_error_string)
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


def flash_v2_rope_split(q, k, rope_theta):
    """The pre-pass of the bf16 v2 kernels with rope: contiguous bf16 q
    [B, H, S, D] and k [B, KH, S, D] on the card rotated in f32 at
    positions ``arange(S)`` and split into bf16 halves hi + lo (hi =
    bf16(x), lo = bf16(x - hi)), in one launch -> a flat bf16 buffer of
    2 * (q + k) values: q's hi and lo planes, then k's.  Tensors on the
    CPU take the plain version (``reference_rope_split``)."""
    global plain_count
    if rope_theta is None:
        raise ValueError("the rope pre-pass needs rope_theta")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the rope pre-pass takes bfloat16, got {q.dtype}")
    if q.device.type != "cuda":
        plain_count += 1
        return reference_rope_split(q, k, rope_theta)
    _check_v2(q, k, {"q": q}, {"k": k})
    planes = torch.empty(2 * (q.numel() + k.numel()), dtype=q.dtype,
                         device=q.device)
    bkh, grp, s, d, _, _, _, rope_c = _common_v2(q, k, True, rope_theta)
    lib = _kernel_v2()
    rc = lib.flash_attention_v2_rope_split(
        q.data_ptr(), k.data_ptr(), planes.data_ptr(), bkh, grp, s, d, rope_c,
        _stream(q))
    _raise_on(rc, "flash_v2_rope_split", lib.flash_attention_v2_error_string)
    prepass_counts["flash_v2_rope_split"] += 1
    return planes


def _v2_planes(q, k, rope_theta, planes):
    """The pre-pass's planes where the kernels take them (bf16 with rope):
    ``planes`` as given, or made here; else None."""
    if q.dtype != torch.bfloat16 or rope_theta is None:
        return None
    if planes is None:
        return flash_v2_rope_split(q, k, rope_theta)
    if (planes.dtype != q.dtype or planes.device != q.device
            or planes.numel() != 2 * (q.numel() + k.numel())
            or not planes.is_contiguous()):
        raise ValueError(f"planes: expected {2 * (q.numel() + k.numel())} "
                         f"contiguous {q.dtype} values on {q.device}")
    return planes


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_v2_forward(q, k, v, causal: bool, rope_theta=None,
                     q_pipeline: int = 1):
    """v2 forward kernel: contiguous q [B, H, S, D] and k, v [B, KH, S, D]
    on the card -> (out [B, H, S, D] in q.dtype, lse [B, H, S] f32), with
    q and k rotated in the kernel when ``rope_theta``.  In bf16 with rope
    the call first runs the pre-pass (``flash_v2_rope_split``), whose
    planes the tensor-core forward stages."""
    _check_v2(q, k, {"q": q}, {"k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    planes = _v2_planes(q, k, rope_theta, None)
    lib = _kernel_v2()
    rc = lib.flash_attention_v2_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(planes), *_common_v2(q, k, causal, rope_theta),
        q_pipeline, _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(rc, "flash_v2_fwd", lib.flash_attention_v2_error_string)
    launch_counts["flash_v2_fwd"] += 1
    return out, lse


def flash_v2_backward_dq(q, k, v, dout, lse, delta, causal: bool,
                         rope_theta=None, q_pipeline: int = 1, planes=None):
    """v2 dq kernel: dq accumulated in the rotated basis, written through
    the transpose rotation; dq [B, H, S, D] in q.dtype.  In bf16 with rope
    it takes the pre-pass's ``planes``, made here when not given."""
    _check_v2(q, k, {"q": q, "dout": dout}, {"k": k, "v": v},
              {"lse": lse, "delta": delta})
    planes = _v2_planes(q, k, rope_theta, planes)
    dq = torch.empty_like(q)
    lib = _kernel_v2()
    rc = lib.flash_attention_v2_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(planes),
        *_common_v2(q, k, causal, rope_theta), q_pipeline,
        _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(rc, "flash_v2_bwd_dq", lib.flash_attention_v2_error_string)
    launch_counts["flash_v2_bwd_dq"] += 1
    return dq


def flash_v2_backward_dkv(q, k, v, dout, lse, delta, causal: bool,
                          rope_theta=None, planes=None):
    """v2 dk/dv kernel: dk and dv [B, KH, S, D] summed over the G query
    heads of each KV head in one block, dk through the transpose
    rotation.  ``planes`` as for dq."""
    _check_v2(q, k, {"q": q, "dout": dout}, {"k": k, "v": v},
              {"lse": lse, "delta": delta})
    planes = _v2_planes(q, k, rope_theta, planes)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_v2()
    rc = lib.flash_attention_v2_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(planes), *_common_v2(q, k, causal, rope_theta),
        _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(rc, "flash_v2_bwd_dkv", lib.flash_attention_v2_error_string)
    launch_counts["flash_v2_bwd_dkv"] += 1
    return dk, dv


def _delta(out, g_out, g_lse):
    """(dO in out's type, delta = rowsum(dO * O) - g_lse in f32), in plain
    torch (elementwise, as the reference keeps it outside its kernels); a
    missing cotangent reads as zero."""
    if g_out is None:
        g_out = torch.zeros_like(out)
    g_out = g_out.to(out.dtype).contiguous()
    delta = (g_out.float() * out.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return g_out, delta.contiguous()


class _FlashAttention(torch.autograd.Function):
    """(out, lse) from the forward kernel; the backward takes ``_delta``
    and launches dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out, delta = _delta(out, g_out, g_lse)
        dq = flash_backward_dq(q, k, v, g_out, lse, delta, ctx.causal)
        dk, dv = flash_backward_dkv(q, k, v, g_out, lse, delta, ctx.causal)
        return dq, dk, dv, None


class _FlashAttentionV2(torch.autograd.Function):
    """The v2 twin of ``_FlashAttention`` (the reference's ``_flash_v2``
    ``custom_vjp``): K/V at [B, KH, S, D], rope and the pipeline as kernel
    arguments, gradients in the unrotated basis."""

    @staticmethod
    def forward(ctx, q, k, v, causal, rope_theta, q_pipeline):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_v2_forward(q, k, v, causal, rope_theta, q_pipeline)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, rope_theta)
        ctx.q_pipeline = q_pipeline
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out, delta = _delta(out, g_out, g_lse)
        # One pre-pass (bf16 with rope) for both kernels.
        planes = _v2_planes(q, k, ctx.args[1], None)
        dq = flash_v2_backward_dq(q, k, v, g_out, lse, delta, *ctx.args,
                                  ctx.q_pipeline, planes)
        dk, dv = flash_v2_backward_dkv(q, k, v, g_out, lse, delta, *ctx.args,
                                       planes)
        return dq, dk, dv, None, None, None


class _Replay(torch.autograd.Function):
    """Attention whose forward already ran: returns the saved ``out`` as
    the output of (q, k, v), and its backward is the flash backward from
    the saved ``out`` and ``lse`` (the dq and dk/dv kernels, with v2's
    pre-pass where it takes one, or their plain versions), so nothing
    runs the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, out, lse, causal, rope_theta, q_pipeline, v2,
                kernels):
        q, k, v = (t.contiguous() for t in (q, k, v))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, rope_theta, q_pipeline, v2, kernels)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, rope_theta, q_pipeline, v2, kernels = ctx.args
        g_out, delta = _delta(out, g_out, None)
        dq, dk, dv = _backward(q, k, v, g_out, lse, delta, causal,
                               rope_theta, q_pipeline, v2, kernels)
        return dq, dk, dv, None, None, None, None, None, None, None


def _backward(q, k, v, dout, lse, delta, causal, rope_theta, q_pipeline,
              v2: bool, kernels: bool):
    """(dq, dk, dv) from the forward's residuals: the dq and dk/dv
    kernels (v2's with its pre-pass where it takes one), or their plain
    versions."""
    if kernels and v2:
        planes = _v2_planes(q, k, rope_theta, None)
        dq = flash_v2_backward_dq(q, k, v, dout, lse, delta, causal,
                                  rope_theta, q_pipeline, planes)
        dk, dv = flash_v2_backward_dkv(q, k, v, dout, lse, delta, causal,
                                       rope_theta, planes)
    elif kernels:
        dq = flash_backward_dq(q, k, v, dout, lse, delta, causal)
        dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, causal)
    elif v2:
        dq = reference_bwd_dq_v2(q, k, v, dout, lse, delta, causal,
                                 rope_theta)
        dk, dv = reference_bwd_dkv_v2(q, k, v, dout, lse, delta, causal,
                                      rope_theta)
    else:
        dq = reference_bwd_dq(q, k, v, dout, lse, delta, causal)
        dk, dv = reference_bwd_dkv(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


def hop_backward(q, k, v, dout, lse, delta, causal: bool):
    """One block of a ring's backward: (dq, dk, dv) of the block q x k, v
    from the whole row's ``lse`` and ``delta`` (the merged output's, so
    the block's probabilities are the whole row's), through the dq and
    dk/dv kernels on CUDA tensors (v2's, rope outside, for grouped K/V
    at fewer heads than q) and their plain versions on the CPU.  No
    forward runs."""
    q, k, v, dout, lse, delta = (t.contiguous() for t in
                                 (q, k, v, dout, lse, delta))
    return _backward(q, k, v, dout, lse, delta, causal, None, 1,
                     k.shape[1] != q.shape[1], q.device.type == "cuda")


def attention_replay(q, k, v, out, lse, *, causal: bool = True,
                     rope_theta: float | None = None, q_pipeline: int = 1,
                     v2: bool = False, plain: bool = False):
    """``out`` (from an earlier forward on the same q, k, v, with its
    ``lse``) as a differentiable function of q, k and v: the backward of
    ``flash_attention_lse`` (``v2``: of ``flash_attention_v2_lse`` with
    ``rope_theta`` and ``q_pipeline``) without its forward, what
    ``remat_policy="save_attn"`` recomputes a block around.  On CUDA
    tensors it launches the backward kernels, unless ``plain`` (the
    forward ran the plain attention); on the CPU it takes their plain
    versions.  ``lse``'s cotangent is zero."""
    kernels = q.device.type == "cuda" and not plain
    return _Replay.apply(q, k, v, out, lse, causal,
                         float(rope_theta) if rope_theta is not None
                         else None, max(1, q_pipeline), v2, kernels)


def flash_attention_lse(q, k, v, causal: bool = True,
                        block_q: int | None = None,
                        block_k: int | None = None):
    """Blockwise attention returning (out [B, H, S, D] in q.dtype,
    lse [B, H, S] f32), differentiable in q, k, v through both outputs."""
    global plain_count
    if q.device.type != "cuda":
        plain_count += 1
        return reference_attention_lse(q, k, v, causal)
    _, _, reason = flash_plan(q.shape[-1], q.dtype, block_q, block_k)
    if reason is not None:
        raise ValueError(f"flash attention kernel does not take q "
                         f"{tuple(q.shape)} {q.dtype}: {reason}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int | None = None, block_k: int | None = None):
    """Blockwise attention, q, k, v [B, H, S, D] -> [B, H, S, D]."""
    return flash_attention_lse(q, k, v, causal, block_q, block_k)[0]


def flash_attention_v2_lse(q, k, v, *, causal: bool = True,
                           rope_theta: float | None = None,
                           block_q: int | None = None,
                           block_k: int | None = None,
                           q_pipeline: int = 1):
    """v2 entry, the reference's signature and errors: q [B, H, S, D]
    against K/V at [B, KH, S, D] (KH | H; KH == H is plain multi-head
    attention) -> (out [B, H, S, D], lse [B, H, S] f32), differentiable in
    q, k, v through both outputs.

    ``rope_theta`` rotates q and k in the kernels at positions
    ``arange(S)`` (gradients land in the unrotated basis); ``q_pipeline``
    P > 1 runs P query tiles per block against each staged K/V tile.  With
    no knob active (KH == H, P == 1, no rope) the call is the v1 entry's.
    On the card a head width, type, tile or P the kernels do not take
    raises ``ValueError``."""
    global plain_count
    b, h, s, d = q.shape
    kh = k.shape[1]
    if h % kh != 0:
        raise ValueError(
            f"query heads {h} must be a multiple of KV heads {kh}")
    if v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if rope_theta is not None and d % 2 != 0:
        raise ValueError(f"fused rope needs an even head dim, got d={d}")
    pipeline = max(1, q_pipeline)
    if h == kh and pipeline == 1 and rope_theta is None:
        return flash_attention_lse(q, k, v, causal, block_q, block_k)
    if q.device.type != "cuda":
        plain_count += 1
        return reference_attention_v2_lse(q, k, v, causal, rope_theta)
    _, _, reason = flash_v2_plan(d, q.dtype, pipeline, block_q, block_k)
    if reason is not None:
        raise ValueError(f"flash attention v2 kernels do not take q "
                         f"{tuple(q.shape)} {q.dtype}: {reason}")
    return _FlashAttentionV2.apply(
        q, k, v, causal,
        float(rope_theta) if rope_theta is not None else None, pipeline)


def flash_attention_v2(q, k, v, *, causal: bool = True,
                       rope_theta: float | None = None,
                       block_q: int | None = None, block_k: int | None = None,
                       q_pipeline: int = 1):
    """v2 blockwise attention -> [B, H, S, D].  See flash_attention_v2_lse."""
    return flash_attention_v2_lse(
        q, k, v, causal=causal, rope_theta=rope_theta, block_q=block_q,
        block_k=block_k, q_pipeline=q_pipeline)[0]
