"""Flash attention v1: the plain PyTorch version and the wrappers of the
hand-written CUDA kernels (``csrc/flash_attention.cu``).

Counterpart of ``k8s_gpu_tpu/ops/attention.py``'s v1 path: the forward
(``_fwd_kernel``) emits the output and the per-row logsumexp, and the
backward recomputes probability tiles from (q, k, lse) in two kernels, one
for dq (``_bwd_dq_kernel``) and one for dk/dv (``_bwd_dkv_kernel``), tied
together by one ``torch.autograd.Function`` in place of the reference's
``custom_vjp``.  The lse is a differentiable output: its cotangent enters
the backward as ``delta - g_lse`` (ring attention merges hops on it).

``flash_attention_lse`` takes the plain version only for tensors on the
CPU (each such call adds one to ``plain_count``); on CUDA tensors it
launches the kernels, or raises ``ValueError`` for a head width, type or
tile the kernels do not take.  The kernels mask the tail of a sequence
that does not fill a tile, so the reference's ``seq_indivisible`` and
``degenerate_seq`` oracle fall-backs have no counterpart on the card.
Each kernel launch adds one to its entry in ``launch_counts``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# The kernels' one compiled tile (query rows x key rows per block), the
# head widths they are instantiated for, and the input types they take.
KERNEL_TILE = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches and plain-version calls since the last reset_counts().
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
plain_count = 0

_lib = None


def reset_counts() -> None:
    global plain_count
    for name in launch_counts:
        launch_counts[name] = 0
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


# -- the plan ---------------------------------------------------------------

def flash_plan(d_head: int, dtype, block_q: int | None = None,
               block_k: int | None = None):
    """(bq, bk, reason): the tile the kernels run this call with, and why
    they cannot (None when they can).

    The TPU's rules do not carry over: blocks there were 512x512 and had
    to meet Mosaic's (sublane, 128) tiling.  On the card a block of 256
    threads owns a 64x64 score tile (4x4 scores a thread), K/V tiles are
    staged in f32 shared memory, and the ragged tail of a sequence is
    masked in-kernel, so any sequence length runs.  ``block_q``/``block_k``
    may name the tile, which must then be the compiled 64."""
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


def describe_train_attention(cfg) -> str:
    """One-line name of the attention path the training step of a
    ``TransformerConfig`` runs on the card."""
    if not getattr(cfg, "use_flash", False):
        return "plain-causal (use_flash off)"
    bq, bk, reason = flash_plan(cfg.d_head, cfg.dtype,
                                cfg.flash_block_q or None,
                                cfg.flash_block_k or None)
    if reason is None:
        return f"flash-v1 blocks {bq}x{bk}"
    return f"flash-v1 rejected on the card ({reason})"


# -- the kernels ------------------------------------------------------------

def _kernel():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_attention")
        # BH, S, D, causal, scale, dtype code, stream
        tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def _raise_on(rc: int, what: str, lib) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _common(q, causal):
    B, H, S, D = q.shape
    return (B * H, S, D, int(causal), D ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


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
    _raise_on(rc, "flash_fwd", lib)
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
    _raise_on(rc, "flash_bwd_dq", lib)
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
    _raise_on(rc, "flash_bwd_dkv", lib)
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """(out, lse) from the forward kernel; the backward takes
    delta = rowsum(dO * O) - g_lse in plain torch (elementwise, as the
    reference keeps it outside its kernels) and launches dq and dk/dv."""

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
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.to(out.dtype).contiguous()
        delta = (g_out.float() * out.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dq = flash_backward_dq(q, k, v, g_out, lse, delta, ctx.causal)
        dk, dv = flash_backward_dkv(q, k, v, g_out, lse, delta, ctx.causal)
        return dq, dk, dv, None


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
