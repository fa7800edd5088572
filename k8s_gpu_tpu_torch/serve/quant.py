"""Int8 weights for serving: the port of ``k8s_gpu_tpu/serve/quant.py``.

A quantized leaf is ``{"q": int8[...], "s": f32[broadcastable]}``, the
reference's form; ``models.transformer.wt`` dequantizes it wherever a
weight is read, and an ``InferenceEngine(int8_compute=True)`` runs its
matmuls as int8 x int8 -> int32 through ``int8_dot`` instead.  Scales are
per output channel: the max-abs over each weight's contraction axes.

``int8_dot`` on CUDA tensors calls ``torch._int_mm`` (cuBLASLt's integer
product; the reference computes it with ``lax.dot_general`` outside
Pallas, so no TPU kernel stands behind it).  ``_int_mm`` takes only more
than 16 rows and contraction and output widths that are multiples of 8,
so the wrapper pads with zero rows and columns, which add nothing to an
integer sum; it never falls back to a float product.  cuBLASLt's integer
product wants the weight column-major (its "TN" layout: a row-major one
is refused for some shapes), so ``quantize_params`` stores each matmul
leaf's ``q`` with that layout for every layer's [K, N] matrix: same
shape and values, other strides.  On CPU tensors the plain version
multiplies in int32, exact: an int8 x int8 sum over K = 4096 reaches
6.6e7, past float32's exact 2^24.

On a tp mesh the tree is quantized whole and then cut
(``shard_quantized``).  The column-parallel products (q/k/v, the MLP's
inputs, the head) contract D, which tp does not cut.  The row-parallel
ones (``wo``, ``wo_mlp``) contract what it cuts: ``int8_dot(group=)``
takes the activation's row max over tp and adds the int32 partial sums
over it, so each rank's product is the one-rank product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Contraction axes per stacked weight leaf: the scale keeps every other
# axis, so each output channel (and each layer) gets its own scale.
_CONTRACT_AXES = {
    "wq": (1,),        # [L, D, H, Dh]: contract D
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),      # [L, H, Dh, D]: contract H, Dh
    "wi_gate": (1,),   # [L, D, F]
    "wi_up": (1,),
    "wo_mlp": (1,),    # [L, F, D]
    "e_wi_gate": (2,),  # [L, E, D, F]
    "e_wi_up": (2,),
    "e_wo": (2,),      # [L, E, F, D]
}
_TOP_LEVEL = {
    "head": (0,),      # [D, V]: contract D
    "embed": (1,),     # [V, D]: a scale per row (a gather, not a matmul)
}

# Launches of torch._int_mm by int8_dot since the last reset_counts().
launch_count = 0


def reset_counts() -> None:
    global launch_count
    launch_count = 0


def _quantize_leaf(w, axes, matmul: bool = True):
    """The scale is taken in the weight's own type, then widened to f32,
    as the reference's ``jnp.max(...) / 127.0`` is.  A matmul leaf's
    ``q`` is laid out column-major a layer (``_column_major``)."""
    s = w.abs().amax(dim=axes, keepdim=True) / 127.0
    s = torch.where(s == 0, 1.0, s).float()
    q = torch.round(w.float() / s).clamp(-127, 127).to(torch.int8)
    return {"q": _column_major(q, axes) if matmul else q, "s": s}


def _column_major(q, axes):
    """``q`` with the same shape and values, stored so that each layer's
    [K, N] matrix (the contraction axes ``axes``, then the rest) is
    column-major: ``int8_dot``'s ``reshape(K, N)`` of a layer is then a
    view cuBLASLt takes as it is."""
    lead = q.shape[:axes[0]]
    k_tot = 1
    for a in axes:
        k_tot *= q.shape[a]
    cm = q.reshape(*lead, k_tot, -1).transpose(-1, -2).contiguous()
    return cm.transpose(-1, -2).reshape(q.shape)


def quantize_params(params: dict, *, quantize_embed: bool = True) -> dict:
    """A serving param tree with the matmul weights as int8 + scale.  Norm
    gains stay float; the input tree is left as it is."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, axes in _CONTRACT_AXES.items():
        if name in blocks:
            blocks[name] = _quantize_leaf(blocks[name], axes)
    out["blocks"] = blocks
    for name, axes in _TOP_LEVEL.items():
        if name == "embed" and not quantize_embed:
            continue
        out[name] = _quantize_leaf(params[name], axes,
                                   matmul=name != "embed")
    return out

def matmul_layout(params: dict) -> dict:
    """A tree whose int8 matmul ``q`` leaves are laid out as
    ``quantize_params`` lays them (``_column_major``; same values): a
    quantized tree read from elsewhere (a bundle) then takes cuBLASLt's
    integer product without a copy a call.  Other leaves pass as they
    are."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, axes in _CONTRACT_AXES.items():
        leaf = blocks.get(name)
        if isinstance(leaf, dict):
            blocks[name] = {"q": _column_major(leaf["q"], axes),
                            "s": leaf["s"]}
    out["blocks"] = blocks
    head = params.get("head")
    if isinstance(head, dict):
        out["head"] = {"q": _column_major(head["q"], _TOP_LEVEL["head"]),
                       "s": head["s"]}
    return out


def shard_quantized(params: dict, logical_axes: dict, mesh) -> dict:
    """This rank's shards of a quantized tree (``quantize_params`` of the
    WHOLE tree: ``parallel.sharding`` says why the order matters), each
    matmul ``q`` laid out again as ``quantize_params`` lays it: a cut is
    a strided view, which cuBLASLt's integer product would copy on
    every call."""
    from ..parallel.sharding import shard_params

    return matmul_layout(shard_params(params, logical_axes, mesh))


def quantize_act(x, group=None):
    """x [..., K] -> (int8 values, f32 scale a row [...]): symmetric
    absmax over the contraction axis, the activation half of an int8 x
    int8 product.  ``group``: the ranks that each hold a slice of K (a
    row-parallel product on a tp mesh); the row max is taken over all of
    them, so each rank's int8 values are its slice of the whole row's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if group is not None:
        from ..parallel.collectives import all_reduce

        amax = all_reduce(amax.contiguous(), group,
                          op=torch.distributed.ReduceOp.MAX)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int_mm(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact.  CUDA:
    ``torch._int_mm`` on operands padded to its shape rules (M > 16, K
    and N multiples of 8), ``a`` row-major and ``b`` column-major (a
    copy when ``b`` comes otherwise); CPU: the plain product in int32."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    global launch_count
    M, K = a.shape
    N = b.shape[1]
    m_pad = max(17, M) - M
    k_pad = _round8(K) - K
    n_pad = _round8(N) - N
    if m_pad or k_pad:
        a = F.pad(a, (0, k_pad, 0, m_pad))
    if k_pad or n_pad:
        b = F.pad(b, (0, n_pad, 0, k_pad))
    if b.stride() != (1, b.shape[0]):
        b = b.t().contiguous().t()
    y = torch._int_mm(a.contiguous(), b)
    launch_count += 1
    return y[:M, :N]


def int8_dot(x, leaf, out_dtype, contract: int, group=None):
    """True int8 matmul against a quantized leaf: quantize ``x`` a row,
    contract int8 x int8 -> int32, rescale by (activation scale x weight
    scale a channel).  ``leaf`` is a per-layer slice of the ``{"q", "s"}``
    form whose ``contract`` leading axes are contracted against ``x``'s
    ``contract`` trailing axes (named, not read off ``s``: a tp shard may
    hold one head).  The output keeps x's leading axes and the weight's
    output axes.  ``group``: the tp group of a row-parallel product,
    whose contraction axes are cut over it; the activation scale is the
    whole row's (``quantize_act``) and the int32 partial sums are added
    over the group before the rescale, so the output is the whole
    product on every rank, as one rank computes it."""
    w, s = leaf["q"], leaf["s"]
    k_tot = math.prod(w.shape[:contract])
    lead = x.shape[:x.dim() - contract]
    if math.prod(x.shape[x.dim() - contract:]) != k_tot:
        raise ValueError(f"cannot contract {tuple(x.shape)} against "
                         f"{tuple(w.shape)}")
    xq, ax = quantize_act(x.reshape(*lead, k_tot), group)
    y = int_mm(xq.reshape(-1, k_tot), w.reshape(k_tot, -1))
    if group is not None:
        from ..parallel.collectives import all_reduce

        y = all_reduce(y.contiguous(), group)
    y = y.float() * ax.reshape(-1, 1) * s.reshape(1, -1)
    return y.reshape(*lead, *w.shape[contract:]).to(out_dtype)


def quantized_bytes(params: dict) -> tuple[int, int]:
    """(quantized total, bf16 equivalent) parameter bytes: what the
    quantized tree streams (int8 weights, their f32 scales, the float
    leaves) against the same weights served bf16 (2 bytes each)."""

    def walk(node):
        if isinstance(node, dict) and set(node) == {"q", "s"}:
            actual = (node["q"].numel() * node["q"].element_size()
                      + node["s"].numel() * node["s"].element_size())
            return actual, node["q"].numel() * 2
        if isinstance(node, dict):
            pairs = [walk(v) for v in node.values()]
            return sum(a for a, _ in pairs), sum(b for _, b in pairs)
        return node.numel() * node.element_size(), node.numel() * 2

    return walk(params)
