"""Ulysses all-to-all sequence parallelism over the ``sp`` mesh axis: the
port of ``k8s_gpu_tpu/parallel/ulysses.py`` on ``torch.distributed``.

DeepSpeed-Ulysses re-shards around attention instead of streaming K/V:

    [B, H, S/P, D]  --all_to_all-->  [B, H/P, S, D]
         (seq-sharded)                   (head-sharded, full sequence)

then each rank runs one whole-sequence causal flash call for its H/P
heads (v2 for grouped K/V, rope outside), and a second all-to-all
restores the sequence sharding.  It needs the head count to divide by
sp; grouped K/V also need their KV heads to (``ulysses_grouped_ok``).
On a tp mesh a rank holds its H/tp heads, and Ulysses regroups those.

Under ``remat_policy="save_attn"`` the model keeps the rank's own heads'
output and lse after the first all-to-all (``ulysses_attention_saving``)
and its backward replays around them (``ulysses_attention_replay``):
the all-to-alls run again, the flash forward does not, and the
backward runs the flash backward kernels on those heads between the
all-to-alls in reverse.
"""

from __future__ import annotations

import torch

from ..ops.attention import (
    attention_replay, flash_attention_lse, flash_attention_v2_lse,
)
from .collectives import all_to_all
from .mesh import mesh_shape


def _seq_to_heads(x, group):
    # [B, H, S/P, D] -> [B, H/P, S, D]
    return all_to_all(x, group, split_axis=1, concat_axis=2)


def _heads_to_seq(x, group):
    return all_to_all(x, group, split_axis=2, concat_axis=1)


def _attend_heads(q, k, v, block_q, block_k):
    """(out, lse) of this rank's heads over the whole sequence.  The
    tiled all_to_all hands query chunk i exactly KV-head chunk i
    (ulysses_grouped_ok), so grouped K/V keep their pairing here."""
    if k.shape[1] != q.shape[1]:
        return flash_attention_v2_lse(q, k, v, causal=True, block_q=block_q,
                                      block_k=block_k)
    return flash_attention_lse(q, k, v, True, block_q, block_k)


def _ulysses_local(q, k, v, *, group, block_q=None, block_k=None,
                   keep: bool = False):
    """This rank's body: inputs are its sequence blocks [B, H, S/P, D].
    ``keep``: also return (out, lse) of its heads."""
    q, k, v = (_seq_to_heads(t, group) for t in (q, k, v))
    o, lse = _attend_heads(q, k, v, block_q, block_k)
    out = _heads_to_seq(o, group)
    return (out, (o, lse)) if keep else out


def _heads_over(mesh, head_axes) -> int:
    shape = mesh_shape(mesh)
    tp = 1
    for ax in head_axes:
        tp *= shape.get(ax, 1)
    return tp


def ulysses_grouped_ok(h: int, kh: int, mesh, *, axis_name: str = "sp",
                       head_axes=("tp",)) -> bool:
    """True when grouped K/V [B, KH, S, D] can ride ulysses' all-to-alls
    without breaking the query<->KV head pairing: the local KV head
    count must divide by sp.  Otherwise the model broadcasts K/V and
    mints flash_fallback_total{reason="ulysses_kv_heads"}."""
    if h % kh != 0:
        return False
    sp = mesh_shape(mesh).get(axis_name, 1)
    tp = _heads_over(mesh, head_axes)
    if kh % tp != 0:
        return False
    return (kh // tp) % sp == 0


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp",
                      head_axes=("tp",), block_q: int | None = None,
                      block_k: int | None = None):
    """Causal self-attention with the sequence sharded over *axis_name*:
    the same contract as ``ring_attention`` (this rank's blocks in, its
    output block out).  q, k and v hold this rank's heads, the H/tp and
    KH/tp of its place on ``head_axes``; the errors name the whole
    counts, as the reference's do.  The local head count must divide by
    sp; grouped K/V are taken when ``ulysses_grouped_ok`` holds."""
    _check_heads(q, k, mesh, axis_name, head_axes)
    return _ulysses_local(q, k, v, group=mesh.get_group(axis_name),
                          block_q=block_q, block_k=block_k)


def ulysses_attention_saving(q, k, v, mesh, *, axis_name: str = "sp",
                             head_axes=("tp",), block_q: int | None = None,
                             block_k: int | None = None):
    """``ulysses_attention`` without a graph -> (this rank's output
    block, its heads' (out, lse), what ``ulysses_attention_replay``
    replays around)."""
    _check_heads(q, k, mesh, axis_name, head_axes)
    with torch.no_grad():
        return _ulysses_local(q, k, v, group=mesh.get_group(axis_name),
                              block_q=block_q, block_k=block_k, keep=True)


def ulysses_attention_replay(q, k, v, saved, mesh, *, axis_name: str = "sp"):
    """``ulysses_attention``'s output block as a differentiable function
    of q, k and v, from what ``ulysses_attention_saving`` kept on the
    same inputs: the all-to-alls run again, the flash forward does not
    (module docstring)."""
    group = mesh.get_group(axis_name)
    q, k, v = (_seq_to_heads(t, group) for t in (q, k, v))
    o = attention_replay(q, k, v, *saved, causal=True,
                         v2=k.shape[1] != q.shape[1])
    return _heads_to_seq(o, group)


def _check_heads(q, k, mesh, axis_name, head_axes) -> None:
    """The reference's errors for head counts Ulysses cannot regroup."""
    sp = mesh_shape(mesh)[axis_name]
    tp = _heads_over(mesh, head_axes)
    h, kh = q.shape[1] * tp, k.shape[1] * tp
    local_heads = q.shape[1]
    if local_heads % sp != 0:
        raise ValueError(
            f"ulysses needs local heads ({h}/{tp}={local_heads}) "
            f"divisible by sp={sp}; use ring attention instead"
        )
    if kh != h and not ulysses_grouped_ok(
        h, kh, mesh, axis_name=axis_name, head_axes=head_axes
    ):
        raise ValueError(
            f"ulysses grouped K/V needs local KV heads "
            f"({kh}/{tp}) divisible by sp={sp}; broadcast K/V "
            "to the full head count first (see ulysses_grouped_ok)"
        )
