"""Logical-axis sharding rules: the port of
``k8s_gpu_tpu/parallel/sharding.py``.

Parameters carry *logical* axis names ("embed", "heads", "mlp", ...); a
rule table maps them to mesh axes.  A spec is a tuple with one mesh-axis
name, or ``None``, per dimension.  ``shard_params`` cuts each rank's
local shard along the weight axes of size > 1: ``heads``, ``mlp``,
``vocab`` and ``expert_mlp`` over tp, ``experts`` over ep, ``stages``
(a block leaf's leading ``[L]``) over pp; the rank keeps part
``axis_rank`` of each cut, as the reference's ``NamedSharding`` places
it.  ``gather_params`` is its inverse: the whole tree on every rank.
Parameters cut over a data axis (the fsdp rule ``embed_fsdp`` -> dp) are
not ported.

An int8 leaf ``{"q", "s"}`` (``serve.quant.quantize_params``) is cut as
two: ``q`` like the float leaf, ``s`` only along the dimensions it keeps
(size > 1; a contraction axis's scale has size 1 and is whole on every
rank).  Quantize the whole tree, then cut it: the scale is a max over
the contraction axes, and ``wo`` (heads, Dh), ``wo_mlp`` (F) and
``e_wo`` (F) contract exactly the axes tp cuts, so a rank that
quantized its own shard would hold a scale of its own and products that
are not the whole tree's.  ``gather_params`` joins ``s`` where ``q``
shows it was cut; a dimension of size 1 in both shards is joined unless
every rank holds the same scale there (then the size-1 form broadcasts
the same values).

The stages cut is contiguous (pp rank d holds layers [d L/P, (d+1) L/P),
the reference's ``P("pp")``) unless ``virtual_stages`` v > 1: then rank
d holds the v chunks of interleaved 1F1B, virtual stages c P + d for c <
v, as one ``[v Lc]`` leading axis (chunk c at rows [c Lc, (c+1) Lc), Lc
= L/(P v)).  The reference keeps the contiguous layout and reshards it
to ``[v, P, Lc]`` inside every call of ``interleaved_1f1b``
(``pipeline.py:426-429``), a move of every block parameter each step;
the port's ``Trainer`` holds the interleaved layout from ``init`` on, so
a step moves no parameter, and ``gather_params`` puts the layers back in
``[L]`` order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .collectives import all_gather
from .mesh import axis_rank, axis_size

# The mesh axes a parameter may be cut along.
WEIGHT_AXES = ("pp", "ep", "tp")

# Default rule table: tp shards heads/mlp/vocab, ep shards experts,
# sp shards sequence, dp shards batch.  "embed" unsharded by default
# (flip to ("dp",) for zero/fsdp-style parameter sharding).
DEFAULT_RULES: dict[str, Any] = {
    "batch": "dp",
    "seq": "sp",
    "heads": "tp",
    "kv": None,
    "embed": None,
    "embed_fsdp": "dp",   # used when fsdp param sharding is on
    "mlp": "tp",
    "vocab": "tp",
    "experts": "ep",
    "expert_mlp": "tp",
    "stages": "pp",
    None: None,
}


@dataclass
class ParamRules:
    rules: dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def spec(self, logical_axes: tuple) -> tuple:
        return tuple(self.rules.get(ax, None) for ax in logical_axes)


def _map(fn, tree, *rest):
    """``fn`` over the axis tuples of a logical tree (and the matching
    leaves of ``rest``), keeping the tree's nesting."""
    if isinstance(tree, tuple):
        return fn(tree, *rest)
    return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def logical_to_spec(rules: ParamRules, logical_tree) -> Any:
    """Map a tree of logical-axis tuples to a tree of specs."""
    return _map(rules.spec, logical_tree)


def cut_axes(spec: tuple, mesh) -> list[tuple[int, str]]:
    """(dimension, mesh axis) of each dimension a spec cuts on ``mesh``
    (its axis above size 1); a cut over a data axis raises."""
    cuts = []
    for dim, name in enumerate(spec):
        if name is None or axis_size(mesh, name) == 1:
            continue
        if name not in WEIGHT_AXES:
            raise NotImplementedError(
                f"parameters cut over {name} (fsdp): not ported; the "
                f"port cuts them over {', '.join(WEIGHT_AXES)}")
        cuts.append((dim, name))
    return cuts


def _interleaved(L: int, pp: int, v: int) -> int:
    """Layers a chunk of interleaved 1F1B (the reference's error when
    they do not divide)."""
    if L % (pp * v):
        raise ValueError(f"{L} layers not divisible by {pp}·{v} chunks")
    return L // (pp * v)


def shard_params(params, logical_tree, mesh, rules: ParamRules | None = None,
                 virtual_stages: int = 1):
    """Each rank's local shard of ``params``: every dimension whose spec
    names a mesh axis of size > 1 is cut into that axis's equal parts and
    this rank keeps its own (views of ``params``, but for the interleaved
    stages cut of ``virtual_stages`` > 1).  ``mesh`` None (one device)
    returns ``params`` as they are."""
    if mesh is None:
        return params
    rules = rules or ParamRules()
    v = virtual_stages

    def cut_one(axes, t, scale: bool = False):
        for dim, name in cut_axes(rules.spec(axes), mesh):
            if scale and t.shape[dim] == 1:
                continue
            n, r = axis_size(mesh, name), axis_rank(mesh, name)
            if name == "pp" and v > 1:
                lc = _interleaved(t.shape[0], n, v)
                t = t.reshape(v, n, lc, *t.shape[1:])[:, r].reshape(
                    v * lc, *t.shape[1:])
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of {tuple(t.shape)} does not divide "
                    f"over {name}={n}")
            t = t.chunk(n, dim)[r]
        return t

    def cut(axes, t):
        if isinstance(t, dict):
            return {"q": cut_one(axes, t["q"]),
                    "s": cut_one(axes, t["s"], scale=True)}
        return cut_one(axes, t)

    return _map(cut, logical_tree, params)


def gather_params(params, logical_tree, mesh,
                  rules: ParamRules | None = None, virtual_stages: int = 1):
    """The inverse of ``shard_params``: every rank's shards joined back
    into the whole tree, on every rank (detached).  ``mesh`` None
    returns ``params`` as they are."""
    if mesh is None:
        return params
    rules = rules or ParamRules()
    v = virtual_stages

    def join_one(axes, t, q=None):
        t = t.detach()
        for dim, name in cut_axes(rules.spec(axes), mesh):
            if q is not None and t.shape[dim] == 1 and q.shape[dim] > 1:
                continue          # a contraction axis of the scale
            parts = all_gather(t, mesh.get_group(name))
            if q is not None and t.shape[dim] == 1 and all(
                    torch.equal(p, parts[0]) for p in parts[1:]):
                continue          # the one rank-independent case left
            if name == "pp" and v > 1:
                # [P][v Lc, ...] -> [v, P, Lc, ...] -> [L, ...]
                rest = t.shape[1:]
                t = torch.stack([p.reshape(v, -1, *rest) for p in parts],
                                1).reshape(-1, *rest)
            else:
                t = torch.cat(parts, dim)
        return t

    def join(axes, t):
        if isinstance(t, dict):
            return {"q": join_one(axes, t["q"]),
                    "s": join_one(axes, t["s"], t["q"])}
        return join_one(axes, t)

    return _map(join, logical_tree, params)
