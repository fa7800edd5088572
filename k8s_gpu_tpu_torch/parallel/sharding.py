"""Logical-axis sharding rules: the port of
``k8s_gpu_tpu/parallel/sharding.py``.

Parameters carry *logical* axis names ("embed", "heads", "mlp", ...); a
rule table maps them to mesh axes.  A spec is a tuple with one mesh-axis
name, or ``None``, per dimension.  ``shard_params`` cuts each rank's
local shard along the weight axes of size > 1: ``heads``, ``mlp``,
``vocab`` and ``expert_mlp`` over tp, ``experts`` over ep; the rank
keeps part ``axis_rank`` of each cut, as the reference's
``NamedSharding`` places it.  ``gather_params`` is its inverse: the
whole tree on every rank.  Parameters cut over a data axis (the fsdp
rule ``embed_fsdp`` -> dp) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .collectives import all_gather
from .mesh import axis_rank, axis_size, check_slice

# The mesh axes a parameter may be cut along.
WEIGHT_AXES = ("ep", "tp")

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


def shard_params(params, logical_tree, mesh, rules: ParamRules | None = None):
    """Each rank's local shard of ``params``: every dimension whose spec
    names a mesh axis of size > 1 is cut into that axis's equal parts and
    this rank keeps its own (views of ``params``).  ``mesh`` None (one
    device) returns ``params`` as they are."""
    if mesh is None:
        return params
    check_slice(mesh, "shard_params")
    rules = rules or ParamRules()

    def cut(axes, t):
        for dim, name in cut_axes(rules.spec(axes), mesh):
            n = axis_size(mesh, name)
            if t.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of {tuple(t.shape)} does not divide "
                    f"over {name}={n}")
            t = t.chunk(n, dim)[axis_rank(mesh, name)]
        return t

    return _map(cut, logical_tree, params)


def gather_params(params, logical_tree, mesh,
                  rules: ParamRules | None = None):
    """The inverse of ``shard_params``: every rank's shards joined back
    into the whole tree, on every rank (detached).  ``mesh`` None
    returns ``params`` as they are."""
    if mesh is None:
        return params
    rules = rules or ParamRules()

    def join(axes, t):
        t = t.detach()
        for dim, name in cut_axes(rules.spec(axes), mesh):
            t = torch.cat(all_gather(t, mesh.get_group(name)), dim)
        return t

    return _map(join, logical_tree, params)
