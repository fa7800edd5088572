"""The device mesh over ``(dp, pp, ep, sp, tp)``: the port of
``k8s_gpu_tpu/parallel/mesh.py`` on ``torch.distributed``.

One process drives one device (one rank), and a mesh is a
``DeviceMesh`` over the initialized world, its axes named ``AXES`` in the
reference's order (tp innermost, dp outermost).  A world of one rank
needs no process group: ``build_mesh`` returns ``None`` there, and every
consumer reads ``None`` as the one-device mesh, every axis of size 1.

Every axis runs in training: data, pipeline, sequence, tensor and
expert, for every model the ``Trainer`` takes (the transformer, its LoRA
view and the CNN), as in the reference.  Serving runs dp and tp
(``SERVE_AXES``), as the reference's meshed engine does.  A consumer
refuses an axis it does not run (``check_slice``, with the reference's
reason): serving beyond dp and tp, and the pipeline beyond dp and tp
(``TransformerLM._check_pp_composition``).

Besides one group an axis (``mesh.get_group``), ``build_mesh`` makes the
groups of two axes together that the training path reduces over: the
batch group dp x sp (the ranks whose tokens differ, over which the
gradients are averaged), ep x tp (the ranks that share tokens and cut
the experts' weights) and pp x tp (the ranks that cut a block leaf over
stages and heads, whose squares the global norm sums).  ``axis_group``
hands each out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist

# Canonical axis order: outermost (dp, gradient all-reduce) to innermost
# (tp, the hottest traffic).
AXES = ("dp", "pp", "ep", "sp", "tp")
# The data axes: the ranks whose tokens differ.
DATA_AXES = ("dp", "sp")
# The axes a serving mesh takes: rows over dp, heads over tp.
SERVE_AXES = ("dp", "tp")
# The groups of more than one axis that build_mesh makes.
GROUPED_AXES = (("dp", "sp"), ("ep", "tp"), ("pp", "tp"))


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each logical axis; -1 on dp = absorb remaining devices."""

    dp: int = -1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"dp": self.dp, "pp": self.pp, "ep": self.ep,
                 "sp": self.sp, "tp": self.tp}
        fixed = 1
        for a, s in sizes.items():
            if s != -1:
                if s <= 0:
                    raise ValueError(f"axis {a} size must be positive, got {s}")
                fixed *= s
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}"
            )
        for a, s in sizes.items():
            if s == -1:
                sizes[a] = n_devices // fixed
                fixed *= sizes[a]
        total = 1
        for s in sizes.values():
            total *= s
        if total != n_devices:
            raise ValueError(
                f"axis sizes {sizes} use {total} devices, have {n_devices}"
            )
        return sizes


def world_size() -> int:
    """Ranks of the initialized world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(config: MeshConfig | None = None,
               n_devices: int | None = None, device_type: str = "cuda"):
    """The training mesh over the initialized world: a ``DeviceMesh`` of
    ``device_type`` with the canonical axis names, or ``None`` for a
    world of one rank.  With no config everything goes to dp.
    ``n_devices`` must equal the world size when given (a mesh spans
    every rank).  Each axis group of more than one rank passes one
    barrier here: NCCL requires the first call on a group to involve
    all its ranks, and a ring's first transfer may leave some out."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"want {n_devices} devices, the world has {n} ranks")
    sizes = config.resolve(n)
    if n == 1:
        return None
    mesh = init_device_mesh(device_type, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)
    for a in AXES:
        if sizes[a] > 1:
            dist.barrier(group=mesh.get_group(a))
    # Every rank makes every group of each pair, in the same order
    # (new_group is collective over the world).
    mesh.port_groups = {}
    for axes in GROUPED_AXES:
        if all(sizes[a] > 1 for a in axes):
            group, _ = dist.new_subgroups_by_enumeration(
                _enumerate(mesh, axes))
            dist.barrier(group=group)
            mesh.port_groups[axes] = group
    return mesh


def _enumerate(mesh, axes) -> list[list[int]]:
    """The world's ranks in groups that differ only along ``axes``: the
    mesh's rank grid with those axes last, one row a group."""
    grid = mesh.mesh
    dims = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in dims]
    size = math.prod(grid.shape[d] for d in dims)
    return grid.permute(rest + dims).reshape(-1, size).tolist()


def axis_group(mesh, *axes):
    """This rank's process group over ``axes`` (the ranks that differ only
    along them), or None when none of them exceeds size 1.  One axis of
    size > 1 gives the mesh's own group; two give the group
    ``build_mesh`` made for them (``GROUPED_AXES``)."""
    big = tuple(a for a in AXES if a in axes and axis_size(mesh, a) > 1)
    if not big:
        return None
    if len(big) == 1:
        return mesh.get_group(big[0])
    return mesh.port_groups[big]


def batch_group(mesh):
    """The ranks whose tokens differ (dp x sp): the group the gradients
    and the loss are averaged over."""
    return axis_group(mesh, *DATA_AXES)


def multislice_mesh(config: MeshConfig, num_slices: int,
                    device_type: str = "cuda"):
    """``build_mesh`` with the multislice invariant checked first: dp
    must span slices and every other axis stay inside one, so dp is a
    multiple of the slice count (the reference's error)."""
    sizes = config.resolve(world_size())
    if sizes["dp"] % num_slices != 0:
        raise ValueError(
            f"dp={sizes['dp']} must be a multiple of num_slices={num_slices} "
            "(dp is the only DCN-crossing axis)"
        )
    return build_mesh(config, device_type=device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size} of a mesh (``None``: every axis 1), as the
    reference's ``mesh.shape``."""
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 on a one-device mesh)."""
    return 0 if mesh is None or axis_size(mesh, axis) == 1 \
        else mesh.get_local_rank(axis)


def check_slice(mesh, what: str, axes, reason: str) -> None:
    """Refuse a mesh with an axis above 1 that ``what`` does not run
    (``axes``: the ones it does); ``reason`` says why, in the
    reference's words."""
    big = [a for a, s in mesh_shape(mesh).items()
           if s > 1 and a not in axes]
    if big:
        raise NotImplementedError(
            f"{what} on a mesh with {', '.join(f'{a}>1' for a in big)}: "
            f"{reason}")
