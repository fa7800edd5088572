"""Collectives over a mesh axis's process group, the probes the platform
runs on a fresh slice, and the differentiable ``ppermute`` and
``all_to_all`` that ring attention and Ulysses ride: the port of
``k8s_gpu_tpu/parallel/collectives.py`` on ``torch.distributed``.

The tensor and expert axes ride four more differentiable collectives,
the ones GSPMD inserts around a sharded product in the reference:
``copy_to`` (identity, its backward sums the gradient over the group),
``reduce_from`` (a sum, its backward the identity), ``all_reduce_sum``
(a sum both ways, for a statistic every rank's loss takes whole while
the trainer averages the ranks' gradients) and ``gather_from`` (a
concatenation, its backward this rank's slice).  Each is the identity
when given no group (an axis of size 1).

Every transfer goes through the process group it is given, whatever its
backend.  NCCL moves CUDA tensors itself.  Gloo moves host tensors, so a
CUDA tensor on a gloo group is copied to the host here (``.cpu()``,
which waits for the stream that made it), sent, and copied back: the
compute stays on the card and only the transport crosses the host.  The
caller picks the backend when it joins the world (``multihost``), and
``transport`` names what a group does; nothing switches silently.

Serving on a mesh takes ``reduce_from`` and ``gather_from`` under
``torch.inference_mode()``, where they record no graph, plus
``broadcast_object`` (the leader's descriptor of each device call) and
``all_reduce``/``all_gather`` over dp (a round's tokens).  A meshed
batcher times them (``observe_transfers``): each call's host seconds,
the wait for the tensor's producer included, land in
``collective_seconds{axis,op}``.

The reference's ``shard_map_compat`` is a JAX shim and has no
counterpart here.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import mesh_shape, world_size


# The hook a meshed batcher installs to time its transfers: called with
# (op, group, seconds) after each collective below; None (the default,
# and the training plane's setting) costs one test a call.
_observer = None


def observe_transfers(fn) -> None:
    """Install ``fn(op, group, seconds)`` to be called after every
    ``all_reduce``, ``all_gather`` and ``broadcast_object`` of this
    process (None removes it)."""
    global _observer
    _observer = fn


def _observed(op: str, group, t0: float) -> None:
    if _observer is not None:
        _observer(op, group, time.perf_counter() - t0)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport(group=None, device="cuda") -> str:
    """What a transfer of a tensor on ``device`` over ``group`` takes:
    "nccl", "gloo" (host tensors) or "gloo through the host" (a CUDA
    tensor copied to the host and back)."""
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo through the host"
    return backend


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: contiguous, on the host
    for gloo."""
    t = t.detach().contiguous()
    return t.cpu() if _staged(t, group) else t


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (and return it): a sum, or
    ``op``."""
    t0 = time.perf_counter()
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    _observed("psum", group, t0)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in group-rank order, on
    ``t``'s device."""
    t0 = time.perf_counter()
    wire = _wire(t, group)
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    out = [o.to(t.device) for o in out]
    _observed("all_gather", group, t0)
    return out


def broadcast_object(obj=None, src: int = 0, group=None):
    """``obj`` pickled from global rank ``src`` to every rank of
    ``group`` (the world by default); every other rank passes nothing
    and gets the sender's object.  Tensors in it travel as they are, so
    the sender hands over host tensors."""
    t0 = time.perf_counter()
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    _observed("broadcast", group, t0)
    return box[0]


def _ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """JAX's ``ppermute``: ``perm`` holds (source, destination) pairs of
    group ranks; a rank no pair sends to receives zeros.  A rank that
    only receives reads nothing of ``x`` but its shape, type and
    device."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me]:
        return x.clone()
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, _wire(x, group),
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        recv = torch.empty(x.shape, dtype=x.dtype, device=(
            "cpu" if _staged(x, group) else x.device))
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if not src:
        return torch.zeros_like(x)
    return recv.to(x.device)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into n equal chunks along
    ``split_axis``, chunk j sent to group rank j, the n chunks received
    joined along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide by {n}")
    wire = _wire(torch.stack(x.chunk(n, split_axis)), group)
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_axis)


# Autograd runs a graph's nodes in decreasing creation order on one
# device's thread, so every rank, having created its collectives in the
# same order, runs their backwards in the same (reversed) order, which
# is what keeps the backward's transfers paired across ranks.  Under
# remat (torch.utils.checkpoint, or ``save_attn``'s replay of a block
# around its kept attention) a block's forward, its collectives
# included, runs again inside the backward at the same point on every
# rank, so the order stays the same there too; the ring's replay posts
# its hops (``_ppermute``) in its own backward, in the forward's order.
# Autograd prunes what leads to no input it is asked for, so a hop whose
# peer waits must lead to one on every rank (``pipeline._Anchor``).

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.group, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.detach().contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        n, me = dist.get_world_size(group), dist.get_rank(group)
        return g.chunk(n, dim)[me].contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input entering a sharded product: the identity, whose
    backward sums the partial gradients over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """A sharded product's partial sums: summed over ``group``, the
    gradient handed back as it is (every rank's loss takes the same
    sum, and each rank differentiates only its own part)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` whose backward is also the sum: for
    statistics of the whole batch that enter every rank's loss while the
    trainer averages the ranks' gradients (the MoE aux loss over dp x
    sp), so each rank's share of the gradient comes back from all."""
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group-rank order; the
    backward hands each rank its slice."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Differentiable ``ppermute`` over ``group``: its backward is the
    ppermute along the inverse permutation."""
    return _PPermute.apply(x, group, [tuple(p) for p in perm])


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Differentiable tiled all-to-all over ``group``: its backward is the
    all-to-all with the two axes swapped."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# -- the probes ---------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def psum_smoke(device="cuda") -> dict:
    """All-reduce each rank's index over the world (which every mesh
    spans) and check the sum analytically.  Returns {ok, n_devices,
    wall_s, result}."""
    dev = resolve_device(device)
    n = world_size()
    rank = dist.get_rank() if dist.is_initialized() else 0
    x = torch.full((1,), float(rank), device=dev)
    t0 = time.perf_counter()
    if dist.is_initialized():
        all_reduce(x)
    _sync(dev)
    wall = time.perf_counter() - t0
    expect = float(sum(range(n)))
    result = float(x.item())
    return {"ok": abs(result - expect) <= 1e-6 * max(1.0, expect),
            "n_devices": n, "wall_s": wall, "result": result}


def _timed_all_reduce(x, group, iters: int, dev) -> float:
    all_reduce(x, group)                        # warm the group
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce(x, group)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def all_reduce_bandwidth_probe(mib: int = 64, iters: int = 5,
                               device="cuda") -> dict:
    """Time an all-reduce of a ~mib-MiB bf16 buffer over the world (as
    ``psum_smoke`` does); returns the algorithm bandwidth
    2(n-1)/n bytes / t in GB/s."""
    dev = resolve_device(device)
    n = world_size()
    elems = mib * 1024 * 1024 // 2
    x = torch.ones(elems, dtype=torch.bfloat16, device=dev)
    dt = _timed_all_reduce(x, None, iters, dev) if n > 1 else 0.0
    nbytes = elems * 2
    algo = 2 * (n - 1) / max(n, 1) * nbytes / dt / 1e9 if dt > 0 else 0.0
    return {"n_devices": n, "bytes": nbytes, "time_s": dt,
            "algo_gbps": algo, "transport": transport(None, dev)
            if dist.is_initialized() else "none"}


def per_axis_bandwidth_probe(mesh, mib: float = 1.0, iters: int = 2,
                             registry=None, device="cuda") -> dict:
    """Per-axis collective bandwidth: for each mesh axis of size > 1, the
    time of an all-reduce of a ~``mib``-MiB bf16 buffer over only that
    axis's group, exported as ``collective_seconds{axis,op}`` and
    ``collective_bytes_per_second{axis}`` (2(k-1)/k bytes / t, the
    whole-mesh probe's convention).  Returns {axis: {devices, seconds,
    bytes_per_second, transport}}; on a gloo group of CUDA tensors the
    time includes the copies through the host."""
    from ..utils.metrics import global_metrics

    reg = registry if registry is not None else global_metrics
    dev = resolve_device(device)
    iters = max(1, int(iters))
    elems = max(1, int(mib * 1024 * 1024) // 2)
    x = torch.ones(elems, dtype=torch.bfloat16, device=dev)
    out: dict[str, dict] = {}
    for axis, k in mesh_shape(mesh).items():
        if k <= 1:
            continue
        group = mesh.get_group(axis)
        dt = _timed_all_reduce(x, group, iters, dev)
        bw = 2 * (k - 1) / k * elems * 2 / max(dt, 1e-12)
        reg.observe("collective_seconds", dt, axis=axis, op="psum")
        reg.set_gauge("collective_bytes_per_second", bw, axis=axis)
        out[axis] = {"devices": k, "seconds": dt, "bytes_per_second": bw,
                     "transport": transport(group, dev)}
    return out
