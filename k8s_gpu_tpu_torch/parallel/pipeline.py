"""Pipeline parallelism over the mesh's pp axis: the port of
``k8s_gpu_tpu/parallel/pipeline.py`` on ``torch.distributed``, one
process a rank.

A pp rank holds its stage's blocks (``parallel.sharding``: contiguous
layers, or with v virtual stages the v chunks ``c P + d``) and runs a
static tick table in Python: at each tick it runs the forward and the
backward of at most one (chunk, microbatch) each, which ``decode_fwd``
and ``decode_bwd`` give, the reference's skew (``pipeline.py:169-170,
385, 472-491``).  Virtual stage s = c P + d runs the forward of
microbatch j at tick

    t_f = d + (j mod P) + P c + P v (j div P)

and its backward at t_f(0, j) + 2 S - 2 - s (S = P v), so consecutive
virtual stages are one tick apart both ways; v = 1 is classic 1F1B (F
at d + j, B at 2 P - 2 - d + j).  Activations move forward and
cotangents backward by one hop a tick through the port's ``ppermute``
(``collectives._ppermute``), a ring when v > 1.  Both peers of a hop
read the same table, so a hop is posted only by the ranks it moves a
valid microbatch between, and every rank posts its hops in the same
order: the forward hop, then the backward hop, each tick.

``gpipe`` is the forward schedule alone (the F column of the same
table), differentiated by autograd through the differentiable
``ppermute``; its output is shared over pp by a sum whose backward
hands each rank its own cotangent (``reduce_from``: the last stage gets
the cotangent of one copy of the loss, not the sum of pp copies), and
its input enters through ``copy_to``, whose backward sums the input's
cotangent over pp, so every pp rank leaves with the same embedding
gradient.  ``one_f_one_b`` and ``interleaved_1f1b`` run the forward of a
tick without a graph, keep its input, and in the backward tick recompute
the stage from that input under ``torch.enable_grad()`` and
differentiate it with the received cotangent: that recompute is the
remat (no ``checkpoint`` inside it, so a block runs two forwards per
microbatch, one on the last virtual stage, where F is fused into B with
the tail).  With a ``saving_fn`` (the model's ``save_attn``) the forward
tick also keeps what ``saving_fn`` returns beside the input, and the
backward tick's ``stage_fn`` takes it: the stage is recomputed around
it (the attention's forward is not run again).  At most 2 S - 1 stage
inputs are live, the reference's ring.
Gradients accumulate in the ``.grad`` of leaves made once a call, in the
parameters' type (the ``Trainer``'s f32 masters), and leave as f32.

The reference psums the loss, the tail's gradients and the stage
gradients over the batch axes as well; here the schedules sum over pp
only and return this rank's batch block's values, which the ``Trainer``
averages over the batch group (dp x sp) with the other leaves.

With v > 1 and M not a multiple of P the table needs more ticks than the
reference's ``interleaved_ticks``, whose scan then drops the last
backward ticks (``pipeline_ticks``; ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from . import collectives
from .collectives import all_reduce, copy_to, reduce_from
from .mesh import axis_rank, axis_size

# The last call's tick count and the most stage inputs it held at once.
schedule_stats = {"ticks": 0, "live_inputs": 0}


# -- the tick table --------------------------------------------------------

def decode_fwd(i: int, d: int, M: int, pp: int, v: int = 1):
    """(chunk, microbatch) whose forward device ``d`` runs at tick ``i``,
    or None: the reference's ``decode_fwd``."""
    y = i - d
    jr = y % pp                     # j mod P
    z = (y - jr) // pp              # c + v (j div P)
    c = z % v
    q = (z - c) // v
    j = q * pp + jr
    return (c, j) if y >= 0 and q >= 0 and j < M else None


def decode_bwd(i: int, d: int, M: int, pp: int, v: int = 1):
    """(chunk, microbatch) whose backward device ``d`` runs at tick
    ``i``, or None: the reference's ``decode_bwd``."""
    y = i - (2 * pp * v - 2 - d)    # (j mod P) + P v (j div P) - P c
    jr = y % pp
    z = (y - jr) // pp              # v (j div P) - c
    c = (-z) % v
    q = (z + c) // v
    j = q * pp + jr
    return (c, j) if q >= 0 and 0 <= j < M else None


def interleaved_ticks(M: int, pp: int, v: int) -> int:
    """The reference's fine-tick count of the interleaved schedule: M v
    busy fine ticks a device plus the fill/drain bubble P v + P - 2 (a
    fine tick is one chunk of L/(P v) layers, forward and backward)."""
    return M * v + pp * v + pp - 2


def classic_ticks_fine(M: int, pp: int) -> int:
    """Classic 1F1B's M + 2 P - 2 coarse ticks (multiply by v to compare
    with ``interleaved_ticks``)."""
    return M + 2 * pp - 2


def pipeline_ticks(M: int, pp: int, v: int = 1) -> int:
    """Ticks the table needs: one past the last backward, virtual stage
    0's of microbatch M - 1.  Equal to ``interleaved_ticks`` when P
    divides M (and to ``classic_ticks_fine`` at v = 1), larger by (v -
    1)(P - 1 - (M - 1) mod P) otherwise."""
    last = M - 1
    return (last % pp) + pp * v * (last // pp) + 2 * pp * v - 1


def forward_ticks(M: int, pp: int, v: int = 1) -> int:
    """Ticks of the forward schedule alone: one past the last forward,
    the last virtual stage's of microbatch M - 1 (M + P - 1 at v = 1)."""
    last = M - 1
    return (pp - 1 + (last % pp) + pp * (v - 1)
            + pp * v * (last // pp) + 1)


def tick_table(M: int, pp: int, v: int = 1) -> list:
    """table[tick][device] = (forward (chunk, microbatch) or None,
    backward (chunk, microbatch) or None), for ``pipeline_ticks``
    ticks."""
    return [[(decode_fwd(i, d, M, pp, v), decode_bwd(i, d, M, pp, v))
             for d in range(pp)] for i in range(pipeline_ticks(M, pp, v))]


def _fwd_perm(i: int, M: int, pp: int, v: int) -> list:
    """The forward hop after tick ``i``: every device whose forward ran
    a virtual stage other than the last sends to the next device."""
    S = pp * v
    perm = []
    for s in range(pp):
        f = decode_fwd(i, s, M, pp, v)
        if f is not None and f[0] * pp + s != S - 1:
            perm.append((s, (s + 1) % pp))
    return perm


def _bwd_perm(i: int, M: int, pp: int, v: int) -> list:
    """The backward hop after tick ``i``: every device whose backward ran
    a virtual stage other than the first sends to the previous one."""
    perm = []
    for s in range(pp):
        b = decode_bwd(i, s, M, pp, v)
        if b is not None and b[0] * pp + s != 0:
            perm.append((s, (s - 1) % pp))
    return perm


# -- helpers ---------------------------------------------------------------

def _microbatches(local_b: int, M: int) -> int:
    if local_b % M:
        raise ValueError(
            f"local batch {local_b} not divisible by {M} microbatches")
    return M


def _chunk(params: dict, c: int, lc: int) -> dict:
    """Chunk ``c``'s layers (views) of a rank's ``[v Lc, ...]`` leaves."""
    return {k: t[c * lc:(c + 1) * lc] for k, t in params.items()}


def _local_layers(params: dict) -> int:
    return next(iter(params.values())).shape[0]


def _hop(x: torch.Tensor, group, perm, me: int):
    """One hop of the table without a graph: this rank's part of
    ``perm`` (``x`` is what it sends, or only a template of the shape it
    receives); None when the hop does not involve it."""
    if not any(me in p for p in perm):
        return None
    return collectives._ppermute(x, group, perm)


class _Tie(torch.autograd.Function):
    """``y`` itself, with the hops whose output nothing uses tied to it:
    their backward (a transfer the peer waits for) then runs on every
    rank, with a zero cotangent."""

    @staticmethod
    def forward(ctx, y, *loose):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in loose]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.shapes))


class _Anchor(torch.autograd.Function):
    """``y`` itself, tied to ``params`` so that a graph through it leads to
    them; their gradient from it is none."""

    @staticmethod
    def forward(ctx, y, *params):
        ctx.n = len(params)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(None,) * ctx.n)


# -- GPipe -------------------------------------------------------------------

def gpipe(stage_fn, stage_params, x, mesh, num_microbatches: int | None = None,
          axis_name: str = "pp", virtual_stages: int = 1):
    """Run ``x`` through the pipeline's stages: the forward schedule of
    the tick table, M = ``num_microbatches`` or P microbatches of
    contiguous rows.

    stage_fn(params_slice, act[mb, ...]) -> act[mb, ...], with
      params_slice the leaves of one chunk (a ``[Lc, ...]`` leading
      axis);
    stage_params: this rank's block leaves, ``[v Lc, ...]``
      (``parallel.sharding``'s layout for ``virtual_stages`` v);
    x: this rank's batch block [B, ...], the same on every pp rank.
    Returns [B, ...], the same on every pp rank; differentiable in
    ``x`` and ``stage_params`` (module docstring)."""
    pp = axis_size(mesh, axis_name)
    if pp == 1:
        return stage_fn(stage_params, x)
    M = _microbatches(x.shape[0], num_microbatches or pp)
    v = virtual_stages
    S = pp * v
    group = mesh.get_group(axis_name)
    d = axis_rank(mesh, axis_name)
    lc = _local_layers(stage_params) // v
    x = copy_to(x, group)
    xm = x.chunk(M, 0)
    outs = [None] * M
    loose = [] if d == 0 else [x]
    recv = None
    T = forward_ticks(M, pp, v)
    for i in range(T):
        f = decode_fwd(i, d, M, pp, v)
        out = None
        if f is not None:
            c, j = f
            inp = xm[j] if d == 0 and c == 0 else recv
            out = stage_fn(_chunk(stage_params, c, lc), inp)
            if c * pp + d == S - 1:
                outs[j], out = out, None
        perm = _fwd_perm(i, M, pp, v)
        if any(d in p for p in perm):
            # A rank that only receives hands over a template that leads
            # to the stage's parameters, so the hop's backward runs even
            # where the caller differentiates those alone (a LoRA model's
            # adapters: autograd prunes what leads to no input it asks
            # for).
            got = collectives.ppermute(
                out if out is not None
                else _Anchor.apply(xm[0], *stage_params.values()),
                group, perm)
            if any(dst == d for _, dst in perm):
                recv = got
            else:
                loose.append(got)
    schedule_stats.update(ticks=T, live_inputs=0)
    y = torch.cat(outs) if d == pp - 1 else torch.zeros_like(x)
    return _Tie.apply(reduce_from(y, group), *loose)


# -- 1F1B and interleaved 1F1B -----------------------------------------------

def _one_f_one_b(stage_fn, stage_params, tail_params, tail_loss_fn, x,
                 targets, mesh, v: int, num_microbatches, axis_name,
                 saving_fn=None):
    pp = axis_size(mesh, axis_name)
    S = pp * v
    group = mesh.get_group(axis_name)
    d = axis_rank(mesh, axis_name)
    local_b = x.shape[0]
    M = _microbatches(local_b, num_microbatches or (
        2 * pp if local_b % (2 * pp) == 0 else pp))
    lc = _local_layers(stage_params) // v
    x = x.detach()
    xm, tm = x.chunk(M, 0), targets.chunk(M, 0)
    zeros_mb = torch.zeros_like(xm[0])
    # Each chunk's leaves and the tail's as leaves of their own, whose
    # ``.grad`` the backward ticks accumulate into: one leaf's gradient
    # at a time is transient, never a whole stage's.
    chunks = [{k: t.detach().requires_grad_() for k, t in
               _chunk(stage_params, c, lc).items()} for c in range(v)]
    tail = [t.detach().requires_grad_() for t in tail_params]
    dxm = [None] * M
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    store: dict = {}
    live = 0
    fwd_recv = bwd_recv = None
    T = pipeline_ticks(M, pp, v)
    for i in range(T):
        # ---- forward: one chunk, no graph -------------------------------
        f = decode_fwd(i, d, M, pp, v)
        out = zeros_mb
        if f is not None:
            c, j = f
            inp = xm[j] if d == 0 and c == 0 else fwd_recv
            store[(c, j)] = (inp, None)
            live = max(live, len(store))
            if c * pp + d != S - 1:
                # The last virtual stage runs its forward fused into its
                # backward, in the same tick.
                with torch.no_grad():
                    if saving_fn is None:
                        out = stage_fn(_chunk(stage_params, c, lc), inp)
                    else:
                        out, kept = saving_fn(_chunk(stage_params, c, lc),
                                              inp)
                        store[(c, j)] = (inp, kept)
        fwd_recv = _hop(out, group, _fwd_perm(i, M, pp, v), d)
        # ---- backward: one chunk, recomputed from its input --------------
        b = decode_bwd(i, d, M, pp, v)
        dinp = zeros_mb
        if b is not None:
            c, j = b
            s = c * pp + d
            with torch.enable_grad():
                a, kept = store.pop((c, j))
                a = a.detach().requires_grad_()
                p = chunks[c]
                y = stage_fn(p, a) if kept is None else stage_fn(p, a, kept)
                if s == S - 1:
                    loss_j = tail_loss_fn(tail, y, tm[j])
                    torch.autograd.backward(loss_j / M,
                                            inputs=[a, *p.values(), *tail])
                    loss += loss_j.detach().float() / M
                else:
                    torch.autograd.backward(y, bwd_recv,
                                            inputs=[a, *p.values()])
            dinp = a.grad
            if s == 0:
                dxm[j] = dinp
        bwd_recv = _hop(dinp, group, _bwd_perm(i, M, pp, v), d)
    schedule_stats.update(ticks=T, live_inputs=live)

    def grad(t):
        return (torch.zeros_like(t, dtype=torch.float32) if t.grad is None
                else t.grad.float())

    dparams = {k: grad(chunks[0][k]) if v == 1
               else torch.cat([grad(ch[k]) for ch in chunks])
               for k in stage_params}
    # One sum over pp: the loss and the tail's gradients live on the last
    # stage, the input's cotangent on the first.
    dtail = [grad(t) for t in tail]
    dx = (torch.cat(dxm).float() if d == 0
          else torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    flat = torch.cat([loss.reshape(1), *(g.reshape(-1) for g in dtail),
                      dx.reshape(-1)])
    all_reduce(flat, group)
    parts = flat.split([1, *(g.numel() for g in dtail), dx.numel()])
    dtail = tuple(p.view_as(g) for p, g in zip(parts[1:-1], dtail))
    return parts[0][0], dparams, dtail, parts[-1].view(x.shape).to(x.dtype)


def one_f_one_b(stage_fn, stage_params, tail_params, tail_loss_fn, x, targets,
                mesh, num_microbatches: int | None = None,
                axis_name: str = "pp", saving_fn=None):
    """1F1B: the loss and the gradients in one pass of the tick table,
    each microbatch's backward as soon as its forward clears the pipe,
    at most 2 P - 1 stage inputs live (GPipe's autograd holds M + P - 1).
    M = ``num_microbatches``, or 2 P when it divides the local batch,
    else P.

    stage_fn(params_slice, act[mb, ...]) -> act[mb, ...];
    tail_loss_fn(tail_params, act[mb, ...], tgt[mb, ...]) -> the
      microbatch's mean loss (the last stage's norm, head and
      cross-entropy);
    stage_params: this rank's contiguous block leaves [L/P, ...];
    tail_params: a sequence of the tail's leaves (replicated over pp);
    x, targets: this rank's batch block, the same on every pp rank;
    saving_fn(params_slice, act[mb, ...]) -> (act[mb, ...], kept): the
      forward tick's stage when the backward tick's recompute takes
      what it kept, ``stage_fn(params_slice, act, kept)`` (None: the
      forward tick runs ``stage_fn`` and keeps only its input).
    Returns (loss, d_stage_params, d_tail_params, dx): the block's mean
    loss, the tail's gradients and the input's cotangent, each the same
    on every pp rank (summed over pp), and this stage's f32 gradients."""
    if axis_size(mesh, axis_name) == 1:
        raise ValueError("one_f_one_b needs pp > 1; use the plain path")
    return _one_f_one_b(stage_fn, stage_params, tail_params, tail_loss_fn,
                        x, targets, mesh, 1, num_microbatches, axis_name,
                        saving_fn)


def interleaved_1f1b(stage_fn, stage_params, tail_params, tail_loss_fn, x,
                     targets, mesh, v: int,
                     num_microbatches: int | None = None,
                     axis_name: str = "pp", saving_fn=None):
    """Interleaved 1F1B: each rank holds ``v`` non-contiguous chunks of
    L/(P v) layers (virtual stages c P + d), and a microbatch visits
    every rank v times, wrapping from P - 1 to 0 between chunks.  A fine
    tick is one chunk's forward and backward, so the fill and drain
    bubble is (P v + P - 2) fine ticks against classic 1F1B's 2 (P - 1) v;
    2 P v - 1 chunk inputs are live.

    ``stage_params``: this rank's ``[v Lc, ...]`` leaves, chunk c at rows
    [c Lc, (c+1) Lc) (``parallel.sharding``'s interleaved layout, which
    the ``Trainer`` holds from ``init`` on; the reference reshards the
    contiguous ``[L]`` to ``[v, P, Lc]`` at every call).  The other
    arguments and the returns are ``one_f_one_b``'s, d_stage_params in
    the same layout."""
    pp = axis_size(mesh, axis_name)
    if pp == 1:
        raise ValueError("interleaved_1f1b needs pp > 1")
    if v < 2:
        raise ValueError("v < 2 is classic 1F1B; call one_f_one_b")
    local = _local_layers(stage_params)
    if local % v:
        raise ValueError(f"{local * pp} layers not divisible by {pp}·{v} "
                         "chunks")
    return _one_f_one_b(stage_fn, stage_params, tail_params, tail_loss_fn,
                        x, targets, mesh, v, num_microbatches, axis_name,
                        saving_fn)
