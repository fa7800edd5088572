"""Training runner: the port of ``k8s_gpu_tpu/train/runner.py``.

The reference jits one sharded step (optax clip -> AdamW with a warmup
schedule) over a mesh.  Here the step runs eagerly, one process a
device: the loss and its gradients by autograd (flash attention in the
CUDA kernels when the model's ``use_flash``), then the same update optax
applies, written out in torch on f32 master parameters:

- ``clip_by_global_norm``: ``g`` where the global norm is below the limit,
  else ``g / norm * limit`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- ``adamw``: bias-corrected moments with eps 1e-8 outside the square
  root, decoupled weight decay on every leaf, and the learning rate of the
  schedule at the step count *before* the update, so the first step of any
  ``warmup_steps > 0`` run moves nothing.

The reference's telemetry rides along: an optional ``GoodputLedger``
(``init``, the first step as ``compile``, every later step as ``step``,
``fit``'s wait on its iterator as ``data_wait``, and a per-host
heartbeat), a ``PhaseProfiler`` over the step's phases (``shard_batch``,
the batch's copy to the device; ``step_dispatch``; ``loss_sync``) and
the step series ``train_step_seconds``, ``train_last_step_seconds``,
``train_tokens_per_second`` and ``train_mfu`` in the port's
``global_metrics``.  ``fit`` fires the ``train.preempt`` fault site.

On a mesh (``Trainer(mesh=...)`` or ``mesh_config=``) every rank holds
its shards of the parameters (``shard_params``: whole over dp and sp,
cut over tp and ep as the rules say; ``gathered_params`` joins them),
takes its [B/dp, S/sp] block of the global batch (``shard_batch``; the
batch is replicated over tp and ep, the reference's ``P("dp", "sp")``)
and runs the model on it; the ring's or Ulysses' backward carries each
block's loss into the other ranks' K/V.  The gradients and the loss are
then summed over the batch group (dp x sp) in one all-reduce and divided
by its size: each block's loss is its own mean, so that is the mean over
the global token count, the reference's loss.  The leaves tp and ep
leave whole then agree on every rank.  Clipping takes the norm of the
whole global gradient: each cut leaf's squares are summed over the axes
that cut it, the whole leaves counted once.  ``zero1`` shards AdamW's
moments over dp along each local leaf's largest free axis that dp
divides (the reference's ``_zero1_sharding``; a leaf with none stays
replicated): each dp rank updates its slice and the slices are
all-gathered.  On one device, or without a mesh, the step is exactly the
one-device step.

On a pp mesh each rank holds its stage's blocks (in the layout of the
model's ``virtual_stages``) and the leaves replicated over pp whole.
Under ``pp_schedule="gpipe"`` the step is autograd over the model's
GPipe forward; under ``"1f1b"`` the model's ``pipeline_value_and_grad``
hands back the loss and the gradients (``make_pipeline_train_step``),
and accumulation is refused (the schedule already microbatches).  Either
way the loss and the replicated leaves' gradients leave the schedule the
same on every pp rank (summed over pp where one stage alone made them),
and the batch group's mean follows as on any mesh.

``Trainer(rules=...)`` lays the leaves out by a rule table of its own.
Mapping a logical axis to dp or sp (fsdp: ``"embed": "dp"``, or a tuple
``("dp", "sp")``) cuts those leaves over the data axes too, so a rank
holds only its slice of them, of their moments and of their EMA between
steps.  Once a step (before any accumulated microbatch, or the
schedule) each such leaf is all-gathered into a temporary leaf whole
over dp and sp, the step runs unchanged on those, and ``_reduce``
reduce-scatters their gradients back to the rank's slice; AdamW updates
the slices.  ZeRO-1 under fsdp raises at ``init``, as the reference's
duplicate ``dp`` does; a table that moves a weight axis raises there
too (``check_rules``).  Gathering a layer at a time, ahead of its use
(ZeRO-3 proper), is not done: the whole tree is gathered at once.

The state of a meshed trainer reads and loads whole, as the reference's
global arrays do: ``opt_state`` gives AdamW's ``count`` and moments as
the whole tree (ZeRO-1's dp slices joined along their axis, the tp, ep
and pp shards as ``gather_params`` joins the parameters, interleaved
stages back in layer order), and takes a whole tree, keeping this
rank's shards and dp slice; ``gathered_ema`` and ``load_gathered_state``
do the same for the EMA and the parameters.  Reading is a collective:
every rank calls it, in the same order.  So a checkpoint
(``train/checkpoint.py``) holds the one-device layout whatever the mesh
that wrote it, and resumes onto any other.
"""

from __future__ import annotations

import logging
import math
import time
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from ..api.workload import WorkloadInterrupted
from ..convert import tensor_from_numpy
from ..device import resolve_device
from ..ops.attention import describe_train_attention
from ..parallel.collectives import all_gather, all_reduce, reduce_scatter
from ..parallel.mesh import (
    AXES, DATA_AXES, axis_group, axis_groups, axis_rank, axis_size,
    batch_group, build_mesh, mesh_shape,
)
from ..parallel.sharding import (
    ParamRules, check_rules, cut_axes, entry_axes, gather_params,
    shard_params,
)
from ..utils.faults import global_faults
from ..utils.goodput import GoodputLedger
from ..utils.metrics import global_metrics
from ..utils.profiler import PhaseProfiler

log = logging.getLogger("k8s_gpu_tpu_torch.train")

# Peak dense bf16 FLOP/s by card (NVIDIA data sheets, without sparsity):
# the MFU denominator.  Names are matched by substring, most specific
# first; an unknown card or no card reads 0.0.
PEAK_BF16_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
)


def device_peak_flops() -> float:
    """Peak bf16 FLOP/s of CUDA device 0, or 0.0 for unknown kinds."""
    if not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(0)
    return next((peak for key, peak in PEAK_BF16_FLOPS if key in name), 0.0)


def model_flops_per_step(cfg, n_params: int, batch: int) -> float:
    """Analytic model FLOPs for one fwd+bwd step (PaLM appendix-B
    convention): 6 N per token for the matmuls + attention scores
    12 B H Dh S^2 L, halved for causality.  Remat recompute is not
    counted: MFU measures useful model FLOPs."""
    tokens = batch * cfg.max_seq
    matmul = 6.0 * n_params * tokens
    attn = (12.0 * batch * cfg.n_heads * cfg.d_head
            * cfg.max_seq ** 2 * cfg.n_layers / 2.0)
    return matmul + attn


def _check_kv_tp(cfg, mesh) -> None:
    """GQA x tensor parallelism: the K/V head axis shards over 'tp', so
    tp must divide kv_heads (the reference's config-level error)."""
    tp = axis_size(mesh, "tp")
    kh = getattr(cfg, "kv_heads", None)
    if tp > 1 and kh is not None and kh % tp != 0:
        raise ValueError(
            f"n_kv_heads={kh} must be a multiple of tp={tp} (the K/V head "
            "axis shards over 'tp'); lower tp or raise n_kv_heads"
        )


def zero1_dim(shape, spec, dp: int) -> int | None:
    """The axis ZeRO-1 cuts a leaf's moments along: the largest one that
    its spec leaves free (None) and ``dp`` divides, the first of equals;
    None when there is none (the reference's ``_zero1_sharding``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    best = None
    for i, (name, dim) in enumerate(zip(spec, shape)):
        if name is None and dim > 0 and dim % dp == 0:
            if best is None or dim > shape[best]:
                best = i
    return best


@dataclass(frozen=True)
class TrainConfig:
    """The reference's fields and defaults."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    b1: float = 0.9
    b2: float = 0.95
    # >1: strided microbatches per optimizer step (make_train_step).
    grad_accum_steps: int = 1
    # AdamW's moments sharded over dp (ZeRO-1): a no-op on one device.
    zero1: bool = False
    # After warmup: "constant" or "cosine" (to lr * min_lr_frac over
    # decay_steps).
    schedule: str = "constant"
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    # Polyak EMA of the params (0 disables), at Trainer.ema.
    ema_decay: float = 0.0


def make_schedule(tc: TrainConfig):
    """count -> learning rate, as ``optax.join_schedules`` of a linear
    warmup from 0 and a constant or cosine tail.  A warmup of 0 steps is
    optax's degenerate linear schedule: the rate stays 0."""
    lr, warm = tc.learning_rate, tc.warmup_steps
    if tc.schedule not in ("constant", "cosine"):
        raise ValueError(
            f"unknown schedule {tc.schedule!r}; expected constant|cosine")
    if tc.schedule == "cosine" and not tc.decay_steps > 0:
        raise ValueError("cosine schedule needs decay_steps > 0")

    def warmup(count):
        if warm <= 0:
            return 0.0
        return lr * min(max(count, 0), warm) / warm

    def schedule(count: int) -> float:
        if tc.schedule == "constant" or count < warm:
            return warmup(count)
        t = min(count - warm, tc.decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * t / tc.decay_steps))
        return lr * ((1 - tc.min_lr_frac) * decay + tc.min_lr_frac)

    return schedule


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree: dict, prefix: str = "") -> list[str]:
    """The "/"-joined key path of each tensor, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def tree_map(fn, tree: dict):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_like(tree: dict, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) nested as ``tree`` is."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


class AdamW:
    """The reference's ``make_optimizer``: optax
    ``chain(clip_by_global_norm, adamw(schedule, b1, b2, wd))`` on a list
    of f32 parameters, updated in place.

    ``zero``: ZeRO-1 over dp, ``(dims, dp group)`` with ``dims[i]`` the
    axis leaf i's moments are cut along (None: kept whole).  This rank
    then holds and updates its dp slice of each cut leaf and all-gathers
    the slices, the same elementwise update as without ``zero``.

    ``cut``: for each leaf, the process groups its shards are cut over
    (``axis_groups``: tp, ep x tp, dp and tp in turn, ...; empty for a
    whole leaf), so that the global norm sums a cut leaf's squares over
    them and a whole one once."""

    def __init__(self, tc: TrainConfig, params: list[torch.Tensor],
                 zero=None, cut=None):
        self.tc = tc
        self.schedule = make_schedule(tc)
        self.count = 0
        self.cut = cut
        self.dims, self.group = zero or ([None] * len(params), None)
        self.mu = [torch.zeros_like(self._mine(p, d))
                   for p, d in zip(params, self.dims)]
        self.nu = [torch.zeros_like(m) for m in self.mu]

    def _mine(self, t, dim):
        """This rank's dp slice of ``t`` along ``dim`` (a view), or ``t``."""
        if dim is None:
            return t
        n = torch.distributed.get_world_size(self.group)
        return t.chunk(n, dim)[torch.distributed.get_rank(self.group)]

    def _global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """optax's ``global_norm`` of the whole tree: each cut leaf's
        squares summed over its group, one all-reduce a group in the
        order the leaves first name them (the same on every rank)."""
        squares = [g.square().sum() for g in grads]
        if self.cut is None or not any(self.cut):
            return torch.sqrt(sum(squares))
        total = sum(s for s, c in zip(squares, self.cut) if not c)
        by_groups: dict = {}
        for s, c in zip(squares, self.cut):
            if c:
                by_groups.setdefault(c, []).append(s)
        for groups, part in by_groups.items():
            part = torch.stack(part).sum()
            for group in groups:
                all_reduce(part, group)
            total = total + part
        return torch.sqrt(total)

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]):
        tc = self.tc
        grads = [g.float() for g in grads]
        norm = self._global_norm(grads)
        clip = norm < tc.grad_clip
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - tc.b1 ** self.count
        c2 = 1 - tc.b2 ** self.count
        for full, g, m, v, dim in zip(params, grads, self.mu, self.nu,
                                      self.dims):
            p, g = self._mine(full, dim), self._mine(g, dim)
            g = torch.where(clip, g, g / norm * tc.grad_clip)
            m.mul_(tc.b1).add_(g, alpha=1 - tc.b1)
            v.mul_(tc.b2).add_(g.square(), alpha=1 - tc.b2)
            u = (m / c1) / ((v / c2).sqrt() + 1e-8)
            u.add_(p, alpha=tc.weight_decay)
            p.sub_(lr * u)
            if dim is not None:
                full.copy_(torch.cat(all_gather(p, self.group), dim))

    def state(self, params: dict) -> dict:
        """optax's ``ScaleByAdamState`` fields: the step ``count`` and the
        moments ``mu`` and ``nu`` as trees shaped like ``params``."""
        return {"count": self.count, "mu": tree_like(params, self.mu),
                "nu": tree_like(params, self.nu)}

    def load_state(self, state: dict) -> None:
        """Take ``state`` (moments shaped like the parameters); under
        ``zero`` this rank keeps its dp slice of each cut leaf."""
        self.count = int(state["count"])
        self.mu, self.nu = (
            [t if d is None else self._mine(t, d).clone()
             for t, d in zip(tree_leaves(state[k]), self.dims)]
            for k in ("mu", "nu"))

    def whole_moments(self) -> tuple[list, list]:
        """(mu, nu) at the parameters' shapes: the dp slices of each cut
        leaf all-gathered and joined along its axis (a collective of the
        dp group under ``zero``)."""
        def join(t, dim):
            return t if dim is None else torch.cat(
                all_gather(t, self.group), dim)

        return ([join(t, d) for t, d in zip(self.mu, self.dims)],
                [join(t, d) for t, d in zip(self.nu, self.dims)])


def _unflatten(grads: list, idx: list, flat: torch.Tensor) -> None:
    """Put ``flat``'s consecutive parts back at ``grads[i]`` for i in
    ``idx``, each at its old shape."""
    for i, f in zip(idx, flat.split([grads[i].numel() for i in idx])):
        grads[i] = f.view_as(grads[i])


def make_pipeline_train_step(model, optimizer: AdamW, mesh, reduce=None,
                             gather=None):
    """The train step of a model with ``pipeline_value_and_grad`` (1F1B):
    the gradients come from the schedule, whose forwards and backwards
    of different microbatches interleave in one loop, not from autograd
    of a forward.  ``reduce`` and ``gather`` as in ``make_train_step``."""

    def step(params, tokens, targets):
        work = params if gather is None else gather(params)
        loss, grads = model.pipeline_value_and_grad(work, tokens, targets,
                                                    mesh)
        grads = tree_leaves(grads)
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        optimizer.update(tree_leaves(params), grads)
        return loss

    return step


def make_train_step(loss_fn, optimizer: AdamW, accum: int = 1,
                    reduce=None, gather=None):
    """loss_fn(params, *batch) -> scalar.  Returns step(params, *batch) ->
    loss (a 0-d tensor), which updates the leaves of ``params`` in place.

    ``accum`` > 1 splits the batch into ``accum`` STRIDED microbatches
    (rows k, k + accum, ...: the reference's reshape-and-swap), sums their
    f32 gradients and applies one update from the mean: the same step as
    the full batch at 1/accum the activation memory.  ``reduce(loss,
    grads) -> (loss, grads)`` runs before the update (the mesh's
    all-reduce).  ``gather(params)``: the tree the loss differentiates,
    made once a step (fsdp's leaves joined over the data axes), whose
    gradients ``reduce`` brings back to the shapes of ``params``."""

    def grads_of(params, leaves, *batch):
        loss = loss_fn(params, *batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(params, *batch):
        work = params if gather is None else gather(params)
        leaves = tree_leaves(work)
        if accum == 1:
            loss, grads = grads_of(work, leaves, *batch)
        else:
            gsum, lsum = None, 0.0
            for k in range(accum):
                mb = tuple(b[k::accum] for b in batch)
                l, g = grads_of(work, leaves, *mb)
                g = [x.float() for x in g]
                gsum = g if gsum is None else [a + x for a, x in zip(gsum, g)]
                lsum = lsum + l
            grads = [g / accum for g in gsum]
            loss = lsum / accum
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        optimizer.update(tree_leaves(params), grads)
        return loss

    return step


class Trainer:
    """Drives the train step of a ``TransformerLM``-shaped model on this
    process's device: f32 master parameters at ``self.params`` (leaves
    with ``requires_grad``), AdamW state (``self.opt_state``), and the EMA
    shadow at ``self.ema``.  Runs on the card unless given
    ``device="cpu"``.

    ``mesh``: a ``parallel.mesh`` mesh over the initialized world, or
    ``mesh_config`` to build one (None on a world of one rank: the
    one-device step).  On a mesh that cuts the model's leaves (its ``logical_axes``: tp, ep
    and pp for the transformer and its LoRA view, tp for the CNN)
    ``self.params`` holds this rank's shards and ``gathered_params()``
    the whole tree.

    ``rules``: the ``ParamRules`` that lay the leaves out (the default
    table when None); a table may cut them over dp and sp too (fsdp,
    ``check_rules``).  ``batch_specs``: one spec a batch array (tuples of
    mesh axes, such as ``("dp",)``), or None to infer them; both stay
    public attributes, as the reference's, and ``batch_specs`` may be set
    after construction.

    ``peak_flops``: the MFU denominator (None reads the card's kind; 0.0,
    as on the CPU, keeps ``train_mfu`` at 0).  ``profiler``: the phase
    profiler of the step's phases (default: a fresh one over
    ``global_metrics``).  ``ledger``: an optional ``GoodputLedger``; None
    costs nothing."""

    def __init__(self, model, train_config: TrainConfig | None = None,
                 device="cuda", peak_flops: float | None = None,
                 profiler: PhaseProfiler | None = None,
                 ledger: GoodputLedger | None = None, mesh=None,
                 mesh_config=None, rules: ParamRules | None = None,
                 batch_specs: tuple | None = None):
        self.device = resolve_device(device)
        if getattr(model, "device", self.device) != self.device:
            raise ValueError(f"model on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.tc = train_config or TrainConfig()
        if mesh is None and mesh_config is not None:
            mesh = build_mesh(mesh_config, device_type=self.device.type)
        self.mesh = mesh
        if mesh is not None:
            _check_kv_tp(getattr(model, "cfg", None), mesh)
        self.rules = rules or ParamRules()
        # Batch layout: explicit specs, or inferred per array in
        # shard_batch (rows over dp, dim 1 over sp on an sp mesh).
        self.batch_specs = batch_specs
        self.peak_flops = peak_flops
        self.profiler = (profiler if profiler is not None
                         else PhaseProfiler(plane="train"))
        self.ledger = ledger
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        self._host = f"host{rank}"
        self._steps_done = 0
        self._n_params: int | None = None
        self._step_ewma_s: float | None = None
        self.params = None
        self.optimizer = None
        self.ema = None
        self._step = None
        # Each leaf's (dimension, mesh axis) cuts, and those over the
        # data axes (fsdp's), set by ``init``.
        self.leaf_cuts: list = []
        self.data_cuts: list = []

    def _seg(self, name: str):
        """The ledger's segment, or nothing when no ledger rides."""
        return (self.ledger.segment(name) if self.ledger is not None
                else nullcontext())

    @property
    def opt_state(self) -> dict | None:
        """AdamW's ``count``, ``mu`` and ``nu``, the moments keyed by
        parameter path as ``params`` is (what a checkpoint holds).  On a
        mesh the moments are the whole tree's, on every rank (a
        collective: every rank reads it)."""
        if self.optimizer is None:
            return None
        if self.mesh is None:
            return self.optimizer.state(self.params)
        mu, nu = self.optimizer.whole_moments()
        return {"count": self.optimizer.count,
                "mu": self._gather(tree_like(self.params, mu)),
                "nu": self._gather(tree_like(self.params, nu))}

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        """Load a whole state (a mesh's rank keeps its shards and its dp
        slice of the moments)."""
        self.optimizer.load_state({"count": state["count"],
                                   "mu": self._cut(state["mu"]),
                                   "nu": self._cut(state["nu"])})

    # -- setup -------------------------------------------------------------
    def init(self, seed: int = 0, params: dict | None = None) -> None:
        """Fresh f32 parameters from ``seed``, or a copy of ``params`` (a
        nested dict of tensors or numpy arrays, e.g. carried across from
        the JAX package) as f32 on the trainer's device."""
        with self._seg("init"):
            self._init(seed, params)

    def _init(self, seed: int, params: dict | None) -> None:
        if params is None:
            params = self.model.init(seed, dtype=torch.float32)

        def master(t):
            if not torch.is_tensor(t):
                t = tensor_from_numpy(t, self.device)
            return t.detach().to(self.device, torch.float32)

        params = tree_map(master, params)
        specs = self._specs()
        if specs is not None and self.mesh is not None:
            check_rules(self.rules, self.mesh, self.model.logical_axes())
            params = shard_params(params, self.model.logical_axes(),
                                  self.mesh, self.rules,
                                  virtual_stages=self._virtual_stages())
        self.params = tree_map(
            lambda t: t.contiguous().clone().requires_grad_(True), params)
        # Each leaf's cuts, (dimension, mesh axis) pairs in tree_leaves
        # order, and the groups the global norm sums its squares over.
        specs = specs or [()] * len(tree_leaves(self.params))
        self.leaf_cuts = [cut_axes(sp, self.mesh) for sp in specs]
        self.data_cuts = [[(d, a) for d, a in c if a in DATA_AXES]
                          for c in self.leaf_cuts]
        cut = [axis_groups(self.mesh, *(a for _, a in c))
               for c in self.leaf_cuts]
        self.optimizer = AdamW(self.tc, tree_leaves(self.params),
                               self._zero1(), cut)
        self.ema = (tree_map(lambda p: p.detach().clone(), self.params)
                    if self.tc.ema_decay > 0 else None)
        self._step = None

    def _specs(self) -> list | None:
        """Each leaf's spec under ``rules`` (the model's
        ``logical_axes``), in ``tree_leaves`` order; None for a model
        without logical axes."""
        if not hasattr(self.model, "logical_axes"):
            return None
        return [self.rules.spec(ax)
                for ax in tree_leaves(self.model.logical_axes())]

    def _virtual_stages(self) -> int:
        """The chunks of the blocks' layout on a pp mesh (the model's)."""
        return getattr(self.model, "virtual_stages", 1)

    def _zero1(self):
        """AdamW's ``zero`` argument: each local leaf's ZeRO-1 axis over
        dp, free meaning unnamed by the leaf's logical spec, or None
        without ``zero1`` or a dp axis.  A leaf whose spec already cuts
        it over dp and that ZeRO-1 would cut again raises, as the
        reference's ``DuplicateSpecError`` does at ``init``."""
        dp = axis_size(self.mesh, "dp")
        if not self.tc.zero1 or dp <= 1:
            return None
        leaves = tree_leaves(self.params)
        specs = self._specs() or [()] * len(leaves)
        dims = [zero1_dim(tuple(p.shape), spec, dp)
                for p, spec in zip(leaves, specs)]
        for path, p, spec, dim in zip(tree_paths(self.params), leaves, specs,
                                      dims):
            if dim is not None and any("dp" in entry_axes(e) for e in spec):
                moments = list(spec) + [None] * (p.ndim - len(spec))
                moments[dim] = "dp"
                raise ValueError(
                    f"zero1 on {path}: PartitionSpec{tuple(moments)} has "
                    f"duplicate entries for `dp` (the rules cut it over dp "
                    f"already); turn zero1 off under fsdp")
        return dims, self.mesh.get_group("dp")

    def n_params(self) -> int:
        """The whole model's parameter count: each shard's times the sizes
        of the axes that cut it."""
        return sum(p.numel() * math.prod(axis_size(self.mesh, a)
                                         for _, a in cuts)
                   for p, cuts in zip(tree_leaves(self.params),
                                      self.leaf_cuts))

    def _gather(self, tree: dict) -> dict:
        """A tree shaped like this rank's parameters joined into the
        whole (detached), on every rank."""
        if self.mesh is None or not hasattr(self.model, "logical_axes"):
            return tree_map(lambda p: p.detach(), tree)
        return gather_params(tree, self.model.logical_axes(), self.mesh,
                             self.rules,
                             virtual_stages=self._virtual_stages())

    def _cut(self, tree: dict) -> dict:
        """This rank's shards of a whole tree, f32 on the trainer's
        device (copies: nothing keeps the whole tree alive)."""
        if self.mesh is not None and hasattr(self.model, "logical_axes"):
            tree = shard_params(tree, self.model.logical_axes(), self.mesh,
                                self.rules,
                                virtual_stages=self._virtual_stages())
        return tree_map(lambda t: t.detach().to(
            self.device, torch.float32).contiguous().clone(), tree)

    def gathered_params(self) -> dict:
        """The whole parameter tree (detached), on every rank: this
        rank's shards joined with the others' over every axis that cuts
        them."""
        return self._gather(self.params)

    def gathered_ema(self) -> dict | None:
        """The whole EMA shadow (None without one), as
        ``gathered_params``."""
        return None if self.ema is None else self._gather(self.ema)

    def checkpoint_like(self) -> dict:
        """What a restore checks a checkpoint's parameter leaves against
        and maps them onto: the parameters themselves on one device; on
        a mesh, empty host tensors of the whole tree's shapes (no
        gather), which ``load_gathered_state`` then cuts."""
        if self.mesh is None:
            return self.params

        def whole(p, cuts):
            shape = list(p.shape)
            for dim, axis in cuts:
                shape[dim] *= axis_size(self.mesh, axis)
            return torch.empty(shape, dtype=torch.float32)

        return tree_like(self.params, [
            whole(p, c) for p, c in zip(tree_leaves(self.params),
                                        self.leaf_cuts)])

    def load_gathered_state(self, params: dict, opt_state: dict | None = None,
                            ema: dict | None = None) -> None:
        """Take whole trees (a checkpoint's): this rank keeps its shards
        of the parameters and of ``ema`` and its slice of
        ``opt_state``'s moments.  Without ``ema`` a trainer that keeps
        one seeds it from ``params``."""
        self.params = tree_map(lambda t: t.requires_grad_(True),
                               self._cut(params))
        if opt_state is not None:
            self.opt_state = opt_state
        if self.ema is not None:
            self.ema = (self._cut(ema) if ema is not None
                        else tree_map(lambda p: p.detach().clone(),
                                      self.params))

    def _check_batch_spec(self, spec: tuple, shape: tuple) -> bool:
        """Raise where the reference's ``device_put`` of an array of
        ``shape`` under ``spec`` raises (more entries than dimensions, a
        name that is no mesh axis, a dimension its axes do not divide);
        return whether the spec cuts the rows over dp."""
        if len(spec) > len(shape):
            raise ValueError(f"batch spec {spec} has more entries than "
                             f"the array {shape} has dimensions")
        for dim, entry in enumerate(spec):
            names = entry_axes(entry)
            for name in names:
                if name not in AXES:
                    raise ValueError(f"batch spec {spec} names {name!r}, "
                                     f"not an axis of the mesh {AXES}")
            n = math.prod(axis_size(self.mesh, a) for a in names)
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of the batch {shape} does not "
                                 f"divide over {names} of size {n}")
        return bool(spec) and "dp" in entry_axes(spec[0])

    def shard_batch(self, *batch):
        """This rank's block of each global array on the trainer's
        device: rows over dp and, for arrays of 2 or more dimensions on
        an sp mesh, dim 1 over sp (the reference's ``P("dp", "sp")``).
        ``batch_specs`` decide the placement and never the result, as in
        the reference: a spec is checked as its ``device_put`` checks
        it, then the array takes the layout the model needs, but for a
        spec that leaves the rows whole (``()``), whose rows every dp
        rank then takes (the batch group's mean is the same)."""
        specs = self.batch_specs
        if specs is not None and len(specs) != len(batch):
            raise ValueError(f"{len(specs)} batch specs for {len(batch)} "
                             "arrays")
        out = []
        for i, b in enumerate(batch):
            t = torch.as_tensor(b)
            rows = (True if specs is None
                    else self._check_batch_spec(tuple(specs[i]),
                                                tuple(t.shape)))
            for dim, axis in ((0, "dp"), (1, "sp")):
                n = axis_size(self.mesh, axis)
                if n == 1 or t.ndim <= dim or (dim == 0 and not rows):
                    continue
                if t.shape[dim] % n:
                    raise ValueError(
                        f"dim {dim} of the batch {tuple(t.shape)} does not "
                        f"divide over {axis}={n}")
                t = t.chunk(n, dim)[axis_rank(self.mesh, axis)]
            out.append(t.to(self.device))
        return tuple(out)

    def _loss(self, params, *batch):
        if self.mesh is not None:
            return self.model.loss(params, *batch, mesh=self.mesh)
        return self.model.loss(params, *batch)

    def _use_1f1b(self) -> bool:
        """Whether the step runs the model's 1F1B schedule: on a pp mesh
        under ``pp_schedule="1f1b"`` (gpipe for a model that names none);
        an unknown schedule raises, the reference's error."""
        if axis_size(self.mesh, "pp") <= 1:
            return False
        sched = getattr(getattr(self.model, "cfg", None), "pp_schedule",
                        "gpipe")
        if sched == "1f1b":
            return hasattr(self.model, "pipeline_value_and_grad")
        if sched == "gpipe":
            return False
        raise ValueError(
            f"unknown pp_schedule {sched!r}; expected '1f1b' or 'gpipe'")

    def _make_step(self):
        reduce = self._reduce if self.mesh is not None else None
        gather = self._whole_over_data if any(self.data_cuts) else None
        if self._use_1f1b():
            if self.tc.grad_accum_steps > 1:
                raise ValueError(
                    "grad_accum_steps composes with the dense/gpipe "
                    "paths; the 1f1b schedule already microbatches — "
                    "raise pp_microbatches instead")
            return make_pipeline_train_step(self.model, self.optimizer,
                                            self.mesh, reduce, gather)
        return make_train_step(self._loss, self.optimizer,
                               accum=self.tc.grad_accum_steps, reduce=reduce,
                               gather=gather)

    def _whole_over_data(self, params: dict) -> dict:
        """The tree a fsdp step differentiates: each leaf cut over a data
        axis all-gathered over it (minor cuts first) into a fresh leaf,
        whole over dp and sp and still cut over pp, ep and tp as the
        model expects; the other leaves as they are.  Made once a step
        (accumulated microbatches share it) and dropped after it."""
        leaves = []
        for p, cuts in zip(tree_leaves(params), self.data_cuts):
            if cuts:
                for dim, axis in reversed(cuts):
                    p = torch.cat(all_gather(p, self.mesh.get_group(axis)),
                                  dim)
                p.requires_grad_(True)
            leaves.append(p)
        return tree_like(params, leaves)

    def _reduce(self, loss, grads):
        """The mean of the loss and the gradients over the batch group
        (dp x sp, the ranks whose tokens differ); the ranks of a tp, ep
        or pp group already hold the same loss and their own shards'
        gradients.  The whole leaves' gradients and the loss go in one
        all-reduce.  A fsdp leaf's gradient (of the leaf made whole over
        its data axes) is reduce-scattered over those axes, major first,
        to this rank's slice, then all-reduced over the batch axes that
        leave it whole, one all-reduce for the leaves alike.  Empty
        ``grads``: the loss alone."""
        group = batch_group(self.mesh)
        if group is None:
            return loss, grads
        n = torch.distributed.get_world_size(group)
        grads = [g.float() for g in grads]
        data = self.data_cuts if grads else []
        whole = [i for i, c in enumerate(data) if not c]
        by_rest: dict = {}
        for i, cuts in enumerate(data):
            if not cuts:
                continue
            for dim, axis in cuts:
                grads[i] = reduce_scatter(grads[i],
                                          self.mesh.get_group(axis), dim)
            cut = {a for _, a in cuts}
            rest = axis_group(self.mesh,
                              *(a for a in DATA_AXES if a not in cut))
            by_rest.setdefault(rest, []).append(i)
        flat = torch.cat([grads[i].reshape(-1) for i in whole]
                         + [loss.float().reshape(1)])
        all_reduce(flat, group)
        loss = flat[-1] / n
        _unflatten(grads, whole, flat[:-1] / n)
        for rest, idx in by_rest.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            if rest is not None:
                all_reduce(flat, rest)
            _unflatten(grads, idx, flat / n)
        return loss, grads

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.tc.ema_decay
        for e, p in zip(tree_leaves(self.ema), tree_leaves(self.params)):
            e.mul_(d).add_(p, alpha=1 - d)

    # -- the step ----------------------------------------------------------
    def step(self, *batch, sync: bool = True):
        """One optimizer step.  ``sync=False`` returns the loss as a device
        tensor without waiting for the card, so a loop can queue steps and
        read one loss at its log boundaries (the step's time then measures
        the queueing).  The first step is the ledger's ``compile`` segment:
        on the card it pays for the kernels' first load and cuBLAS's
        heuristics."""
        with self._seg("compile" if self._step is None else "step"):
            return self._timed_step(*batch, sync=sync)

    def _timed_step(self, *batch, sync: bool):
        if self._step is None:
            self._step = self._make_step()
            cfg = getattr(self.model, "cfg", None)
            if cfg is not None and hasattr(cfg, "use_flash"):
                log.info("train step attention path: %s",
                         describe_train_attention(
                             cfg, axis_size(self.mesh, "sp") > 1))
        rows = len(batch[0]) if batch else 0
        with self.profiler.phase("shard_batch"):
            batch = self.shard_batch(*batch)
        t0 = time.perf_counter()
        with self.profiler.phase("step_dispatch"):
            loss = self._step(self.params, *batch)
            if self.ema is not None:
                self._update_ema()
        if sync:
            with self.profiler.phase("loss_sync"):
                loss = float(loss)
        dt = time.perf_counter() - t0
        global_metrics.observe("train_step_seconds", dt)
        global_metrics.set_gauge("train_last_step_seconds", dt)
        if dt > 0.0 and batch:
            global_metrics.set_gauge("train_tokens_per_second",
                                     float(batch[0].numel()) / dt)
        self._update_mfu(dt, rows)
        self.profiler.export_shares()
        self._steps_done += 1
        if self.ledger is not None:
            self.ledger.heartbeat(self._host, self._steps_done, dt)
        return loss

    def _update_mfu(self, dt: float, rows: int) -> None:
        """``train_mfu``: the model's analytic FLOPs a step (``rows``: the
        global batch's) over an EWMA of the step time, against
        ``peak_flops``.  The first step (kernel loads) seeds nothing; a
        model without a transformer-shaped config publishes no gauge."""
        cfg = getattr(self.model, "cfg", None)
        if (dt <= 0.0 or not rows or cfg is None
                or not all(hasattr(cfg, a) for a in
                           ("max_seq", "n_heads", "d_head", "n_layers"))):
            return
        if self._n_params is None:
            self._n_params = self.n_params()
            return
        # A rank's share of the global step's FLOPs (the mesh spans the
        # world).
        shape = mesh_shape(self.mesh)
        flops = model_flops_per_step(cfg, self._n_params, rows
                                     ) / math.prod(shape.values())
        self._step_ewma_s = (dt if self._step_ewma_s is None
                             else 0.2 * dt + 0.8 * self._step_ewma_s)
        peak = (self.peak_flops if self.peak_flops is not None
                else device_peak_flops())
        mfu = flops / self._step_ewma_s / peak if peak > 0.0 else 0.0
        global_metrics.set_gauge("train_mfu", mfu)

    def step_many(self, xs, ys) -> float:
        """``xs.shape[0]`` chained optimizer steps over stacked [n, B, S]
        inputs and targets; returns the final loss."""
        loss = None
        for x, y in zip(xs, ys):
            loss = self.step(x, y, sync=False)
        return float(loss)

    def fit(self, data_iter, steps: int, log_every: int = 10) -> list[float]:
        """Run ``steps`` optimizer steps and return ONE loss per step.  The
        loop waits for the card only at log boundaries; the other losses
        stay device tensors until the single conversion at the end.

        Each iteration fires the ``train.preempt`` fault site first: an
        armed plan interrupts the loop as a slice preemption would, and the
        ledger records the incident and opens ``preempted`` (the resume's
        checkpoint restore closes it)."""
        losses = []
        for i in range(steps):
            try:
                global_faults.fire("train.preempt",
                                   error_type=WorkloadInterrupted)
            except WorkloadInterrupted as e:
                if self.ledger is not None:
                    self.ledger.incident("preemption", detail=str(e))
                    self.ledger.begin("preempted")
                raise
            with self._seg("data_wait"):
                batch = next(data_iter)
            at_log = i % log_every == 0 or i == steps - 1
            loss = self.step(*batch, sync=at_log)
            losses.append(loss)
            if at_log:
                log.info("step %d loss %.4f", i, float(loss))
        return [float(x) for x in losses]
