"""Training runner: the port of ``k8s_gpu_tpu/train/runner.py`` for one
device.

The reference jits one sharded step (optax clip -> AdamW with a warmup
schedule) over a mesh.  Here the step runs eagerly on one card: the loss
and its gradients by autograd (flash attention in the CUDA kernels when
the model's ``use_flash``), then the same update optax applies, written
out in torch on f32 master parameters:

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

Not ported yet (ROADMAP.md): the mesh and ``zero1`` over dp (``zero1`` is
a no-op on one device, as in the reference) and the pipeline schedules.
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
    # Optimizer state sharded over dp: a no-op on one device.
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
    of f32 parameters, updated in place."""

    def __init__(self, tc: TrainConfig, params: list[torch.Tensor]):
        self.tc = tc
        self.schedule = make_schedule(tc)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]):
        tc = self.tc
        grads = [g.float() for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = norm < tc.grad_clip
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - tc.b1 ** self.count
        c2 = 1 - tc.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            g = torch.where(clip, g, g / norm * tc.grad_clip)
            m.mul_(tc.b1).add_(g, alpha=1 - tc.b1)
            v.mul_(tc.b2).add_(g.square(), alpha=1 - tc.b2)
            u = (m / c1) / ((v / c2).sqrt() + 1e-8)
            u.add_(p, alpha=tc.weight_decay)
            p.sub_(lr * u)

    def state(self, params: dict) -> dict:
        """optax's ``ScaleByAdamState`` fields: the step ``count`` and the
        moments ``mu`` and ``nu`` as trees shaped like ``params``."""
        return {"count": self.count, "mu": tree_like(params, self.mu),
                "nu": tree_like(params, self.nu)}

    def load_state(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu = tree_leaves(state["mu"])
        self.nu = tree_leaves(state["nu"])


def make_train_step(loss_fn, optimizer: AdamW, accum: int = 1):
    """loss_fn(params, *batch) -> scalar.  Returns step(params, *batch) ->
    loss (a 0-d tensor), which updates the leaves of ``params`` in place.

    ``accum`` > 1 splits the batch into ``accum`` STRIDED microbatches
    (rows k, k + accum, ...: the reference's reshape-and-swap), sums their
    f32 gradients and applies one update from the mean: the same step as
    the full batch at 1/accum the activation memory."""

    def grads_of(params, leaves, *batch):
        loss = loss_fn(params, *batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(params, *batch):
        leaves = tree_leaves(params)
        if accum == 1:
            loss, grads = grads_of(params, leaves, *batch)
        else:
            gsum, lsum = None, 0.0
            for k in range(accum):
                mb = tuple(b[k::accum] for b in batch)
                l, g = grads_of(params, leaves, *mb)
                g = [x.float() for x in g]
                gsum = g if gsum is None else [a + x for a, x in zip(gsum, g)]
                lsum = lsum + l
            grads = [g / accum for g in gsum]
            loss = lsum / accum
        optimizer.update(leaves, grads)
        return loss

    return step


class Trainer:
    """Drives the train step of a ``TransformerLM``-shaped model on one
    device: f32 master parameters at ``self.params`` (leaves with
    ``requires_grad``), AdamW state (``self.opt_state``), and the EMA
    shadow at ``self.ema``.  Runs on the card unless given
    ``device="cpu"``.

    ``peak_flops``: the MFU denominator (None reads the card's kind; 0.0,
    as on the CPU, keeps ``train_mfu`` at 0).  ``profiler``: the phase
    profiler of the step's phases (default: a fresh one over
    ``global_metrics``).  ``ledger``: an optional ``GoodputLedger``; None
    costs nothing."""

    def __init__(self, model, train_config: TrainConfig | None = None,
                 device="cuda", peak_flops: float | None = None,
                 profiler: PhaseProfiler | None = None,
                 ledger: GoodputLedger | None = None):
        self.device = resolve_device(device)
        if getattr(model, "device", self.device) != self.device:
            raise ValueError(f"model on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.tc = train_config or TrainConfig()
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

    def _seg(self, name: str):
        """The ledger's segment, or nothing when no ledger rides."""
        return (self.ledger.segment(name) if self.ledger is not None
                else nullcontext())

    @property
    def opt_state(self) -> dict | None:
        """AdamW's ``count``, ``mu`` and ``nu``, the moments keyed by
        parameter path as ``params`` is (what a checkpoint holds)."""
        if self.optimizer is None:
            return None
        return self.optimizer.state(self.params)

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        self.optimizer.load_state(state)

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
            return (t.detach().to(self.device, torch.float32).clone()
                    .requires_grad_(True))

        self.params = tree_map(master, params)
        self.optimizer = AdamW(self.tc, tree_leaves(self.params))
        self.ema = (tree_map(lambda p: p.detach().clone(), self.params)
                    if self.tc.ema_decay > 0 else None)
        self._step = None

    def _batch(self, batch):
        return tuple(torch.as_tensor(b).to(self.device) for b in batch)

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
            self._step = make_train_step(self.model.loss, self.optimizer,
                                         accum=self.tc.grad_accum_steps)
            cfg = getattr(self.model, "cfg", None)
            if cfg is not None and hasattr(cfg, "use_flash"):
                log.info("train step attention path: %s",
                         describe_train_attention(cfg))
        with self.profiler.phase("shard_batch"):
            batch = self._batch(batch)
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
        self._update_mfu(dt, batch)
        self.profiler.export_shares()
        self._steps_done += 1
        if self.ledger is not None:
            self.ledger.heartbeat(self._host, self._steps_done, dt)
        return loss

    def _update_mfu(self, dt: float, batch: tuple) -> None:
        """``train_mfu``: the model's analytic FLOPs a step over an EWMA of
        the step time, against ``peak_flops``.  The first step (kernel
        loads) seeds nothing; a model without a transformer-shaped config
        publishes no gauge."""
        cfg = getattr(self.model, "cfg", None)
        if (dt <= 0.0 or not batch or cfg is None
                or not all(hasattr(cfg, a) for a in
                           ("max_seq", "n_heads", "d_head", "n_layers"))):
            return
        if self._n_params is None:
            self._n_params = sum(p.numel() for p in tree_leaves(self.params))
            return
        flops = model_flops_per_step(cfg, self._n_params,
                                     int(batch[0].shape[0]))
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
