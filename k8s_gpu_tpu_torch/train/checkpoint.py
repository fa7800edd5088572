"""Checkpoint and resume: a torch-native ``CheckpointManager`` with the
interface of ``k8s_gpu_tpu/train/checkpoint.py`` (which wraps Orbax, not
available to the port; a JAX checkpoint is not read here, and parameters
cross between the packages through servable bundles).

Layout: one directory per step under ``directory``, named by the step,
holding ``params.pt``, ``opt_state.pt`` and, when the run keeps an EMA,
``ema.pt``, each a ``torch.save`` of tensors keyed by parameter path
(``"blocks/wq"``), never by list order.  ``opt_state`` is AdamW's
``count`` with ``mu`` and ``nu``: without the count a resume would start
the warmup schedule again.  A step is written under a temporary name,
synced, and renamed when complete, so a crash mid-save never becomes
``latest_step``; ``max_to_keep`` keeps the newest steps.  ``restore``
maps every tensor onto the device (and type) of the trees it is given.

Telemetry under the reference's names: ``train_checkpoint_seconds{op}``,
``train_checkpoint_bytes`` and ``train_checkpoint_failures_total{op}``,
timed on an injected clock.

A meshed trainer saves the same layout, with global shapes: every rank
gathers the whole trees (``Trainer.gathered_params``, ``opt_state``,
``gathered_ema``), rank 0 of the world writes them, and every rank
waits for it (``distributed=True``).  ``latest_step`` is rank 0's, given
to every rank; ``restore`` reads the whole leaves on every rank and the
trainer cuts them onto its own layout (``Trainer.load_gathered_state``).
So a checkpoint resumes onto any mesh, one device included, whatever
wrote it, as the reference's restore onto the trainer's shardings does.
One writer suits a model whose whole state one host holds; a file of
shards a rank, in Orbax's style, waits for a model that outgrows it.
"""

from __future__ import annotations

import logging
import os
import shutil
from contextlib import nullcontext
from pathlib import Path

import torch
import torch.distributed as dist

from ..utils.clock import Clock, RealClock
from ..utils.metrics import MetricsRegistry, global_metrics

log = logging.getLogger("k8s_gpu_tpu_torch.train.checkpoint")


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree.detach()}


def _onto(flat: dict, like, what: str, prefix: str = ""):
    """The loaded ``flat`` leaves nested as ``like`` is, each with its
    like leaf's shape check, type and ``requires_grad``."""
    if isinstance(like, dict):
        return {k: _onto(flat, v, what, f"{prefix}{k}/")
                for k, v in like.items()}
    path = prefix.rstrip("/")
    if path not in flat:
        raise KeyError(f"checkpoint {what} has no leaf {path!r}")
    t = flat[path]
    if t.shape != like.shape:
        raise ValueError(f"checkpoint {what} leaf {path!r}: shape "
                         f"{tuple(t.shape)}, expected {tuple(like.shape)}")
    return t.to(like.device, like.dtype).requires_grad_(like.requires_grad)


def _device_of(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree.device


def _write(obj, path: Path) -> None:
    with open(path, "wb") as fh:
        torch.save(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())


class CheckpointManager:
    """Step directories with retention and telemetry: every save and
    restore lands in ``train_checkpoint_seconds{op}`` (and the failure
    counter when it raises), the step's size in
    ``train_checkpoint_bytes``.

    ``distributed``: every rank of the initialized world holds a manager
    over the same directory (a meshed trainer's): rank 0 writes, every
    rank waits for the write and learns its outcome, and
    ``latest_step`` is rank 0's.  Each call is then a collective."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 clock: Clock | None = None,
                 registry: MetricsRegistry | None = None,
                 distributed: bool = False):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.clock = clock or RealClock()
        self.registry = registry if registry is not None else global_metrics
        self.distributed = distributed and dist.is_initialized()
        self.writer = not self.distributed or dist.get_rank() == 0

    def _settle(self, error: Exception | None) -> None:
        """Raise ``error``; when ``distributed``, every rank first learns
        every rank's outcome, so all raise if any failed."""
        if self.distributed:
            errors = [None] * dist.get_world_size()
            dist.all_gather_object(errors, None if error is None
                                   else f"{type(error).__name__}: {error}")
            failed = [(r, e) for r, e in enumerate(errors) if e is not None]
            if failed and error is None:
                raise RuntimeError(f"checkpoint failed on rank "
                                   f"{failed[0][0]}: {failed[0][1]}")
        if error is not None:
            raise error

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _step_bytes(self, step: int) -> int:
        root = self._step_dir(step)
        if not root.exists():
            return 0
        return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())

    def all_steps(self) -> list[int]:
        """Complete steps, oldest first (a save in flight is not one)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def latest_step(self) -> int | None:
        """The newest complete step (rank 0's view, on every rank, when
        ``distributed``)."""
        steps = self.all_steps() if self.writer else None
        latest = steps[-1] if steps else None
        if self.distributed:
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        return latest

    def _save(self, step: int, params, opt_state, ema) -> None:
        tmp = self.directory / f".tmp-{int(step)}-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _write(_flatten(params), tmp / "params.pt")
        _write({"count": int(opt_state["count"]),
                "mu": _flatten(opt_state["mu"]),
                "nu": _flatten(opt_state["nu"])}, tmp / "opt_state.pt")
        if ema is not None:
            _write(_flatten(ema), tmp / "ema.pt")
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def save(self, step: int, params, opt_state, ema=None) -> None:
        """Write a step's whole trees (only rank 0's are written when
        ``distributed``; every rank waits for the write)."""
        t0 = self.clock.now()
        try:
            error = None
            try:
                if self.writer:
                    self._save(step, params, opt_state, ema)
            except Exception as e:
                error = e
            self._settle(error)
        except Exception:
            self.registry.inc("train_checkpoint_failures_total", op="save")
            raise
        self.registry.observe("train_checkpoint_seconds",
                              self.clock.now() - t0, op="save")
        b = self._step_bytes(step)
        if b:
            self.registry.set_gauge("train_checkpoint_bytes", float(b))

    def _load(self, step: int, name: str, device):
        return torch.load(self._step_dir(step) / name, map_location=device,
                          weights_only=True)

    def restore(self, params_like, opt_state_like, step: int | None = None,
                ema_like=None):
        """Restore onto the structure, devices and types of the ``*_like``
        trees (a freshly initialised trainer's state; on a mesh its
        ``checkpoint_like``).  Returns (params, opt_state, step), or with
        ``ema_like`` (params, opt_state, ema, step), ema None when the
        checkpoint has none (the caller then seeds it from the restored
        params, not from the fresh init).  When ``distributed`` every
        rank reads the step rank 0 names, and learns whether any rank
        failed."""
        step = self.latest_step() if step is None else int(step)
        if step is None or not self._step_dir(step).is_dir():
            raise FileNotFoundError(
                f"no checkpoint {'' if step is None else step} under "
                f"{self.directory}")
        want_ema = ema_like is not None and self._has_ema(step)
        device = _device_of(params_like)
        t0 = self.clock.now()
        try:
            error = None
            try:
                params = _onto(self._load(step, "params.pt", device),
                               params_like, "params")
                raw = self._load(step, "opt_state.pt", device)
                opt_state = {
                    "count": int(raw["count"]),
                    "mu": _onto(raw["mu"], opt_state_like["mu"], "mu"),
                    "nu": _onto(raw["nu"], opt_state_like["nu"], "nu"),
                }
                ema = (_onto(self._load(step, "ema.pt", device), ema_like,
                             "ema") if want_ema else None)
            except Exception as e:
                error = e
            self._settle(error)
        except Exception:
            self.registry.inc("train_checkpoint_failures_total",
                              op="restore")
            raise
        self.registry.observe("train_checkpoint_seconds",
                              self.clock.now() - t0, op="restore")
        b = self._step_bytes(step)
        if b:
            self.registry.set_gauge("train_checkpoint_bytes", float(b))
        if ema_like is not None:
            return params, opt_state, ema, step
        return params, opt_state, step

    def _has_ema(self, step: int) -> bool:
        return (self._step_dir(step) / "ema.pt").exists()

    def export_to_assets(self, store, space: str, asset_id: str,
                         step: int | None = None):
        """A step's directory into an asset store (the reference's
        ``AssetStore``: ``import_path``) as a versioned model asset."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("nothing to export")
        return store.import_path(space, "model", asset_id,
                                 self._step_dir(step))

    def close(self) -> None:
        """Nothing outlives a call (saves are synchronous)."""


def attach_to_trainer(trainer, directory: str | Path, max_to_keep: int = 3,
                      clock: Clock | None = None,
                      registry: MetricsRegistry | None = None):
    """(ckpt, save(step), resume() -> step) bound to a ``Trainer``'s
    params, optimizer state and EMA.  With a goodput ledger on the
    trainer, every save and restore is its ``checkpoint_save`` /
    ``checkpoint_restore`` segment.  A meshed trainer's save and resume
    are collectives: every rank calls them (module docstring)."""
    meshed = getattr(trainer, "mesh", None) is not None
    ckpt = CheckpointManager(directory, max_to_keep=max_to_keep, clock=clock,
                             registry=registry, distributed=meshed)

    def _seg(name: str):
        ledger = getattr(trainer, "ledger", None)
        return ledger.segment(name) if ledger is not None else nullcontext()

    def save(step: int) -> None:
        with _seg("checkpoint_save"):
            ckpt.save(step, trainer.gathered_params(), trainer.opt_state,
                      ema=trainer.gathered_ema())

    def _resume() -> int:
        like = trainer.checkpoint_like()
        opt_like = {"count": 0, "mu": like, "nu": like}
        if trainer.ema is not None:
            params, opt_state, ema, step = ckpt.restore(
                like, opt_like, ema_like=like)
        else:
            (params, opt_state, step), ema = ckpt.restore(
                like, opt_like), None
        # A checkpoint without an EMA seeds the shadow from the restored
        # params, not from the fresh init's (``load_gathered_state``).
        trainer.load_gathered_state(params, opt_state, ema)
        return step

    def resume() -> int:
        with _seg("checkpoint_restore"):
            return _resume()

    return ckpt, save, resume
