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

A meshed trainer (``distributed=True``) saves shard-wise, as Orbax
writes each process's shards: every rank writes the blocks of its
parameters, AdamW moments (ZeRO-1's slice where there is one) and EMA
that it holds between steps (``Trainer.shard_state``) into
``rank<r>.pt``, keyed ``"<kind>/<path>"`` (``"mu/blocks/wq"``).  A block
that several ranks hold alike (a leaf whole over dp, one tp shard on
every dp rank) is written once, by the lowest of them, so the step's
files hold one copy of the state.  Each rank writes and syncs its file
in the step's temporary directory; after a barrier rank 0 writes
``manifest.json`` and renames the directory.  The manifest holds the
mesh's axis sizes, the rule table, the virtual stages, each leaf's whole
shape and dtype, AdamW's ``count``, and each file's blocks as index runs
per dimension (``sharding.block_ranges``: an interleaved stages cut
holds several runs of layers).  Only small objects cross between ranks:
the step, the outcomes of each phase, the blocks' index runs.  No
parameter, moment or EMA byte does, and no rank holds more on its
device than it holds at rest.

One reader (``_Reader``) serves every restore, from either layout (a
step in the one-device layout is three files of whole blocks).
``restore_shards`` fills a trainer's own blocks in place: each rank
reads, from the files that hold them, only the index runs its layout
needs (``torch.load(mmap=True)``), whatever mesh, rule table or ZeRO-1
wrote them, and onto one device it fills the whole trees.  ``restore``
gives whole trees onto the structure of the trees it is given.
"""

from __future__ import annotations

import itertools
import json
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

MANIFEST = "manifest.json"


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree.detach()}


def _assembled(reader: "_Reader", kind: str, like, prefix: str = ""):
    """Whole leaves of ``kind`` read from a shard-wise step, nested as
    ``like`` is, each on its like leaf's device and type."""
    if isinstance(like, dict):
        return {k: _assembled(reader, kind, v, f"{prefix}{k}/")
                for k, v in like.items()}
    t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    reader.fill(f"{kind}/{prefix.rstrip('/')}", t,
                [[(0, n)] for n in like.shape], tuple(like.shape))
    return t.requires_grad_(like.requires_grad)


def _write(obj, path: Path) -> None:
    with open(path, "wb") as fh:
        torch.save(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host in a storage of its own (``torch.save`` writes a
    view's whole storage)."""
    t = t.detach()
    if t.is_cuda:
        return t.cpu()
    whole = t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if whole and t.is_contiguous() else t.clone()


def _overlaps(dst: list, src: list) -> list:
    """(offset in the destination, offset in the source, length) of each
    run of indices two blocks' runs along one dimension share."""
    out, dpos = [], 0
    for a, b in dst:
        spos = 0
        for c, d in src:
            lo, hi = max(a, c), min(b, d)
            if lo < hi:
                out.append((dpos + lo - a, spos + lo - c, hi - lo))
            spos += d - c
        dpos += b - a
    return out


class _Reader:
    """The blocks of one step, in either layout: ``fill`` copies the
    indices a destination block holds out of the blocks that hold them,
    opening a file (memory-mapped) only when one of its blocks is
    needed."""

    def __init__(self, root: Path):
        self.root, self.files = root, {}
        self.index: dict = {}
        self.shapes: dict = {}
        manifest = root / MANIFEST
        if manifest.exists():
            m = json.loads(manifest.read_text())
            self.count = int(m["count"])
            self.shapes = {f"{kind}/{path}": tuple(meta["shape"])
                           for kind, leaves in m["leaves"].items()
                           for path, meta in leaves.items()}
            for name, blocks in m["files"].items():
                for key, ranges in blocks.items():
                    self.index.setdefault(key, []).append((name, ranges))
            return
        opt = self._open("opt_state.pt")
        self.count = int(opt["count"])
        trees = {"params": self._open("params.pt"), "mu": opt["mu"],
                 "nu": opt["nu"]}
        if (root / "ema.pt").exists():
            trees["ema"] = self._open("ema.pt")
        for kind, flat in trees.items():
            for path, t in flat.items():
                key = f"{kind}/{path}"
                self.shapes[key] = tuple(t.shape)
                self.index[key] = [(t, [[(0, n)] for n in t.shape])]

    def _open(self, name: str):
        if name not in self.files:
            self.files[name] = torch.load(self.root / name,
                                          map_location="cpu", mmap=True,
                                          weights_only=True)
        return self.files[name]

    def has(self, kind: str) -> bool:
        return any(k.startswith(f"{kind}/") for k in self.shapes)

    @torch.no_grad()
    def fill(self, key: str, dst: torch.Tensor, ranges: list,
             shape: tuple) -> None:
        """Copy the whole leaf ``key``'s indices ``ranges`` (a block of a
        leaf of ``shape``) into ``dst``."""
        if key not in self.shapes:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        if self.shapes[key] != tuple(shape):
            raise ValueError(f"checkpoint leaf {key!r}: shape "
                             f"{self.shapes[key]}, expected {tuple(shape)}")
        done = 0
        for src, held in self.index[key]:
            runs = [_overlaps(d, s) for d, s in zip(ranges, held)]
            if not all(runs):
                continue
            if isinstance(src, str):
                src = self._open(src)[key]
            for pieces in itertools.product(*runs):
                d, s = dst, src
                for dim, (at, frm, n) in enumerate(pieces):
                    d, s = d.narrow(dim, at, n), s.narrow(dim, frm, n)
                d.copy_(s)
                done += d.numel()
        if done != dst.numel():
            raise ValueError(f"checkpoint leaf {key!r}: its blocks hold "
                             f"{done} of the {dst.numel()} elements asked")


class CheckpointManager:
    """Step directories with retention and telemetry: every save and
    restore lands in ``train_checkpoint_seconds{op}`` (and the failure
    counter when it raises), the step's size in
    ``train_checkpoint_bytes``.

    ``distributed``: every rank of the initialized world holds a manager
    over the same directory (a meshed trainer's): ``save_shards`` has
    every rank write its blocks (``save``, the one-device writer, then
    refuses); every rank learns every phase's outcome, and
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
        self.rank = dist.get_rank() if self.distributed else 0
        self.writer = self.rank == 0

    def _settle(self, error: Exception | None, payload=None) -> list:
        """Raise ``error``; when ``distributed``, every rank first learns
        every rank's outcome (a barrier), so all raise if any failed.
        Returns every rank's small ``payload``, by rank."""
        if not self.distributed:
            if error is not None:
                raise error
            return [payload]
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (None if error is None else
                                     f"{type(error).__name__}: {error}",
                                     payload))
        failed = [(r, e) for r, (e, _) in enumerate(got) if e is not None]
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"checkpoint failed on rank "
                               f"{failed[0][0]}: {failed[0][1]}")
        return [p for _, p in got]

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
        self._commit(tmp, step)

    def _commit(self, tmp: Path, step: int) -> None:
        """Rename a complete step's directory into place; keep the
        newest ``max_to_keep``."""
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _timed(self, op: str, fn, step: int):
        """``fn()`` under the checkpoint telemetry of ``op``."""
        t0 = self.clock.now()
        try:
            out = fn()
        except Exception:
            self.registry.inc("train_checkpoint_failures_total", op=op)
            raise
        self.registry.observe("train_checkpoint_seconds",
                              self.clock.now() - t0, op=op)
        b = self._step_bytes(step)
        if b:
            self.registry.set_gauge("train_checkpoint_bytes", float(b))
        return out

    def save_shards(self, step: int, state: dict) -> None:
        """Write a step shard-wise (module docstring): ``state`` is this
        rank's ``Trainer.shard_state()``.  Every rank calls it."""
        self._timed("save", lambda: self._save_shards(int(step), state),
                    step)

    def _save_shards(self, step: int, state: dict) -> None:
        tmp = self.directory / f".tmp-{step}"
        blocks = state["blocks"]
        held = {f"{kind}/{path}": ranges
                for kind, leaves in blocks.items()
                for path, (_, ranges, _) in leaves.items()}
        error = None
        try:
            if self.writer:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir()
        except Exception as e:
            error = e
        try:
            every = self._settle(error, held)
            # Each block is written by the lowest rank that holds it.
            first = {}
            for r, ranks_held in enumerate(every):
                for key, ranges in ranks_held.items():
                    first.setdefault((key, repr(ranges)), r)
            files = {}
            for r, ranks_held in enumerate(every):
                mine = {k: v for k, v in ranks_held.items()
                        if first[(k, repr(v))] == r}
                if mine:
                    files[f"rank{r}.pt"] = mine
            error = None
            try:
                name = f"rank{self.rank}.pt"
                if name in files:
                    _write({key: _host_copy(blocks[key.split("/", 1)[0]][
                        key.split("/", 1)[1]][0]) for key in files[name]},
                        tmp / name)
            except Exception as e:
                error = e
            self._settle(error)
            error = None
            try:
                if self.writer:
                    manifest = {
                        "step": step, "count": int(state["count"]),
                        **state["layout"],
                        "leaves": {kind: {path: {
                            "shape": list(shape),
                            "dtype": str(t.dtype).replace("torch.", "")}
                            for path, (t, _, shape) in leaves.items()}
                            for kind, leaves in blocks.items()},
                        "files": files}
                    with open(tmp / MANIFEST, "w") as fh:
                        json.dump(manifest, fh)
                        fh.flush()
                        os.fsync(fh.fileno())
                    self._commit(tmp, step)
            except Exception as e:
                error = e
            self._settle(error)
        except Exception:
            if self.writer:
                shutil.rmtree(tmp, ignore_errors=True)
            raise

    def restore_shards(self, blocks: dict, step: int | None = None):
        """Fill ``blocks`` (a ``Trainer.shard_state()``'s, ``{kind: {path:
        (tensor, ranges, whole shape)}}``) in place from ``step`` (the
        latest when None), in either layout.  Returns (step, AdamW's
        count, whether the step held an EMA); an ``ema`` the step lacks
        is left as it is.  When ``distributed`` every rank reads the
        step rank 0 names and learns whether any rank failed."""
        step = self.latest_step() if step is None else int(step)
        if step is None or not self._step_dir(step).is_dir():
            raise FileNotFoundError(
                f"no checkpoint {'' if step is None else step} under "
                f"{self.directory}")

        def fill():
            error, out = None, None
            try:
                reader = _Reader(self._step_dir(step))
                for kind, leaves in blocks.items():
                    if kind == "ema" and not reader.has("ema"):
                        continue
                    for path, (t, ranges, shape) in leaves.items():
                        reader.fill(f"{kind}/{path}", t, ranges, shape)
                out = (step, reader.count, reader.has("ema"))
            except Exception as e:
                error = e
            self._settle(error)
            return out

        return self._timed("restore", fill, step)

    def save(self, step: int, params, opt_state, ema=None) -> None:
        """Write a step's whole trees in the one-device layout (a meshed
        trainer's steps are written by ``save_shards``)."""
        if self.distributed:
            raise ValueError("a meshed step is written by save_shards, "
                             "every rank its own blocks")
        self._timed("save", lambda: self._save(step, params, opt_state, ema),
                    step)

    def restore(self, params_like, opt_state_like, step: int | None = None,
                ema_like=None):
        """Restore whole trees onto the structure, devices and types of
        the ``*_like`` trees (a freshly initialised trainer's state; on a
        mesh its ``checkpoint_like``), from either layout.  Returns
        (params, opt_state, step), or with ``ema_like`` (params,
        opt_state, ema, step), ema None when the checkpoint has none
        (the caller then seeds it from the restored params, not from the
        fresh init).  When ``distributed`` every rank reads the step
        rank 0 names, and learns whether any rank failed."""
        step = self.latest_step() if step is None else int(step)
        if step is None or not self._step_dir(step).is_dir():
            raise FileNotFoundError(
                f"no checkpoint {'' if step is None else step} under "
                f"{self.directory}")

        def read():
            error, out = None, None
            try:
                reader = _Reader(self._step_dir(step))
                out = (_assembled(reader, "params", params_like),
                       {"count": reader.count,
                        "mu": _assembled(reader, "mu", opt_state_like["mu"]),
                        "nu": _assembled(reader, "nu", opt_state_like["nu"])},
                       _assembled(reader, "ema", ema_like)
                       if ema_like is not None and reader.has("ema")
                       else None)
            except Exception as e:
                error = e
            self._settle(error)
            return out

        params, opt_state, ema = self._timed("restore", read, step)
        if ema_like is not None:
            return params, opt_state, ema, step
        return params, opt_state, step

    def _has_ema(self, step: int) -> bool:
        return _Reader(self._step_dir(step)).has("ema")

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
    ``checkpoint_restore`` segment.  A meshed trainer saves shard-wise
    and resumes into its own blocks, and both are collectives: every
    rank calls them (module docstring).  One device saves the one-device
    layout.  Either resumes from either layout into the trainer's own
    tensors (``restore_shards``)."""
    meshed = getattr(trainer, "mesh", None) is not None
    ckpt = CheckpointManager(directory, max_to_keep=max_to_keep, clock=clock,
                             registry=registry, distributed=meshed)

    def _seg(name: str):
        ledger = getattr(trainer, "ledger", None)
        return ledger.segment(name) if ledger is not None else nullcontext()

    def save(step: int) -> None:
        with _seg("checkpoint_save"):
            if meshed:
                ckpt.save_shards(step, trainer.shard_state())
            else:
                ckpt.save(step, trainer.gathered_params(),
                          trainer.opt_state, ema=trainer.gathered_ema())

    def _resume() -> int:
        step, count, ema = ckpt.restore_shards(
            trainer.shard_state()["blocks"])
        trainer.load_shard_state(count, ema)
        return step

    def resume() -> int:
        with _seg("checkpoint_restore"):
            return _resume()

    return ckpt, save, resume
