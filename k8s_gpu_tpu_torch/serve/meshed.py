"""The seam of serving on a mesh: one scheduler, every rank runs every
device program.  The port's own module: the reference's meshed batcher
is one GSPMD program driven by one scheduler and has no such seam.

The port runs one process a rank (``torch.distributed``).  Global rank
0 is the leader: it runs the batcher's scheduler thread (and, under
``LmServer``, the HTTP server) and alone holds the host state: the
request queue, the ``BlockPool`` and its chain hashes, the page tables,
the journal, the metrics, the profiler and the spans.  Every other rank
is a follower: it builds the same batcher on its own shards and slice
of the pool and, once started, runs ``follow``, a loop with no HTTP and
no scheduler.

Each device program of the executor goes through ``Seam.call``: the
leader broadcasts a descriptor of the call over the world (the method's
name and its arguments, device tensors as host tensors, a dense prefix
entry by its key), then every rank, the leader too, runs the method on
its own shards, so every rank issues the method's tp collectives in the
same order.  The scheduler's host decisions (``_adaptive_k``, the
n-gram gate, deadlines) read the leader's clock and are never
replicated.  After the call the dense pool's rows, cut over dp, are
collected over dp: an admission's first token and log-prob by a sum over
dp (the other groups contribute zeros), a round's tokens by a gather
along the rows.  The paged pool is whole on every dp group (the
reference replicates it over dp: page gathers cross the block axis), so
dp adds no pool capacity there and nothing is collected.

Sampling needs nothing more: after the tp gather the logits are the same
bits on every rank of a tp group, and the slot's generator is seeded
alike on each, so they draw alike.

Besides the executor's programs the seam carries the pool's block
migration (``_export_dev`` gathers each block's heads over tp, so the
wire holds whole heads; ``_import_dev`` hands every rank the wire
blocks and each writes its heads) and the prefills of an in-process
prefill pool (``disagg.DisaggregatedLm`` on the same mesh, attached as
``"pool"``).  A pool's row stays on the rank that computed it, its heads
only: the leader's is a ``HeldRow`` that travels in a descriptor by its
key, and each follower takes its own row of that key (``held``).  The
pool's worker threads call the seam beside the scheduler thread, so a
call holds a lock from its descriptor to its last collective: the
followers run the calls one by one in the leader's order.

``close`` (the leader's scheduler thread, as it exits) sends the final
descriptor that ends every follower's loop; a call after it raises.  A
follower whose leader died fails at its next collective, within the
process group's timeout.
"""

from __future__ import annotations

import threading

import torch

from ..parallel import collectives
from ..parallel.mesh import AXES, axis_group, axis_size

# The executor's device programs by what their outputs need over dp:
# an admission's (first token, log-prob) and, for the fused start, its
# round; the rounds' outputs, rows on dim 1.
_ADMITS = ("_admit_dev", "_admit_prefix_dev", "_admit_exact_dev",
           "_admit_entry_dev", "_admit_paged_dev")
_ROUNDS = ("_round_dev", "_round_spec_dev", "_round_spec_ngram_dev")
_RECORDED = (*_ADMITS, *_ROUNDS, "_admit_round_dev")
_CALLS = (*_RECORDED, "_prefix_dev", "_export_dev", "_import_dev",
          "_drop_held_dev", "pool._prefill_dev")


class _Entry:
    """A dense prefix entry in a descriptor: its key."""

    def __init__(self, key: bytes):
        self.key = key


class _Held:
    """A held row in a descriptor: its key."""

    def __init__(self, key: int):
        self.key = key


class HeldRow(dict):
    """A K/V row (a dict of cache leaves at this rank's heads) that every
    rank of the mesh computed in one seam call and holds under ``key``:
    a descriptor names it by the key, and each rank reads its own."""

    def __init__(self, leaves: dict, key: int):
        super().__init__(leaves)
        self.key = key


class Seam:
    """The leader's and the followers' half of a meshed batcher's device
    calls (module docstring)."""

    def __init__(self, batcher, mesh):
        import torch.distributed as dist

        self.batcher = batcher
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.is_leader = self.rank == 0
        # The dense pool's rows are cut over dp; the paged pool's not.
        self.dp_group = (axis_group(mesh, "dp")
                         if not batcher.paged and axis_size(mesh, "dp") > 1
                         else None)
        self._labels = {id(axis_group(mesh, a)): a for a in AXES
                        if axis_group(mesh, a) is not None}
        # A list to keep each call's outputs in, as host tensors (None:
        # kept nowhere): what tests compare across ranks.
        self.record = None
        # Objects besides the batcher whose programs the seam runs, by
        # name; a follower's rows of the calls that made them, by key.
        self.targets = {}
        self.held = {}
        self._lock = threading.Lock()
        self.closed = False

    def attach(self, name: str, target) -> None:
        """Run ``name.<method>`` calls on ``target`` (the same object on
        every rank, attached before the batcher starts)."""
        self.targets[name] = target

    def observe(self, registry) -> None:
        """Time this process's transfers into ``registry``'s
        ``collective_seconds{axis,op}`` (the world group is
        ``axis="world"``)."""
        labels = self._labels

        def record(op, group, seconds):
            registry.observe("collective_seconds", seconds,
                             axis=labels.get(id(group), "world"), op=op)

        collectives.observe_transfers(record)

    @staticmethod
    def unobserve() -> None:
        collectives.observe_transfers(None)

    # -- descriptors -------------------------------------------------------
    def _encode(self, x):
        if isinstance(x, HeldRow):
            return _Held(x.key)
        if torch.is_tensor(x):
            return x.detach().cpu()
        if isinstance(x, dict) and "key" in x and "cache" in x:
            return _Entry(x["key"])
        if isinstance(x, (tuple, list)):
            return type(x)(self._encode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        return x

    def _decode(self, x):
        if torch.is_tensor(x):
            return x.to(self.batcher.device)
        if isinstance(x, _Entry):
            return self.batcher._prefix[x.key]
        if isinstance(x, _Held):
            return self.held.pop(x.key)
        if isinstance(x, (tuple, list)):
            return type(x)(self._decode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._decode(v) for k, v in x.items()}
        return x

    # -- the calls ---------------------------------------------------------
    def call(self, name: str, args: tuple, kw: dict):
        """The leader: send the descriptor, run the method here, collect
        its outputs over dp."""
        if name not in _CALLS:
            raise ValueError(f"{name} is not a device program of the "
                             "executor")
        with self._lock:
            if self.closed:
                raise RuntimeError("the serving mesh is closed")
            collectives.broadcast_object(
                (name, self._encode(args), self._encode(kw)))
            return self._collect(name, self._method(name)(*args, **kw))

    def _method(self, name: str):
        target, _, method = name.rpartition(".")
        return getattr(self.targets[target] if target else self.batcher,
                       method)

    def follow(self) -> None:
        """A follower: run every descriptor the leader sends until the
        final one (None)."""
        while True:
            desc = collectives.broadcast_object()
            if desc is None:
                return
            name, args, kw = desc
            self._collect(name, self._method(name)(
                *self._decode(args), **self._decode(kw)))

    def close(self) -> None:
        """The leader: end every follower's loop."""
        with self._lock:
            self.closed = True
            collectives.broadcast_object(None)

    def _collect(self, name: str, out):
        """A dense dp mesh's outputs, whole on every rank: the admission's
        (token, log-prob) summed over dp, the rounds' rows gathered."""
        group = self.dp_group
        if name not in _RECORDED:
            return out
        if group is not None:
            out = self._gather_dp(name, list(out), group)
        if self.record is not None:
            self.record.append((name, [t.cpu() for t in out]))
        return out

    @staticmethod
    def _gather_dp(name: str, out: list, group) -> tuple:
        if name in _ADMITS or name == "_admit_round_dev":
            both = collectives.all_reduce(
                torch.stack([out[0].float(), out[1].float()]), group)
            out[:2] = [both[0].to(torch.int32), both[1]]
        if name in _ROUNDS or name == "_admit_round_dev":
            lo = 2 if name == "_admit_round_dev" else 0
            out[lo:] = [torch.cat(collectives.all_gather(t.contiguous(),
                                                         group), dim=1)
                        for t in out[lo:]]
        return tuple(out)
