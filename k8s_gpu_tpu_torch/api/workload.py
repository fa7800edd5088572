"""The channel between a TrainJob operator and an in-process workload:
the port's own copy of ``k8s_gpu_tpu/api/workload.py``.

A workload that takes a third argument receives a ``WorkloadContext``.
Through it the workload reports its progress, checkpoints and resume
into the job's status, and learns from ``heartbeat`` (which raises
``WorkloadInterrupted``) that the slice under it was preempted, so the
operator can place the gang again and the workload resume from its
latest checkpoint.  The port's workloads read only the context's
attributes (``checkpoint_dir``, ``checkpoint_interval``, ``heartbeat``,
``record_checkpoint``, ``record_resume``), so the reference operator's
own context drives them unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


class WorkloadInterrupted(RuntimeError):
    """The gang's placement vanished mid-run (slice preempted, nodes
    pruned): restartable, not fatal."""


@dataclass
class WorkloadContext:
    """Handed to three-argument workloads: ``fn(spec, placements, ctx)``.

    ``heartbeat(step)``, called once a training step, publishes progress
    and raises ``WorkloadInterrupted`` when a placement node is gone or
    was replaced (its uid changed)."""

    checkpoint_dir: str = ""
    checkpoint_interval: int = 0
    placements: dict[str, str] = field(default_factory=dict)
    # Node name -> uid at placement time: a preempted slice's nodes may
    # come back under the same names, so the uid tells them apart.
    node_uids: dict[str, str] = field(default_factory=dict)
    _node_uid: Callable[[str], str | None] | None = None
    _patch_status: Callable[[Callable[[Any], None]], None] | None = None

    def heartbeat(self, step: int) -> None:
        self._set_status("progress_step", step)
        if self._node_uid is None:
            return
        lost = []
        for node in sorted(set(self.placements.values())):
            uid = self._node_uid(node)
            want = self.node_uids.get(node)
            if uid is None:
                lost.append(f"{node} (gone)")
            elif want and uid != want:
                lost.append(f"{node} (replaced)")
        if lost:
            raise WorkloadInterrupted(
                f"placement node(s) lost at step {step}: {', '.join(lost)}")

    def record_checkpoint(self, step: int) -> None:
        self._set_status("checkpoint_step", step)

    def record_resume(self, step: int) -> None:
        self._set_status("resumed_from_step", step)

    def _set_status(self, attr: str, value: int) -> None:
        if self._patch_status is not None:
            self._patch_status(lambda status: setattr(status, attr, value))
