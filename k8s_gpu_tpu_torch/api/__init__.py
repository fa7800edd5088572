"""The port's copy of the workload contract between a TrainJob operator
and an in-process workload."""

from .workload import WorkloadContext, WorkloadInterrupted

__all__ = ["WorkloadContext", "WorkloadInterrupted"]
