"""Rendezvous env contract: the port's copy of
``k8s_gpu_tpu/utils/rendezvous.py``.

The TrainJob controller renders these variables into every worker pod;
a torch worker reads the same names (``parallel/multihost.py``) to join
``torch.distributed``: the coordinator's address, its own rank and the
world size.
"""

from __future__ import annotations

from dataclasses import dataclass

ENV_COORDINATOR = "TPU_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "TPU_PROCESS_ID"
ENV_PROCESS_COUNT = "TPU_PROCESS_COUNT"


@dataclass(frozen=True)
class HostEnv:
    """The per-host rendezvous env the trainjob controller injects."""

    coordinator_address: str
    process_id: int
    process_count: int

    def as_env(self) -> dict[str, str]:
        return {
            ENV_COORDINATOR: self.coordinator_address,
            ENV_PROCESS_ID: str(self.process_id),
            ENV_PROCESS_COUNT: str(self.process_count),
        }


def rendezvous_env(
    hosts: int, coordinator_host: str = "localhost", port: int = 8476
) -> list[HostEnv]:
    """Env for each of *hosts* workers; worker 0's host is the coordinator
    (the torchrun master_addr convention)."""
    addr = f"{coordinator_host}:{port}"
    return [HostEnv(addr, i, hosts) for i in range(hosts)]
