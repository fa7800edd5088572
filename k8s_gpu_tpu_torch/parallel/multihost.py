"""Multi-process orchestration: the port of
``k8s_gpu_tpu/parallel/multihost.py`` on ``torch.distributed``.

Every worker pod runs the same program; ``initialize_from_env`` joins it
to the world from the rendezvous env the trainjob controller renders
(``TPU_COORDINATOR_ADDRESS``/``TPU_PROCESS_ID``/``TPU_PROCESS_COUNT``,
``utils/rendezvous.py``): ``tcp://`` to the coordinator, one rank a
process, one device a rank.

``spawn_local_cluster`` is the simulation half: it starts N fresh
interpreters (``python -c``, never a fork, so CUDA is safe), joins them
through a coordinator on localhost, runs a caller function in each and
collects the results.  On the card rank r drives card r mod the card
count, so on a one-card host N ranks share it: NCCL refuses two ranks of
one communicator on one card, gloo takes any number (``collectives``
copies CUDA tensors through the host for it).

``serve_ranks`` runs a meshed server's ranks on one host: each rank
builds the serving meshes and calls ``fn(*meshes)``, which builds its
``LmServer`` or ``ContinuousBatcher`` (``mesh=``) on its shards; rank 0
drives and the others follow (``serve/meshed.py``).  In a pod of a real
cluster the same ``fn`` runs after ``initialize_from_env`` on the mesh
of ``mesh.build_mesh`` (or ``mesh.multislice_mesh``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.rendezvous import (  # noqa: F401
    ENV_COORDINATOR,
    ENV_PROCESS_COUNT,
    ENV_PROCESS_ID,
    HostEnv,
    rendezvous_env,
)

# The kernels a rank of the training path loads (built once in the
# parent before ranks spawn on a card), and a rank of the serving path.
TRAIN_KERNELS = ("flash_attention", "flash_attention_v2")
SERVE_KERNELS = ("paged_attention",)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_from_env(backend: str | None = None, device="cuda",
                        timeout: float = 180.0) -> bool:
    """Inside a workload pod: join the world if the rendezvous env is
    present (``backend`` default: nccl on the card, gloo on the CPU).
    Returns True when running multi-process.  ``timeout`` bounds the
    rendezvous and every collective after it."""
    addr = os.environ.get(ENV_COORDINATOR)
    if not addr:
        return False
    dist.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://{addr}",
        world_size=int(os.environ[ENV_PROCESS_COUNT]),
        rank=int(os.environ[ENV_PROCESS_ID]),
        timeout=datetime.timedelta(seconds=timeout),
    )
    return True


# -- built-in multi-process workloads (top-level: picklable by reference) --

def workload_device_report() -> dict:
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "global_devices": dist.get_world_size(),
        "local_devices": 1,
    }


def workload_global_psum(devices_per_host: int = 1, device="cuda") -> dict:
    """Each process stands for a host of ``devices_per_host`` devices and
    contributes (process_index + 1) per device; the global sum proves the
    collective crosses the process boundary."""
    from .collectives import all_reduce

    dev = torch.device(device)
    x = torch.full((1,), float((dist.get_rank() + 1) * devices_per_host),
                   device=dev)
    all_reduce(x)
    return {"sum": float(x.item()),
            "global_devices": dist.get_world_size() * devices_per_host}


def workload_train_step(device="cuda", mesh=None) -> dict:
    """One train step of a small LM over the global mesh (``mesh``, or
    all ranks on dp): each dp block's rows come from its own seed, the
    ``Trainer`` averages the gradients over the batch group, and an
    equal loss on every process proves a coherent update."""
    import numpy as np

    from ..models import TransformerConfig, TransformerLM
    from ..train import TrainConfig, Trainer
    from .mesh import MeshConfig, axis_size

    dev = torch.device(device)
    model = TransformerLM(TransformerConfig(
        vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_head=8,
        d_ff=64, max_seq=32, use_flash=False, dtype=torch.float32),
        device=dev)
    trainer = Trainer(model, TrainConfig(warmup_steps=1), device=dev,
                      mesh=mesh, mesh_config=MeshConfig(dp=-1))
    trainer.init(0)
    rows = np.concatenate([
        np.random.default_rng(p).integers(0, 128, size=(2, 33),
                                          dtype=np.int64)
        for p in range(axis_size(trainer.mesh, "dp"))])
    trainer.batch_specs = (("dp",), ("dp",))
    loss = trainer.step(rows[:, :-1], rows[:, 1:])
    return {"loss": float(loss), "global_devices": dist.get_world_size()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_WORKER_TEMPLATE = """\
import os, pickle, sys

sys.path.insert(0, {repo_root!r})
import torch
import torch.distributed as dist

from k8s_gpu_tpu_torch.parallel.multihost import initialize_from_env

if {device!r} == "cuda":
    torch.cuda.set_device(
        int(os.environ["TPU_PROCESS_ID"]) % torch.cuda.device_count())
if not initialize_from_env({backend!r}, {device!r}, {timeout!r}):
    raise SystemExit("rendezvous env missing")
fn = pickle.loads(open({fn_path!r}, "rb").read())
out = fn()
with open({out_path!r} + ".tmp", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
os.replace({out_path!r} + ".tmp", {out_path!r})
"""


def spawn_local_cluster(fn, num_processes: int = 2, timeout: float = 180.0,
                        device="cuda", backend: str | None = None,
                        kernels: tuple = TRAIN_KERNELS) -> list:
    """Run ``fn()`` in *num_processes* ranks joined through a local
    coordinator, each on ``device`` (on the card: rank r drives card r
    mod the card count, so every rank card 0 on a one-card host) over
    ``backend`` (default: nccl on the card, gloo on the CPU);
    return each rank's (pickled) result, ordered by rank.  ``fn`` must
    pickle (a top-level function, or a ``functools.partial`` of one).

    One deadline covers every worker: a worker that dies fails the run
    within 10 s, one that hangs fails it at the deadline, and then every
    worker still running is killed.  On the card ``kernels`` (the flash
    kernels by default) are built here first, so the ranks load them
    instead of building them side by side."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda" and kernels:
        from concurrent.futures import ThreadPoolExecutor

        from ..ops import _build

        with ThreadPoolExecutor(len(kernels)) as pool:
            list(pool.map(_build.load, kernels))
    envs = rendezvous_env(num_processes, port=_free_port())
    repo_root = str(Path(__file__).resolve().parent.parent.parent)
    with tempfile.TemporaryDirectory() as td:
        fn_path = str(Path(td) / "fn.pkl")
        Path(fn_path).write_bytes(pickle.dumps(fn))
        procs, outs, logs = [], [], []
        for env in envs:
            out_path = str(Path(td) / f"out-{env.process_id}.pkl")
            outs.append(out_path)
            script = _WORKER_TEMPLATE.format(
                repo_root=repo_root, device=device.type,
                backend=backend, timeout=float(timeout), fn_path=fn_path,
                out_path=out_path)
            penv = dict(os.environ)
            penv.update(env.as_env())
            # Each worker's output goes to a file: a pipe nobody reads
            # would block a chatty worker.
            logs.append(Path(td) / f"log-{env.process_id}.txt")
            with open(logs[-1], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", script], env=penv,
                    stdout=log, stderr=subprocess.STDOUT))
        failed = []
        deadline = time.monotonic() + timeout
        try:
            for p, env in zip(procs, envs):
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append((env.process_id, "timeout"))
                    continue
                if p.returncode != 0:
                    failed.append((env.process_id, f"rc={p.returncode}"))
                    # Fail fast: the world is dead without this worker.
                    deadline = min(deadline, time.monotonic() + 10.0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            msgs = "\n".join(
                f"worker {pid} {why}:\n" + textwrap.indent(
                    logs[pid].read_bytes().decode(errors="replace")[-2000:],
                    "  ")
                for pid, why in failed)
            raise RuntimeError(f"multihost workers failed:\n{msgs}")
        return [pickle.loads(Path(o).read_bytes()) for o in outs]


def _serve_rank(fn, mesh_configs, device_type: str):
    from .mesh import build_mesh

    return fn(*(build_mesh(c, device_type=device_type)
                for c in mesh_configs))


def serve_ranks(fn, *mesh_configs, timeout: float = 300.0, device="cuda",
                backend: str | None = None) -> list:
    """Run a meshed server's ranks on this host: one process a rank
    (``spawn_local_cluster``; gloo on the CPU, by default nccl on
    cards), each building the serving mesh of every ``MeshConfig`` given
    (all of one size: the world's) and calling ``fn(*meshes)``; returns
    every rank's result, by rank.  ``fn`` pickles by reference (a
    top-level function or a ``functools.partial`` of one).  Rank 0 is
    the leader: ``fn`` serves its requests there and stops the server,
    which ends every other rank's loop (``LmServer.wait``)."""
    import functools
    import math

    from .mesh import MeshConfig

    sizes = set()
    for c in mesh_configs:
        if not isinstance(c, MeshConfig) or min(
                c.dp, c.pp, c.ep, c.sp, c.tp) < 1:
            raise ValueError("serve_ranks takes MeshConfigs with every "
                             "axis size given")
        sizes.add(math.prod((c.dp, c.pp, c.ep, c.sp, c.tp)))
    if len(sizes) != 1:
        raise ValueError(f"the meshes span different worlds: {sizes}")
    return spawn_local_cluster(
        functools.partial(_serve_rank, fn, mesh_configs,
                          resolve_device(device).type),
        sizes.pop(), timeout=timeout, device=device, backend=backend,
        kernels=SERVE_KERNELS)
