"""The port's TrainJob workload registry: the reference's names, each
workload at tiny arguments on the CPU, and the reference
``TrainJobReconciler`` on a ``FakeKube`` driving the port's
``lm-train-ckpt`` through a node loss to a resume from its checkpoint.

The operator test swaps the port's workload into the reference
registry's ``_REGISTRY`` with ``monkeypatch`` (the reference's source is
untouched).  It holds the workload at step 5's heartbeat until the
preempted slice's nodes are gone or replaced, so the interruption lands
there whatever the host's speed: checkpoints every 2 steps, so the job
resumes from step 4.
"""

import threading
import time
import types

import pytest
import torch

import k8s_gpu_tpu.operators.tpupodslice as tps_mod
import k8s_gpu_tpu.operators.trainjob as tj_mod
from k8s_gpu_tpu.api import TpuPodSlice, TrainJob
from k8s_gpu_tpu.cloud import FakeCloudTpu, cloudtpu_client_factory
from k8s_gpu_tpu.cloud.topology import parse_accelerator_type
from k8s_gpu_tpu.controller import FakeKube, Manager
from k8s_gpu_tpu.operators import TpuPodSliceReconciler, TrainJobReconciler
from k8s_gpu_tpu.train import registry as ref_registry
from k8s_gpu_tpu_torch.api import WorkloadContext, WorkloadInterrupted
from k8s_gpu_tpu_torch.train import registry

torch.set_num_threads(1)

LM_ARGS = {"steps": 8, "d_model": 32, "layers": 1, "d_ff": 64, "batch": 2,
           "vocab": 64, "device": "cpu"}
# The keys each reference workload returns (k8s_gpu_tpu/train/registry.py).
KEYS = {
    "cnn-train": {"first_loss", "last_loss", "steps"},
    "lm-train": {"first_loss", "last_loss", "steps"},
    "lora-finetune": {"first_loss", "last_loss", "steps", "adapter_params",
                      "base_params"},
    "lm-train-ckpt": {"steps", "start_step", "resumed", "first_loss",
                      "last_loss"},
}


def _spec(**args):
    return types.SimpleNamespace(workload_args=dict(args))


def _reference_builtins() -> list[str]:
    """The workloads the reference registry module registers itself: other
    test files (``tests/test_trainjob.py``) register more into it at run
    time, in whichever worker runs them first."""
    return sorted(n for n, fn in ref_registry._REGISTRY.items()
                  if fn.__module__ == ref_registry.__name__)


def test_known_workloads_equal_reference():
    assert registry.known_workloads() == _reference_builtins()
    with pytest.raises(KeyError, match="unknown workload"):
        registry.get_workload("nope")


def test_known_workloads_ignore_names_registered_at_run_time(monkeypatch):
    monkeypatch.setitem(ref_registry._REGISTRY, "always-fails",
                        lambda spec, placements: None)
    assert "always-fails" in ref_registry.known_workloads()
    assert registry.known_workloads() == _reference_builtins()
    assert "always-fails" not in registry.known_workloads()


@pytest.mark.parametrize("name,args", [
    ("cnn-train", {"steps": 3, "batch": 4}),
    ("lm-train", {"steps": 3, "d_model": 32, "layers": 1}),
    ("lora-finetune", {"steps": 3, "d_model": 32, "layers": 1, "rank": 4}),
    ("lm-train-ckpt", {"steps": 4, "d_model": 32, "layers": 1,
                       "interval": 2}),
])
def test_workload_runs_on_the_cpu(name, args, tmp_path):
    if name == "lm-train-ckpt":
        args = dict(args, checkpoint_dir=str(tmp_path))
    out = registry.get_workload(name)(_spec(device="cpu", **args), {})
    assert set(out) == KEYS[name]
    assert out["steps"] == args["steps"]
    assert torch.isfinite(torch.tensor([out["first_loss"],
                                        out["last_loss"]])).all()
    if name != "lm-train-ckpt":
        assert out["last_loss"] < out["first_loss"]
    if name == "lora-finetune":
        # rank 4 on wq, wk, wv, wo of one layer at d_model 32, 4 x 16 heads
        assert out["adapter_params"] == 4 * (32 * 4 + 4 * 64)
    if name == "lm-train-ckpt":
        assert out["start_step"] == 0 and not out["resumed"]


@pytest.mark.parametrize("name", ["psum-smoke", "dist-psum-smoke"])
def test_parallel_workloads_name_their_roadmap_item(name):
    """ROADMAP queue 1 item 11's first half ported both: they run on the
    CPU and return the reference's keys and sums (psum-smoke over a
    world of one rank; dist-psum-smoke over two gloo ranks standing for
    hosts of two devices each: 1 x 2 + 2 x 2)."""
    out = registry.get_workload(name)(
        _spec(device="cpu", processes=2, devices_per_host=2), {})
    if name == "psum-smoke":
        assert out == {"ok": True, "n_devices": 1, "wall_s": out["wall_s"],
                       "result": 0.0}
    else:
        assert out == {"processes": 2, "global_devices": 4, "psum": 6.0}


def test_ckpt_workload_resumes_where_it_was_interrupted(tmp_path):
    """Interrupted by the port's own context at step 5 and run again: it
    resumes from the step-4 checkpoint and ends where an uninterrupted
    run ends; a checkpoint dir is required."""

    class Preempting(WorkloadContext):
        def heartbeat(self, step):
            super().heartbeat(step)
            if step == 5 and not self.fired:
                self.fired = True
                raise WorkloadInterrupted("slice preempted at step 5")

    run = registry.get_workload("lm-train-ckpt")
    ctx = Preempting(checkpoint_dir=str(tmp_path / "a"),
                     checkpoint_interval=2)
    ctx.fired = False
    with pytest.raises(WorkloadInterrupted):
        run(_spec(**LM_ARGS), {}, ctx)
    resumed = run(_spec(**LM_ARGS), {}, ctx)
    straight = run(_spec(**LM_ARGS, checkpoint_dir=str(tmp_path / "b")), {})
    assert resumed["start_step"] == 4 and resumed["resumed"]
    assert resumed["last_loss"] == straight["last_loss"]
    with pytest.raises(ValueError, match="checkpoint dir"):
        run(_spec(**LM_ARGS), {})


# -- the reference operator drives the port's workload ----------------------

ACCEL = "v4-8"  # one host -> one worker pod


@pytest.fixture
def live(monkeypatch):
    monkeypatch.setattr(tps_mod, "RESYNC", 0.05)
    monkeypatch.setattr(tj_mod, "CAPACITY_POLL", 0.05)
    kube = FakeKube()
    cloud = FakeCloudTpu()
    mgr = Manager(kube)
    mgr.register("TpuPodSlice", TpuPodSliceReconciler(
        kube, cloudtpu_client_factory(cloud), provision_poll=0.01))
    mgr.register("TrainJob", TrainJobReconciler(kube))
    mgr.start()
    yield kube, cloud
    mgr.stop()


def _wait(cond, timeout=60.0, what="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {what}")


def test_reference_operator_resumes_port_workload(live, tmp_path,
                                                  monkeypatch):
    kube, cloud = live
    port_fn = registry.get_workload("lm-train-ckpt")
    at_step5 = threading.Event()
    calls = []

    def workload(spec, placements, ctx):
        calls.append(dict(placements))
        beat = ctx.heartbeat

        def heartbeat(step):
            if step == 5 and len(calls) == 1:
                at_step5.set()
                node = next(iter(placements.values()))
                _wait(lambda: ctx._node_uid(node) != ctx.node_uids.get(node),
                      what="the preempted node to go")
            beat(step)

        ctx.heartbeat = heartbeat
        return port_fn(spec, placements, ctx)

    monkeypatch.setitem(ref_registry._REGISTRY, "lm-train-ckpt", workload)
    ps = TpuPodSlice()
    ps.metadata.name = "pool"
    ps.spec.accelerator_type = ACCEL
    kube.create(ps)
    _wait(lambda: kube.get("TpuPodSlice", "pool").status.phase == "Ready",
          what="slice Ready")
    job = TrainJob()
    job.metadata.name = "port"
    job.spec.accelerator_type = ACCEL
    job.spec.num_workers = parse_accelerator_type(ACCEL).hosts
    job.spec.workload = "lm-train-ckpt"
    job.spec.workload_args = dict(LM_ARGS)
    job.spec.restart_policy = "OnFailure"
    job.spec.checkpoint_interval_steps = 2
    job.spec.checkpoint_dir = str(tmp_path / "ck")
    kube.create(job)
    assert at_step5.wait(60), "the workload never reached step 5"
    cloud.preempt_slice("default-pool-qr")
    _wait(lambda: kube.get("TrainJob", "port").status.phase == "Succeeded",
          timeout=120, what="job Succeeded after the node loss")
    status = kube.get("TrainJob", "port").status
    assert status.restarts == 1 and len(calls) == 2
    assert status.result["resumed"]
    assert status.result["start_step"] == 4
    assert status.resumed_from_step == 4
    assert status.checkpoint_step >= status.resumed_from_step
    assert status.result["steps"] == LM_ARGS["steps"]
    # The loss curve continues: the run ends where an uninterrupted one
    # of the same workload ends.
    straight = port_fn(_spec(**LM_ARGS,
                             checkpoint_dir=str(tmp_path / "straight")), {})
    assert status.result["last_loss"] == pytest.approx(
        straight["last_loss"], abs=1e-6)
