"""The port's goodput ledger, phase profiler and trainer telemetry against
the JAX package's.

- The two ledgers under one ``TickingFakeClock`` script give equal
  snapshots field for field, equal ``/debug/goodput`` bodies and equal
  text expositions (all advances dyadic, so float sums are exact).
- The port ``Trainer``'s ledger segments for a ``fit`` equal the
  reference ``Trainer``'s (both with plain attention: the segments do
  not depend on it).
- The ``train.preempt`` chaos walk, the step series and
  ``train_phase_seconds``.
"""

import jax
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, build_mesh
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.utils import goodput as ref_goodput
from k8s_gpu_tpu.utils.clock import TickingFakeClock as JaxTickingClock
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.api.workload import WorkloadInterrupted
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer
from k8s_gpu_tpu_torch.utils import goodput
from k8s_gpu_tpu_torch.utils.clock import TickingFakeClock
from k8s_gpu_tpu_torch.utils.faults import FaultPlan, global_faults
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, d_head=8,
            d_ff=64, max_seq=16)


def _script(name, led, clk):
    """One scripted run: segments chained and with residual gaps, an
    outage, incidents and heartbeats of two hosts (a straggler)."""
    led.begin("init")
    clk.advance(0.5)
    led.begin("compile")
    clk.advance(2.0)
    for i in range(4):
        with led.segment("data_wait"):
            clk.advance(0.125)
        with led.segment("step"):
            clk.advance(1.0)
        led.heartbeat("host0", i + 1, 1.0)
        if name != "one-host":
            led.heartbeat("host1", i + 1, 1.5 if name == "straggler" else 1.0)
    clk.advance(0.25)                                  # residual
    if name == "outage":
        led.incident("preemption", detail="slice suspended")
        led.begin("preempted")
        clk.advance(16.0)
        led.begin("checkpoint_restore")
        clk.advance(0.5)
        led.end()
        led.incident("resume", detail="restored step 4")
    with led.segment("checkpoint_save"):
        clk.advance(0.75)
    led.begin("step")                                  # left open
    clk.advance(0.5)


@pytest.mark.parametrize("name", ["one-host", "straggler", "outage"])
def test_ledger_snapshots_equal_reference(name):
    sides = []
    for clock_cls, reg_cls, mod in ((TickingFakeClock, MetricsRegistry,
                                     goodput),
                                    (JaxTickingClock, JaxRegistry,
                                     ref_goodput)):
        clk, reg = clock_cls(), reg_cls()
        led = mod.GoodputLedger(registry=reg, clock=clk, window_s=8.0)
        _script(name, led, clk)
        reg.observe("train_checkpoint_seconds", 0.75, op="save")
        reg.inc("train_checkpoint_failures_total", op="restore")
        reg.set_gauge("train_checkpoint_bytes", 4096.0)
        sides.append((led.snapshot(), mod.goodput_snapshot(led, reg),
                      reg.render()))
    (snap, body, text), (ref_snap, ref_body, ref_text) = sides
    assert snap == ref_snap
    assert body == ref_body
    assert text == ref_text
    assert (goodput.goodput_snapshot_from_exposition(text)
            == ref_goodput.goodput_snapshot_from_exposition(ref_text))
    total = sum(v["seconds"] for v in snap["segments"].values())
    assert total + snap["residual_s"] == snap["elapsed_s"]


def test_unknown_segment_and_incident_kind_raise():
    led = goodput.GoodputLedger(registry=MetricsRegistry(),
                                clock=TickingFakeClock())
    assert goodput.SEGMENTS == ref_goodput.SEGMENTS
    assert goodput.INCIDENT_KINDS == ref_goodput.INCIDENT_KINDS
    with pytest.raises(ValueError, match="segment"):
        led.begin("lunch")
    with pytest.raises(ValueError, match="incident"):
        led.incident("meteor")


def _batches(n=8):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, DIMS["vocab_size"], (2, DIMS["max_seq"] + 1),
                        dtype=np.int32)
    for _ in range(n):
        yield toks[:, :-1], toks[:, 1:]


def _port_trainer(ledger=None, **kw):
    model = TransformerLM(TransformerConfig(**DIMS, use_flash=False,
                                            dtype=torch.float32),
                          device="cpu")
    return Trainer(model, TrainConfig(warmup_steps=1), device="cpu",
                   ledger=ledger, **kw)


def test_trainer_fit_segments_equal_reference():
    """init 1, compile 1 (the first step), step 2, data_wait 3, and the
    same seconds under the same clock script on both sides."""
    snaps = []
    for side in ("port", "reference"):
        if side == "port":
            clk = TickingFakeClock()
            led = goodput.GoodputLedger(registry=MetricsRegistry(), clock=clk)
            tr = _port_trainer(led)
            tr.init(0)
        else:
            clk = JaxTickingClock()
            led = ref_goodput.GoodputLedger(registry=JaxRegistry(), clock=clk)
            tr = JaxTrainer(
                JaxLM(JaxConfig(**DIMS, use_flash=False)),
                mesh=build_mesh(MeshConfig(dp=1), n_devices=1),
                train_config=JaxTrainConfig(warmup_steps=1), ledger=led)
            tr.init(jax.random.PRNGKey(0))
        assert len(tr.fit(_batches(), 3, log_every=1)) == 3
        snaps.append(led.snapshot())
    port, ref = snaps
    counts = {k: v["count"] for k, v in port["segments"].items()}
    assert counts == {"init": 1, "compile": 1, "step": 2, "data_wait": 3}
    assert port["segments"] == ref["segments"]
    for key in ("elapsed_s", "residual_s", "productive_s", "open",
                "goodput_ratio", "goodput_ratio_total", "incidents"):
        assert port[key] == ref[key], key
    assert set(port["hosts"]) == set(ref["hosts"]) == {"host0"}
    assert port["hosts"]["host0"]["step"] == ref["hosts"]["host0"]["step"]


def test_train_preempt_chaos_walk(tmp_path):
    """An armed ``train.preempt`` interrupts ``fit``: the ledger opens
    ``preempted`` and records the incident; the checkpoint restore closes
    it and training goes on; the partition stays exact."""
    clk = TickingFakeClock()
    reg = MetricsRegistry()
    led = goodput.GoodputLedger(registry=reg, clock=clk, window_s=8.0)
    tr = _port_trainer(led)
    tr.init(0)
    data = _batches()
    assert len(tr.fit(data, 2, log_every=1)) == 2
    _, save, resume = attach_to_trainer(tr, tmp_path / "ck", clock=clk,
                                        registry=reg)
    save(2)
    injected = global_metrics.counter("faults_injected_total",
                                      site="train.preempt", kind="error")
    global_faults.arm("train.preempt", FaultPlan(flaky=1))
    try:
        with pytest.raises(WorkloadInterrupted, match="train.preempt"):
            tr.fit(data, 2, log_every=1)
    finally:
        global_faults.disarm()
    assert global_metrics.counter("faults_injected_total",
                                  site="train.preempt",
                                  kind="error") == injected + 1
    snap = led.snapshot()
    assert snap["open"] == "preempted"
    inc = snap["incidents"][-1]
    assert inc["kind"] == "preemption" and "train.preempt" in inc["detail"]
    assert inc["trace_id"] == ""          # fit runs under no span
    assert reg.counter("train_incidents_total", kind="preemption") == 1.0
    clk.advance(16.0)                                 # the outage
    assert led.goodput_ratio() < 0.5
    assert resume() == 2
    snap = led.snapshot()
    assert snap["open"] is None
    assert snap["segments"]["preempted"]["seconds"] >= 16.0
    assert snap["segments"]["checkpoint_restore"]["count"] == 1
    assert len(tr.fit(data, 2, log_every=1)) == 2
    snap = led.snapshot()
    total = sum(v["seconds"] for v in snap["segments"].values())
    assert total + snap["residual_s"] == snap["elapsed_s"]
    assert snap["segments"]["step"]["count"] == 3     # compile took one
    assert reg.counter("train_nonproductive_seconds_total",
                       segment="preempted") >= 16.0


@pytest.mark.parametrize("peak", [1e12, None])
def test_step_metrics_and_phase_seconds(peak):
    """Every step observes ``train_step_seconds`` and sets the last-step
    and tokens/s gauges; ``train_mfu`` skips the first step and reads 0
    against the CPU's zero peak; the profiler times the three phases."""
    reg = MetricsRegistry()
    prof = PhaseProfiler(plane="train", registry=reg)
    tr = _port_trainer(peak_flops=peak, profiler=prof)
    tr.init(0)
    before = global_metrics.histogram("train_step_seconds")
    n0 = before.n if before is not None else 0
    global_metrics.set_gauge("train_mfu", -1.0)
    tr.fit(_batches(), 3, log_every=1)
    assert global_metrics.histogram("train_step_seconds").n == n0 + 3
    last = global_metrics.gauge("train_last_step_seconds")
    assert last > 0.0
    assert global_metrics.gauge("train_tokens_per_second") == pytest.approx(
        2 * DIMS["max_seq"] / last)
    mfu = global_metrics.gauge("train_mfu")
    assert (mfu > 0.0) if peak else (mfu == 0.0)
    for phase in ("shard_batch", "step_dispatch", "loss_sync"):
        assert reg.histogram("train_phase_seconds", phase=phase).n == 3
    shares = reg.series("train_phase_share")
    assert set(dict(k)["phase"] for k in shares) == {
        "shard_batch", "step_dispatch", "loss_sync", "residual"}
    assert sum(shares.values()) == pytest.approx(1.0)
