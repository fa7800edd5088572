"""The port's per-op tracing (``utils/profiling.py``, on ``torch.profiler``)
against the reference's ``jax.profiler`` wrappers: ``trace`` leaves a
Chrome trace with the step annotations in it, ``profile_trainer`` runs
one untraced warm-up step and returns the reference's dict under the
same clock script, and a short iterator raises the reference's
``ValueError``."""

import json

import numpy as np
import pytest
import torch

from k8s_gpu_tpu.utils.clock import TickingFakeClock as JaxTickingClock
from k8s_gpu_tpu.utils.profiling import profile_trainer as jax_profile
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
from k8s_gpu_tpu_torch.utils.clock import TickingFakeClock
from k8s_gpu_tpu_torch.utils.profiling import (
    profile_trainer, step_annotation, trace, trace_files,
)

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2, d_head=8,
            d_ff=32, max_seq=16)


def _batches(n):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, DIMS["vocab_size"], (2, DIMS["max_seq"] + 1),
                        dtype=np.int32)
    return iter([(toks[:, :-1], toks[:, 1:])] * n)


def _trainer():
    model = TransformerLM(TransformerConfig(**DIMS, use_flash=False,
                                            dtype=torch.float32),
                          device="cpu")
    tr = Trainer(model, TrainConfig(warmup_steps=1), device="cpu")
    tr.init(0)
    return tr


class _CountingTrainer:
    """A trainer that only counts its steps (the reference's side needs
    no model to show its contract)."""

    def __init__(self):
        self.steps = 0

    def step(self, *batch):
        self.steps += 1


def test_trace_leaves_a_chrome_trace(tmp_path):
    assert trace_files(tmp_path) == []
    with trace(tmp_path / "t") as d:
        for i in range(2):
            with step_annotation("train", i):
                torch.ones(8, 8) @ torch.ones(8, 8)
    files = trace_files(d)
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train#0", "train#1"} <= names
    assert any("mm" in str(n) for n in names)


def test_profile_trainer_returns_the_reference_dict(tmp_path):
    tr = _trainer()
    calls = []
    step = tr.step
    tr.step = lambda *b: calls.append(1) or step(*b)
    mine = profile_trainer(tr, _batches(3), 2, tmp_path / "port",
                           clock=TickingFakeClock())
    ref_tr = _CountingTrainer()
    ref = jax_profile(ref_tr, _batches(3), 2, tmp_path / "ref",
                      clock=JaxTickingClock())
    assert len(calls) == ref_tr.steps == 3          # warm-up + 2 traced
    assert mine.pop("trace_dir") == str(tmp_path / "port")
    assert ref.pop("trace_dir") == str(tmp_path / "ref")
    assert mine == ref and mine["steps"] == 2
    assert trace_files(tmp_path / "port")


@pytest.mark.parametrize("n_batches", [0, 2])
def test_profile_trainer_refuses_a_short_iterator(tmp_path, n_batches):
    with pytest.raises(ValueError) as mine:
        profile_trainer(_CountingTrainer(), _batches(n_batches), 2,
                        tmp_path / "port")
    with pytest.raises(ValueError) as ref:
        jax_profile(_CountingTrainer(), _batches(n_batches), 2,
                    tmp_path / "ref")
    assert str(mine.value) == str(ref.value)
    assert f"after {n_batches} batches" in str(mine.value)
