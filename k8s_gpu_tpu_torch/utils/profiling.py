"""Per-op traces: the ``torch.profiler`` counterpart of the reference's
``jax.profiler`` wrappers (``k8s_gpu_tpu/utils/profiling.py``).

``trace`` captures host operators and, on the card, its kernels into a
directory as a Chrome trace (``*.pt.trace.json``: TensorBoard's profile
plugin, ``chrome://tracing`` and ui.perfetto.dev load it);
``step_annotation`` names a training step on the timeline;
``profile_trainer`` traces N steps after one untraced warm-up step.
This is the deep dive; the always-on counterpart is
``utils/profiler.py`` (phase shares at ``/debug/profile``): that module
answers "which phase", this one "which op".  Wall-clock reads go through
an injected ``utils.clock.Clock``.

``torch.profiler`` records host operators only from the thread that
enters it: trace a batcher's rounds by entering it on the scheduler
thread (``ContinuousBatcher.run_quiesced``).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

from .clock import Clock, RealClock


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture a profiler trace into ``log_dir``: every activity this
    build of PyTorch can record (the card's kernels where there is one)."""
    import torch

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(
        activities=sorted(torch.profiler.supported_activities(),
                          key=lambda a: a.value),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            str(log_dir)),
    )
    with prof:
        yield log_dir


def step_annotation(name: str, step: int):
    """Marks a training step on the trace's timeline."""
    import torch

    return torch.profiler.record_function(f"{name}#{step}")


def profile_trainer(trainer, data_iter, steps: int, log_dir: str | Path,
                    clock: Clock | None = None) -> dict:
    """Trace ``steps`` steps after one untraced warm-up step, so the
    trace shows steady-state steps and not the kernels' first builds.
    Returns {trace_dir, steps, mean_step_s}.

    ``data_iter`` must yield at least ``steps + 1`` batches (the extra
    one feeds the warm-up); a shorter iterator raises ``ValueError`` up
    front instead of a bare ``StopIteration`` mid-trace."""
    clock = clock or RealClock()

    def draw(drawn: int):
        try:
            return next(data_iter)
        except StopIteration:
            raise ValueError(
                f"data_iter exhausted after {drawn} batches: "
                f"profile_trainer(steps={steps}) draws steps + 1 batches "
                "(one un-traced warmup step precedes the trace window) — "
                "pass an iterator yielding at least that many"
            ) from None

    batch = draw(0)
    trainer.step(*batch)  # the kernels build outside the trace
    t0 = clock.now()
    with trace(log_dir) as d:
        for i in range(steps):
            with step_annotation("train", i):
                batch = draw(i + 1)
                trainer.step(*batch)
    wall = clock.now() - t0
    return {
        "trace_dir": str(d),
        "steps": steps,
        "mean_step_s": wall / max(1, steps),
    }


def trace_files(log_dir: str | Path) -> list[Path]:
    """The Chrome traces a capture wrote (empty: no capture)."""
    return sorted(Path(log_dir).rglob("*.pt.trace.json"))
