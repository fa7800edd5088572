"""Host cost of the serving plane's observability on one GPU.

    python3 tools/torch_obs_cost.py [--micro] [--serve N] [--stub]
                                    [--json PATH]

The batcher's phase profiler is always on, and every HTTP request to
``LmServer`` records spans; serving is host-bound, so each of their
calls adds host time to a round.  ``--micro`` times, on this host,
each operation the scheduler thread adds a round: a phase push and pop
(with its histogram sample), ``export_shares`` and a span's
``add_span`` (microseconds a call, 20,000 calls).  ``--serve N`` runs
``chip_smoke.py``'s phase 4 burst N times in this process and counts
those operations in it (phase samples, spans, share exports), so their
cost a burst is the counts times the microseconds.  ``--stub`` runs the
bursts with the profiler's recording and the tracer's ``add_span``
replaced by no-ops: a diagnostic of what they cost end to end, never
the shipped path (compare it in one call with ``tools/
torch_paged_check.py --tree ... --serve 1`` on this tree and its
parent, in turns).  Runs on the card and raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CALLS = 20_000
PHASES = ("admission", "paged_plan", "prefill_dispatch", "decode_dispatch",
          "decode_consume", "spec_draft", "spec_verify", "retire")


def _per_call_us(fn, n: int = CALLS) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def micro() -> dict:
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry
    from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler
    from k8s_gpu_tpu_torch.utils.tracing import (
        SpanContext, Tracer, new_span_id, new_trace_id,
    )

    prof = PhaseProfiler(plane="serve", registry=MetricsRegistry())

    def phase():
        prof.push("decode_dispatch")
        prof.pop()

    tracer = Tracer(registry=MetricsRegistry())
    ctx = SpanContext(new_trace_id(), new_span_id())
    t = time.monotonic()
    return {
        "phase_push_pop_us": _per_call_us(phase),
        "export_shares_us": _per_call_us(prof.export_shares),
        "add_span_us": _per_call_us(lambda: tracer.add_span(
            "serve.round", parent=ctx, start=t, end=t, round=1, tokens=8)),
    }


def _stub() -> None:
    """No-op recording: phases, share exports and added spans."""
    from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler
    from k8s_gpu_tpu_torch.utils.tracing import Tracer

    PhaseProfiler.push = lambda self, name: None
    PhaseProfiler.pop = lambda self: 0.0
    PhaseProfiler.export_shares = lambda self: None
    Tracer.add_span = lambda self, name, /, parent=None, **kw: parent


def serve(n: int, stub: bool) -> dict:
    import torch

    import chip_smoke
    from k8s_gpu_tpu_torch.ops import _build
    from k8s_gpu_tpu_torch.utils.metrics import global_metrics
    from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler

    if not torch.cuda.is_available():
        raise RuntimeError("torch_obs_cost: CUDA is not available")
    _build.load("paged_attention")
    if stub:
        _stub()
    exports = [0]
    export = PhaseProfiler.export_shares

    def counted(self):
        exports[0] += 1
        return export(self)

    PhaseProfiler.export_shares = counted
    spans0 = global_metrics.counter("tracing_spans_total")
    runs = [chip_smoke.run_main_path(torch, 0, chip_smoke.LAYERS)
            for _ in range(n)]
    samples = {}
    for ph in PHASES:
        h = global_metrics.histogram("serve_phase_seconds", phase=ph)
        if h is not None:
            samples[ph] = h.n
    return {
        "stub": stub,
        "tokens_per_s": [r["tokens_per_s"] for r in runs],
        "wall_s": [r["wall_s"] for r in runs],
        "rounds": [r["rounds"] for r in runs],
        "phase_samples": samples,
        "share_exports": exports[0],
        "spans": global_metrics.counter("tracing_spans_total") - spans0,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="N")
    ap.add_argument("--stub", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    import chip_smoke

    out = {"gpu": chip_smoke.gpu_line()}
    if args.micro:
        out["micro"] = micro()
    if args.serve:
        out["serve"] = serve(args.serve, args.stub)
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
