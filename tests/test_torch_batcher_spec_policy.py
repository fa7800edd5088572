"""The port's speculative policies against the JAX reference batcher,
same weights, float32: the n-gram draft's gate and the adaptive window.

Greedy streams are byte-identical to the reference's with equal drafted
and accepted counts:

- the n-gram draft on the dense pool with the gate's knobs set alike on
  both sides: every dispatch speculating (no floor, no timed rounds),
  and the gate falling back to plain rounds (counted in
  ``fallback_rounds`` and ``serve_spec_fallback_rounds_total``; they
  keep each row's history warm) when every slot's acceptance sits below
  the floor;
- a GQA target (G 4) on the unshared paged pool whose window adapts from
  K 2 to K 8, so the verify's folded rows (K + 1)·G cross 16, where the
  kernel on the card changes route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import paged_attention as pa
from k8s_gpu_tpu_torch.serve import ContinuousBatcher

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT_DIMS = dict(DIMS, n_layers=1, d_model=16, d_ff=32)
SPEC_KEYS = ("drafted", "accepted")

_rng = np.random.default_rng(5)
PREFIX = [(i * 7 + 3) % 60 for i in range(17)]        # 2 pages + a tail
REQUESTS = [
    (PREFIX + _rng.integers(0, 64, 3).tolist(), 12),
    (_rng.integers(0, 64, 5).tolist(), 9),
    (PREFIX + [4, 4, 4, 4], 16),
    (_rng.integers(0, 64, 9).tolist(), 20),
    # A repeating prompt: the n-gram draft finds its matches.
    ([1, 2, 3, 1, 2, 3, 1, 2], 14),
]


def _pair(dims, seed):
    jm = JaxLM(JaxConfig(**dims, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                       device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


TARGET = _pair(DIMS, 0)
DRAFT = _pair(DRAFT_DIMS, 7)


def _draft(kind, jax_side: bool):
    if kind == "ngram":
        return "ngram"
    jm, jp, tm, tp = TARGET if kind == "self" else DRAFT
    return (jm, jp) if jax_side else (tm, tp)


def _always_speculate(b):
    """The n-gram gate's knobs, set alike on both sides: no acceptance
    floor and no timed rounds, so every dispatch speculates."""
    b.ngram_breakeven = 0.0
    b._ngram_next_meas = {"plain": float("inf"), "spec": float("inf")}
    return b


def _drive(b, requests, warm=None):
    b.start()
    try:
        if warm is not None:
            warm(b)
        hs = [b.submit(p, max_new_tokens=n) for p, n in requests]
        return [h.result() for h in hs]
    finally:
        b.stop()


def _make(kind, K, jax_side, **kw):
    jm, jp, tm, tp = TARGET
    if jax_side:
        b = JaxBatcher(jm, jp, slots=3, draft=_draft(kind, True), spec_k=K,
                       metrics=JaxRegistry(), **kw)
    else:
        b = ContinuousBatcher(tm, tp, slots=3, draft=_draft(kind, False),
                              spec_k=K, device="cpu", **kw)
    return _always_speculate(b) if kind == "ngram" else b


def _both(kind, K, requests=REQUESTS, warm=None, **kw):
    jb, tb = _make(kind, K, True, **kw), _make(kind, K, False, **kw)
    return _drive(jb, requests, warm), _drive(tb, requests, warm), jb, tb


def _stats(b):
    return {k: b.spec_stats[k] for k in SPEC_KEYS}


@pytest.mark.parametrize("K", [2, 4])
def test_dense_ngram_streams_match_reference(K):
    ref, got, jb, tb = _both("ngram", K)
    assert got == ref and _stats(tb) == _stats(jb)
    assert tb.spec_stats["accepted"] > 0        # the repeating prompt


def test_ngram_gate_falls_back_below_the_floor():
    """With a floor no slot reaches and no timed rounds, every dispatch
    after the first observations is a plain round: counted in
    ``fallback_rounds`` and ``serve_spec_fallback_rounds_total``, the
    history kept warm by them, and the streams still the reference's."""
    jm, jp, tm, tp = TARGET

    def gate(b):
        b.ngram_breakeven = 1.1
        b.ngram_min_obs = 4
        b._ngram_next_meas = {"plain": float("inf"), "spec": float("inf")}
        return b

    reqs = [(p, 40) for p, _ in REQUESTS[1:4]]
    jb = gate(JaxBatcher(jm, jp, slots=3, draft="ngram", spec_k=2,
                         metrics=JaxRegistry()))
    tb = gate(ContinuousBatcher(tm, tp, slots=3, draft="ngram", spec_k=2,
                                device="cpu"))
    ref, got = _drive(jb, reqs), _drive(tb, reqs)
    assert got == ref
    assert tb.spec_stats["fallback_rounds"] == jb.spec_stats[
        "fallback_rounds"] > 0
    assert _stats(tb) == _stats(jb)
    assert tb.metrics.counter("serve_spec_fallback_rounds_total") == \
        tb.spec_stats["fallback_rounds"]
    assert tb.dispatched["decode_steps"] > 0


def test_gqa_window_adapts_across_sixteen_folded_rows():
    """G 4 on the unshared paged pool (cold admissions prefill the draft,
    so a self-draft accepts everything); with the draft/target byte
    ratio set to 0.02 on both sides the window adapts from 2 to 8, and
    the verify's folded rows go from 12 to 36: on the card the kernel
    leaves the split-K decode route for the tile route there."""
    dims = dict(DIMS, n_heads=8, n_kv_heads=2, d_head=4, max_seq=128)
    jm, jp, tm, tp = _pair(dims, 3)
    reqs = [(_rng.integers(0, 64, 6).tolist(), 100) for _ in range(8)]
    kw = dict(slots=3, spec_k=2, paged_blocks=64, page_size=8,
              prefix_cache=False, attn_impl="paged_kernel")
    jb = JaxBatcher(jm, jp, draft=(jm, jp), metrics=JaxRegistry(), **kw)
    tb = ContinuousBatcher(tm, tp, draft=(tm, tp), device="cpu", **kw)
    for b in (jb, tb):
        b._draft_ratio = 0.02
    ref, got = _drive(jb, reqs), _drive(tb, reqs)
    assert got == ref and _stats(tb) == _stats(jb)
    assert tb._spec_k_active == jb._spec_k_active == 8
    routes = [pa.plan((3, k + 1, 8, 128), torch.float32, 2, page=8,
                      t_hi=128, n_sms=132).design for k in (2, 8)]
    assert routes == ["cuda-splitk", "cuda-fma"]
