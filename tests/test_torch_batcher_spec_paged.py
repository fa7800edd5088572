"""The port's speculative continuous batcher on the paged KV pool and the
n-gram draft against the JAX reference batcher, same weights, float32.

Greedy streams are byte-identical to the reference's with equal drafted
and accepted counts:

- the paged pool read by gather and by the paged kernel's plain version
  (what the kernel computes on the card), with a random draft, a
  self-draft and the n-gram draft (its gate's knobs set alike on both
  sides, so every dispatch speculates; on gather in the migration case);
- a chain moved by a migration export and import: the request admitted
  onto the imported blocks (``paged_shared``) seats a zeroed draft row
  and a history built from its prompt.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import migrate as jmig
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher
from k8s_gpu_tpu_torch.serve import migrate as tmig

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT_DIMS = dict(DIMS, n_layers=1, d_model=16, d_ff=32)
PAGE = 8
BLOCKS = 40
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


def _warm_prefix(b):
    """Register PREFIX's full pages first: the batch then shares them."""
    b.submit(PREFIX + [9], max_new_tokens=2).result()


@pytest.mark.parametrize("kind,K,impl", [
    ("random", 2, "gather"), ("self", 4, "paged_kernel"),
    ("ngram", 2, "paged_kernel"),
])
def test_paged_spec_streams_match_reference(kind, K, impl):
    ref, got, jb, tb = _both(kind, K, warm=_warm_prefix,
                             paged_blocks=BLOCKS, page_size=PAGE,
                             attn_impl=impl)
    assert got == ref
    assert [len(s) for s in got] == [n for _, n in REQUESTS]
    assert _stats(tb) == _stats(jb) and tb.spec_stats["drafted"] > 0
    assert tb.admission_paths["paged_shared"] == 2
    assert tb.spec_stats["fallback_rounds"] == 0
    assert sorted(tb._pool.allocatable_blocks()) == list(range(1, BLOCKS))


def test_migrated_chain_admits_with_a_zeroed_draft():
    """PREFIX's chain, served and exported by a plain port batcher,
    imported by a spec batcher on each side; the request admitted onto
    the imported blocks speculates from a zeroed draft row (neural) or
    a prompt-built history (n-gram)."""
    jm, jp, tm, tp = TARGET
    src = ContinuousBatcher(tm, tp, slots=3, paged_blocks=BLOCKS,
                            page_size=PAGE, device="cpu").start()
    try:
        src.submit(PREFIX + [9], max_new_tokens=2).result()
        payload = json.loads(json.dumps(tmig.pack(src.run_quiesced(
            src.migrate_export))))
    finally:
        src.stop()
    assert len(payload["blocks"]) == 2
    reqs = [(PREFIX + [5, 6], 14), (PREFIX + [7], 10)]
    for kind in ("random", "ngram"):
        jb = _make(kind, 3, True, paged_blocks=BLOCKS, page_size=PAGE)
        tb = _make(kind, 3, False, paged_blocks=BLOCKS, page_size=PAGE)

        def load(b, unpack):
            assert b.run_quiesced(
                lambda: b.migrate_import(unpack(payload))) == 2

        ref = _drive(jb, reqs, lambda b: load(b, jmig.unpack))
        got = _drive(tb, reqs, lambda b: load(b, tmig.unpack))
        assert got == ref and _stats(tb) == _stats(jb)
        assert tb.admission_paths == {"paged_shared": 2}
