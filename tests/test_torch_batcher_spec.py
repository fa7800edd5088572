"""The port's speculative continuous batcher on the dense KV pool against
the JAX reference batcher, same weights, float32.

Greedy streams are byte-identical to the reference's, with equal drafted
and accepted counts (``spec_stats``), for a random draft (spec_k 2 and
4), a perfect self-draft (acceptance 1.0) and an int8 draft; and on the
prefix admissions, which seat a zeroed draft row (``prefix_exact``,
``prefix_suffix`` after ``precache_prefix``), with EOS inside an
accepted window and a budget shorter than one window.  Each request's
journal record carries its drafted and accepted counts.  Seeded sampled
rows keep their streams whatever their co-tenants.  ``LmServer(draft=,
spec_k=)`` serves speculatively over HTTP.  A ``gpu`` test repeats a
paged spec batcher on the card through the paged kernel: one launch a
layer for every kernel admission and verify sub-round, no fall-back.
"""

import json
import urllib.request

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
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT_DIMS = dict(DIMS, n_layers=1, d_model=16, d_ff=32)
SPEC_KEYS = ("drafted", "accepted")

_rng = np.random.default_rng(11)
PREFIX = _rng.integers(0, 64, 12).tolist()
# (prompt, max_new), queued together before the scheduler starts; three
# slots, so the first rounds run with admissions pending.
REQUESTS = [
    (_rng.integers(0, 64, 5).tolist(), 9),
    (_rng.integers(0, 64, 12).tolist(), 14),
    (_rng.integers(0, 64, 7).tolist(), 20),
    (_rng.integers(0, 64, 3).tolist(), 2),
    (_rng.integers(0, 64, 9).tolist(), 11),
]


def _pair(dims, seed):
    jm = JaxLM(JaxConfig(**dims, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                       device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


TARGET = _pair(DIMS, 0)
DRAFT = _pair(DRAFT_DIMS, 7)


def _drafts(kind):
    """(reference draft, port draft, draft_int8) of a kind."""
    jm, jp, tm, tp = TARGET if kind == "self" else DRAFT
    return (jm, jp), (tm, tp), kind == "int8"


def _drive(b, requests, precache=None):
    if precache is not None:
        b.precache_prefix(precache)
    hs = [b.submit(p, max_new_tokens=n) for p, n in requests]
    b.start()
    try:
        return [h.result() for h in hs]
    finally:
        b.stop()


def _both(kind, K, requests=REQUESTS, precache=None, **kw):
    """The same requests through the reference and the port batcher with
    the same draft: (reference streams, port streams, reference batcher,
    port batcher)."""
    jdraft, tdraft, int8 = _drafts(kind)
    jm, jp, tm, tp = TARGET
    jb = JaxBatcher(jm, jp, slots=3, draft=jdraft, spec_k=K,
                    draft_int8=int8, metrics=JaxRegistry(), **kw)
    tb = ContinuousBatcher(tm, tp, slots=3, draft=tdraft, spec_k=K,
                           draft_int8=int8, device="cpu", **kw)
    return (_drive(jb, requests, precache), _drive(tb, requests, precache),
            jb, tb)


def _stats(b):
    return {k: b.spec_stats[k] for k in SPEC_KEYS}


@pytest.mark.parametrize("kind,K", [("random", 2), ("random", 4),
                                    ("self", 4), ("int8", 4)])
def test_dense_spec_streams_match_reference(kind, K):
    ref, got, jb, tb = _both(kind, K)
    assert got == ref
    assert [len(s) for s in got] == [n for _, n in REQUESTS]
    assert _stats(tb) == _stats(jb) and tb.spec_stats["drafted"] > 0
    if kind == "self":
        assert tb.spec_stats["acceptance"] == 1.0
    assert tb._spec_k_active == jb._spec_k_active
    assert tb.admission_paths == {"cold": len(REQUESTS)}
    assert tb.dispatched["verify_subrounds"] > 0
    assert "decode_steps" not in tb.dispatched
    records = tb.journal.snapshot()
    assert len(records) == len(REQUESTS)
    assert sum(r["spec_drafted"] for r in records) == _stats(tb)["drafted"]
    assert sum(r["spec_accepted"] for r in records) == _stats(tb)[
        "accepted"]


def test_prefix_admissions_eos_and_budget_match_reference():
    """A self-draft on the prefix paths: ``prefix_exact`` and
    ``prefix_suffix`` seat a zeroed draft row (the draft re-warms from
    the stream), EOS retires a row inside an accepted window, and a
    2-token budget clips a 4-token window."""
    jm, jp, tm, tp = TARGET
    plain = JaxBatcher(jm, jp, slots=3)
    base = _drive(plain, [(PREFIX + [5, 6], 12)])[0]
    eos = base[5]
    reqs = [(PREFIX, 10), (PREFIX + [5, 6], 12), (REQUESTS[2][0], 2),
            (REQUESTS[1][0], 9)]
    ref, got, jb, tb = _both("self", 3, reqs, precache=PREFIX, eos_id=eos)
    assert got == ref
    assert got[1] == base[:base.index(eos)]
    assert len(got[2]) == 2
    assert _stats(tb) == _stats(jb)
    assert tb.admission_paths["prefix_exact"] == 1
    assert tb.admission_paths["prefix_suffix"] == 1
    assert tb.spec_stats["acceptance"] < 1.0   # the zeroed rows re-warm


def test_seeded_sampled_rows_keep_their_streams():
    """A seeded sampled row draws from its own generator: alone or beside
    a greedy and another sampled co-tenant, on a random or a self draft,
    its stream is the same."""
    jm, jp, tm, tp = TARGET
    for draft in (DRAFT[2:], (tm, tp)):
        def run(extra):
            b = ContinuousBatcher(tm, tp, slots=3, draft=draft, spec_k=3,
                                  device="cpu")
            hs = [b.submit(REQUESTS[1][0], max_new_tokens=16,
                           temperature=0.9, top_p=0.8, seed=42)]
            hs += [b.submit(p, max_new_tokens=n, **kw) for p, n, kw in extra]
            b.start()
            try:
                return [h.result() for h in hs]
            finally:
                b.stop()

        alone = run([])[0]
        crowd = run([(REQUESTS[0][0], 12, {}),
                     (REQUESTS[2][0], 20, dict(temperature=1.2, seed=3))])
        assert crowd[0] == alone and len(alone) == 16


def test_draft_option_checks():
    jm, jp, tm, tp = TARGET
    with pytest.raises(ValueError, match="vocabulary"):
        other = TransformerLM(TransformerConfig(
            **dict(DRAFT_DIMS, vocab_size=32), dtype=torch.float32),
            device="cpu")
        ContinuousBatcher(tm, tp, draft=(other, other.init(0)),
                          device="cpu")
    with pytest.raises(ValueError, match="draft mode"):
        ContinuousBatcher(tm, tp, draft="bigram", device="cpu")
    with pytest.raises(ValueError, match="ConstraintBank"):
        ContinuousBatcher(tm, tp, draft="ngram", constraints=object(),
                          device="cpu")
    b = ContinuousBatcher(tm, tp, draft=DRAFT[2:], draft_int8=True,
                          device="cpu")
    assert b._dev["d_cache"]["k"].dtype == torch.float32
    assert b.draft_params["blocks"]["wq"]["q"].dtype == torch.int8
    assert 0.0 < b._draft_ratio < 1.0


CORPUS = "the cat sat on the mat. the dog sat on the log. " * 40


def test_server_passes_draft_through():
    tok = BpeTokenizer.train(CORPUS, vocab_size=300)
    cfg = TransformerConfig(vocab_size=tok.vocab_size, d_model=32,
                            n_layers=1, n_heads=2, d_head=16, d_ff=64,
                            max_seq=64, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    params = model.init(0)
    srv = LmServer(model, params, tok, slots=2, draft="ngram", spec_k=2,
                   device="cpu").start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": "the cat sat on the mat. the cat",
                             "max_new_tokens": 12}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    assert body["generated_tokens"] == 12
    assert srv.batcher.spec_mode == "ngram" and srv.batcher.spec_k == 2
    assert srv.batcher.spec_stats["drafted"] > 0


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged kernel has no CPU mode "
                    "(chip_smoke.py phase 4e drives it at full size)")
    return torch.device("cuda")


GPU_DIMS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                d_head=64, n_kv_heads=1, d_ff=128, max_seq=128)


@pytest.mark.gpu
@pytest.mark.parametrize("draft", ["ngram", "neural", "int8"])
def test_cuda_spec_batcher_counts_its_kernel_launches(cuda, draft):
    """float32 on the card, the paged pool with the paged kernel: greedy
    streams equal the reference's, and the kernel launched exactly once a
    layer for every kernel admission and every verify sub-round (the
    neural draft's cache is dense: no paged launch), with no fall-back
    (``torch._int_mm`` carries the int8 draft's products)."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa
    from k8s_gpu_tpu_torch.serve import quant

    jm = JaxLM(JaxConfig(**GPU_DIMS, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = TransformerLM(TransformerConfig(**GPU_DIMS, dtype=torch.float32),
                       device=cuda)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cuda)
    ddims = dict(GPU_DIMS, n_layers=1)
    jd = JaxLM(JaxConfig(**ddims, use_flash=False, dtype=jnp.float32))
    jdp = jd.init(jax.random.PRNGKey(2))
    td = TransformerLM(TransformerConfig(**ddims, dtype=torch.float32),
                       device=cuda)
    tdp = params_from_numpy(jax.tree.map(np.asarray, jdp), cuda)
    reqs = [(_rng.integers(0, 64, n).tolist(), m)
            for n, m in ((40, 30), (5, 20), (70, 8), (17, 40))]
    kw = dict(paged_blocks=40, page_size=16, spec_k=4,
              draft_int8=draft == "int8")
    ref = _drive(JaxBatcher(jm, jp, slots=2, metrics=JaxRegistry(),
                            draft="ngram" if draft == "ngram" else (jd, jdp),
                            **kw), reqs)
    pa.reset_counts()
    quant.reset_counts()
    b = ContinuousBatcher(tm, tp, slots=2, attn_impl="paged_kernel",
                          draft="ngram" if draft == "ngram" else (td, tdp),
                          device=cuda, **kw)
    if draft == "ngram":
        for t in (b,):
            t.ngram_breakeven = 0.0
            t._ngram_next_meas = {"plain": float("inf"),
                                  "spec": float("inf")}
    got = _drive(b, reqs)
    assert got == ref
    admits = b.admission_paths["paged_cold"] + b.admission_paths[
        "paged_shared"]
    work = (admits + b.dispatched["verify_subrounds"]
            + b.dispatched["decode_steps"])
    assert pa.fallback_count == 0
    assert pa.launch_count == GPU_DIMS["n_layers"] * work
    assert b.dispatched["verify_subrounds"] > 0
    assert (quant.launch_count > 0) == (draft == "int8")


@pytest.mark.gpu
def test_cuda_gqa_verify_windows_cross_sixteen_rows(cuda):
    """float32 on the card, G 4, the unshared paged pool through the
    kernel, a self-draft with the draft/target byte ratio set to 0.02 on
    both sides: the window adapts from K 2 to K 8, so the verify's folded
    rows go from 12 (the split-K route) to 36 (the CUDA-core tile
    route); the streams stay the reference's and every verify sub-round
    is one launch a layer."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    dims = dict(GPU_DIMS, n_heads=4, n_kv_heads=1)
    jm = JaxLM(JaxConfig(**dims, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                       device=cuda)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cuda)
    reqs = [(_rng.integers(0, 64, 6).tolist(), 100) for _ in range(8)]
    kw = dict(slots=3, spec_k=2, paged_blocks=64, page_size=16,
              prefix_cache=False)
    jb = JaxBatcher(jm, jp, draft=(jm, jp), metrics=JaxRegistry(), **kw)
    tb = ContinuousBatcher(tm, tp, draft=(tm, tp), attn_impl="paged_kernel",
                           device=cuda, **kw)
    for b in (jb, tb):
        b._draft_ratio = 0.02
    ref = _drive(jb, reqs)
    pa.reset_counts()
    got = _drive(tb, reqs)
    assert got == ref and _stats(tb) == _stats(jb)
    assert tb._spec_k_active == 8
    assert [pa.plan((3, k + 1, 4, 64), torch.float32, 1, page=16, t_hi=128,
                    n_sms=pa.sm_count(cuda)).design for k in (2, 8)] == [
        "cuda-splitk", "cuda-fma"]
    assert pa.fallback_count == 0
    assert pa.launch_count == dims["n_layers"] * (
        tb.dispatched["verify_subrounds"] + tb.dispatched["decode_steps"])
