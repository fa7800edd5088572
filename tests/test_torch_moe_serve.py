"""The port serving a Switch top-1 MoE model against the JAX reference
batcher, on the CPU at float32, same weights.

Greedy streams are byte-identical to the reference's for concurrent
requests of mixed lengths at a capacity that binds in prefill (so a row
admitted with other widths or rows beside it would drop other tokens):
on the dense pool (``cold_fused`` and ``cold``) and on the paged pool
(every admission ``cold``: MoE shares no blocks) through the gather read
and through the paged route's plain version; with the admission paths
the reference counts.  Also byte-identical: left-padded generation,
speculative decoding with an MoE target (a self-draft on the dense pool,
n-gram on the paged pool, equal drafted and accepted counts), and the
disaggregated prefill pool with ``chunk_tokens`` set, which an MoE model
must ignore (whole-prompt prefill on both decode sides).  Prefix caching
is refused on both pools with the reference's message, and ``/precache``
answers it with a 400.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import DisaggregatedLm as JaxDisagg
from k8s_gpu_tpu.serve import InferenceEngine as JaxEngine
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import paged_attention as pa
from k8s_gpu_tpu_torch.serve import (
    ContinuousBatcher, DisaggregatedLm, InferenceEngine, LmServer,
)

torch.set_num_threads(1)

# capacity_factor 1.0: a prefill's fullest expert overflows its share.
DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64, num_experts=4,
            capacity_factor=1.0)
PAGE = 8
BLOCKS = 40
PATHS = ("cold", "cold_fused", "prefix_exact", "prefix_suffix",
         "paged_cold", "paged_shared", "precomputed")

_rng = np.random.default_rng(17)
SOLO = (_rng.integers(0, 64, 9).tolist(), 10)
# (prompt, max_new), queued together before the scheduler starts; three
# slots, so rows of buckets 8, 16 and 32 prefill beside running rows.
REQUESTS = [
    (_rng.integers(0, 64, 5).tolist(), 7),
    (_rng.integers(0, 64, 12).tolist(), 12),
    (_rng.integers(0, 64, 30).tolist(), 14),
    (_rng.integers(0, 64, 17).tolist(), 9),
    (_rng.integers(0, 64, 3).tolist(), 4),
]

JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def _pool(paged: bool, impl: str = "gather") -> dict:
    return (dict(paged_blocks=BLOCKS, page_size=PAGE, attn_impl=impl)
            if paged else {})


def _drive(make):
    """A solo request on an idle batcher; then, on a second batcher, every
    request queued before its scheduler starts."""
    a = make().start()
    try:
        out = [a.submit(*SOLO[:1], max_new_tokens=SOLO[1]).result()]
    finally:
        a.stop()
    b = make()
    hs = [b.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    b.start()
    try:
        out += [h.result() for h in hs]
    finally:
        b.stop()
    return out, b


_REF = {}


def _reference(paged: bool):
    if paged not in _REF:
        metrics = JaxRegistry()
        streams, _ = _drive(lambda: JaxBatcher(JM, JP, slots=3,
                                               metrics=metrics,
                                               **_pool(paged)))
        paths = {p: int(metrics.counter("serve_admissions_total", path=p))
                 for p in PATHS}
        _REF[paged] = streams, {p: n for p, n in paths.items() if n}
    return _REF[paged]


def _count_drops(monkeypatch) -> list:
    """Real tokens each capped MoE call of the port dropped."""
    drops, moe = [], TM._moe_mlp

    def counting(x, lp, full_capacity=False, token_mask=None, **kw):
        y, aux = moe(x, lp, full_capacity=full_capacity,
                     token_mask=token_mask, **kw)
        if not full_capacity:
            live = (torch.ones(x.shape[:2], dtype=torch.bool)
                    if token_mask is None else token_mask)
            drops.append(int(((y == 0).all(-1) & live).sum()))
        return y, aux

    monkeypatch.setattr(TM, "_moe_mlp", counting)
    return drops


@pytest.mark.parametrize("paged,impl", [
    (False, "gather"), (True, "gather"), (True, "paged_kernel"),
])
def test_streams_match_reference(monkeypatch, paged, impl):
    ref, ref_paths = _reference(paged)
    drops = _count_drops(monkeypatch)
    pa.reset_counts()
    got, b = _drive(lambda: ContinuousBatcher(TM, TP, slots=3, device="cpu",
                                              **_pool(paged, impl)))
    assert got == ref
    assert [len(s) for s in got] == [SOLO[1]] + [n for _, n in REQUESTS]
    # The reference counts the solo batcher's admission too.
    paths = {"cold": len(REQUESTS)}
    paths["cold" if paged else "cold_fused"] = (
        paths["cold"] + 1 if paged else 1)
    assert ref_paths == paths
    assert dict(b.admission_paths) == {"cold": len(REQUESTS)}
    assert sum(drops) > 0                  # capacity bound in prefill
    assert pa.fallback_count == 0
    if paged:
        assert sorted(b._pool.allocatable_blocks()) == list(
            range(1, BLOCKS))


def test_left_padded_generation_matches_reference():
    """Padding takes no expert capacity: a left-padded batch gives the
    unpadded stream (capacity high enough never to bind, as the
    reference's own test sets it) and the reference's."""
    jm = JaxLM(JaxConfig(**dict(DIMS, capacity_factor=8.0), use_flash=False,
                         dtype=jnp.float32))
    tm = TransformerLM(TransformerConfig(**dict(DIMS, capacity_factor=8.0),
                                         dtype=torch.float32), device="cpu")
    prompt = _rng.integers(0, 64, (2, 6)).astype(np.int32)
    padded = np.concatenate([np.zeros((2, 10), np.int32), prompt], axis=1)
    ref = JaxEngine(jm).generate(JP, jnp.asarray(padded), max_new_tokens=5,
                                 pad_left=10)
    eng = InferenceEngine(tm, device="cpu")
    got = eng.generate(TP, torch.from_numpy(padded), max_new_tokens=5,
                       pad_left=10)
    plain = eng.generate(TP, torch.from_numpy(prompt), max_new_tokens=5)
    assert got.tokens.tolist() == np.asarray(ref.tokens).tolist()
    assert got.tokens.tolist() == plain.tokens.tolist()


def _always_speculate(b):
    """The n-gram gate's knobs, set alike on both sides: every dispatch
    speculates."""
    b.ngram_breakeven = 0.0
    b._ngram_next_meas = {"plain": float("inf"), "spec": float("inf")}
    return b


def _spec_run(b, requests):
    hs = [b.submit(p, max_new_tokens=n) for p, n in requests]
    b.start()
    try:
        return [h.result() for h in hs]
    finally:
        b.stop()


@pytest.mark.parametrize("draft,paged,impl", [
    ("self", False, "gather"), ("ngram", True, "paged_kernel"),
])
def test_spec_with_moe_target_matches_reference(draft, paged, impl):
    """The verify window routes at full capacity, as the width-1 decodes
    it stands in for: spec streams equal plain ones and the reference's,
    with equal drafted and accepted counts."""
    requests = [([5, 9, 17], 8)] + REQUESTS[:3]
    if paged:
        # Repeating prompts give the n-gram draft something to match.
        requests = [([3, 4, 5, 6] * 4, 12), ([7, 1, 7, 1] * 3, 10)]
    jd = "ngram" if draft == "ngram" else (JM, JP)
    td = "ngram" if draft == "ngram" else (TM, TP)
    ref_b = JaxBatcher(JM, JP, slots=3, draft=jd, spec_k=3,
                       metrics=JaxRegistry(), **_pool(paged))
    got_b = ContinuousBatcher(TM, TP, slots=3, draft=td, spec_k=3,
                              device="cpu", **_pool(paged, impl))
    if draft == "ngram":
        _always_speculate(ref_b)
        _always_speculate(got_b)
    ref = _spec_run(ref_b, requests)
    got = _spec_run(got_b, requests)
    plain = _spec_run(ContinuousBatcher(TM, TP, slots=3, device="cpu",
                                        **_pool(paged, impl)), requests)
    assert got == ref == plain
    stats = ("drafted", "accepted")
    assert ({k: got_b.spec_stats[k] for k in stats}
            == {k: ref_b.spec_stats[k] for k in stats})
    assert got_b.spec_stats["drafted"] > 0
    if draft == "self":
        assert got_b.spec_stats["acceptance"] > 0.5


def _refusal(make) -> str:
    with pytest.raises(ValueError, match="MoE") as e:
        make().precache_prefix(list(range(1, 20)))
    return str(e.value)


@pytest.mark.parametrize("paged", [False, True])
def test_precache_refused_as_the_reference_refuses(paged):
    ref = _refusal(lambda: JaxBatcher(JM, JP, slots=2, **_pool(paged)))
    assert _refusal(lambda: ContinuousBatcher(
        TM, TP, slots=2, device="cpu", **_pool(paged))) == ref


def test_precache_endpoint_answers_the_refusal():
    tok = BpeTokenizer.train(b"the experts route every token " * 30,
                             vocab_size=DIMS["vocab_size"] + 256 - 64)
    cfg = TransformerConfig(**dict(DIMS, vocab_size=tok.vocab_size),
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    srv = LmServer(model, model.init(0), tok, slots=2, **_pool(True),
                   device="cpu").start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/precache",
            data=json.dumps({"prompt": "the experts route"}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
        assert "MoE" in json.loads(e.value.read())["error"]
    finally:
        srv.stop()


def _disagg_run(b, d, requests):
    b.start()
    d.start()
    try:
        hs = [d.submit(p, max_new_tokens=n) for p, n in requests]
        return [h.result() for h in hs]
    finally:
        d.stop()
        b.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_disagg_takes_the_whole_prompt_path(monkeypatch, paged):
    """With ``chunk_tokens`` set (and, on a paged decode side, exact-page
    prefill available) an MoE model still prefills the whole left-padded
    prompt, as the reference does: the handed-over streams are the
    reference's."""
    requests = REQUESTS[:4]
    jb = JaxBatcher(JM, JP, slots=3, metrics=JaxRegistry(), **_pool(paged))
    ref = _disagg_run(jb, JaxDisagg(JM, JP, batcher=jb, chunk_tokens=8),
                      requests)
    b = ContinuousBatcher(TM, TP, slots=3, device="cpu", **_pool(paged))
    d = DisaggregatedLm(TM, TP, batcher=b, chunk_tokens=8)

    def refuse(*args, **kw):
        raise AssertionError("an MoE prompt took a chunked or exact prefill")

    monkeypatch.setattr(d, "_prefill_chunked", refuse)
    monkeypatch.setattr(d, "_prefill_exact", refuse)
    got = _disagg_run(b, d, requests)
    assert got == ref
    assert dict(b.admission_paths) == {"precomputed": len(requests)}
