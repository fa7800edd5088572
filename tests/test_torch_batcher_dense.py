"""The port's ContinuousBatcher on the dense KV pool (its default) and on
the unshared paged pool (``prefix_cache=False``) against the JAX
reference batcher, same weights, float32.

Greedy streams must be byte-identical for concurrent requests of mixed
lengths, MHA and GQA, with ``kv_quant`` off and on, on every admission
path: ``cold``, ``cold_fused`` (a solo request on an idle batcher),
``prefix_exact`` and ``prefix_suffix`` (after ``precache_prefix``), and
the paged pool's left-padded splice.  Greedy logprobs agree to atol 1e-4
(1e-3 with an int8 pool: where the two frameworks' float32 K/V straddle
a rounding boundary the int8 values differ by one step).  The port's
admission counts equal the reference's ``serve_admissions_total``.  Two
``gpu`` tests repeat the dense pool and the unshared paged pool (through
the paged kernel) on the card in float32.
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
from k8s_gpu_tpu.utils.metrics import MetricsRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=64)
HEADS = {"gqa": 2, "mha": 0}
PAGE = 8
BLOCKS = 40
PATHS = ("cold", "cold_fused", "prefix_exact", "prefix_suffix",
         "paged_cold", "paged_shared")

_rng = np.random.default_rng(3)
PREFIX = _rng.integers(0, 64, 20).tolist()
SOLO = (_rng.integers(0, 64, 9).tolist(), 11)
# (prompt, max_new), submitted together.  The 17-token prompt sits in the
# 32 bucket: its left pad of 15 is more than a page of 8.
REQUESTS = [
    (_rng.integers(0, 64, 5).tolist(), 7),
    (_rng.integers(0, 64, 12).tolist(), 12),
    (_rng.integers(0, 64, 30).tolist(), 20),
    (_rng.integers(0, 64, 17).tolist(), 9),
    (_rng.integers(0, 64, 3).tolist(), 4),
    (PREFIX + _rng.integers(0, 64, 4).tolist(), 9),
    (PREFIX, 6),
]

_MODELS = {}


def _models(heads: str):
    """(JAX model, JAX params, port model, port params), one set a head
    layout, the same weights on both sides."""
    if heads not in _MODELS:
        dims = dict(DIMS, n_kv_heads=HEADS[heads])
        jm = JaxLM(JaxConfig(**dims, use_flash=False, dtype=jnp.float32))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                           device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[heads] = (jm, jp, tm, tp)
    return _MODELS[heads]


def _drive(make, precache: bool):
    """A solo request on an idle batcher; then, on a second batcher, every
    request queued at once (after precaching the prefix) before its
    scheduler starts, so no admission of the batch is solo.  Returns the
    streams, their logprobs and the two batchers."""
    a = make().start()
    try:
        solo = a.submit(SOLO[0], max_new_tokens=SOLO[1])
        out, lps = [solo.result()], [solo.logprobs]
    finally:
        a.stop()
    b = make()
    if b.paged:
        b.start()            # the paged precache rides a generation
    if precache:
        b.precache_prefix(PREFIX)
    hs = [b.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    if not b.paged:
        b.start()
    try:
        out += [h.result() for h in hs]
        lps += [h.logprobs for h in hs]
    finally:
        b.stop()
    return out, lps, (a, b)


def _reference(heads, precache=True, **kw):
    jm, jp, _, _ = _models(heads)
    metrics = MetricsRegistry()
    streams, lps, _ = _drive(lambda: JaxBatcher(
        jm, jp, slots=3, logprobs=True, metrics=metrics, **kw), precache)
    paths = {p: int(metrics.counter("serve_admissions_total", path=p))
             for p in PATHS}
    return streams, lps, {p: n for p, n in paths.items() if n}


def _port(heads, precache=True, **kw):
    _, _, tm, tp = _models(heads)
    streams, lps, (a, b) = _drive(lambda: ContinuousBatcher(
        tm, tp, slots=3, logprobs=True, device="cpu", **kw), precache)
    return streams, lps, dict(a.admission_paths + b.admission_paths), b


def _assert_same(ref, got, atol):
    assert got[0] == ref[0]
    assert [len(s) for s in got[0]] == [SOLO[1]] + [n for _, n in REQUESTS]
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a, b, atol=atol)
    assert got[2] == ref[2]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("heads", ["gqa", "mha"])
def test_dense_pool_matches_reference_on_every_path(heads, kv_quant):
    ref = _reference(heads, kv_quant=kv_quant)
    got = _port(heads, kv_quant=kv_quant)
    _assert_same(ref, got, 1e-3 if kv_quant else 1e-4)
    paths = got[2]
    assert paths["cold_fused"] == 1 and paths["prefix_exact"] == 1
    assert paths["prefix_suffix"] == 1 and paths["cold"] == 5


def test_prefix_cache_off_prefills_every_prompt_cold():
    ref = _reference("gqa", prefix_cache=False)
    got = _port("gqa", prefix_cache=False)
    _assert_same(ref, got, 1e-4)
    assert got[2] == {"cold_fused": 1, "cold": len(REQUESTS)}


@pytest.mark.parametrize("impl", ["gather", "paged_kernel"])
@pytest.mark.parametrize("heads", ["gqa", "mha"])
def test_unshared_paged_pool_matches_reference(heads, impl):
    """Every admission a left-padded prefill spliced into fresh blocks;
    decode then reads from kv_start = pad, with RoPE positions behind the
    cache positions.  The reference's kernel runs as its own tests run it
    on the CPU."""
    kw = dict(paged_blocks=BLOCKS, page_size=PAGE, prefix_cache=False,
              attn_impl=impl)
    ref = _reference(heads, precache=False, **kw)
    got = _port(heads, precache=False, **kw)
    _assert_same(ref, got, 1e-4)
    assert got[2] == {"cold": 1 + len(REQUESTS)}
    assert sorted(got[3]._free_blocks) == list(range(1, BLOCKS))


def test_paged_precache_warms_the_block_cache():
    """Paged precache is a throwaway one-token generation: the prefix's
    full pages are then shared by the prompts that start with it."""
    kw = dict(paged_blocks=BLOCKS, page_size=PAGE)
    ref = _reference("gqa", **kw)
    got = _port("gqa", **kw)
    _assert_same(ref, got, 1e-4)
    assert got[2]["paged_shared"] == 2


def test_fused_cold_start_equals_the_unfused_admission():
    """A solo request on an idle batcher takes one dispatch for its
    admission and first round; the same request queued beside another
    takes the plain cold admission.  Greedy and seeded sampled streams
    are the same both ways (the slot's generator takes the same draws)."""
    _, _, tm, tp = _models("gqa")
    for kw in (dict(), dict(temperature=0.8, top_p=0.9, seed=4)):
        a = ContinuousBatcher(tm, tp, slots=3, device="cpu").start()
        try:
            fused = a.submit(SOLO[0], max_new_tokens=20, **kw).result()
        finally:
            a.stop()
        b = ContinuousBatcher(tm, tp, slots=3, device="cpu")
        other = b.submit(REQUESTS[2][0], max_new_tokens=40)
        h = b.submit(SOLO[0], max_new_tokens=20, **kw)
        b.start()
        try:
            plain = h.result()
            other.result()
        finally:
            b.stop()
        assert fused == plain and len(fused) == 20
        assert a.admission_paths == {"cold_fused": 1}
        assert b.admission_paths == {"cold": 2}


def test_rounds_past_max_seq_drop_their_writes():
    """Rows that run past max_seq (a retired row's garbage steps, a solo
    round sized past the budget) write nowhere: no error, and every
    stream equals the reference's."""
    jm, jp, tm, tp = _models("gqa")
    # 40 tokens sit in the 48 bucket: 16 positions of room, and a 15-token
    # budget's solo round is 16 steps.
    reqs = [(list(range(1, 41)), 15), (list(range(2, 30)), 30),
            (list(range(5, 50)), 8)]

    def drive(b):
        b.start()
        try:
            solo = b.submit(*reqs[0]).result()
            hs = [b.submit(p, max_new_tokens=n) for p, n in reqs]
            return [solo] + [h.result() for h in hs]
        finally:
            b.stop()

    ref = drive(JaxBatcher(jm, jp, slots=2))
    b = ContinuousBatcher(tm, tp, slots=2, device="cpu")
    assert drive(b) == ref
    assert int(b._dev["pos"].max()) > DIMS["max_seq"]


def test_precache_rejects_unusable_prefixes():
    _, _, tm, tp = _models("gqa")
    b = ContinuousBatcher(tm, tp, slots=2, device="cpu")
    for ids in ([], list(range(DIMS["max_seq"] - 7))):
        with pytest.raises(ValueError):
            b.precache_prefix(ids)
    paged = ContinuousBatcher(tm, tp, slots=2, paged_blocks=BLOCKS,
                              page_size=PAGE, device="cpu")
    with pytest.raises(RuntimeError):       # not started
        paged.precache_prefix(PREFIX)


def test_prefix_entries_are_an_lru_of_four():
    """The longest matching entry wins and is touched; the least recently
    used entry goes when a fifth is inserted."""
    _, _, tm, tp = _models("gqa")
    b = ContinuousBatcher(tm, tp, slots=2, device="cpu")
    for k in range(4):
        b.precache_prefix([k + 1] * (k + 2))       # n = 2, 3, 4, 5
    b.precache_prefix([1] * 5)                     # n = 5: evicts [1, 1]
    assert b._match_prefix(np.asarray([1] * 9, np.int32))["n"] == 5
    assert b._match_prefix(np.asarray([2] * 3 + [7], np.int32))["n"] == 3
    b.precache_prefix([9] * 6)                     # evicts [3] * 4
    assert [e["n"] for e in b._prefix.values()] == [5, 5, 3, 6]
    assert b._match_prefix(np.asarray([3] * 4, np.int32)) is None
    off = ContinuousBatcher(tm, tp, slots=2, prefix_cache=False,
                            device="cpu")
    off.precache_prefix([2] * 3)
    assert off._match_prefix(np.asarray([2] * 3, np.int32)) is None


def test_entry_points_default_to_the_card():
    """No fall-back: without CUDA the default device raises, and with it a
    CPU model is refused."""
    _, _, tm, tp = _models("gqa")
    with pytest.raises((RuntimeError, ValueError)):
        ContinuousBatcher(tm, tp)


# -- LmServer with its defaults: the dense pool ------------------------------

CORPUS = "the cat sat on the mat. the dog sat on the log. " * 40


@pytest.fixture(scope="module")
def server():
    tok = BpeTokenizer.train(CORPUS, vocab_size=300)
    cfg = TransformerConfig(vocab_size=tok.vocab_size, d_model=32,
                            n_layers=1, n_heads=2, d_head=16, d_ff=64,
                            max_seq=64, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    srv = LmServer(model, model.init(0), tok, slots=2, device="cpu").start()
    yield srv, tok
    srv.stop()


def _call(srv, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_defaults_serve_the_dense_pool(server):
    srv, tok = server
    assert not srv.batcher.paged
    text = "the cat sat on the mat."
    code, body = _call(srv, "/generate", {"prompt": text,
                                          "max_new_tokens": 6})
    assert code == 200 and body["generated_tokens"] == 6
    code, pre = _call(srv, "/precache", {"prompt": text})
    assert code == 200 and pre == {"cached_tokens": int(tok.encode(
        text).size)}
    code, again = _call(srv, "/generate", {"prompt": text,
                                           "max_new_tokens": 6})
    assert code == 200 and again["ids"] == body["ids"]
    ids = tok.encode(text).tolist()
    code, longer = _call(srv, "/generate", {"prompt_ids": ids + [5, 6],
                                            "max_new_tokens": 4})
    assert code == 200 and longer["generated_tokens"] == 4
    paths = srv.batcher.admission_paths
    assert paths["prefix_exact"] == 1 and paths["prefix_suffix"] == 1


@pytest.mark.parametrize("payload", [{"prompt": ""}, {"prompt": 3}, {},
                                     {"prompt": "the mat " * 200}])
def test_server_precache_rejects_bad_prompts(server, payload):
    srv, _ = server
    code, body = _call(srv, "/precache", payload)
    assert code == 400 and "error" in body


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged kernel has no CPU mode "
                    "and the dense pool's masked writes are CUDA code here "
                    "(chip_smoke.py drives both at full size)")
    return torch.device("cuda")


# Head width 64 and pages of 16: shapes the paged kernel takes.
GPU_DIMS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                d_head=64, n_kv_heads=1, d_ff=128, max_seq=128)
GPU_PAGE = 16
# The 40-token prompt sits in the 64 bucket: a left pad of 24 > a page.
GPU_REQUESTS = [(_rng.integers(0, 64, n).tolist(), m)
                for n, m in ((40, 30), (5, 20), (99, 8), (17, 60))]


def _gpu_streams(make):
    b = make()
    hs = [b.submit(p, max_new_tokens=n) for p, n in GPU_REQUESTS]
    b.start()
    try:
        return [h.result() for h in hs], b
    finally:
        b.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_pools_match_reference(cuda, paged):
    """float32 on the card: the dense pool (rows past max_seq included:
    the 99-token prompt's 8 tokens end at the cache's end while others
    decode on) and the unshared paged pool through the paged kernel give
    the reference's greedy streams."""
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    jm = JaxLM(JaxConfig(**GPU_DIMS, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = TransformerLM(TransformerConfig(**GPU_DIMS, dtype=torch.float32),
                       device=cuda)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cuda)
    kw = (dict(paged_blocks=40, page_size=GPU_PAGE, prefix_cache=False)
          if paged else {})
    ref, _ = _gpu_streams(lambda: JaxBatcher(jm, jp, slots=2, **kw))
    pa.reset_counts()
    got, b = _gpu_streams(lambda: ContinuousBatcher(
        tm, tp, slots=2, attn_impl="paged_kernel", device=cuda, **kw))
    assert got == ref
    assert [len(s) for s in got] == [n for _, n in GPU_REQUESTS]
    assert dict(b.admission_paths) == {"cold": len(GPU_REQUESTS)}
    if paged:
        assert pa.launch_count > 0 and pa.fallback_count == 0
    else:
        assert pa.launch_count == 0
        assert int(b._dev["pos"].max()) > GPU_DIMS["max_seq"]
