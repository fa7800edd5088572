"""The port's in-process disaggregated prefill pool and
``submit_precomputed`` against the JAX package, on the CPU at float32;
and a batcher writing into a journal it was given.

Greedy streams are byte-identical to the reference's: dense and paged
decode sides, whole and chunked prefill, with an adapter riding through;
every handover admits as ``precomputed``.  ``submit_precomputed``
refuses the reference's bad shapes with the reference's messages.  The
reference's ``test_disagg.py`` cases have counterparts here (its
backpressure case polls the pool's in-flight count instead of sleeping).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import DisaggregatedLm as JaxDisagg
from k8s_gpu_tpu.serve.replay import WorkloadRecorder
from k8s_gpu_tpu.train.lora import LoraAdapter as JaxAdapter
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import paged_attention as pa
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, DisaggregatedLm
from k8s_gpu_tpu_torch.serve.engine import _empty_cache
from k8s_gpu_tpu_torch.serve.journal import RequestJournal
from k8s_gpu_tpu_torch.train import LoraAdapter, LoraConfig

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
PAGE = 8
BLOCKS = 40

JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

_CFG = dict(rank=4, targets=("wq", "wv"))
_tree = JaxAdapter(JaxLoraConfig(**_CFG)).init(jax.random.PRNGKey(1), JP)
_keys = iter(jax.random.split(jax.random.PRNGKey(9), 8))
_tree["blocks"] = {t: {"a": ab["a"], "b": jax.random.normal(
    next(_keys), ab["b"].shape) * 0.05} for t, ab in _tree["blocks"].items()}
JAX_ADAPTERS = {"t1": (_tree, JaxLoraConfig(**_CFG))}
ADAPTERS = {"t1": (params_from_numpy(jax.tree.map(np.asarray, _tree), "cpu"),
                   LoraConfig(**_CFG))}

# (prompt, max_new, adapter): across chunk boundaries (n < C, n = C,
# n = kC + r) and bucket widths; one adapter row.
REQUESTS = [
    ([(i * 7) % 60 + 1 for i in range(3)], 6, None),
    ([(i * 5) % 60 + 2 for i in range(8)], 5, None),
    ([(i * 3) % 60 + 1 for i in range(21)], 7, None),
    ([(i * 11) % 60 + 3 for i in range(30)], 4, "t1"),
]


def _run(b, d, requests=REQUESTS):
    b.start()
    d.start()
    try:
        hs = [d.submit(p, max_new_tokens=n, adapter=a)
              for p, n, a in requests]
        return [h.result() for h in hs]
    finally:
        d.stop()
        b.stop()


def _pool(paged: bool, impl="gather") -> dict:
    return (dict(paged_blocks=BLOCKS, page_size=PAGE, attn_impl=impl)
            if paged else {})


@pytest.fixture(scope="module")
def reference():
    out = {}
    for paged in (False, True):
        kw = dict(paged_blocks=BLOCKS, page_size=PAGE) if paged else {}
        for chunk in (0, 8):
            b = JaxBatcher(JM, JP, slots=3, adapters=JAX_ADAPTERS,
                           metrics=JaxRegistry(), **kw)
            d = JaxDisagg(JM, JP, batcher=b, chunk_tokens=chunk)
            out[paged, chunk] = _run(b, d)
    return out


def _port(paged, impl="gather", **kw):
    return ContinuousBatcher(TM, TP, slots=3, adapters=ADAPTERS,
                             device="cpu", **_pool(paged, impl), **kw)


@pytest.mark.parametrize("paged,chunk,impl", [
    (False, 0, "gather"), (False, 8, "gather"), (True, 0, "gather"),
    (True, 8, "paged_kernel"),
])
def test_streams_equal_reference(reference, paged, chunk, impl):
    """Handed-over rows decode as the reference's do: the left-padded
    prefill (dense), the right-padded exact one (paged) and chunked
    prefill, an adapter riding through; every admission ``precomputed``,
    the paged pool's blocks all returned."""
    b = _port(paged, impl)
    pa.reset_counts()
    got = _run(b, DisaggregatedLm(TM, TP, batcher=b, chunk_tokens=chunk))
    assert got == reference[paged, chunk]
    assert [len(s) for s in got] == [n for _, n, _ in REQUESTS]
    assert dict(b.admission_paths) == {"precomputed": len(REQUESTS)}
    assert pa.fallback_count == 0
    if paged:
        assert sorted(b._pool.allocatable_blocks()) == list(
            range(1, BLOCKS))


def test_handover_equals_the_batchers_own_stream():
    """The same requests served without disaggregation: the same
    streams (the batcher's own admissions on the paged pool)."""
    plain = _port(True)
    plain.start()
    try:
        hs = [plain.submit(p, max_new_tokens=n, adapter=a)
              for p, n, a in REQUESTS]
        want = [h.result() for h in hs]
    finally:
        plain.stop()
    b = _port(True)
    assert _run(b, DisaggregatedLm(TM, TP, batcher=b)) == want


def test_concurrent_requests_with_two_workers():
    b = _port(False)
    d = DisaggregatedLm(TM, TP, batcher=b, prefill_workers=2)
    prompts = [[5, 9], [7, 3, 11], [2, 4, 6, 8], [13]]
    b.start()
    d.start()
    results = [None] * len(prompts)
    try:
        def run(i):
            results[i] = d.submit(prompts[i], max_new_tokens=6).result()

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        d.stop()
        b.stop()
    solo = _port(False).start()
    try:
        for p, got in zip(prompts, results):
            assert got == solo.submit(p, max_new_tokens=6).result()
    finally:
        solo.stop()


def test_backpressure_bounds_inflight():
    """inflight_cap=1 with the batcher not started: the second prefill
    waits until the first row is seated."""
    b = _port(False)
    d = DisaggregatedLm(TM, TP, batcher=b, inflight_cap=1).start()
    done = []

    def run(i):
        h = d.submit([3 + i, 5, 7], max_new_tokens=2)
        done.append(i)
        h.result()

    try:
        t1 = threading.Thread(target=run, args=(0,), daemon=True)
        t1.start()
        deadline = time.monotonic() + 30
        while done != [0] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert done == [0] and d.inflight == 1
        t2 = threading.Thread(target=run, args=(1,), daemon=True)
        t2.start()
        time.sleep(0.5)
        assert done == [0] and d.inflight == 1
        b.start()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert sorted(done) == [0, 1]
        assert d.max_inflight == 1 and d.inflight == 0
    finally:
        d.stop()
        b.stop()


def test_stop_then_submit_raises():
    b = _port(False).start()
    d = DisaggregatedLm(TM, TP, batcher=b).start()
    d.stop()
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            d.submit([1, 2, 3])
    finally:
        b.stop()


def test_submit_validation():
    b = _port(False)
    with pytest.raises(ValueError, match="multiple of 8"):
        DisaggregatedLm(TM, TP, batcher=b, chunk_tokens=10)
    with pytest.raises(ValueError, match="multiple of 8"):
        DisaggregatedLm(TM, TP, batcher=b, chunk_tokens=-8)
    d = DisaggregatedLm(TM, TP, batcher=b, chunk_tokens=8)
    with pytest.raises(ValueError, match="empty prompt"):
        d.submit([])
    with pytest.raises(ValueError, match="too long"):
        d.submit(list(range(60)))
    with pytest.raises(KeyError, match="unknown adapter"):
        d.submit([1, 2], adapter="nope")


def _bad_rows():
    """(row, logits, n_tokens) cases each side must refuse: a max_seq the
    pool lacks, a wrong kv_quant layout, flat logits, a full prompt."""
    L, KH, Dh, T, V = (DIMS["n_layers"], DIMS["n_kv_heads"], DIMS["d_head"],
                       DIMS["max_seq"], DIMS["vocab_size"])
    good = {"k": np.zeros((L, 1, KH, T, Dh), np.float32),
            "v": np.zeros((L, 1, KH, T, Dh), np.float32)}
    short = {k: v[:, :, :, :32] for k, v in good.items()}
    quant = dict(good, k_s=np.zeros((L, 1, KH, T), np.float32))
    return [(short, np.zeros((1, V), np.float32), 8),
            (quant, np.zeros((1, V), np.float32), 8),
            (good, np.zeros((V,), np.float32), 8),
            (good, np.zeros((1, V), np.float32), T)]


def test_submit_precomputed_refuses_what_the_reference_refuses():
    jb = JaxBatcher(JM, JP, slots=2, metrics=JaxRegistry())
    tb = _port(False)
    for row, logits, n in _bad_rows():
        with pytest.raises(ValueError) as ref:
            jb.submit_precomputed({k: jnp.asarray(v) for k, v in row.items()},
                                  jnp.asarray(logits), n, 0)
        with pytest.raises(ValueError) as got:
            tb.submit_precomputed({k: torch.from_numpy(v)
                                   for k, v in row.items()},
                                  torch.from_numpy(logits), n, 0)
        msg = str(ref.value)
        assert str(got.value).split(" (")[0].split(" != ")[0] == \
            msg.split(" (")[0].split(" != ")[0]
    with pytest.raises(KeyError, match="unknown adapter"):
        tb.submit_precomputed(_empty_cache(TM.cfg, 1, 64, False, "cpu"),
                              torch.zeros(1, 64), 8, 0, adapter="nope")


def test_precomputed_row_seats_with_its_geometry():
    """A row prefilled by hand (left-padded to 16, 11 real tokens) and
    handed over decodes as the same request admitted normally."""
    from k8s_gpu_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine(TM, device="cpu")
    ids = [(i * 13) % 60 + 1 for i in range(11)]
    padded = torch.tensor([[0] * 5 + ids], dtype=torch.int32)
    for paged in (False, True):
        b = _port(paged).start()
        try:
            row, logits = eng.prefill(TP, padded, 5)
            h = b.submit_precomputed(row, logits, 16, 5, max_new_tokens=7)
            got = h.result()
            want = b.submit(ids, max_new_tokens=7).result()
        finally:
            b.stop()
        assert got == want and b.admission_paths["precomputed"] == 1


# -- journal= -----------------------------------------------------------------

def test_batcher_writes_the_journal_it_is_given():
    """A journal made before the batcher: the batcher writes its records
    there, and the reference's recorder scraping it captures them."""
    journal = RequestJournal()
    rec = WorkloadRecorder({"torch": journal})
    assert rec.scrape_once() == 0
    b = ContinuousBatcher(TM, TP, slots=2, journal=journal, device="cpu")
    assert b.journal is journal
    reqs = [([4, 4, 5], 5), (list(range(20, 30)), 6)]
    b.start()
    try:
        outs = [b.submit(p, max_new_tokens=n).result() for p, n in reqs]
    finally:
        b.stop()
    assert rec.scrape_once() == len(reqs)
    got = rec.workload()["requests"]
    assert sorted(r["prompt_ids"] for r in got) == sorted(p for p, _ in reqs)
    assert sorted(r["max_new"] for r in got) == sorted(n for _, n in reqs)
    assert [len(o) for o in outs] == [n for _, n in reqs]
    assert ContinuousBatcher(TM, TP, slots=2, device="cpu").journal \
        is not journal


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the handover's splice and the "
                    "paged kernel's decode run on the card")
    return torch.device("cuda")


# The kernel's shapes: heads of 64, pages of 16.
GPU_DIMS = dict(DIMS, d_model=64, n_heads=2, d_head=64, n_kv_heads=1,
                d_ff=128, max_seq=128)


@pytest.mark.gpu
def test_cuda_handover_onto_the_paged_pool(cuda):
    """Whole and chunked handovers onto the paged pool through the kernel
    (float32), an adapter riding through: streams equal the CPU's plain
    version's, every admission ``precomputed`` (a handover adds no
    kernel admission), every decode step one launch a layer."""
    from k8s_gpu_tpu_torch.ops import _build

    _build.load("paged_attention")
    jp = JaxLM(JaxConfig(**GPU_DIMS, use_flash=False,
                         dtype=jnp.float32)).init(jax.random.PRNGKey(1))
    # The adapter is drawn on the CPU and moved to each side's device.
    cfg = LoraConfig(**_CFG)
    tree = LoraAdapter(cfg).init(
        1, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    for ab in tree["blocks"].values():
        ab["b"] = torch.full_like(ab["b"], 0.01)
    for chunk in (0, 8):
        streams = {}
        for dev in ("cpu", cuda):
            tm = TransformerLM(TransformerConfig(**GPU_DIMS,
                                                 dtype=torch.float32),
                               device=dev)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), dev)
            moved = {"blocks": {t: {h: x.to(dev) for h, x in ab.items()}
                                for t, ab in tree["blocks"].items()}}
            b = ContinuousBatcher(tm, tp, slots=3,
                                  adapters={"t1": (moved, cfg)},
                                  paged_blocks=BLOCKS, page_size=16,
                                  attn_impl="paged_kernel", device=dev)
            pa.reset_counts()
            streams[str(dev)] = _run(b, DisaggregatedLm(
                tm, tp, batcher=b, chunk_tokens=chunk))
            if dev != "cpu":
                torch.cuda.synchronize()
            assert dict(b.admission_paths) == {"precomputed": len(REQUESTS)}
        assert pa.fallback_count == 0
        assert pa.launch_count == GPU_DIMS["n_layers"] * b.dispatched[
            "decode_steps"]
        assert streams["cpu"] == streams[str(cuda)]
