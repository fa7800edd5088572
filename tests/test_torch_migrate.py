"""KV block migration between the port's paged pool and the JAX
reference's, over the reference's wire format (version 1), float32.

A chain moved either way is the source's chain: the destination's first
admission of the prompt shares it, its greedy stream is byte-identical,
and re-exporting it gives the source payload's block bytes.  bf16 leaves
travel as the reference writes them (raw 16-bit words named
``"bfloat16"``), and each side's ``unpack`` reads the other's.  Malformed
payloads are refused before the pool changes, the dense pool refuses
migration, and export/import churn between a torch and a JAX pool leaks
no block.
"""

import ast
import base64
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import migrate as jmig
from k8s_gpu_tpu.utils import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher
from k8s_gpu_tpu_torch.serve import migrate as tmig
from k8s_gpu_tpu_torch.serve.kv_blocks import chunk_hashes
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=128)
PAGE = 16
BLOCKS = 64
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

PREFIX = [(i * 7 + 3) % 120 for i in range(40)]   # 2 full pages + tail
PROMPT = np.asarray(PREFIX + [99, 98], np.int32)
N_NEW = 10


def _jax(**kw):
    return JaxBatcher(JM, JP, slots=4, paged_blocks=BLOCKS, page_size=PAGE,
                      metrics=JaxRegistry(), **kw).start()


def _torch(**kw):
    kw.setdefault("metrics", MetricsRegistry())
    return ContinuousBatcher(TM, TP, slots=4, paged_blocks=BLOCKS,
                             page_size=PAGE, device="cpu", **kw).start()


def _export(b, **kw):
    return b.run_quiesced(lambda: b.migrate_export(**kw))


def _import(b, parsed):
    return b.run_quiesced(lambda: b.migrate_import(parsed))


def _wire(payload):
    """The payload as it crosses HTTP: through JSON and back."""
    return json.loads(json.dumps(payload, sort_keys=True))


def _leakfree(b):
    assert b._pool.allocatable_blocks() == list(range(1, b.paged_blocks))


def _serve_and_export(b, pack):
    try:
        toks = b.submit(PROMPT, max_new_tokens=N_NEW).result()
        payload = _wire(pack(_export(b)))
    finally:
        b.stop()
    return [int(t) for t in toks], payload


@pytest.fixture(scope="module")
def jax_source():
    return _serve_and_export(_jax(), jmig.pack)


@pytest.fixture(scope="module")
def torch_source():
    return _serve_and_export(_torch(), tmig.pack)


def test_both_sides_serve_the_same_chain(jax_source, torch_source):
    (jtoks, jpay), (ttoks, tpay) = jax_source, torch_source
    assert ttoks == jtoks and len(jtoks) == N_NEW
    want = [h.hex() for h in chunk_hashes(PROMPT, PAGE)]
    assert [b["hash"] for b in jpay["blocks"]] == sorted(want)
    assert [b["hash"] for b in tpay["blocks"]] == sorted(want)
    assert tpay["geometry"] == jpay["geometry"]
    assert tpay["geometry"]["k"] == {"dtype": "float32",
                                     "shape": [2, 2, PAGE, 8]}
    # Independently computed K/V: equal to f32 summation order.
    for jb, tb in zip(jpay["blocks"], tpay["blocks"]):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                np.frombuffer(base64.b64decode(tb["data"][leaf]),
                              np.float32),
                np.frombuffer(base64.b64decode(jb["data"][leaf]),
                              np.float32), atol=1e-5)


def test_jax_chain_into_torch(jax_source):
    jtoks, payload = jax_source
    reg = MetricsRegistry()
    b = _torch(metrics=reg)
    try:
        assert _import(b, tmig.unpack(payload)) == len(payload["blocks"])
        toks = b.submit(PROMPT, max_new_tokens=N_NEW).result()
        assert [int(t) for t in toks] == jtoks
        # The first admission of the prompt shares the migrated chain.
        assert dict(b.admission_paths) == {"paged_shared": 1}
        assert reg.counter("serve_prefix_cache_hits_total") == 1
        back = {e["hash"]: e["data"]
                for e in tmig.pack(_export(b))["blocks"]}
        for ent in payload["blocks"]:
            assert back[ent["hash"]] == ent["data"]
    finally:
        b.stop()
    _leakfree(b)


def test_torch_chain_into_jax(torch_source):
    ttoks, payload = torch_source
    b = _jax()
    try:
        assert _import(b, jmig.unpack(payload)) == len(payload["blocks"])
        toks = b.submit(PROMPT, max_new_tokens=N_NEW).result()
        assert [int(t) for t in toks] == ttoks
        assert b.metrics.counter("serve_prefix_cache_hits_total") == 1
        back = {e["hash"]: e["data"]
                for e in jmig.pack(_export(b))["blocks"]}
        for ent in payload["blocks"]:
            assert back[ent["hash"]] == ent["data"]
    finally:
        b.stop()
    _leakfree(b)


# -- bf16 leaves ------------------------------------------------------------

BF16_DIMS = dict(DIMS, max_seq=64)


def _bf16_torch():
    """A torch batcher (not started) on a bf16 paged pool of 8 blocks."""
    model = TransformerLM(TransformerConfig(**BF16_DIMS, dtype=torch.bfloat16),
                          device="cpu")
    return ContinuousBatcher(model, model.init(0), slots=2, paged_blocks=8,
                             page_size=PAGE, device="cpu")


def _bf16_pools():
    """The same f32 values rounded to bf16 in a torch pool and a JAX pool,
    in the same blocks under the same hashes (neither batcher started)."""
    t = _bf16_torch()
    jm = JaxLM(JaxConfig(**BF16_DIMS, use_flash=False, dtype=jnp.bfloat16))
    j = JaxBatcher(jm, jm.init(jax.random.PRNGKey(0)), slots=2,
                   paged_blocks=8, page_size=PAGE, metrics=JaxRegistry())
    rng = np.random.default_rng(3)
    jcache = {}
    for name, arr in t._dev["cache"].items():
        vals = rng.standard_normal(tuple(arr.shape)).astype(np.float32)
        arr.copy_(torch.from_numpy(vals))           # round to nearest even
        jcache[name] = jnp.asarray(vals, jnp.bfloat16)
    j._dev["cache"] = jcache
    hashes = chunk_hashes(np.arange(3 * PAGE, dtype=np.int32), PAGE)
    for b in (t, j):
        for blk, h in zip((5, 2, 7), hashes):
            b._pool.register(blk, h)
    return t, j


def test_bf16_payload_is_the_reference_payload():
    t, j = _bf16_pools()
    tpay = tmig.pack(t.migrate_export())
    jpay = jmig.pack(j.migrate_export())
    assert tpay["geometry"]["k"]["dtype"] == "bfloat16"
    assert tmig.payload_bytes(tpay) == jmig.payload_bytes(jpay)
    # Each side's unpack reads the other's payload to the same values.
    ref = jmig.unpack(_wire(tpay))
    mine = tmig.unpack(_wire(jpay))
    for (h1, l1), (h2, l2) in zip(ref["blocks"], mine["blocks"]):
        assert h1 == h2
        for name in l1:
            assert l1[name].dtype == ml_dtypes.bfloat16
            assert l2[name].dtype == np.uint16
            np.testing.assert_array_equal(l1[name].view(np.uint16), l2[name])
    # The reference's payload spliced into a fresh torch pool holds the
    # same bf16 values in the blocks it allocated.
    fresh = _bf16_torch()
    assert fresh.migrate_import(mine) == 3
    for h, blk in fresh._pool.registered():
        src = t._pool._blk_of[h]
        for name, arr in fresh._dev["cache"].items():
            assert torch.equal(arr[:, blk], t._dev["cache"][name][:, src])


# -- determinism, refusals, churn ------------------------------------------

def test_two_run_export_byte_identical():
    def run():
        b = _torch()
        try:
            for i in range(2):
                b.submit(np.asarray(PREFIX + [60 + i], np.int32),
                         max_new_tokens=4).result()
            p = tmig.pack(_export(b))
        finally:
            b.stop()
        p["replica"] = "pinned-name"
        return tmig.payload_bytes(p)

    assert run() == run()


def _drop_leaf(p):
    del p["blocks"][0]["data"]["v"]


def _truncate(p):
    p["blocks"][0]["data"]["k"] = "AAAA"


def _set(path, value):
    def edit(p):
        node = p
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return edit


def _extra_leaf(p):
    p["geometry"]["k_s"] = {"dtype": "float32", "shape": [2, 2, PAGE]}
    for ent in p["blocks"]:
        ent["data"]["k_s"] = base64.b64encode(
            bytes(4 * 2 * 2 * PAGE)).decode()


MALFORMED = {
    "version": (_set(("version",), 2), "version"),
    "no_geometry": (_set(("geometry",), {}), "geometry"),
    "unknown_dtype": (_set(("geometry", "k", "dtype"), "float99"),
                      "geometry"),
    "bad_hash": (_set(("blocks", 0, "hash"), "zz"), "hash"),
    "missing_leaf": (_drop_leaf, "leaves"),
    "truncated_leaf": (_truncate, "bytes"),
    "page_size": (_set(("page_size",), PAGE // 2), "page_size"),
    "shape": (_set(("geometry", "k", "shape"), [2, 2, PAGE * 8]), "leaf"),
    "dtype": (_set(("geometry", "k", "dtype"), "int32"), "leaf"),
    "extra_leaf": (_extra_leaf, "leaves"),
}


@pytest.fixture(scope="module")
def warm_pool():
    b = _torch()
    b.submit(np.asarray(list(reversed(PREFIX)) + [5], np.int32),
             max_new_tokens=4).result()
    yield b
    b.stop()


def _pool_state(b):
    return (b._pool.allocatable_blocks(), b._pool.registered(),
            {n: a.clone() for n, a in b._dev["cache"].items()})


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_import_rejects_malformed_payloads(warm_pool, torch_source, case):
    edit, match = MALFORMED[case]
    bad = _wire(torch_source[1])
    edit(bad)
    before = _pool_state(warm_pool)
    with pytest.raises(ValueError, match=match):
        _import(warm_pool, tmig.unpack(bad))
    after = _pool_state(warm_pool)
    assert after[:2] == before[:2]
    assert all(torch.equal(after[2][n], before[2][n]) for n in before[2])
    assert warm_pool.scheduler_alive


def test_dense_pool_refuses_migration():
    b = ContinuousBatcher(TM, TP, slots=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        b.migrate_export()
    with pytest.raises(ValueError, match="paged"):
        b.migrate_import({"page_size": PAGE, "geometry": {}, "blocks": []})


def test_churn_between_torch_and_jax_pools_leak_free():
    """20 alternating export/import cycles: every block stays
    allocatable on both sides, re-imports skip what is there, and once
    the pools hold the same chains both export the same bytes."""
    t, j = _torch(), _jax()
    try:
        for i in range(2):
            t.submit(np.asarray(PREFIX + [70 + i], np.int32),
                     max_new_tokens=4).result()
            j.submit(np.asarray(list(reversed(PREFIX)) + [80 + i],
                                np.int32), max_new_tokens=4).result()
        for cycle in range(20):
            if cycle % 2 == 0:
                n = _import(j, jmig.unpack(_wire(tmig.pack(_export(t)))))
            else:
                n = _import(t, tmig.unpack(_wire(jmig.pack(_export(j)))))
            assert n == (2 if cycle < 2 else 0)
            _leakfree(t)
            _leakfree(j)
        assert (tmig.payload_bytes(tmig.pack(_export(t)))
                == jmig.payload_bytes(jmig.pack(_export(j))))
    finally:
        t.stop()
        j.stop()
    _leakfree(t)
    _leakfree(j)


def test_port_reads_bf16_without_ml_dtypes():
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "k8s_gpu_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), f
