"""The port's request journal and serve-plane series against the JAX
reference's, float32, on the paged pool.

Every terminal path (budget, eos, deadline at admission and mid-stream,
queue-full shed, abort on stop, migrated) writes exactly one record with
exactly the reference ``RequestRecord``'s fields and the reference's
golden hash of the delivered stream; the batcher mints the reference's
series under the reference's labels (the exposition parsed by the
reference's own parser); the reference's recorder and replayer drive the
torch batcher to zero mismatches; and the reference's ``MetricsServer``
serves the port's journal at ``/debug/requests``.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve.journal import RequestRecord as JaxRecord
from k8s_gpu_tpu.serve.journal import golden_hash as jax_golden_hash
from k8s_gpu_tpu.serve.replay import WorkloadRecorder, WorkloadReplayer
from k8s_gpu_tpu.utils import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu.utils.metrics import parse_exposition
from k8s_gpu_tpu.utils.obs import MetricsServer
from k8s_gpu_tpu.utils.tracing import SpanContext as JaxSpanContext
from k8s_gpu_tpu.utils.tracing import format_traceparent as jax_format
from k8s_gpu_tpu.utils.tracing import parse_traceparent as jax_parse
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, Overloaded
from k8s_gpu_tpu_torch.serve.journal import (
    FINISH_REASONS,
    RequestJournal,
    RequestRecord,
    golden_hash,
)
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry
from k8s_gpu_tpu_torch.utils.tracing import (
    SpanContext,
    Tracer,
    format_traceparent,
    parse_traceparent,
)

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_head=16,
            d_ff=64, max_seq=128)
PAGE = 8
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

FIELDS = {f.name for f in dataclasses.fields(JaxRecord)}
P_LONG, P2 = [1, 2, 3, 4], [10, 20, 30]
# A budget no cut stream reaches: a cut lands within a few rounds.
LONG = 100


def _torch(**kw):
    kw.setdefault("metrics", MetricsRegistry())
    return ContinuousBatcher(TM, TP, paged_blocks=32, page_size=PAGE,
                             device="cpu", **kw)


def _first(handle):
    """Block until the request is seated and has emitted a token."""
    return next(iter(handle))


@pytest.fixture(scope="module")
def terminal():
    """One run through every terminal path; returns {path: (record,
    delivered ids, handle)}."""
    a = _torch(slots=1, max_pending=1, steps_per_round=1).start()
    out = {}
    try:
        h_long = a.submit(P_LONG, max_new_tokens=12, tenant="acme")
        _first(h_long)
        h_pend = a.submit(P2, max_new_tokens=6)
        with pytest.raises(Overloaded):
            a.submit([5, 5], max_new_tokens=2, tenant="blue")
        out["budget"] = h_long.result()
        eos_stream = h_pend.result()
        h_dead = a.submit(P_LONG, max_new_tokens=4, deadline=1e-9)
        out["deadline_at_admission"] = h_dead.result()
        h_mid = a.submit(P_LONG, max_new_tokens=LONG,
                         deadline=time.monotonic() + 600)
        _first(h_mid)
        h_mid._req.deadline = time.monotonic()      # passes mid-stream
        out["deadline_mid_stream"] = h_mid.result()
        h_mig = a.submit(P_LONG, max_new_tokens=LONG)
        _first(h_mig)
        snap = a.run_quiesced(lambda: a.migrate_export(abort_live=True))
        assert snap["aborted"] == 1 and h_mig.migrated
        out["migrated"] = h_mig.result()
        h_ab = a.submit(P_LONG, max_new_tokens=LONG)
        _first(h_ab)
        a.stop()
        out["aborted"] = h_ab.result()
        assert h_ab.aborted and not h_ab.migrated
        assert h_dead.deadline_expired and h_mid.deadline_expired
    finally:
        a.stop()
    recs = a.journal.snapshot(limit=100)
    # eos: the first token of P2's stream not seen before it, as the eos
    # id of a second batcher, retires the same prompt early.
    cut = next(i for i in range(1, len(eos_stream))
               if eos_stream[i] not in eos_stream[:i])
    b = _torch(slots=1, eos_id=eos_stream[cut]).start()
    try:
        out["eos"] = b.submit(P2, max_new_tokens=6).result()
        assert out["eos"] == eos_stream[:cut]
    finally:
        b.stop()
    recs += b.journal.snapshot(limit=100)
    return out, recs


EXPECT = {   # path -> (reason, delivered ids known, extra)
    "budget": ("budget", True, {}),
    "eos": ("eos", True, {}),
    "deadline_at_admission": ("deadline", True, {}),
    "deadline_mid_stream": ("deadline", True, {}),
    "queue_full": ("queue_full", False, {}),
    "aborted": ("aborted", True, {}),
    "migrated": ("aborted", True, {"migrated": True}),
}


def _record_of(recs, path, streams):
    reason, _, extra = EXPECT[path]
    cands = [r for r in recs if r["reason"] == reason
             and r.get("extra", {}) == extra]
    if path == "queue_full":
        return cands
    if path.startswith("deadline"):
        cands = [r for r in cands
                 if (r["path"] == "") == (path == "deadline_at_admission")]
    elif path == "budget":
        cands = [r for r in cands if r["tenant"] == "acme"]
    return cands


@pytest.mark.parametrize("path", sorted(EXPECT))
def test_every_terminal_path_writes_one_record(terminal, path):
    streams, recs = terminal
    cands = _record_of(recs, path, streams)
    assert len(cands) == 1, (path, recs)
    rec = cands[0]
    assert set(rec) | {"extra"} == FIELDS
    assert rec["reason"] in FINISH_REASONS
    assert rec["prompt_ids"] and rec["max_new"] >= 1
    if path == "queue_full":
        assert rec["tenant"] == "blue" and rec["tokens"] == 0
        assert rec["golden_hash"] == ""
        return
    ids = streams[path]
    assert rec["tokens"] == len(ids)
    assert rec["golden_hash"] == jax_golden_hash(ids)
    if path == "deadline_at_admission":
        assert ids == [] and rec["deadline_expired"] and rec["slot"] == -1
    if path in ("deadline_mid_stream", "migrated", "aborted"):
        assert 0 < len(ids) < LONG
    if path == "deadline_mid_stream":
        assert rec["deadline_expired"] and rec["deadline_s"] > 0


@pytest.mark.parametrize("ids", [[], [0], [1, 2, 3], [63] * 40,
                                 list(range(64))])
def test_golden_hash_is_the_reference_hash(ids):
    assert golden_hash(ids) == jax_golden_hash(ids)
    rec = RequestRecord(prompt_ids=ids, extra={"migrated": True})
    assert rec.to_dict() == JaxRecord(prompt_ids=ids,
                                      extra={"migrated": True}).to_dict()


def test_journal_ring_and_cursor():
    j = RequestJournal(maxlen=3)
    for i in range(5):
        j.append(RequestRecord(tenant=f"t{i}", t_submit=10.0 + i))
    assert len(j) == 3 and j.dropped == 2 and j.cursor == 5
    assert [r["tenant"] for r in j.snapshot(limit=10)] == ["t4", "t3", "t2"]
    assert [r["seq"] for r in j.snapshot(since=3)] == [5, 4]
    assert j.snapshot(limit=0) == [] and j.origin == 10.0


@pytest.mark.parametrize("header", [
    None, "", "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-00",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01", "00-xyz", "garbage",
])
def test_traceparent_is_the_reference_parse(header):
    mine, ref = parse_traceparent(header), jax_parse(header)
    assert (mine is None) == (ref is None)
    # A server span continues the inbound trace under its own span id.
    with Tracer(registry=MetricsRegistry()).span("http", parent=mine) as sp:
        ctx = sp.context
    if ref is not None:
        assert (mine.trace_id, mine.span_id) == (ref.trace_id, ref.span_id)
        assert format_traceparent(mine) == jax_format(ref)
        assert ctx.trace_id == ref.trace_id and ctx.span_id != ref.span_id
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    ctx2 = SpanContext(ctx.trace_id, ctx.span_id)
    assert format_traceparent(ctx2) == jax_format(
        JaxSpanContext(ctx.trace_id, ctx.span_id))


@pytest.mark.parametrize("cap", [256, 2])
def test_registry_renders_the_reference_exposition(cap):
    mine, ref = MetricsRegistry(cap), JaxRegistry(cap)
    for reg in (mine, ref):
        reg.inc("serve_admissions_total", path="paged_cold")
        reg.inc("serve_shed_total", reason="deadline", tenant='a"b\\c')
        for t in ("acme", "blue", "coral"):
            reg.inc("serve_tenant_tokens_total", 7.0, tenant=t)
            reg.observe("serve_ttft_seconds", 0.02, tenant=t)
        reg.observe("serve_ttft_seconds", 3.5)
        reg.set_gauge("serve_slots_active", 2.0)
    assert mine.render() == ref.render()
    assert mine.percentile("serve_ttft_seconds", 0.5) == ref.percentile(
        "serve_ttft_seconds", 0.5)


# -- the reference's series --------------------------------------------------

SERIES = (
    "serve_admissions_total", "serve_completions_total",
    "serve_prefix_cache_hits_total", "serve_prefix_cache_misses_total",
    "serve_shed_total", "serve_resumed_requests_total",
    "serve_ttft_seconds", "serve_inter_token_seconds",
    "serve_queue_wait_seconds", "serve_tenant_tokens_total",
    "serve_tenant_goodput_tokens_total", "serve_generated_tokens",
    "serve_slots_active", "serve_kv_blocks_used",
    "serve_paged_kernel_rounds_total",
)
# The one series whose value depends on how the rounds fell.
TIMING = "serve_paged_kernel_rounds_total"
SHARED = [(i * 5 + 1) % 60 for i in range(17)]     # two full pages + 1


def _workload(b, overloaded):
    """The same traffic on either side: a shared-prefix pair, tenants, a
    deadline shed, a queue-full shed and a resumed request."""
    b.submit(SHARED + [3], max_new_tokens=5, tenant="acme").result()
    b.submit(SHARED + [4, 5], max_new_tokens=4, tenant="acme").result()
    b.submit([9, 8, 7], max_new_tokens=3, deadline=1e-9,
             tenant="blue").result()
    h1 = b.submit(P_LONG, max_new_tokens=30, tenant="blue")
    next(iter(h1))
    h2 = b.submit(P2, max_new_tokens=3)
    with pytest.raises(overloaded):
        b.submit([5, 5], max_new_tokens=2, tenant="coral")
    h1.result()
    h2.result()
    b.submit(P2 + [1], max_new_tokens=2, tenant="acme",
             migrated_from="lm-a").result()


def _families(registry):
    """{(name, labels): value} of SERIES: counters and gauges, and each
    histogram's observation count."""
    fam = parse_exposition(registry.render())
    out = {}
    for name in SERIES:
        for suffix in ("", "_count"):
            for labels, v in fam.get(name + suffix, {}).items():
                out[(name, labels)] = v
    return out


def test_series_minted_with_the_reference_labels():
    from k8s_gpu_tpu.serve.batcher import Overloaded as JaxOverloaded

    jreg, treg = JaxRegistry(), MetricsRegistry()
    kw = dict(slots=1, max_pending=1, steps_per_round=1,
              attn_impl="paged_kernel")
    jb = JaxBatcher(JM, JP, paged_blocks=32, page_size=PAGE, metrics=jreg,
                    **kw).start()
    try:
        _workload(jb, JaxOverloaded)
    finally:
        jb.stop()
    tb = _torch(metrics=treg, **kw).start()
    try:
        _workload(tb, Overloaded)
    finally:
        tb.stop()
    jf, tf = _families(jreg), _families(treg)
    assert sorted(tf) == sorted(jf)
    assert {name for name, _ in tf} == set(SERIES)
    for key, v in jf.items():
        if key[0] != TIMING:
            assert tf[key] == v, key
    assert tf[("serve_shed_total", (("reason", "queue_full"),
                                    ("tenant", "coral")))] == 1
    assert tf[(TIMING, ())] > 0


# -- replay and the reference's /debug/requests ------------------------------

REPLAY = [(SHARED + [3], 6, "acme"), (SHARED + [2, 2], 5, "acme"),
          ([4, 4, 5], 7, "blue"), (list(range(20, 40)), 9, "default")]


@pytest.fixture(scope="module")
def recorded():
    jb = JaxBatcher(JM, JP, slots=2, paged_blocks=32, page_size=PAGE,
                    metrics=JaxRegistry()).start()
    try:
        for ids, n, tenant in REPLAY:
            jb.submit(ids, max_new_tokens=n, tenant=tenant).result()
    finally:
        jb.stop()
    rec = WorkloadRecorder({"jax": jb.journal})
    assert rec.scrape_once() == len(REPLAY)
    return rec.workload()


def test_reference_replayer_drives_the_torch_batcher(recorded):
    assert all(r["verify"] for r in recorded["requests"])
    tb = _torch(slots=2).start()
    try:
        report = WorkloadReplayer(registry=JaxRegistry(),
                                  time_scale=0.0).run(recorded, batcher=tb)
    finally:
        tb.stop()
    assert report["totals"] == {"requests": len(REPLAY),
                                "verified": len(REPLAY),
                                "matched": len(REPLAY), "mismatches": 0,
                                "errors": 0}


def test_reference_metrics_server_serves_the_torch_journal(recorded):
    tb = _torch(slots=2).start()
    try:
        for r in recorded["requests"]:
            tb.submit(r["prompt_ids"], max_new_tokens=r["max_new"],
                      tenant=r["tenant"]).result()
    finally:
        tb.stop()
    srv = MetricsServer(registry=JaxRegistry(), journal=tb.journal).start()
    try:
        rec = WorkloadRecorder(
            {"torch": f"http://127.0.0.1:{srv.port}"})
        assert rec.scrape_once() == len(REPLAY)
        assert rec.scrape_once() == 0          # the since= cursor holds
        got = rec.workload()["requests"]
    finally:
        srv.stop()
    assert [(r["key"], r["golden_hash"]) for r in got] == [
        (r["key"], r["golden_hash"]) for r in recorded["requests"]]
