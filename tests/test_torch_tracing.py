"""The port's serving spans, phase profiler and fault sites against the
JAX package's: the ``Tracer`` on one scripted sequence (nesting, error
status, ring eviction, the ``since`` cursor, ``render_trace``) byte for
byte; a traced request through the port's ``LmServer`` shows its
``serve.*`` spans on the port's ``/debug/traces`` and an untraced one
records none; the reference's ``MetricsServer`` serves the port's
tracer, journal, profiler and ledger with the port's bodies, and its
``FleetTraceAssembler`` stitches a torch replica's request under a
gateway's dispatch; ``serve_phase_share`` is on the replica's
``/metrics``; the ``serve.submit`` and ``migrate.export``/``import``
sites answer as the reference's; a goodput incident takes the active
trace id."""

import itertools
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_gpu_tpu.utils.tracing as jax_tracing
from k8s_gpu_tpu.data import BpeTokenizer as JaxTokenizer
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import LmServer as JaxServer
from k8s_gpu_tpu.utils import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu.utils.clock import FakeClock as JaxFakeClock
from k8s_gpu_tpu.utils.faults import FaultPlan as JaxFaultPlan
from k8s_gpu_tpu.utils.faults import global_faults as jax_faults
from k8s_gpu_tpu.utils.goodput import GoodputLedger as JaxLedger
from k8s_gpu_tpu.utils.obs import MetricsServer as JaxMetricsServer
from k8s_gpu_tpu.utils.waterfall import FleetTraceAssembler
import k8s_gpu_tpu_torch.utils.tracing as port_tracing
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import LmServer
from k8s_gpu_tpu_torch.utils.clock import FakeClock
from k8s_gpu_tpu_torch.utils.faults import FaultPlan, global_faults
from k8s_gpu_tpu_torch.utils.goodput import GoodputLedger
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from k8s_gpu_tpu_torch.utils.obs import MetricsServer
from k8s_gpu_tpu_torch.utils.profiler import PhaseProfiler
from k8s_gpu_tpu_torch.utils.tracing import (
    SpanContext, Tracer, format_traceparent, global_tracer, new_span_id,
    new_trace_id,
)

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

PAGE = 8
CORPUS = "the cat sat on the mat. the dog sat on the log. " * 40
JTOK = JaxTokenizer.train(CORPUS, vocab_size=300, backend="python")
DIMS = dict(vocab_size=JTOK.vocab_size, d_model=32, n_layers=1, n_heads=2,
            d_head=16, d_ff=64, max_seq=64)
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
SERVE_PHASES = {"admission", "paged_plan", "prefill_dispatch",
                "decode_dispatch", "decode_consume", "retire"}


@pytest.fixture(scope="module")
def replica():
    """The port's LmServer on the paged pool, and a MetricsServer over its
    journal and profiler (the tracer is the port's global one)."""
    srv = LmServer(TM, TP, BpeTokenizer(JTOK.merges), slots=4,
                   paged_blocks=40, page_size=PAGE, max_new_tokens_cap=24,
                   metrics=MetricsRegistry(), name="torch-a",
                   device="cpu").start()
    obs = MetricsServer(registry=srv.batcher.metrics, journal=srv.journal,
                        profile=srv.profiler).start()
    yield srv, obs
    obs.stop()
    srv.stop()


@pytest.fixture(scope="module")
def jax_replica():
    """The reference's LmServer: its fault sites answer before any device
    work, so nothing is compiled here."""
    srv = JaxServer(JM, JP, JTOK, name="jax-a").start()
    yield srv
    srv.stop()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _flatten(node):
    yield node
    for c in node.get("children", ()):
        yield from _flatten(c)


def _spans(trace):
    return [n for r in trace["tree"] for n in _flatten(r)]


def _idle(srv, timeout=30.0):
    """Wait until no request is in flight: every span of the retired
    rows is recorded before the slot frees."""
    t_end = time.monotonic() + timeout
    while srv.batcher.inflight_requests and time.monotonic() < t_end:
        time.sleep(0.01)
    assert srv.batcher.inflight_requests == 0


def _server_span_recorded(trace_id, timeout=30.0):
    """Wait for a request's server span: the handler records it when its
    block ends, after the client has read the response."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        t = global_tracer.get_trace(trace_id)
        if t and any(n["name"] == "http POST /generate" for n in _spans(t)):
            return
        time.sleep(0.01)
    raise AssertionError(f"no server span in trace {trace_id}")


# -- the tracer against the reference's --------------------------------------

def _scripted(mod, clock, registry, monkeypatch):
    """One sequence through a tracer of ``mod`` with counted ids; the
    JSON of everything it can be asked."""
    sids, tids = itertools.count(1), itertools.count(1)
    monkeypatch.setattr(mod, "new_span_id", lambda: f"{next(sids):016x}")
    monkeypatch.setattr(mod, "new_trace_id", lambda: f"{next(tids):032x}")
    tr = mod.Tracer(max_traces=3, max_spans_per_trace=4, registry=registry,
                    clock=clock)
    out = {}
    with tr.span("http POST /generate", server="lm-server") as root:
        clock.advance(0.5)
        with tr.span("child", k=1):
            clock.advance(0.25)
        with pytest.raises(ValueError):
            with tr.span("bad"):
                clock.advance(0.125)
                raise ValueError("boom")
        out["current"] = list(vars(tr.current()).values())
    first = root.trace_id
    c0 = tr.cursor
    q = tr.add_span("serve.queue_wait", parent=root.context, start=100.0,
                    end=100.5, slot=1, path="paged_cold")
    for i in range(4):      # past the cap: the middle of the trace drops
        tr.add_span("serve.round", parent=q, start=101.0 + i,
                    end=101.5 + i, round=i, tokens=8, speculative=i == 3)
    with tr.use(root.context):
        with tr.span("under_use"):
            clock.advance(1.0)
    with tr.use(None):
        out["none_current"] = tr.current() is None
    out["get_first"] = tr.get_trace(first)
    out["since"] = tr.traces(since=c0)
    out["by_name"] = tr.traces(name="child")
    out["min_ms"] = tr.traces(min_ms=10_000.0)
    c1 = tr.cursor
    for k in range(3):      # a fourth trace evicts the oldest
        with tr.span(f"other{k}"):
            clock.advance(0.0625)
    out["evicted"] = tr.get_trace(first)
    out["traces"] = tr.traces(limit=10)
    out["since_c1"] = tr.traces(since=c1, limit=1)
    out["one"] = tr.traces(trace_id=out["traces"][-1]["trace_id"])
    out["render"] = [mod.render_trace(t) for t in out["traces"]]
    out["render_first"] = mod.render_trace(out["get_first"])
    out["cursor"] = tr.cursor
    out["counters"] = [registry.counter("tracing_spans_total"),
                       registry.counter("tracing_dropped_total",
                                        kind="trace"),
                       registry.counter("tracing_dropped_total",
                                        kind="span")]
    tr.clear()
    out["cleared"] = tr.traces()
    return json.dumps(out, sort_keys=True)


def test_tracer_is_the_reference_on_a_scripted_sequence(monkeypatch):
    mine = _scripted(port_tracing, FakeClock(100.0), MetricsRegistry(),
                     monkeypatch)
    ref = _scripted(jax_tracing, JaxFakeClock(100.0), JaxRegistry(),
                    monkeypatch)
    assert mine == ref
    out = json.loads(mine)
    assert out["counters"] == [12.0, 1.0, 5.0]
    assert out["evicted"] is None and out["cleared"] == []
    bad = [n for n in _spans(out["get_first"]) if n["name"] == "bad"]
    assert bad[0]["status"] == "error" and "boom" in bad[0]["attributes"][
        "error"]


def test_tracer_ring_is_thread_safe():
    """Eight threads record at once into a small ring: no span is lost
    from the count and the cursor, and the ring stays within its caps."""
    reg = MetricsRegistry()
    tr = Tracer(max_traces=4, max_spans_per_trace=8, registry=reg)
    roots = [SpanContext(new_trace_id(), new_span_id()) for _ in range(6)]

    def work(w):
        for i in range(200):
            tr.add_span("s", parent=roots[(w + i) % 6])

    threads = [threading.Thread(target=work, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert tr.cursor == reg.counter("tracing_spans_total") == 1600
    traces = tr.traces(limit=100)
    assert len(traces) <= 4
    assert all(t["span_count"] <= 8 for t in traces)


# -- a torch replica's spans -------------------------------------------------

def test_traced_request_has_queue_wait_prefill_and_rounds(replica):
    srv, obs = replica
    ctx = SpanContext(new_trace_id(), new_span_id())
    code, out, hdrs = _post(srv.port, "/generate",
                            {"prompt": "the cat", "max_new_tokens": 20},
                            {"traceparent": format_traceparent(ctx)})
    assert code == 200 and out["trace_id"] == ctx.trace_id
    assert hdrs["x-trace-id"] == ctx.trace_id
    _idle(srv)
    _server_span_recorded(ctx.trace_id)
    code, body = _get(obs.port, f"/debug/traces?trace_id={ctx.trace_id}")
    assert code == 200
    traces = json.loads(body)["traces"]
    assert len(traces) == 1
    spans = _spans(traces[0])
    names = [s["name"] for s in spans]
    assert names.count("http POST /generate") == 1
    assert "serve.queue_wait" in names and "serve.prefill" in names
    assert names.count("serve.round") >= 1
    server = next(s for s in spans if s["name"] == "http POST /generate")
    assert server["parent_id"] == ctx.span_id
    assert server["attributes"] == {"server": "lm-server", "code": 200}
    for s in spans:
        if s["name"].startswith("serve."):
            assert s["parent_id"] == server["span_id"]
    rounds = [s for s in spans if s["name"] == "serve.round"]
    assert sum(s["attributes"]["tokens"] for s in rounds) >= (
        out["generated_tokens"] - 1)
    qw = next(s for s in spans if s["name"] == "serve.queue_wait")
    assert qw["attributes"]["path"] == "paged_cold"
    # The journal record carries the same trace id.
    code, body = _get(obs.port, f"/debug/requests?trace_id={ctx.trace_id}")
    recs = json.loads(body)["requests"]
    assert len(recs) == 1 and recs[0]["tokens"] == out["generated_tokens"]


def test_untraced_submit_records_no_serve_spans(replica):
    srv, _ = replica
    _idle(srv)
    global_tracer.clear()
    handles = [srv.batcher.submit(np.asarray([1, 2, 3 + i], np.int32),
                                  max_new_tokens=6) for i in range(3)]
    assert all(len(h.result()) == 6 for h in handles)
    _idle(srv)
    assert not [n["name"] for t in global_tracer.traces(limit=100)
                for n in _spans(t) if n["name"].startswith("serve.")]


def test_serve_phase_shares_are_on_metrics(replica):
    srv, obs = replica
    code, _, _ = _post(srv.port, "/generate",
                       {"prompt": "the dog sat", "max_new_tokens": 12})
    assert code == 200
    _idle(srv)
    srv.profiler.export_shares()
    code, body = _get(obs.port, "/metrics")
    assert code == 200
    shares = {}
    for line in body.decode().splitlines():
        if line.startswith("serve_phase_share{"):
            phase = line.split('phase="')[1].split('"')[0]
            shares[phase] = float(line.rsplit(" ", 1)[1])
    assert SERVE_PHASES | {"residual"} <= set(shares)
    assert sum(shares.values()) == pytest.approx(1.0)
    assert all(0.0 <= v <= 1.0 for v in shares.values())
    reg = srv.batcher.metrics
    for phase in SERVE_PHASES:
        assert reg.histogram("serve_phase_seconds", phase=phase).n >= 1
    snap = json.loads(_get(obs.port, "/debug/profile")[1])
    assert snap["plane"] == "serve" and SERVE_PHASES <= set(snap["phases"])


# -- the reference's readers over the port's objects -------------------------

def _port_sources():
    """A tracer, profiler and ledger on fake clocks, scripted, so every
    body they give is a function of the script alone."""
    clk = FakeClock(50.0)
    reg = MetricsRegistry()
    tr = Tracer(registry=reg, clock=clk)
    with tr.span("http POST /generate", server="lm-server") as sp:
        clk.advance(0.25)
        tr.add_span("serve.round", parent=sp.context, start=50.0,
                    end=50.125, tokens=8)
    prof = PhaseProfiler(plane="serve", registry=reg, clock=clk)
    for ph, dt in (("admission", 0.5), ("decode_dispatch", 0.25),
                   ("decode_consume", 1.0)):
        with prof.phase(ph):
            clk.advance(dt)
    prof.export_shares()
    led = GoodputLedger(registry=reg, clock=clk)
    led.begin("step")
    clk.advance(2.0)
    led.end()
    led.incident("preemption", detail="scripted")
    return reg, tr, prof, led


def test_reference_metrics_server_reads_the_port(replica):
    srv, _ = replica
    _post(srv.port, "/generate", {"prompt": "the log", "max_new_tokens": 4,
                                  "tenant": "acme"})
    _idle(srv)
    reg, tr, prof, led = _port_sources()
    kw = dict(registry=reg, tracer=tr, journal=srv.journal, profile=prof,
              goodput=led)
    mine, ref = MetricsServer(**kw).start(), JaxMetricsServer(**kw).start()
    try:
        for path in ("/debug/traces", "/debug/traces?limit=1&since=1",
                     "/debug/traces?name=serve&min_ms=0",
                     "/debug/traces?limit=x", "/debug/requests",
                     "/debug/requests?tenant=acme&limit=1",
                     "/debug/requests?since=bad", "/debug/goodput",
                     "/metrics", "/readyz"):
            assert _get(mine.port, path) == _get(ref.port, path), path
        # /debug/profile: the same body but the deep-dive hint, which
        # names each package's own per-op tracer.
        a = json.loads(_get(mine.port, "/debug/profile")[1])
        b = json.loads(_get(ref.port, "/debug/profile")[1])
        assert "torch.profiler" in a.pop("deep_dive")
        b.pop("deep_dive")
        assert a == b
    finally:
        mine.stop()
        ref.stop()
    bare = MetricsServer(registry=MetricsRegistry()).start()
    bare_ref = JaxMetricsServer(registry=MetricsRegistry()).start()
    try:
        for path in ("/debug/requests", "/debug/profile", "/debug/goodput"):
            assert _get(bare.port, path) == _get(bare_ref.port, path), path
        assert _get(bare.port, "/nope")[0] == 404
    finally:
        bare.stop()
        bare_ref.stop()


def test_fleet_assembler_stitches_a_torch_replica(replica):
    """A gateway's dispatch span (a reference tracer's) propagates its
    pre-minted id; the torch replica's server span parents to it, and the
    reference's FleetTraceAssembler stitches both rings into one
    waterfall with the replica's queue wait, prefill and decode."""
    srv, obs = replica
    gw = jax_tracing.Tracer(registry=JaxRegistry())
    with gw.span("http POST /generate", server="fleet-frontend") as root:
        did = jax_tracing.new_span_id()
        t0 = gw.clock.now()
        dctx = jax_tracing.SpanContext(root.trace_id, did)
        code, out, _ = _post(srv.port, "/generate",
                             {"prompt": "the mat", "max_new_tokens": 16},
                             {"traceparent": jax_tracing.format_traceparent(
                                 dctx)})
        gw.add_span("gateway.dispatch", parent=root.context, start=t0,
                    span_id=did, replica="torch-a", attempt=1,
                    outcome="ok")
    assert code == 200
    _idle(srv)
    _server_span_recorded(root.trace_id)

    def gateway():
        return {"traces": gw.traces(), "cursor": gw.cursor}

    asm = FleetTraceAssembler(
        targets={"gateway": gateway,
                 "torch-a": f"http://127.0.0.1:{obs.port}"},
        registry=JaxRegistry())
    assert asm.scrape_once() == {"gateway": True, "torch-a": True}
    wf = asm.waterfall(root.trace_id)
    assert wf["stitched"] and not wf["missing_spans"]
    assert wf["processes"]["torch-a"]["aligned"]
    for seg in ("queue_wait", "prefill", "decode"):
        assert wf["segments"][seg]["seconds"] > 0.0, seg
    assert wf["ttft_s"] is not None and wf["ttft_s"] <= wf["e2e_s"]
    assert wf["journal"]["torch-a"]["tokens"] == out["generated_tokens"]


# -- fault sites --------------------------------------------------------------

FAULT_CASES = [
    ("serve.submit", "/generate", {"prompt": "the cat", "max_new_tokens": 2}),
    ("migrate.export", "/admin/export", {}),
    ("migrate.import", "/admin/import", {"blocks": []}),
]


@pytest.mark.parametrize("site,path,body", FAULT_CASES)
def test_fault_sites_answer_as_the_reference(replica, jax_replica, site,
                                            path, body):
    srv, _ = replica
    got = []
    for port, faults, plan in ((srv.port, global_faults, FaultPlan),
                               (jax_replica.port, jax_faults,
                                JaxFaultPlan)):
        faults.arm(site, plan(flaky=1, kinds=("error",)))
        try:
            code, out, hdrs = _post(port, path, body)
            got.append((code, out, hdrs.get("Retry-After"),
                        faults.sites()[site]))
        finally:
            faults.disarm(site)
    assert got[0] == got[1]
    assert got[0][0] == 503 and f"injected fault at {site}" in got[0][1][
        "error"]
    assert got[0][3] == {"calls": 1, "injected": 1}


@pytest.mark.parametrize("site,path,body", FAULT_CASES)
def test_fault_sites_honour_only_their_kinds(replica, site, path, body):
    """A "slow" decision at a site without a clock is not an injection:
    nothing is counted and the request takes its normal course."""
    srv, _ = replica
    before = global_metrics.counter("faults_injected_total", site=site,
                                    kind="slow")
    global_faults.arm(site, FaultPlan(kinds=("slow",)))
    try:
        code, _, _ = _post(srv.port, path, body)
        assert global_faults.injected(site) == 0
        assert global_faults.calls(site) == 1
    finally:
        global_faults.disarm(site)
    assert code != 503
    assert global_metrics.counter("faults_injected_total", site=site,
                                  kind="slow") == before
    _idle(srv)


def test_submit_fault_fires_at_both_submits():
    before = global_metrics.counter("faults_injected_total",
                                    site="serve.submit", kind="timeout")
    global_faults.arm("serve.submit", FaultPlan(kinds=("timeout",)))
    try:
        from k8s_gpu_tpu_torch.serve import ContinuousBatcher

        b = ContinuousBatcher(TM, TP, slots=2, device="cpu")
        with pytest.raises(RuntimeError, match="injected timeout at "
                                               "serve.submit"):
            b.submit([1, 2, 3])
        with pytest.raises(RuntimeError, match="serve.submit"):
            b.submit_precomputed({}, torch.zeros(1, 1), 4, 0)
    finally:
        global_faults.disarm()
    assert global_metrics.counter("faults_injected_total",
                                  site="serve.submit",
                                  kind="timeout") == before + 2


# -- goodput incidents ---------------------------------------------------------

def test_goodput_incident_takes_the_active_trace_id():
    mine = GoodputLedger(registry=MetricsRegistry(), clock=FakeClock())
    ref = JaxLedger(registry=JaxRegistry(), clock=JaxFakeClock())
    with global_tracer.span("reconcile") as sp:
        mine.incident("preemption", detail="node gone")
    with jax_tracing.global_tracer.span("reconcile") as jsp:
        ref.incident("preemption", detail="node gone")
    mine.incident("restart")
    ref.incident("restart")
    mine.incident("resume", trace_id="ab" * 16)
    a, b = mine.snapshot()["incidents"], ref.snapshot()["incidents"]
    assert a[0]["trace_id"] == sp.trace_id
    assert b[0]["trace_id"] == jsp.trace_id
    assert a[1]["trace_id"] == b[1]["trace_id"] == ""
    assert a[2]["trace_id"] == "ab" * 16
    strip = [{k: v for k, v in r.items() if k != "trace_id"}
             for r in (a[0], a[1])]
    assert strip == [{k: v for k, v in r.items() if k != "trace_id"}
                     for r in b]
