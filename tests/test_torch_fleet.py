"""The reference fleet drives a torch replica: the JAX package's
``FleetFrontend`` (gateway, migrator, disaggregated prefill) over one JAX
``LmServer`` and one of the port's, float32, end to end over sockets.

The torch replica's journal carries the gateway's trace id, tenant and
routing stamp; its health bodies have the reference's keys; its
``/debug/chains`` agrees with the gateway's chain definition; a
live-migrating drain hands its stream to the JAX replica with no token
lost or duplicated; a disaggregated handover runs both ways (torch
prefill, JAX decode and the reverse) byte-identical to the fused path,
with no decode step on the prefill worker; and ``/admin/role`` answers
409, 200 and 400 as the reference does.
"""

import http.client
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.data import BpeTokenizer as JaxTokenizer
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import FleetFrontend
from k8s_gpu_tpu.serve import LmServer as JaxServer
from k8s_gpu_tpu.serve.kv_blocks import shareable_chain
from k8s_gpu_tpu.utils import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

PAGE = 8
CORPUS = "the cat sat on the mat. the dog sat on the log. " * 40
JTOK = JaxTokenizer.train(CORPUS, vocab_size=300, backend="python")
TTOK = BpeTokenizer(JTOK.merges)
DIMS = dict(vocab_size=JTOK.vocab_size, d_model=32, n_layers=1, n_heads=2,
            d_head=16, d_ff=64, max_seq=64)
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

# Distinct first pages: each prompt's chain routes on its own.
PROMPTS = [f"q{i} the cat sat on the log. the dog sat on the mat."
           for i in range(12)]
LONG_IDS = list(range(2, 28))          # 26 tokens: 3 shareable pages


def _jax_server(name, role="both"):
    return JaxServer(JM, JP, JTOK, slots=4, paged_blocks=64,
                     page_size=PAGE, metrics=JaxRegistry(), name=name,
                     role=role).start()


def _torch_server(name, role="both", round_delay=0.0):
    """A torch replica; ``round_delay`` seconds before every decode round
    (one step each) keeps a stream in flight long enough to act on."""
    srv = LmServer(TM, TP, TTOK, slots=4, paged_blocks=64, page_size=PAGE,
                   metrics=MetricsRegistry(), name=name, role=role,
                   device="cpu")
    if round_delay:
        b = srv.batcher
        b.steps_per_round = 1
        b.solo_buckets = [1]
        plain = b._round_dev

        def slow(*args, **kw):
            time.sleep(round_delay)
            return plain(*args, **kw)

        b._round_dev = slow
    return srv.start()


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


def _post(base, path, payload, headers=None, timeout=60.0):
    req = urllib.request.Request(
        base.rstrip("/") + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except ValueError:
            body = {}
        return e.code, body, dict(e.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _gateway(**kw):
    return FleetFrontend(JTOK, page_size=PAGE, metrics=JaxRegistry(),
                         **kw).start()


@pytest.fixture(scope="module")
def jax0():
    srv = _jax_server("jax-0")
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def fleet(jax0):
    tsrv = _torch_server("torch-0")
    fe = _gateway()
    for srv in (jax0, tsrv):
        fe.register_replica(srv.name, _url(srv))
    yield fe, jax0, tsrv
    fe.stop()
    tsrv.stop()


def _routed_to(fe, name, **body):
    """The first prompt the gateway routes to ``name``: its chain is then
    owned there, so the gateway sends it there again."""
    for prompt in PROMPTS:
        code, out, hdrs = _post(fe.url, "/generate", {
            "prompt": prompt, "max_new_tokens": 2, **body})
        assert code == 200, out
        if hdrs["x-route-replica"] == name:
            return prompt
    raise AssertionError(f"no prompt of {len(PROMPTS)} routed to {name}")


def test_gateway_stamps_reach_the_torch_journal(fleet):
    fe, _, tsrv = fleet
    prompt = _routed_to(fe, "torch-0")
    trace_id = "ab" * 16
    code, out, hdrs = _post(
        fe.url, "/generate",
        {"prompt": prompt, "max_new_tokens": 4, "tenant": "blue"},
        headers={"traceparent": f"00-{trace_id}-{'cd' * 8}-01",
                 "x-request-deadline-ms": "20000"})
    assert code == 200 and hdrs["x-route-replica"] == "torch-0"
    reason = hdrs["x-route-reason"]
    down = [r for r in tsrv.journal.snapshot(limit=50)
            if r["trace_id"] == trace_id]
    assert len(down) == 1
    rec = down[0]
    assert rec["tenant"] == "blue" and rec["replica"] == "torch-0"
    assert rec["route_reason"] == reason and rec["reason"] == "budget"
    assert 0 < rec["deadline_s"] <= 20.0
    assert rec["prompt_ids"] == TTOK.encode(prompt).tolist()
    gw = next(r for r in fe.journal.snapshot(limit=50)
              if r["trace_id"] == trace_id)
    assert gw["replica"] == "torch-0" and gw["route_reason"] == reason


def test_health_bodies_have_the_reference_keys(fleet):
    _, jsrv, tsrv = fleet
    for path in ("/healthz", "/readyz"):
        jcode, jbody = _get(_url(jsrv), path)
        tcode, tbody = _get(_url(tsrv), path)
        assert tcode == jcode == 200
        assert sorted(tbody) == sorted(jbody)
    assert tbody["replica"] == "torch-0" and tbody["role"] == "both"
    assert tbody["migrating"] is False and tbody["inflight"] == 0


def test_debug_chains_agree_with_the_gateway_definition(fleet):
    _, jsrv, tsrv = fleet
    prompt = PROMPTS[-1] + " chains"
    chain = {h.hex() for h in shareable_chain(JTOK.encode(prompt), PAGE)}
    assert len(chain) >= 2
    bodies = []
    for srv in (jsrv, tsrv):
        code, _, _ = _post(_url(srv), "/generate",
                           {"prompt": prompt, "max_new_tokens": 2})
        assert code == 200
        code, body = _get(_url(srv), "/debug/chains")
        assert code == 200 and body["page_size"] == PAGE
        assert body["chains"] == sorted(body["chains"])
        assert chain <= set(body["chains"])
        bodies.append(body)
    assert sorted(bodies[1]) == sorted(bodies[0])


def test_live_migrating_drain_hands_the_stream_to_jax(jax0):
    tsrv = _torch_server("torch-dr", round_delay=0.1)
    fe = _gateway()
    try:
        for srv in (jax0, tsrv):
            fe.register_replica(srv.name, _url(srv), on_drain=srv.drain)
        prompt = _routed_to(fe, "torch-dr")
        _, ref, _ = _post(_url(jax0), "/generate",
                          {"prompt": prompt, "max_new_tokens": 40})
        resumed0 = jax0.batcher.metrics.counter(
            "serve_resumed_requests_total")
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
        conn.request("POST", "/generate", json.dumps(
            {"prompt": prompt, "max_new_tokens": 40, "stream": True}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.getheader("x-route-replica") == "torch-dr"
        events = [json.loads(resp.readline())]
        code, st, _ = _post(fe.url, "/admin/drain",
                            {"name": "torch-dr", "deadline_s": 30.0})
        assert code == 202 and st["state"] == "draining"
        events += [json.loads(line) for line in resp if line.strip()]
        conn.close()
        summary = events[-1]
        assert summary["done"] is True, summary
        ids = [e["id"] for e in events if "id" in e]
        # Zero lost, zero duplicated: the greedy stream, whole.
        assert ids == ref["ids"] and summary["generated_tokens"] == 40
        assert jax0.batcher.metrics.counter(
            "serve_resumed_requests_total") == resumed0 + 1
        deadline = time.time() + 15
        while time.time() < deadline:
            drains = _get(fe.url, "/admin/drain")[1]["drains"]
            state = next(d for d in drains if d["replica"] == "torch-dr")
            if state["state"] == "retired":
                break
            time.sleep(0.05)
        assert state["state"] == "retired" and not state["forced"]
        assert state["migrated"]["blocks"] >= 2
        assert state["migrated"]["resumed"] == 1
        cut = [r for r in tsrv.journal.snapshot(limit=50)
               if r.get("extra", {}).get("migrated")]
        assert len(cut) <= 1
    finally:
        fe.stop()
        tsrv.stop()


# -- disaggregated prefill/decode, both ways ------------------------------

@pytest.fixture(scope="module")
def fused():
    """The fused-path greedy stream of LONG_IDS on each implementation."""
    jb = JaxBatcher(JM, JP, slots=2, paged_blocks=64, page_size=PAGE,
                    metrics=JaxRegistry()).start()
    tb = ContinuousBatcher(TM, TP, slots=2, paged_blocks=64, page_size=PAGE,
                           metrics=MetricsRegistry(), device="cpu").start()
    try:
        out = {name: [int(t) for t in
                      b.submit(LONG_IDS, max_new_tokens=8).result()]
               for name, b in (("jax", jb), ("torch", tb))}
    finally:
        jb.stop()
        tb.stop()
    assert out["jax"] == out["torch"]
    return out


def _handover(prefill, decode, fused_ids):
    fe = _gateway(disagg_threshold=16)
    try:
        fe.register_replica(prefill.name, _url(prefill), role="prefill")
        fe.register_replica(decode.name, _url(decode))
        code, out, hdrs = _post(fe.url, "/generate", {
            "prompt_ids": LONG_IDS, "max_new_tokens": 8})
        assert code == 200, out
        assert hdrs["x-route-replica"] == decode.name
        assert out["ids"] == fused_ids
        assert fe.metrics.counter("disagg_requests_total",
                                  path="disagg") == 1
        assert decode.batcher.metrics.counter(
            "serve_prefix_cache_hits_total") >= 1
        rec = next(r for r in fe.journal.snapshot(limit=10)
                   if r.get("prefill_replica"))
        assert rec["prefill_replica"] == prefill.name
        assert prefill.batcher.steps_taken == 0
    finally:
        fe.stop()


def test_handover_torch_prefill_jax_decode(jax0, fused):
    pf = _torch_server("torch-pf", role="prefill")
    try:
        assert _get(_url(pf), "/readyz")[1]["role"] == "prefill"
        _handover(pf, jax0, fused["jax"])
    finally:
        pf.stop()


def test_handover_jax_prefill_torch_decode(fused):
    pf = _jax_server("jax-pf", role="prefill")
    dc = _torch_server("torch-dc")
    try:
        _handover(pf, dc, fused["torch"])
    finally:
        pf.stop()
        dc.stop()


def test_admin_role_refusals_and_flip():
    srv = _torch_server("torch-role", round_delay=0.05)
    base = _url(srv)
    try:
        assert _post(base, "/admin/role", {"role": "chef"})[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/generate", json.dumps(
            {"prompt_ids": [5, 6, 7], "max_new_tokens": 20,
             "stream": True}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.readline()                       # the stream is live
        code, body, hdrs = _post(base, "/admin/role", {"role": "prefill"})
        assert code == 409 and "Retry-After" in hdrs, body
        assert srv.batcher.role == "both"
        for _ in resp:
            pass
        conn.close()
        deadline = time.time() + 10
        while srv.batcher.inflight_requests and time.time() < deadline:
            time.sleep(0.01)
        code, body, _ = _post(base, "/admin/role", {"role": "prefill"})
        assert code == 200 and body == {"replica": "torch-role",
                                        "role": "prefill"}
        steps = srv.batcher.steps_taken
        code, out, _ = _post(base, "/generate",
                             {"prompt_ids": [5, 6, 7], "max_new_tokens": 9})
        assert code == 200 and len(out["ids"]) == 1
        assert srv.batcher.steps_taken == steps
        assert _post(base, "/admin/role", {"role": "both"})[0] == 200
        assert _get(base, "/readyz")[1]["role"] == "both"
    finally:
        srv.stop()
