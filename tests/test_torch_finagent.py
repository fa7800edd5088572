"""The port's Fin-Agent-Suite against the JAX package's on the same
inputs: the embedder on the carried projection, exact L2 and IP search,
the splitter, the SQL store and the ingest, the agents' answers with
``TemplateLM`` and the HTTP acceptance flow byte for byte,
``TorchLMClient``'s greedy bytes against ``TpuLMClient``'s on converted
float32 params, and ``HttpLMClient`` against the port's ``LmServer``
beside the reference's client, error paths included."""

import dataclasses
import datetime
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_gpu_tpu.finagent.sqlstore as jax_sqlstore
from k8s_gpu_tpu.data import BpeTokenizer as JaxTokenizer
from k8s_gpu_tpu.finagent import FinAgentApp as JaxApp
from k8s_gpu_tpu.finagent import HttpLMClient as JaxHttpLM
from k8s_gpu_tpu.finagent import QueryRequest as JaxQuery
from k8s_gpu_tpu.finagent import SqlStore as JaxSql
from k8s_gpu_tpu.finagent import TemplateLM as JaxTemplate
from k8s_gpu_tpu.finagent import TextEmbedder as JaxEmbedder
from k8s_gpu_tpu.finagent import VectorStore as JaxStore
from k8s_gpu_tpu.finagent import ingest as jax_ingest
from k8s_gpu_tpu.finagent import recursive_split as jax_split
from k8s_gpu_tpu.finagent.llm import TpuLMClient
from k8s_gpu_tpu.finagent.server import serve_background as jax_serve
from k8s_gpu_tpu.finagent.splitter import load_markdown_dir as jax_load
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import LmServer as JaxServer
import k8s_gpu_tpu_torch.finagent.sqlstore as port_sqlstore
from k8s_gpu_tpu_torch.convert import embedder_from_numpy, params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.finagent import (
    FinAgentApp, HttpLMClient, QueryRequest, SqlStore, TemplateLM,
    TextEmbedder, TorchLMClient, VectorStore, ingest, recursive_split,
)
from k8s_gpu_tpu_torch.finagent.agents import (
    COMPLAINT_AGENT, MARKETING_AGENT,
)
from k8s_gpu_tpu_torch.finagent.server import serve_background
from k8s_gpu_tpu_torch.finagent.splitter import load_markdown_dir
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import LmServer

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

KB_DOCS = {
    "products/gold.md": (
        "# 贵金属产品\n\n我们的贵金属产品包括黄金积存和白银账户。"
        "黄金积存支持每日定投，起投金额为1克。\n\n"
        "White-gold savings products support daily automatic investment."
    ),
    "products/loans.md": (
        "# 贷款产品\n\n个人消费贷款年利率低至3.4%，最高额度50万元。\n\n"
        "Personal loans have annual rates from 3.4 percent."
    ),
    "faq.md": "# 常见问题\n\n如何重置密码？请前往设置页面点击重置。",
}
# The reference tests' queries: (query, user_id).
QUERIES = [
    ("我无法登录，人脸识别失败了，我要投诉", "user_123"),
    ("介绍一下你们的贵金属黄金产品", "user_123"),
    ("transfer failed twice", "u9"),
    ("个人贷款利率是多少", "u1"),
    ("How do I reset my password?", "user_123"),
]
SMALL = dict(dim=64, n_features=1024)      # the reference tests' size
JEMB = JaxEmbedder(**SMALL)
PEMB = embedder_from_numpy(np.asarray(JEMB._proj), device="cpu")


@pytest.fixture(scope="module")
def kb(tmp_path_factory):
    root = tmp_path_factory.mktemp("kb")
    for rel, text in KB_DOCS.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text, encoding="utf-8")
    return root


class _FrozenNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both SQL stores stamp complaints at one instant, so prompts that
    carry the stamp compare byte for byte."""
    for mod in (jax_sqlstore, port_sqlstore):
        monkeypatch.setattr(mod, "datetime",
                            types.SimpleNamespace(datetime=_FrozenNow))


def _apps(kb):
    jv, js = JaxStore(), JaxSql()
    jax_ingest(kb, jv, js, embedder=JEMB)
    pv, ps = VectorStore(device="cpu"), SqlStore()
    ingest(kb, pv, ps, embedder=PEMB)
    return (JaxApp(embedder=JEMB, vectors=jv, sql=js, llm=JaxTemplate()),
            FinAgentApp(embedder=PEMB, vectors=pv, sql=ps, llm=TemplateLM()))


# -- embedder ---------------------------------------------------------------

@pytest.mark.parametrize("dims", [SMALL, dict(dim=1024, n_features=8192)])
def test_encode_on_the_carried_projection(dims):
    ref = JaxEmbedder(**dims) if dims != SMALL else JEMB
    mine = embedder_from_numpy(np.asarray(ref._proj), device="cpu")
    texts = list(KB_DOCS.values()) + [q for q, _ in QUERIES] + [""]
    a, b = ref.encode(texts), mine.encode(texts)
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mine.encode(texts[0]), a[0], rtol=0,
                               atol=1e-6)


def test_embedder_seeded_projection_is_its_own(monkeypatch):
    """The port draws its projection from a torch.Generator: seeded,
    at the reference's scale, unit rows out; the entry points that hold
    tensors run on the card unless asked for the CPU."""
    a = TextEmbedder(**SMALL, seed=3, device="cpu")
    b = TextEmbedder(**SMALL, seed=3, device="cpu")
    c = TextEmbedder(**SMALL, seed=4, device="cpu")
    assert torch.equal(a._proj, b._proj) and not torch.equal(a._proj,
                                                             c._proj)
    assert abs(float(a._proj.std()) * 1024 ** 0.5 - 1.0) < 0.05
    v = a.encode(["贵金属 黄金", "loans"])
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TextEmbedder(**SMALL), VectorStore,
                 lambda: TorchLMClient()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- vector store -----------------------------------------------------------

@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("qseed", [0, 1, 2])
def test_search_matches_the_reference(metric, qseed):
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(512, 64)).astype(np.float32)
    texts = [f"t{i}" for i in range(512)]
    ref = JaxStore().create_collection("c", dim=64)
    mine = VectorStore(device="cpu").create_collection("c", dim=64)
    # The port's store takes its rows in two inserts, one a tensor.
    ref.insert(texts, emb)
    mine.insert(texts[:300], emb[:300])
    mine.insert(texts[300:], torch.from_numpy(emb[300:]))
    assert mine.num_entities == ref.num_entities == 512
    q = np.random.default_rng(qseed).normal(size=(64,)).astype(np.float32)
    a = ref.search(q, limit=5, metric=metric)
    b = mine.search(q, limit=5, metric=metric)
    assert [h.id for h in b] == [h.id for h in a]
    assert [h.text for h in b] == [h.text for h in a]
    np.testing.assert_allclose([h.distance for h in b],
                               [h.distance for h in a], rtol=0, atol=1e-5)
    if metric == "L2":
        exact = np.sqrt(((emb.astype(np.float64) - q) ** 2).sum(-1))
        np.testing.assert_allclose([h.distance for h in b],
                                   np.sort(exact)[:5], rtol=0, atol=1e-5)


def test_vectorstore_lifecycle_and_refusals():
    vs = VectorStore(device="cpu")
    c = vs.create_collection("k", dim=8)
    assert vs.has_collection("k") and c.search(np.zeros(8)) == []
    with pytest.raises(ValueError, match="exists"):
        vs.create_collection("k", dim=8)
    with pytest.raises(ValueError, match=r"\[N, 8\]"):
        c.insert(["a"], np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="length"):
        c.insert(["a", "b"], np.zeros((1, 8), np.float32))
    c.insert(["a", "b"], np.eye(8, dtype=np.float32)[:2])
    c.create_index(metric="L2")
    with pytest.raises(ValueError, match="unknown metric"):
        c.search(np.ones(8), metric="cosine")
    assert [h.id for h in c.search(np.eye(8)[1], limit=9)] == [1, 0]
    vs.drop_collection("k")
    vs.drop_collection("k")
    assert not vs.has_collection("k")
    with pytest.raises(KeyError):
        vs.collection("k")


# -- splitter, SQL store, ingest --------------------------------------------

SPLIT_TEXTS = [
    "\n\n".join(f"Paragraph {i}: " + "word " * 60 for i in range(8)),
    "一二三四五六七八九十" * 130,
    "# 标题\n\n" + "\n".join("行" * 90 for _ in range(12)),
    "short",
]


@pytest.mark.parametrize("text", SPLIT_TEXTS)
@pytest.mark.parametrize("size,overlap", [(500, 50), (200, 30)])
def test_recursive_split_is_the_reference(text, size, overlap):
    assert recursive_split(text, size, overlap) == jax_split(text, size,
                                                             overlap)


def test_sqlstore_is_the_reference():
    a, b = JaxSql(), SqlStore()
    assert vars(b.latest_failed_event("user_123")) == vars(
        a.latest_failed_event("user_123"))
    assert b.latest_failed_event("nobody") is None
    assert a.latest_failed_event("nobody") is None
    when = datetime.datetime(2026, 1, 2, 3, 4, 5)
    for s in (a, b):
        s.insert_complaint("user_123", "无法登录", when=when)
        s.insert_complaint("u9", "transfer", when=when)
    assert b.complaints() == a.complaints()
    assert b.complaints("u9") == a.complaints("u9")
    for s in (a, b):
        s.setup()
    assert b.complaints() == a.complaints() == []


def test_sqlstore_serves_concurrent_complaints():
    """/chat runs on many threads: eight complaint handlers at once must
    all land (one sqlite connection used by two threads at once fails
    with "bad parameter or other API misuse"; the port's store locks
    it)."""
    sql = SqlStore()
    errors = []

    def handler(k):
        for i in range(100):
            try:
                sql.latest_failed_event("user_123")
                sql.insert_complaint(f"u{k}", f"complaint {i}")
            except Exception as e:  # noqa: BLE001 - collected, asserted
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=handler, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(sql.complaints()) == 800
    assert len(sql.complaints("u3")) == 100


def test_ingest_is_the_reference(kb):
    assert load_markdown_dir(kb) == jax_load(kb)
    jv, pv = JaxStore(), VectorStore(device="cpu")
    for _ in range(2):      # a rerun converges to the same state
        a = jax_ingest(kb, jv, JaxSql(), embedder=JEMB)
        b = ingest(kb, pv, SqlStore(), embedder=PEMB)
        assert b == a
    jc = jv.collection("financial_knowledge")
    pc = pv.collection("financial_knowledge")
    assert pc.num_entities == jc.num_entities == a["num_chunks"] > 0
    jc.flush()
    pc.flush()
    assert pc._d.texts == jc._d.texts
    np.testing.assert_allclose(pc._d.emb.numpy(), np.asarray(jc._d.device_emb),
                               rtol=0, atol=1e-6)


# -- agents -----------------------------------------------------------------

@pytest.mark.parametrize("query,user", QUERIES)
def test_agents_answer_as_the_reference(kb, frozen_clock, query, user):
    ja, pa = _apps(kb)
    a = ja.chat(JaxQuery(query=query, user_id=user))
    b = pa.chat(QueryRequest(query=query, user_id=user))
    assert (b.agent, b.response) == (a.agent, a.response)
    assert list(pa.llm.calls) == list(ja.llm.calls)
    assert pa.sql.complaints() == ja.sql.complaints()
    assert b.agent in (COMPLAINT_AGENT, MARKETING_AGENT)


def test_extension_contract_as_the_reference(kb):
    ja, pa = _apps(kb)
    for app in (ja, pa):
        app.extra_routes["余额"] = (
            "查询专员", lambda req: f"balance for {req.user_id}")
    a = ja.chat(JaxQuery(query="查询余额", user_id="u1"))
    b = pa.chat(QueryRequest(query="查询余额", user_id="u1"))
    assert (b.agent, b.response) == (a.agent, a.response) == (
        "查询专员", "balance for u1")


def _http(port, path, data=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_acceptance_flow_as_the_reference(kb, frozen_clock):
    ja, pa = _apps(kb)
    (jsrv, jport), (psrv, pport) = jax_serve(ja), serve_background(pa)
    try:
        calls = [("/", None), ("/nope", None)]
        calls += [("/chat", json.dumps({"query": q, "user_id": u}).encode())
                  for q, u in QUERIES]
        calls += [("/chat", json.dumps({"query": "介绍贵金属产品"}).encode()),
                  ("/chat", b"{}"), ("/chat", b'"query string"'),
                  ("/chat", b"{not json"), ("/other", b"{}")]
        for path, data in calls:
            assert _http(pport, path, data) == _http(jport, path, data), path
        code, body = _http(pport, "/", None)
        assert code == 200 and json.loads(body)["status"] == (
            "Fin-Agent-Suite is running.")
    finally:
        jsrv.shutdown()
        psrv.shutdown()


# -- the in-process client --------------------------------------------------

BYTE_DIMS = dict(vocab_size=259, d_model=32, n_layers=2, n_heads=2,
                 d_head=16, d_ff=64, max_seq=128)


@pytest.fixture(scope="module")
def byte_models():
    jm = JaxLM(JaxConfig(**BYTE_DIMS, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**BYTE_DIMS, dtype=torch.float32),
                       device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


@pytest.mark.parametrize("prompt", ["你好", "介绍贵金属黄金产品 gold " * 3])
def test_torch_lm_client_greedy_bytes_are_the_reference(byte_models,
                                                        prompt):
    jm, jp, tm, tp = byte_models
    ref = TpuLMClient(model=jm, params=jp, max_new_tokens=8,
                      temperature=0.0)
    mine = TorchLMClient(model=tm, params=tp, max_new_tokens=8,
                         temperature=0.0)
    assert mine.chat(prompt) == ref.chat(prompt)


def test_torch_lm_client_serves_the_agents(kb, byte_models):
    _, _, tm, tp = byte_models
    lm = TorchLMClient(model=tm, params=tp, max_new_tokens=8, seed=5)
    _, pa = _apps(kb)
    app = dataclasses.replace(pa, llm=lm)
    assert app.chat(QueryRequest(query="介绍产品")).agent == MARKETING_AGENT
    # Sampled: each call draws the next seed of the client's sequence.
    outs = [lm.chat("gold") for _ in range(2)]
    again = TorchLMClient(model=tm, params=tp, max_new_tokens=8, seed=5)
    assert [again.chat("gold") for _ in range(3)][1:] == outs


# -- the HTTP client against the port's LmServer ----------------------------

CORPUS = "黄金积存产品 收益 咨询 投诉 转账 " * 20 + "gold yield help " * 20


@pytest.fixture(scope="module")
def port_lm():
    jtok = JaxTokenizer.train(CORPUS, vocab_size=300, backend="python")
    tok = BpeTokenizer(jtok.merges)
    cfg = TransformerConfig(vocab_size=tok.vocab_size, d_model=32,
                            n_layers=1, n_heads=2, d_head=16, d_ff=64,
                            max_seq=2048, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    srv = LmServer(model, model.init(0), tok, max_new_tokens_cap=16,
                   device="cpu").start()
    yield srv, jtok
    srv.stop()


def test_http_client_serves_the_agents_from_the_port_server(kb, port_lm):
    srv, _ = port_lm
    url = f"http://127.0.0.1:{srv.port}"
    _, pa = _apps(kb)
    app = dataclasses.replace(pa, llm=HttpLMClient(url, max_new_tokens=8,
                                                   temperature=0.0))
    r1 = app.chat(QueryRequest(query="黄金积存产品怎么样", user_id="u1"))
    r2 = app.chat(QueryRequest(query="我要投诉转账问题", user_id="user_123"))
    assert r1.agent == MARKETING_AGENT and r2.agent == COMPLAINT_AGENT
    assert isinstance(r1.response, str) and isinstance(r2.response, str)
    # The reference's client gets the same greedy text from this server.
    ref = JaxHttpLM(url, max_new_tokens=8, temperature=0.0)
    mine = HttpLMClient(url, max_new_tokens=8, temperature=0.0)
    assert mine.chat("gold yield 投诉") == ref.chat("gold yield 投诉")


def test_http_client_error_paths(port_lm):
    srv, _ = port_lm
    url = f"http://127.0.0.1:{srv.port}"
    for client in (HttpLMClient, JaxHttpLM):
        with pytest.raises(RuntimeError, match="unreachable"):
            client("http://127.0.0.1:1", timeout=2).chat("hi")
    errors = []
    for client in (HttpLMClient, JaxHttpLM):
        with pytest.raises(RuntimeError, match=r"rejected the request \(400\)"
                           ) as e:
            client(url, adapter="nope", timeout=30).chat("gold")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_prompt_over_the_budget_is_refused_as_the_reference(port_lm):
    """An agent's prompt longer than the server's budget: both servers
    answer 400 "prompt too long", which the client raises."""
    srv, jtok = port_lm
    cfg = JaxConfig(vocab_size=jtok.vocab_size, d_model=32, n_layers=1,
                    n_heads=2, d_head=16, d_ff=64, max_seq=64,
                    use_flash=False, dtype=jnp.float32)
    jm = JaxLM(cfg)
    jsrv = JaxServer(jm, jm.init(jax.random.PRNGKey(0)), jtok).start()
    small = TransformerConfig(vocab_size=jtok.vocab_size, d_model=32,
                              n_layers=1, n_heads=2, d_head=16, d_ff=64,
                              max_seq=64, dtype=torch.float32)
    tm = TransformerLM(small, device="cpu")
    psrv = LmServer(tm, tm.init(0), BpeTokenizer(jtok.merges),
                    device="cpu").start()
    try:
        long_prompt = "黄金积存产品 收益 " * 40
        got = []
        for port in (jsrv.port, psrv.port):
            with pytest.raises(RuntimeError, match="prompt too long") as e:
                HttpLMClient(f"http://127.0.0.1:{port}").chat(long_prompt)
            got.append(str(e.value).split(": ", 1)[1])
        assert got[0] == got[1]
    finally:
        jsrv.stop()
        psrv.stop()
