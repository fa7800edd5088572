"""The port's LmServer over HTTP on the CPU, and its tokenizer against the
reference BpeTokenizer's Python fallback on the same training text.

The server's greedy /generate must give the stream the port's batcher
gives for the same ids (which test_torch_batcher holds byte-identical to
the reference batcher).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from k8s_gpu_tpu.data.tokenizer import BpeTokenizer as JaxBpeTokenizer
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer, Overloaded

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

CORPUS = "the cat sat on the mat. the dog sat on the log. " * 40


def _model(vocab):
    cfg = TransformerConfig(vocab_size=vocab, d_model=32, n_layers=1,
                            n_heads=2, d_head=16, d_ff=64, max_seq=64,
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    return model, model.init(0)


@pytest.fixture(scope="module")
def server():
    tok = BpeTokenizer.train(CORPUS, vocab_size=300)
    model, params = _model(tok.vocab_size)
    srv = LmServer(model, params, tok, slots=2, paged_blocks=24,
                   page_size=8, name="torch-0", device="cpu")
    ready_before = srv.readiness()["ready"]
    srv.start()
    yield srv, model, params, ready_before
    srv.stop()


def _call(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_tokenizer_ids_match_reference_python_fallback(tmp_path):
    ref = JaxBpeTokenizer.train(CORPUS, vocab_size=300, backend="python")
    tok = BpeTokenizer.train(CORPUS, vocab_size=300)
    assert tok.merges == ref.merges
    text = "the cat sat on the log, the dog on the mat."
    np.testing.assert_array_equal(tok.encode(text), ref.encode(text))
    ids = ref.encode(text)
    assert tok.decode(ids) == ref.decode(ids) == text
    loaded = BpeTokenizer.load(tok.save(tmp_path / "vocab.json"))
    np.testing.assert_array_equal(loaded.encode(text), ref.encode(text))


def test_health_and_readiness(server):
    srv, _, _, ready_before = server
    assert ready_before is False          # nothing served yet
    code, body = _call(srv, "/healthz")
    assert code == 200 and json.loads(body)["replica"] == "torch-0"
    _call(srv, "/generate", {"prompt": "the cat", "max_new_tokens": 2})
    code, body = _call(srv, "/readyz")
    r = json.loads(body)
    assert code == 200 and r["ready"] and r["scheduler_alive"]
    srv.drain()
    assert _call(srv, "/readyz")[0] == 503
    srv.undrain()


def test_generate_prompt_and_prompt_ids(server):
    srv, model, params, _ = server
    code, body = _call(srv, "/tokenize", {"text": "the dog sat"})
    ids = json.loads(body)["ids"]
    assert code == 200 and ids == srv.tokenizer.encode("the dog sat").tolist()
    code, by_text = _call(srv, "/generate",
                          {"prompt": "the dog sat", "max_new_tokens": 6})
    by_text = json.loads(by_text)
    code2, by_ids = _call(srv, "/generate",
                          {"prompt_ids": ids, "max_new_tokens": 6,
                           "logprobs": True})
    by_ids = json.loads(by_ids)
    assert code == code2 == 200
    assert by_text["ids"] == by_ids["ids"]
    assert by_ids["generated_tokens"] == 6 and len(by_ids["logprobs"]) == 6
    assert by_ids["text"] == srv.tokenizer.decode(by_ids["ids"])
    b = ContinuousBatcher(model, params, slots=2, paged_blocks=24,
                          page_size=8, device="cpu").start()
    try:
        assert b.submit(ids, max_new_tokens=6).result() == by_ids["ids"]
    finally:
        b.stop()


def test_stream_and_sampling(server):
    srv, _, _, _ = server
    code, raw = _call(srv, "/generate", {
        "prompt": "the mat", "max_new_tokens": 5, "stream": True,
        "temperature": 0.8, "top_p": 0.9, "seed": 3})
    events = [json.loads(line) for line in raw.decode().splitlines()]
    assert code == 200 and events[-1]["done"]
    assert [e["id"] for e in events[:-1]] and len(events) == 6
    _, again = _call(srv, "/generate", {
        "prompt": "the mat", "max_new_tokens": 5, "temperature": 0.8,
        "top_p": 0.9, "seed": 3})
    assert json.loads(again)["ids"] == [e["id"] for e in events[:-1]]


@pytest.mark.parametrize("payload", [
    {"prompt": ""}, {"prompt_ids": []}, {"prompt_ids": [1, "x"]},
    {"prompt_ids": [10_000]}, {"prompt": "a", "max_new_tokens": "many"},
])
def test_bad_requests_are_400(server, payload):
    assert _call(server[0], "/generate", payload)[0] == 400


def test_overloaded_maps_to_429(server, monkeypatch):
    srv = server[0]

    def full(*args, **kwargs):
        raise Overloaded("pending queue full (1 requests); retry later")

    monkeypatch.setattr(srv.batcher, "submit", full)
    url = f"http://127.0.0.1:{srv.port}/generate"
    req = urllib.request.Request(url, data=json.dumps(
        {"prompt": "the cat"}).encode())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 429
    assert err.value.headers["Retry-After"] == "1"
