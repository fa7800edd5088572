"""The port's constrained decoding against the JAX package, on the CPU at
float32: the regex compiler's tables, the JSON-schema compiler, the
one-shot ``generate_constrained`` and constrained rows in the continuous
batcher on both pools.

Tolerances: tables, schema regexes and greedy streams equal the
reference's exactly; log-probs within 1e-5 (the two frameworks sum the
softmax in other orders; a dead end's log-prob is exactly 0 on both).
Sampled constrained rows are held to the language, not to the
reference's draws.  The reference's ``test_constrain.py`` cases and the
DFA layers of ``test_jsonschema.py`` have counterparts here.
"""

import ast
import json
import math
import os
import re
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
from k8s_gpu_tpu.serve import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve import SamplingConfig as JaxSampling
from k8s_gpu_tpu.serve import constrain as jcon
from k8s_gpu_tpu.serve import jsonschema as jschema
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import paged_attention as pa
from k8s_gpu_tpu_torch.serve import (
    ConstraintBank, ContinuousBatcher, InferenceEngine, LmServer,
    SamplingConfig, compile_constraint, schema_to_regex,
)
from k8s_gpu_tpu_torch.serve.constrain import RegexError
from k8s_gpu_tpu_torch.serve.jsonschema import SchemaError

torch.set_num_threads(1)

# Multi-character string tokens, as a BPE vocabulary looks to the
# automaton; token 0 (the empty string) is EOS.
TOKENS = ["", "0", "1", "7", "12", "ab", "cd", "e", "a", "x", "yes", "no",
          "9", "y", "es", "o", "s"]
DIMS = dict(vocab_size=len(TOKENS), d_model=32, n_layers=2, n_heads=2,
            d_head=16, d_ff=64, max_seq=48)
PAGE = 8
BLOCKS = 40
LP_TOL = 1e-5
PATTERNS = {"digits": "[0-9]+", "yn": "yes|no", "abe": "(ab|cd)+e"}

JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

# (prompt, max_new, constraint): free rows, a finite language that dead-
# ends into EOS, an open one that runs to its budget, and one more.
REQUESTS = [
    ([5, 9, 16], 6, None),
    ([7, 3], 6, "yn"),
    ([2, 4, 6, 8], 9, "digits"),
    ([1, 1, 2], 8, "abe"),
    ([11, 12, 13, 14, 15], 7, None),
    ([3, 3], 5, "yn"),
]


def _decode(ids):
    return "".join(TOKENS[t] for t in ids)


def _is_language_prefix(pattern: str, s: str) -> bool:
    """Python's ``re`` as an independent oracle: ``s`` completes to a full
    match within three more characters."""
    from itertools import product

    alphabet = "".join(sorted({ch for t in TOKENS for ch in t}))
    return any(re.fullmatch(pattern, s + "".join(tail))
               for depth in range(4)
               for tail in product(alphabet, repeat=depth))


# -- the compilers ------------------------------------------------------------

BPE_ISH = ["", "{", "}", "[", "]", '"', ":", ",", "-", "ok", "fail", "0",
           "1", "7", "12", "true", "false", "null", "a", "b", "e",
           '"status"', '"n"', '{"status":', "\n", "\t", ".", " "]


@pytest.mark.parametrize("pattern", [
    "[0-9]+", "(ab|cd)+e", "yes|no", ".*", r"\d{0}|[^0-9]?x*", r"[\t\n]+a",
    r"\.|e+", "(a|b)*(ok|fail)?",
])
def test_tables_equal_reference(pattern):
    for vocab in (TOKENS, BPE_ISH):
        try:
            ref = jcon.compile_constraint(pattern, vocab)
        except jcon.RegexError as e:
            with pytest.raises(RegexError, match=re.escape(str(e))):
                compile_constraint(pattern, vocab)
            continue
        got = compile_constraint(pattern, vocab)
        assert got.start == ref.start and got.pattern == ref.pattern
        for name in ("next_state", "allowed", "accepting"):
            r = np.asarray(getattr(ref, name))
            g = getattr(got, name)
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_bank_tables_equal_reference():
    ref = jcon.ConstraintBank(PATTERNS, TOKENS)
    got = ConstraintBank(PATTERNS, TOKENS)
    assert got.names == ref.names == ["__free__", "abe", "digits", "yn"]
    for name in ("next_state", "allowed", "accepting"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert bool(got.allowed[0, 0].all()) and int(got.next_state[0, 0, 3]) == 0
    assert got.index(None) == 0
    with pytest.raises(KeyError, match="unknown constraint"):
        got.index("nope")
    assert ConstraintBank({}, TOKENS).banked is None
    assert got.to("cpu") is got and got.table_bytes == sum(
        t.numel() * t.element_size()
        for t in (got.next_state, got.allowed, got.accepting))


def test_regex_errors():
    for bad in ("(ab", "[abc", "*a", r"\q", r"[\q]"):
        with pytest.raises(RegexError):
            compile_constraint(bad, TOKENS)


def _schemas_of_reference_tests():
    """Every dict literal in the reference's ``tests/test_jsonschema.py``
    (schemas, nested sub-schemas, the rejected ones), read from its
    source."""
    path = os.path.join(os.path.dirname(__file__), "test_jsonschema.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            try:
                out.append(ast.literal_eval(node))
            except ValueError:
                continue
    return out


SCHEMAS = _schemas_of_reference_tests() + [
    {"type": "string", "pattern": p}
    for p in ("a|b", "[^a-]*", "a^b", "x{2}", "(a", "\\d+", "[^abc]")
]


def test_schema_to_regex_equals_reference():
    """Over every schema of the reference's tests: the same regex string,
    or SchemaError with the same message on both sides."""
    assert len(SCHEMAS) > 40
    raised = 0
    for schema in SCHEMAS:
        try:
            ref = jschema.schema_to_regex(schema)
        except jschema.SchemaError as e:
            raised += 1
            with pytest.raises(SchemaError) as got:
                schema_to_regex(schema)
            assert str(got.value) == str(e)
            continue
        assert schema_to_regex(schema) == ref, schema
    assert raised > 5


# -- one-shot generation ------------------------------------------------------

J_ENG = JaxEngine(JM)
T_ENG = InferenceEngine(TM, device="cpu")


@pytest.mark.parametrize("pattern,eos", [
    ("[0-9]+", -1), ("(ab|cd)+e", -1), ("yes|no", -1), (".*", 3),
    ("(ab|cd)+e", 7),
])
def test_generate_constrained_equals_reference(pattern, eos):
    """Greedy tokens, lengths and acceptance equal the reference's,
    through dead ends and EOS (which is not emitted)."""
    c_ref = jcon.compile_constraint(pattern, TOKENS)
    c = compile_constraint(pattern, TOKENS)
    prompt = np.random.default_rng(3).integers(1, 15, (4, 5)).astype(
        np.int32)
    ref = J_ENG.generate_constrained(
        JP, jnp.asarray(prompt), c_ref, max_new_tokens=10,
        sampling=JaxSampling(eos_id=eos))
    got = T_ENG.generate_constrained(
        TP, torch.from_numpy(prompt), c, max_new_tokens=10,
        sampling=SamplingConfig(eos_id=eos))
    for key in ("tokens", "lengths", "accepted"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    for b in range(4):
        s = _decode(got["tokens"][b][:int(got["lengths"][b])].tolist())
        if bool(got["accepted"][b]):
            assert re.fullmatch(pattern, s), (pattern, s)
        else:
            assert _is_language_prefix(pattern, s), (pattern, s)


def test_permissive_pattern_matches_plain_greedy():
    """'.*' over a vocabulary without an empty token reproduces
    unconstrained greedy."""
    toks = ["0", "1", "ab", "cd", "e", "x", "y"]
    tm = TransformerLM(TransformerConfig(**dict(DIMS, vocab_size=len(toks)),
                                         dtype=torch.float32), device="cpu")
    params = tm.init(2)
    eng = InferenceEngine(tm, device="cpu")
    c = compile_constraint(".*", toks)
    assert c.allowed.all()
    prompt = torch.randint(0, len(toks), (2, 6),
                           generator=torch.Generator().manual_seed(7))
    ref = eng.generate(params, prompt, max_new_tokens=10)
    out = eng.generate_constrained(params, prompt, c, max_new_tokens=10)
    assert torch.equal(out["tokens"], ref.tokens)


def test_sampled_constrained_stays_in_language():
    c = compile_constraint("(ab|cd)+e", TOKENS)
    prompt = torch.randint(1, 15, (4, 4),
                           generator=torch.Generator().manual_seed(9))
    for seed in range(3):
        out = T_ENG.generate_constrained(
            TP, prompt, c, max_new_tokens=9,
            sampling=SamplingConfig(temperature=1.0, top_p=0.9), seed=seed)
        for b in range(4):
            s = _decode(out["tokens"][b][:int(out["lengths"][b])].tolist())
            assert _is_language_prefix("(ab|cd)+e", s), s
            if bool(out["accepted"][b]):
                assert re.fullmatch("(ab|cd)+e", s), s


def test_vocab_mismatch_rejected():
    c = compile_constraint("[0-9]", TOKENS + ["zz"])
    with pytest.raises(ValueError, match="vocab"):
        T_ENG.generate_constrained(TP, torch.ones((1, 3), dtype=torch.int32),
                                   c)


# -- the continuous batcher ---------------------------------------------------

def _serve(b, requests=REQUESTS, **kw):
    b.start()
    try:
        hs = [b.submit(p, max_new_tokens=n, constraint=c, **kw)
              for p, n, c in requests]
        return [h.result() for h in hs], [h.logprobs for h in hs]
    finally:
        b.stop()


def _pool(paged: bool, impl: str = "gather") -> dict:
    return (dict(paged_blocks=BLOCKS, page_size=PAGE, attn_impl=impl)
            if paged else {})


@pytest.fixture(scope="module")
def reference():
    out = {}
    for paged in (False, True):
        kw = dict(paged_blocks=BLOCKS, page_size=PAGE) if paged else {}
        b = JaxBatcher(JM, JP, slots=3, eos_id=0, logprobs=True,
                       constraints=jcon.ConstraintBank(PATTERNS, TOKENS),
                       **kw)
        out[paged] = _serve(b)
    return out


@pytest.mark.parametrize("paged,impl", [
    (False, "gather"), (True, "gather"), (True, "paged_kernel"),
])
def test_batcher_streams_equal_reference(reference, paged, impl):
    """Free and constrained rows together: streams equal the reference's
    and log-probs agree (dead ends retire on EOS with a log-prob of 0).
    ``paged_kernel`` runs the kernel's plain version here."""
    ref_streams, ref_lps = reference[paged]
    pa.reset_counts()
    b = ContinuousBatcher(TM, TP, slots=3, eos_id=0, logprobs=True,
                          constraints=ConstraintBank(PATTERNS, TOKENS),
                          device="cpu", **_pool(paged, impl))
    streams, lps = _serve(b)
    assert streams == ref_streams
    for got, ref in zip(lps, ref_lps):
        np.testing.assert_allclose(got, ref, atol=LP_TOL)
        assert all(math.isfinite(x) for x in got)
    for (_, n, c), s in zip(REQUESTS, streams):
        if c is not None:
            text = _decode(s)
            if len(s) < n:     # stopped before its budget: a full match
                assert re.fullmatch(PATTERNS[c], text), (c, text)
            else:
                assert _is_language_prefix(PATTERNS[c], text), (c, text)
    assert pa.fallback_count == 0


@pytest.mark.parametrize("paged", [False, True])
def test_free_rows_equal_a_bankless_batcher(paged):
    """A bank leaves free rows as they were: tokens and log-probs bit for
    bit against a batcher with no bank."""
    free = [(p, n, None) for p, n, _ in REQUESTS]

    def run(bank):
        return _serve(ContinuousBatcher(
            TM, TP, slots=3, eos_id=0, logprobs=True, constraints=bank,
            device="cpu", **_pool(paged)), free)

    assert run(ConstraintBank(PATTERNS, TOKENS)) == run(None)


def test_batcher_constrained_matches_engine():
    c = compile_constraint("[0-9]+", TOKENS)
    b = ContinuousBatcher(TM, TP, slots=2, eos_id=0, device="cpu",
                          constraints=ConstraintBank({"digits": "[0-9]+"},
                                                     TOKENS))
    prompt = [4, 9, 2, 7, 1]
    (got,), _ = _serve(b, [(prompt, 8, "digits")])
    ref = T_ENG.generate_constrained(TP, torch.tensor([prompt]), c,
                                     max_new_tokens=8)
    assert got == ref["tokens"][0][:int(ref["lengths"][0])].tolist()
    assert all(TOKENS[t].isdigit() for t in got)


def test_sampled_batcher_rows_stay_in_language():
    b = ContinuousBatcher(TM, TP, slots=3, eos_id=0, device="cpu",
                          constraints=ConstraintBank(PATTERNS, TOKENS))
    reqs = [(p, n, c) for p, n, c in REQUESTS if c is not None]
    streams, _ = _serve(b, reqs, temperature=1.0, top_p=0.9, seed=5)
    for (_, n, c), s in zip(reqs, streams):
        text = _decode(s)
        assert _is_language_prefix(PATTERNS[c], text), (c, text)
        if len(s) < n:
            assert re.fullmatch(PATTERNS[c], text), (c, text)


def test_batcher_checks():
    bank = ConstraintBank({"d": "[0-9]+"}, TOKENS + ["zz", "qq"])
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(TM, TP, slots=2, eos_id=0, constraints=bank,
                          device="cpu")
    bank = ConstraintBank({"d": "[0-9]+"}, TOKENS)
    with pytest.raises(ValueError, match="eos_id"):
        ContinuousBatcher(TM, TP, slots=2, constraints=bank, device="cpu")
    with pytest.raises(ValueError, match="cannot be combined"):
        ContinuousBatcher(TM, TP, slots=2, eos_id=0, constraints=bank,
                          draft="ngram", device="cpu")
    b = ContinuousBatcher(TM, TP, slots=2, device="cpu")
    with pytest.raises(KeyError, match="no ConstraintBank"):
        b.submit([1], constraint="d")


def test_json_schema_row_emits_an_instance():
    """Through the DFA and the batcher: a constrained row emits the
    canonical JSON of the schema (the reference's end-to-end case)."""
    schema = {"type": "object", "properties": {
        "status": {"enum": ["ok", "fail"]}, "n": {"type": "integer"}}}
    toks = BPE_ISH[:24]
    tm = TransformerLM(TransformerConfig(**dict(DIMS, vocab_size=len(toks)),
                                         dtype=torch.float32), device="cpu")
    b = ContinuousBatcher(
        tm, tm.init(3), slots=2, eos_id=0, device="cpu",
        constraints=ConstraintBank({"resp": schema_to_regex(schema)}, toks))
    (got,), _ = _serve(b, [([18, 19], 30, "resp")])
    obj = json.loads("".join(toks[t] for t in got))
    assert obj["status"] in ("ok", "fail") and isinstance(obj["n"], int)


def test_lm_server_constraint_param():
    tok = BpeTokenizer.train("0 1 7 9 12 ab cd e yes no " * 30, 260)
    tm = TransformerLM(TransformerConfig(**dict(
        DIMS, vocab_size=tok.vocab_size, n_layers=1), dtype=torch.float32),
        device="cpu")
    srv = LmServer(tm, tm.init(4), tok, constraints={"digits": "[0-9 ]+"},
                   eos_id=0, device="cpu").start()
    try:
        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, out = post({"prompt": "ab cd", "max_new_tokens": 6,
                          "constraint": "digits", "logprobs": True})
        assert code == 200
        assert re.fullmatch("[0-9 ]*", out["text"]), out["text"]
        assert all(math.isfinite(x) for x in out["logprobs"])
        code, err = post({"prompt": "x", "constraint": "nope"})
        assert code == 400 and "unknown constraint" in err["error"]
        code, err = post({"prompt": "x", "constraint": ["d"]})
        assert code == 400 and "string" in err["error"]
    finally:
        srv.stop()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged kernel and the "
                    "constraint tables' gathers run on the card")
    return torch.device("cuda")


# The kernel's shapes: heads of 64, pages of 16.
GPU_DIMS = dict(DIMS, d_model=64, n_heads=2, d_head=64, n_kv_heads=1,
                d_ff=128, max_seq=64)


@pytest.mark.gpu
def test_cuda_constrained_paged_batcher(cuda):
    """Free and constrained rows on the paged pool through the kernel
    (float32): the streams equal the CPU's plain version's, every
    decode step and kernel admission launches the kernel once a layer,
    nothing falls back."""
    from k8s_gpu_tpu_torch.ops import _build

    _build.load("paged_attention")
    jp = JaxLM(JaxConfig(**GPU_DIMS, use_flash=False,
                         dtype=jnp.float32)).init(jax.random.PRNGKey(1))
    streams = {}
    for dev in ("cpu", cuda):
        tm = TransformerLM(TransformerConfig(**GPU_DIMS,
                                             dtype=torch.float32),
                           device=dev)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), dev)
        b = ContinuousBatcher(tm, tp, slots=3, eos_id=0, logprobs=True,
                              constraints=ConstraintBank(PATTERNS, TOKENS),
                              paged_blocks=BLOCKS, page_size=16,
                              attn_impl="paged_kernel", device=dev)
        pa.reset_counts()
        streams[str(dev)], _ = _serve(b)
        if dev != "cpu":
            torch.cuda.synchronize()
        work = (b.admission_paths["paged_cold"]
                + b.admission_paths["paged_shared"]
                + b.dispatched["decode_steps"])
    assert pa.fallback_count == 0
    assert pa.launch_count == GPU_DIMS["n_layers"] * work
    assert streams["cpu"] == streams[str(cuda)]
