"""The port's int8 weights (``serve/quant.py``) and the engine's
``int8_compute`` against the JAX reference, same float weights.

- ``quantize_params`` and ``int8_draft``: the same int8 ``q`` bit for bit
  and the same ``s`` within one float32 ulp, from float32 and from bf16
  weights;
- ``quantize_act`` and ``int8_dot``: int8 values equal, products within
  1e-6 relative (both sides sum int8 x int8 exactly in int32 and scale in
  the same order);
- the plain integer product stays exact past float32's 2^24;
- an ``int8_compute`` engine's prefill and decode logits within 1e-4 of
  the reference's;
- on the card (``gpu``), ``torch._int_mm`` through ``int_mm`` at 8, 17 and
  64 rows against the plain integer product, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import engine as jax_engine
from k8s_gpu_tpu.serve import quant as jax_quant
from k8s_gpu_tpu.serve import speculative as jax_spec
from k8s_gpu_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import quant
from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
from k8s_gpu_tpu_torch.serve.speculative import int8_draft

torch.set_num_threads(1)

DIMS = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
_CACHE = {}


def _models(dtype="float32"):
    if dtype not in _CACHE:
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "float32" else torch.bfloat16
        jm = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jdt))
        jp = jm.init(jax.random.PRNGKey(0))
        if dtype != "float32":
            jp = jax.tree.map(lambda a: a.astype(jdt), jp)
        tm = TransformerLM(TransformerConfig(**DIMS, dtype=tdt),
                           device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[dtype] = (jm, jp, tm, tp)
    return _CACHE[dtype]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")


def _assert_same_quantized(ref_tree, got_tree):
    ref = dict(_leaves(ref_tree))
    got = dict(_leaves(got_tree))
    assert set(ref) == set(got) and len(ref) == 9
    for name, leaf in ref.items():
        q = np.asarray(leaf["q"])
        s = np.asarray(leaf["s"], np.float32)
        assert got[name]["q"].dtype == torch.int8, name
        np.testing.assert_array_equal(got[name]["q"].numpy(), q, name)
        gs = got[name]["s"].numpy()
        assert gs.dtype == np.float32 and gs.shape == s.shape, name
        # One float32 ulp of the scale.
        np.testing.assert_array_less(np.abs(gs - s),
                                     np.spacing(s) * 1.0001, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_reference(dtype):
    _, jp, _, tp = _models(dtype)
    _assert_same_quantized(jax_quant.quantize_params(jp),
                           quant.quantize_params(tp))
    kept = quant.quantize_params(tp, quantize_embed=False)
    assert not isinstance(kept["embed"], dict)
    assert not isinstance(tp["blocks"]["wq"], dict)   # input untouched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_draft_carries_across(dtype):
    """A draft quantized by the reference and one quantized by the port
    from the same float weights hold the same ``q`` and ``s``; the
    reference's tree also crosses as it is (``params_from_numpy``)."""
    _, jp, _, tp = _models(dtype)
    ref = jax_spec.int8_draft(jp)
    _assert_same_quantized(ref, int8_draft(tp))
    crossed = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    _assert_same_quantized(ref, crossed)
    assert quant.quantized_bytes(int8_draft(tp)) == tuple(
        int(x) for x in jax_quant.quantized_bytes(ref))


def test_quantize_act_matches_reference():
    x = np.random.default_rng(0).normal(size=(3, 5, 32)).astype(np.float32)
    x[0, 0] = 0.0                          # an all-zero row: scale 1e-8/127
    qr, sr = jax_quant.quantize_act(jnp.asarray(x))
    qg, sg = quant.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(qg.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sr))


@pytest.mark.parametrize("leaf,shape", [
    ("wq", (2, 3, 32)), ("wk", (1, 1, 32)), ("wo", (2, 3, 4, 8)),
    ("wi_up", (4, 1, 32)), ("wo_mlp", (2, 3, 64)), ("head", (2, 7, 32)),
])
def test_int8_dot_matches_reference(leaf, shape):
    _, jp, _, tp = _models()
    jq = jax_quant.quantize_params(jp)
    tq = quant.quantize_params(tp)
    if leaf == "head":
        jl, tl = jq["head"], tq["head"]
    else:
        jl = jax.tree.map(lambda a: a[1], jq["blocks"][leaf])
        tl = {k: v[1] for k, v in tq["blocks"][leaf].items()}
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_quant.int8_dot(jnp.asarray(x), jl, jnp.float32))
    contract = 2 if leaf == "wo" else 1      # wo contracts H and Dh
    got = quant.int8_dot(torch.from_numpy(x), tl, torch.float32, contract)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_plain_integer_product_is_exact_past_float32():
    """A sum of 4096 int8 x int8 products near 127 x 127 needs 26 bits:
    the plain version sums in int32, where float32 would round."""
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 16), -127, dtype=torch.int8)
    b[0, :] = 0
    want = -127 * 127 * 4095                        # -66,048,255: odd
    assert float(np.float32(want)) != want
    y = quant.int_mm(a, b)
    assert y.dtype == torch.int32
    assert int(y[0, 0]) == want and int(y[2, 15]) == want
    x = torch.full((2, 4096), 0.5)
    leaf = {"q": b, "s": torch.ones(1, 16)}
    out = quant.int8_dot(x, leaf, torch.float32, 1)
    assert float(out[0, 0]) == pytest.approx(want * 0.5 / 127, rel=1e-7)


def test_int8_compute_engine_matches_reference():
    """Prefill and one decode step of an ``int8_compute`` engine on the
    int8 tree: logits within 1e-4 of the reference engine's (both take
    the same int8 x int8 products)."""
    jm, jp, tm, tp = _models()
    jq = jax_quant.quantize_params(jp)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    prompt = np.random.default_rng(2).integers(1, 90, (2, 10))
    jeng = jax_engine.InferenceEngine(jm, int8_compute=True)
    teng = InferenceEngine(tm, int8_compute=True, device="cpu")
    jc, jl = jeng.prefill(jq, jnp.asarray(prompt, jnp.int32))
    tc, tl = teng.prefill(tq, torch.from_numpy(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _, jd = jeng.decode_step(jq, jc, 10, jnp.asarray(tok))
    _, td = teng.decode_step(tq, tc, 10, torch.from_numpy(tok))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    # The plain wt() path reads the same tree differently: int8_compute
    # really changed the products.
    _, plain = InferenceEngine(tm, device="cpu").prefill(
        tq, torch.from_numpy(prompt))
    assert not torch.equal(plain, tl)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm is the card's "
                    "integer product (the CPU takes the plain int32 one)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 17, 64])
def test_cuda_int_mm_is_exact(cuda, m):
    """A draft decode step has 8 rows (the slots): the wrapper pads them
    past _int_mm's 16-row floor and odd widths to multiples of 8."""
    gen = torch.Generator().manual_seed(m)
    for k, n in ((512, 1024), (4096, 24), (40, 13)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8)
        before = quant.launch_count
        got = quant.int_mm(a.to(cuda), b.to(cuda))
        assert quant.launch_count == before + 1
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert torch.equal(got.cpu(), quant.int_mm(a, b))


@pytest.mark.gpu
def test_cuda_int8_dot_matches_the_plain_version(cuda):
    _, _, _, tp = _models()
    leaf = quant.quantize_params(tp)["blocks"]["wq"]
    leaf = {k: v[0] for k, v in leaf.items()}
    x = torch.randn(8, 1, 32, generator=torch.Generator().manual_seed(3))
    ref = quant.int8_dot(x, leaf, torch.float32, 1)
    got = quant.int8_dot(x.to(cuda), {k: tensor_from_numpy(v.numpy(), cuda)
                                      for k, v in leaf.items()},
                         torch.float32, 1)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-7)
