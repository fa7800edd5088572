"""The port's TransformerLM against the JAX reference, on the same
weights carried across by ``convert.py``.

Tolerances: float32 on the CPU, where the two frameworks differ only in
the order of their sums — atol 1e-5 on logits of magnitude ~1.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.models.transformer import emb_lookup as jax_emb_lookup
from k8s_gpu_tpu.models.transformer import wt as jax_wt
from k8s_gpu_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.models.transformer import emb_lookup, wt

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=64)


def _pair(n_kv_heads):
    jm = JaxLM(JaxConfig(**DIMS, n_kv_heads=n_kv_heads, use_flash=False,
                         dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(
        TransformerConfig(**DIMS, n_kv_heads=n_kv_heads, dtype=torch.float32),
        device="cpu",
    )
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("n_kv_heads", [0, 2, 1])
def test_forward_logits_match_reference(n_kv_heads):
    jm, jp, tm, tp = _pair(n_kv_heads)
    toks = np.random.default_rng(0).integers(0, 64, (2, 11)).astype(np.int32)
    ref, _ = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm.forward(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shape", ["shared", "per_row"])
def test_rope_positions_match_reference(shape):
    jm, _, tm, _ = _pair(2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    if shape == "shared":
        pos = np.arange(5, dtype=np.int32) + 7
    else:
        pos = rng.integers(0, 60, (3, 5)).astype(np.int32)
    ref = jm._rope(jnp.asarray(x), jnp.asarray(pos))
    got = tm._rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_int8_leaves_through_wt_and_emb_lookup():
    """The int8 serving form {q, s} dequantizes the same way on both
    sides: per-channel weight scales and per-row embedding scales."""
    rng = np.random.default_rng(2)
    w = {"q": rng.integers(-127, 128, (16, 4, 8)).astype(np.int8),
         "s": rng.random((1, 4, 8)).astype(np.float32)}
    emb = {"q": rng.integers(-127, 128, (64, 16)).astype(np.int8),
           "s": rng.random((64, 1)).astype(np.float32)}
    toks = rng.integers(0, 64, (2, 5)).astype(np.int32)
    tw = params_from_numpy(w, "cpu")
    te = params_from_numpy(emb, "cpu")
    assert tw["q"].dtype == torch.int8 and te["q"].dtype == torch.int8
    np.testing.assert_array_equal(
        wt(tw, torch.float32).numpy(),
        np.asarray(jax_wt(jax.tree.map(jnp.asarray, w), jnp.float32)))
    np.testing.assert_array_equal(
        emb_lookup(te, torch.from_numpy(toks), torch.float32).numpy(),
        np.asarray(jax_emb_lookup(jax.tree.map(jnp.asarray, emb),
                                  jnp.asarray(toks), jnp.float32)))


def test_bf16_leaves_cross_bit_for_bit():
    a = (np.random.default_rng(3).standard_normal((4, 6)) * 10).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_bf16_rmsnorm_cast_points_match_reference():
    """bf16 in, bf16 out: the cast to x.dtype happens before the scale
    multiply on both sides (one bf16 ulp of slack for rsqrt)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32)).astype(ml_dtypes.bfloat16)
    scale = (rng.random(32) + 0.5).astype(np.float32)
    ref = JaxLM._rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    got = TransformerLM._rmsnorm(tensor_from_numpy(x, "cpu"),
                                 torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               rtol=2 ** -7)
