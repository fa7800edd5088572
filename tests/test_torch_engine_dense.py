"""The port's InferenceEngine on the dense cache with every row at its own
position, against the JAX reference engine on the same weights, float32.

``decode_step_multi`` and ``extend_multi`` without page tables, with
per-row ``start``, ``rope`` and ``kv_start`` (a left-padded row decodes
with RoPE positions behind its cache positions and masks its pad):
logits agree to atol 1e-5 (1e-4 with an int8 cache) and the caches hold
the same values at the same places.  ``_cache_store``'s three write
geometries are held exactly against the reference's on random data,
including the writes the reference's scatter drops (positions at or
past ``max_seq``) and the start ``dynamic_update_slice`` clamps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve.engine import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve.engine import _empty_cache as jax_cache
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
from k8s_gpu_tpu_torch.serve.engine import _empty_cache as torch_cache

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=64)
T = DIMS["max_seq"]
_MODELS = {}


def _models(kv_heads: int):
    if kv_heads not in _MODELS:
        dims = dict(DIMS, n_kv_heads=kv_heads)
        jm = JaxLM(JaxConfig(**dims, use_flash=False, dtype=jnp.float32))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                           device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[kv_heads] = (jm, jp, tm, tp)
    return _MODELS[kv_heads]


def _engines(kv_heads, kv_quant=False):
    jm, jp, tm, tp = _models(kv_heads)
    return (JaxEngine(jm, kv_quant=kv_quant), jp,
            InferenceEngine(tm, kv_quant=kv_quant, device="cpu"), tp)


def _i32(x):
    a = np.asarray(x, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _assert_caches_match(jc, tc, kv_quant):
    for name in jc:
        a, b = np.asarray(jc[name]), tc[name].numpy()
        if kv_quant and name in ("k", "v"):
            # One int8 step where the float32 values straddle a rounding
            # boundary.
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            assert (a != b).mean() < 1e-2
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


# Three rows: a cold one from 0, one left-padded by 5 (RoPE 5 behind its
# cache positions, slots below 5 masked), one extending 20 earlier slots.
START = [0, 5, 20]
ROPE = [0, 0, 20]
KV_START = [0, 5, 0]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("kv_heads", [2, 0])
def test_extend_then_decode_with_per_row_geometry(kv_heads, kv_quant):
    je, jp, te, tp = _engines(kv_heads, kv_quant)
    jc = jax_cache(je.cfg, 3, T, kv_quant)
    tc = torch_cache(te.cfg, 3, T, kv_quant, "cpu")
    atol = 1e-4 if kv_quant else 1e-5
    W = 12
    toks = np.random.default_rng(0).integers(0, 64, (3, W)).astype(np.int32)
    (js, ts), (jr, tr), (jk, tk) = _i32(START), _i32(ROPE), _i32(KV_START)
    jc, jl = je.extend_multi(jp, jc, jnp.asarray(toks), js, jr, jk)
    tc, tl = te.extend_multi(tp, tc, torch.from_numpy(toks), ts, tr, tk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    _assert_caches_match(jc, tc, kv_quant)
    pos, rope = np.asarray(START) + W, np.asarray(ROPE) + W
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t_hi in (48, None, 48):
        (jp_, tp_), (jr, tr), (jt, tt) = _i32(pos), _i32(rope), _i32(nxt)
        jc, jl = je.decode_step_multi(jp, jc, jt, jp_, jr, jk, t_hi=t_hi)
        tc, tl = te.decode_step_multi(tp, tc, tt, tp_, tr, tk, t_hi=t_hi)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        pos, rope = pos + 1, rope + 1
    _assert_caches_match(jc, tc, kv_quant)


def test_decode_rows_past_max_seq_write_nowhere():
    """A retired row keeps advancing past max_seq: its write is dropped
    (no error, no other position touched) and the live rows' logits are
    the reference's."""
    je, jp, te, tp = _engines(2)
    rng = np.random.default_rng(1)
    k0 = rng.standard_normal((2, 3, 2, T, 8)).astype(np.float32)
    v0 = rng.standard_normal((2, 3, 2, T, 8)).astype(np.float32)
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    (jpos, tpos), (jt, tt) = _i32([T + 3, 30, T]), _i32([1, 2, 3])
    (jk, tk) = _i32([0, 0, 0])
    jc, jl = je.decode_step_multi(jp, jc, jt, jpos, jpos, jk)
    tc, tl = te.decode_step_multi(tp, tc, tt, tpos, tpos, tk)
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], atol=1e-5)
    for name, ref0 in (("k", k0), ("v", v0)):
        got = tc[name].numpy()
        np.testing.assert_allclose(got, np.asarray(jc[name]), atol=1e-5)
        np.testing.assert_array_equal(got[:, [0, 2]], ref0[:, [0, 2]])
        assert not np.array_equal(got[:, 1, :, 30], ref0[:, 1, :, 30])


# (start, Sq): host-int starts (in range, and past T - Sq, which
# dynamic_update_slice clamps), per-row single positions and per-row
# windows, with positions at or past T in both.
GEOMETRIES = {
    "int_in_range": (7, 5),
    "int_clamped": (T - 2, 5),
    "rows_one": ([3, T - 1, T, T + 40], 1),
    "rows_window": ([0, T - 3, T + 2, 50], 6),
    "rows_window_wide": ([T - 20, 2, 3 * T + 1, T - 40], 40),
}


@pytest.mark.parametrize("rank", [5, 4])           # values, int8 scales
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_cache_store_matches_reference_geometries(geometry, rank):
    start, sq = GEOMETRIES[geometry]
    rng = np.random.default_rng(2)
    shape = (2, 4, 3, T, 8)[:rank]
    arr = rng.standard_normal(shape).astype(np.float32)
    val = rng.standard_normal((4, 3, sq) + shape[4:]).astype(np.float32)
    if isinstance(start, list):
        jstart, tstart = _i32(start)
    else:
        jstart = tstart = start
    ref = JaxEngine._cache_store(jnp.asarray(arr), jnp.asarray(val), jstart,
                                 sq, layer=1)
    got = torch.from_numpy(arr.copy())
    InferenceEngine._cache_store(got, torch.from_numpy(val), tstart, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_prefill_into_a_used_row_equals_a_fresh_prefill():
    """The batcher prefills into its slot's row in place: the row is
    zeroed first, so a previous tenant's K/V leave no trace."""
    je, jp, te, tp = _engines(2)
    prompt = np.random.default_rng(3).integers(0, 64, (1, 16)).astype(
        np.int32)
    ref_cache, ref_logits = je.prefill(jp, jnp.asarray(prompt), pad_left=4)
    used = torch_cache(te.cfg, 1, T, False, "cpu")
    for arr in used.values():
        arr.normal_()
    cache, logits = te.prefill(tp, torch.from_numpy(prompt), 4, cache=used)
    assert cache is used
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(used[name].numpy(),
                                   np.asarray(ref_cache[name]), atol=1e-5)
        assert not used[name][:, :, :, 16:].any()
