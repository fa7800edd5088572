"""The port's InferenceEngine against the JAX reference engine.

The paged pool: ``extend_multi`` (admission windows) and
``decode_step_multi`` (decode) over staggered page tables, against the
reference's ``attn_impl="gather"`` engine on the same weights.  Logits
agree to atol 1e-5 in float32 (only the order of sums differs), the pools
hold the same K/V at the same physical places (written positions equal to
atol 1e-5, untouched positions exactly zero on both sides).  The dense
cache: greedy ``generate`` streams are byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve.engine import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve.engine import _empty_cache_paged as jax_pool
from k8s_gpu_tpu.serve.engine import nucleus_mask as jax_nucleus_mask
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve.engine import InferenceEngine
from k8s_gpu_tpu_torch.serve.engine import _empty_cache_paged as torch_pool
from k8s_gpu_tpu_torch.serve.engine import nucleus_mask

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
PAGE = 8
MP = DIMS["max_seq"] // PAGE
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def _engines(kv_quant=False, impl="gather"):
    return (JaxEngine(JM, kv_quant=kv_quant, attn_impl="gather"),
            InferenceEngine(TM, kv_quant=kv_quant, attn_impl=impl,
                            device="cpu"))


def _pools(n_blocks, kv_quant=False):
    cfg = TM.cfg
    return (jax_pool(JM.cfg, n_blocks, PAGE, kv_quant),
            torch_pool(cfg, n_blocks, PAGE, kv_quant, "cpu"))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32)), torch.tensor(
        np.asarray(x, np.int32))


def _assert_pools_match(jc, tc, atol=1e-5):
    for name in jc:
        a, b = np.asarray(jc[name], np.float32), tc[name].float().numpy()
        np.testing.assert_array_equal(a == 0, b == 0, err_msg=name)
        np.testing.assert_allclose(b, a, atol=atol, err_msg=name)


# Staggered tables: rows own interleaved, non-contiguous blocks; dead
# entries point at trash block 0.
TABLES = np.zeros((3, MP), np.int32)
TABLES[0, :3] = [5, 2, 9]
TABLES[1, :2] = [7, 1]
TABLES[2, :4] = [3, 8, 4, 6]


@pytest.mark.parametrize("impl", ["gather", "paged_kernel"])
def test_extend_then_decode_on_staggered_tables(impl):
    je, te = _engines(impl=impl)
    jc, tc = _pools(10)
    rng = np.random.default_rng(0)
    W = 8
    toks = rng.integers(0, 64, (3, W)).astype(np.int32)
    start = [0, 3, 12]          # row 2 extends on top of 12 earlier slots
    jpages, tpages = _i32(TABLES)
    (js, ts), (jk, tk) = _i32(start), _i32([0, 0, 2])
    jc, jl = je.extend_multi(JP, jc, jnp.asarray(toks), js, js, jk,
                             t_hi=32, pages=jpages, page=PAGE)
    tc, tl = te.extend_multi(TP, tc, torch.from_numpy(toks), ts, ts, tk,
                             t_hi=32, pages=tpages, page=PAGE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    _assert_pools_match(jc, tc)
    pos = np.asarray(start) + W
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for step in range(3):
        (jpos, tpos), (jt, tt) = _i32(pos), _i32(nxt)
        jc, jl = je.decode_step_multi(JP, jc, jt, jpos, jpos, jk, t_hi=32,
                                      pages=jpages, page=PAGE)
        tc, tl = te.decode_step_multi(TP, tc, tt, tpos, tpos, tk, t_hi=32,
                                      pages=tpages, page=PAGE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (tl.numpy().argmax(-1) == nxt).all()
        pos = pos + 1
    _assert_pools_match(jc, tc)


def test_positions_past_the_table_land_in_the_trash_block():
    """A window running past a two-page table: the overrun goes to block
    0, never onto the table's last (live) block or any other block."""
    _, te = _engines()
    _, tc = _pools(6)
    pages = torch.zeros(1, MP, dtype=torch.int32)
    pages[0, :2] = torch.tensor([3, 4])
    narrow = pages[:, :2].contiguous()        # table of width 2
    toks = torch.arange(1, 13, dtype=torch.int32)[None]   # slots 6..17
    six = torch.tensor([6], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    te.extend_multi(TP, tc, toks, six, six, zero, t_hi=16, pages=narrow,
                    page=PAGE)
    written = (tc["k"].abs().sum(dim=(0, 2, 4)) > 0)      # [NB, page]
    assert written[3, 6:].all() and not written[3, :6].any()  # 6, 7
    assert written[4].all()                   # positions 8..15
    assert written[0, :2].all()               # 16, 17 -> trash block
    assert not written[[1, 2, 5]].any()       # nobody else's block


def test_kv_quant_pool_matches_reference():
    """int8 pool: the same int8 values and scales at the same places,
    within one quantization step where a rounding boundary falls between
    the two frameworks' f32 results; logits within 1e-4."""
    je, te = _engines(kv_quant=True)
    jc, tc = _pools(10, kv_quant=True)
    toks = np.random.default_rng(1).integers(0, 64, (3, 8)).astype(np.int32)
    jpages, tpages = _i32(TABLES)
    (js, ts), (jk, tk) = _i32([0, 3, 12]), _i32([0, 0, 0])
    jc, jl = je.extend_multi(JP, jc, jnp.asarray(toks), js, js, jk,
                             t_hi=32, pages=jpages, page=PAGE)
    tc, tl = te.extend_multi(TP, tc, torch.from_numpy(toks), ts, ts, tk,
                             t_hi=32, pages=tpages, page=PAGE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        a = np.asarray(jc[name], np.int32)
        b = tc[name].numpy().astype(np.int32)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 1e-3
        np.testing.assert_allclose(tc[name + "_s"].numpy(),
                                   np.asarray(jc[name + "_s"]), rtol=1e-5)


@pytest.mark.parametrize("pad_left", [0, 3])
def test_dense_generate_greedy_streams_are_byte_equal(pad_left):
    je, te = _engines()
    prompt = np.random.default_rng(2).integers(0, 64, (2, 9)).astype(
        np.int32)
    ref = je.generate(JP, jnp.asarray(prompt), max_new_tokens=12,
                      pad_left=pad_left)
    got = te.generate(TP, torch.from_numpy(prompt), max_new_tokens=12,
                      pad_left=pad_left)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.prompt_logits.numpy(),
                               np.asarray(ref.prompt_logits), atol=1e-5)


def test_nucleus_mask_matches_reference():
    """Per-row top_p, including off (0 and 1): the same survivors, and
    rows with top_p off come back unchanged."""
    rng = np.random.default_rng(3)
    scaled = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
    top_p = np.asarray([0.0, 0.3, 0.9, 1.0, 0.5], np.float32)
    ref = np.asarray(jax_nucleus_mask(jnp.asarray(scaled),
                                      jnp.asarray(top_p)))
    got = nucleus_mask(torch.from_numpy(scaled),
                       torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_array_equal(got[[0, 3]], scaled[[0, 3]])
