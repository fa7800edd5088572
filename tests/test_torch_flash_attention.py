"""The port's flash attention against the JAX reference.

On the CPU the port's ``flash_attention_lse`` is its plain version; it is
held against the JAX ``flash_attention_lse`` run through the Pallas
interpreter (``interpret=True``, as ``tests/test_flash_attention.py``
runs it), in the output, the lse and the three gradients with a non-zero
lse cotangent.  Tolerances:
- float32: atol 2e-5 (values ~1): the kernels' online softmax sums in
  another order than the plain version's full softmax.
- bfloat16: both sides compute in f32 and round their outputs to bf16, so
  out and the gradients may differ by one bf16 step of the largest value
  (2^-7 relative to the largest value); the reference's backward also
  takes delta from the bf16-rounded output and the plain version from
  the f32 one, which shifts the gradients by a few more 2^-9 of their
  scale: gradients are held at 2^-6 of their largest value.  lse is f32
  on both sides (atol 2e-5).

The CUDA kernels have no CPU mode: their tests are marked ``gpu`` and
skip here; ``chip_smoke.py`` also holds them against the plain version on
the card at the flagship training shape.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.ops.attention import flash_attention_lse as jax_flash_lse
from k8s_gpu_tpu_torch.convert import tensor_from_numpy
from k8s_gpu_tpu_torch.ops import attention as fa

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

B, H, S, D = 2, 2, 32, 16


def _inputs(seed, dtype, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    g_lse = rng.standard_normal(shape[:3]).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v, g = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v, g))
    return q, k, v, g, g_lse


def _jax_side(q, k, v, g, g_lse, causal):
    fn = lambda q, k, v: jax_flash_lse(  # noqa: E731
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True)
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return [np.asarray(x).astype(np.float32) for x in (out, lse, *grads)]


def _torch_side(q, k, v, g, g_lse, causal, device="cpu"):
    q, k, v = (tensor_from_numpy(x, device).requires_grad_()
               for x in (q, k, v))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    g_t = tensor_from_numpy(g, device)
    torch.autograd.backward((out, lse),
                            (g_t, torch.from_numpy(g_lse).to(device)))
    return [x.detach().float().cpu().numpy()
            for x in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_kernels_with_lse_cotangent(causal, dtype):
    data = _inputs(0, dtype)
    ref = _jax_side(*data, causal)
    before = fa.plain_count
    got = _torch_side(*data, causal)
    assert fa.plain_count == before + 1       # CPU tensors: plain version
    names = ("out", "lse", "dq", "dk", "dv")
    for name, r, x in zip(names, ref, got):
        assert x.shape == r.shape, name
        if dtype == "float32" or name == "lse":
            np.testing.assert_allclose(x, r, atol=2e-5, err_msg=name)
        else:
            rel = 2.0 ** -7 if name == "out" else 2.0 ** -6
            assert np.abs(x - r).max() <= rel * np.abs(r).max(), name


def test_lse_cotangent_reaches_q_and_k():
    """With dO = 0 only the lse cotangent drives the backward: dv is zero,
    and dq/dk match the reference's (delta = -g_lse)."""
    q, k, v, g, g_lse = _inputs(1, "float32")
    g = np.zeros_like(g)
    ref = _jax_side(q, k, v, g, g_lse, True)
    got = _torch_side(q, k, v, g, g_lse, True)
    assert np.abs(got[2]).max() > 1e-3
    np.testing.assert_array_equal(got[4], 0.0)
    for r, x in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(x, r, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_kernels_match_autograd(causal):
    """``reference_bwd_dq``/``reference_bwd_dkv`` (the dq and dk/dv
    kernels' plain versions, from lse and delta = rowsum(dO * O) - g_lse)
    equal the autograd of ``reference_attention_lse``."""
    q, k, v, g, g_lse = (torch.from_numpy(x)
                         for x in _inputs(5, "float32", (1, 2, 40, 16)))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = fa.reference_attention_lse(qg, kg, vg, causal)
    torch.autograd.backward((out, lse), (g, g_lse))
    delta = (g * out.detach()).sum(-1) - g_lse
    dq = fa.reference_bwd_dq(q, k, v, g, lse.detach(), delta, causal)
    dk, dv = fa.reference_bwd_dkv(q, k, v, g, lse.detach(), delta, causal)
    for got, ref in ((dq, qg.grad), (dk, kg.grad), (dv, vg.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_bf16_backward_rounding_within_its_bound(d, causal):
    """The bf16 backward kernels round p to bf16 before dv = p^T dO and ds
    before dq = ds k and dk = ds^T q.  Done so in plain torch on bf16
    values (f32 otherwise), each gradient stays within
    ``reference_bwd_rounding``'s term (2^-8 of the same product over
    absolute values) of the f32 plain versions, plus 1e-6 of the largest
    value for f32 summation order; and the rounding does move them."""
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32))
                         for x in _inputs(8, "bfloat16", (2, 3, 100, d)))
    out, lse = fa.reference_attention_lse(q, k, v, causal)
    delta = (g * out).sum(-1) - g_lse
    p, ds = fa._probs_ds(q, k, v, g, lse, delta, causal)
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    got = (torch.einsum("bhqk,bhkd->bhqd", ds16, k),
           torch.einsum("bhqk,bhqd->bhkd", ds16, q),
           torch.einsum("bhqk,bhqd->bhkd", p16, g))
    ref = (fa.reference_bwd_dq(q, k, v, g, lse, delta, causal),
           *fa.reference_bwd_dkv(q, k, v, g, lse, delta, causal))
    terms = fa.reference_bwd_rounding(q, k, v, g, lse, delta, causal)
    for name, x, r, t in zip(("dq", "dk", "dv"), got, ref, terms):
        diff = (x - r).abs()
        assert bool((diff <= t + 1e-6 * r.abs().max()).all()), name
        assert float(diff.max()) > 1e-6 * float(r.abs().max()), name


def test_plan_and_describe():
    assert fa.flash_plan(128, torch.bfloat16) == (64, 64, None)
    assert fa.flash_plan(16, torch.float32, 64, 64) == (64, 64, None)
    assert "head dim 48" in fa.flash_plan(48, torch.bfloat16)[2]
    assert "float16" in fa.flash_plan(128, torch.float16)[2]
    assert "compiled for 64x64" in fa.flash_plan(128, torch.bfloat16,
                                                 512, 512)[2]

    class Cfg:
        use_flash, d_head, dtype = True, 128, torch.bfloat16
        flash_block_q = flash_block_k = 0

    assert fa.describe_train_attention(Cfg) == "flash-v1 blocks 64x64"
    Cfg.flash_block_q = 512
    assert "rejected" in fa.describe_train_attention(Cfg)
    Cfg.use_flash = False
    assert fa.describe_train_attention(Cfg).startswith("plain-causal")


def test_cpu_ignores_tiles_and_counts_no_launch():
    """The plain version has no tiles: a CPU call with the TPU's 512
    blocks runs, counted as plain; no kernel launch is counted."""
    q, k, v, _, _ = _inputs(2, "float32", (1, 2, 40, 48))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    fa.reset_counts()
    out, lse = fa.flash_attention_lse(*t, block_q=512, block_k=512)
    ref_out, ref_lse = fa.reference_attention_lse(*t)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert fa.plain_count == 1
    assert sum(fa.launch_counts.values()) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py holds them on the card)")
    return torch.device("cuda")


def _vs_f32_plain(q, k, v, g, g_lse, causal, device):
    """Kernel outputs and the plain version's in float32 on the same
    values, as numpy."""
    got = _torch_side(q, k, v, g, g_lse, causal, device)
    wide = [np.asarray(x, np.float32) for x in (q, k, v, g)]
    q32, k32, v32 = (torch.from_numpy(x).to(device).requires_grad_()
                     for x in wide[:3])
    out, lse = fa.reference_attention_lse(q32, k32, v32, causal)
    torch.autograd.backward(
        (out, lse), (torch.from_numpy(wide[3]).to(device),
                     torch.from_numpy(g_lse).to(device)))
    ref = [x.detach().cpu().numpy()
           for x in (out, lse, q32.grad, k32.grad, v32.grad)]
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_version(cuda, dtype, d):
    """Every templated head width in both types, causal, an odd S of 100
    (a ragged last tile), a non-zero lse cotangent.  Against the plain
    version in float32 on the same values, relative to the largest value
    of each output: float32 within 1e-4 (summation order only); bf16 out
    within 2^-7 (one rounding), gradients within 2^-6 (one rounding, and
    delta from the bf16 output); lse (f32 on both sides) within 1e-5."""
    fa.reset_counts()
    got, ref = _vs_f32_plain(*_inputs(3, dtype, (2, 3, 100, d)), True, cuda)
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1, "flash_v2_fwd": 0,
                                "flash_v2_bwd_dq": 0, "flash_v2_bwd_dkv": 0}
    assert fa.plain_count == 0
    for name, r, x in zip(("out", "lse", "dq", "dk", "dv"), ref, got):
        if dtype == "float32":
            rel = 1e-4
        else:
            rel = {"out": 2.0 ** -7, "lse": 1e-5}.get(name, 2.0 ** -6)
        assert np.abs(x - r).max() <= rel * np.abs(r).max(), name


@pytest.mark.gpu
def test_cuda_non_causal_long_sequence(cuda):
    got, ref = _vs_f32_plain(*_inputs(4, "float32", (1, 2, 1000, 64)),
                             False, cuda)
    for r, x in zip(ref, got):
        assert np.abs(x - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_bf16_forward_on_tensor_cores(cuda, d, s, causal):
    """The bf16 forward kernel (mma.sync products, p rounded to bf16
    before P.V) alone against the plain version in float32 on the same
    values, element by element: out within 2^-7 |r| (its own rounding) +
    2^-8 (P.|V|) (the rounding of each p: bf16's unit roundoff times
    sum_j p_j |v_j| / l) + 1e-4 max|r| (summation order); lse within 1e-5
    of its largest value (the products are exact, the sums f32)."""
    q, k, v = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
               for x in _inputs(6, "bfloat16", (2, 3, s, d))[:3])
    fa.reset_counts()
    out, lse = fa.flash_forward(*(t.to(torch.bfloat16) for t in (q, k, v)),
                                causal)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_fwd"] == 1 and fa.plain_count == 0
    ref, ref_lse = fa.reference_attention_lse(q, k, v, causal)
    pv = fa.reference_attention_lse(q, k, v.abs(), causal)[0]
    limit = 2.0 ** -7 * ref.abs() + 2.0 ** -8 * pv + 1e-4 * ref.abs().max()
    assert bool(((out.float() - ref).abs() <= limit).all())
    assert float((lse - ref_lse).abs().max()) <= (
        1e-5 * float(ref_lse.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_bf16_backward_on_tensor_cores(cuda, d, s, causal):
    """The bf16 dq and dk/dv kernels (mma.sync products, p rounded to
    bf16 before dv += p^T dO, ds before dq += ds k and dk += ds^T q) alone
    against the plain versions in float32 on the same values and the same
    lse and delta, element by element: within 2^-7 |r| (the output's own
    rounding) + ``reference_bwd_rounding``'s term (2^-8 |dS||K|,
    2^-8 |dS|^T|Q|, 2^-8 P^T|dO|) + 1e-4 max|r| (summation order)."""
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
                         for x in _inputs(7, "bfloat16", (2, 3, s, d)))
    out, lse = fa.reference_attention_lse(q, k, v, causal)
    delta = ((g * out).sum(-1) - g_lse).contiguous()
    fa.reset_counts()
    low = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    dq = fa.flash_backward_dq(*low, lse, delta, causal)
    dk, dv = fa.flash_backward_dkv(*low, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_bwd_dq"] == 1
    assert fa.launch_counts["flash_bwd_dkv"] == 1 and fa.plain_count == 0
    ref = (fa.reference_bwd_dq(q, k, v, g, lse, delta, causal),
           *fa.reference_bwd_dkv(q, k, v, g, lse, delta, causal))
    terms = fa.reference_bwd_rounding(q, k, v, g, lse, delta, causal)
    for name, x, r, t in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, terms):
        limit = 2.0 ** -7 * r.abs() + t + 1e-4 * r.abs().max()
        assert bool(((x.float() - r).abs() <= limit).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["head_dim", "dtype", "blocks"])
def test_cuda_rejects_what_the_kernels_do_not_take(cuda, case):
    shape, dtype, kw = (1, 2, 64, 64), torch.bfloat16, {}
    if case == "head_dim":
        shape = (1, 2, 64, 48)
    elif case == "dtype":
        dtype = torch.float16
    else:
        kw = dict(block_q=128, block_k=128)
    q = torch.randn(shape, device=cuda).to(dtype)
    fa.reset_counts()
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q, q, q, **kw)
    assert sum(fa.launch_counts.values()) == 0 and fa.plain_count == 0
