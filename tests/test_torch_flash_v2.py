"""The port's flash attention v2 against the JAX reference.

On the CPU the port's ``flash_attention_v2_lse`` is its plain version; it
is held against the JAX ``flash_attention_v2_lse``, whose Pallas kernels
run through the interpreter on the CPU by themselves, in the output, the
lse and the three gradients with a non-zero lse cotangent, across KV head
counts (MHA, GQA, MQA), rope on and off, pipeline factors 1 and 2, causal
and not.  Tolerances are the reference's own (``tests/test_flash_v2.py``
``_tol``): float32 atol 2e-5 (summation order: the kernels' online
softmax against the plain version's full softmax); bfloat16 atol 2e-2 on
values of about 1 (both sides compute in f32 and round the outputs once;
the reference's backward also takes delta from the bf16-rounded output).

The CUDA kernels have no CPU mode: their tests are marked ``gpu`` and
skip here; ``chip_smoke.py`` phase 3c also holds them against the plain
versions on the card at the training shape.
"""

import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.ops import attention as jax_fa
from k8s_gpu_tpu_torch.convert import tensor_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig
from k8s_gpu_tpu_torch.ops import attention as fa

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

B, H, S, D = 2, 4, 64, 16
THETA = 10000.0


def _inputs(seed, dtype, kh, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    q, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, kh, s, d)).astype(np.float32)
            for _ in range(2))
    g_lse = rng.standard_normal(shape[:3]).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v, g = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v, g))
    return q, k, v, g, g_lse


def _jax_side(q, k, v, g, g_lse, causal, rope, pipeline):
    fn = lambda q, k, v: jax_fa.flash_attention_v2_lse(  # noqa: E731
        q, k, v, causal=causal, rope_theta=THETA if rope else None,
        block_q=16, block_k=16, q_pipeline=pipeline)
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return [np.asarray(x).astype(np.float32) for x in (out, lse, *grads)]


def _torch_side(q, k, v, g, g_lse, causal, rope, pipeline, device="cpu"):
    q, k, v = (tensor_from_numpy(x, device).requires_grad_()
               for x in (q, k, v))
    out, lse = fa.flash_attention_v2_lse(
        q, k, v, causal=causal, rope_theta=THETA if rope else None,
        q_pipeline=pipeline)
    torch.autograd.backward(
        (out, lse), (tensor_from_numpy(g, device),
                     torch.from_numpy(g_lse).to(device)))
    return [x.detach().float().cpu().numpy()
            for x in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pipeline", [1, 2])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("kh", [4, 2, 1])  # MHA / GQA / MQA
def test_matches_reference_with_lse_cotangent(kh, rope, pipeline, causal,
                                              dtype):
    data = _inputs(kh * 8 + rope * 4 + pipeline, dtype, kh)
    ref = _jax_side(*data, causal, rope, pipeline)
    got = _torch_side(*data, causal, rope, pipeline)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    for name, r, x in zip(("out", "lse", "dq", "dk", "dv"), ref, got):
        assert x.shape == r.shape, name
        np.testing.assert_allclose(x, r, atol=atol, err_msg=name)


@pytest.mark.parametrize("theta", [THETA, 500000.0])
def test_rope_matches_reference(theta):
    """``rope_block`` (the kernels' exp-form frequencies) and
    ``rope_rotate`` (the pow form) against the reference's, both signs,
    at positions up to 2047.  The two libraries' f32 ``exp``/``pow`` may
    differ by an ulp of a frequency, which position p turns into p * 2^-23
    rad: atol 2e-5 on the first 64 positions, and 2e-5 + 2048 * 2^-23 *
    (|x1| + |x2|) on all (about 1e-3 here; a wrong frequency or sign is off
    by O(1))."""
    x = np.random.default_rng(3).standard_normal((2, 2048, 128)).astype(
        np.float32)
    half = x.shape[-1] // 2
    pair = np.abs(x[..., :half]) + np.abs(x[..., half:])
    far = 2e-5 + 2048 * 2.0 ** -23 * np.concatenate([pair, pair], axis=-1)
    for sign in (1.0, -1.0):
        for got, want, bound in (
            (fa.rope_block(torch.from_numpy(x[0]), 0, theta, sign),
             jax_fa._rope_block(jnp.asarray(x[0]), 0, theta, sign), far[0]),
            (fa.rope_rotate(torch.from_numpy(x), theta, sign=sign),
             jax_fa.rope_rotate(jnp.asarray(x), theta, sign=sign), far),
        ):
            got, want = got.numpy(), np.asarray(want)
            np.testing.assert_allclose(got[..., :64, :], want[..., :64, :],
                                       atol=2e-5)
            assert (np.abs(got - want) <= bound).all()
    # An offset tile rotates as the same rows of the whole sequence.
    np.testing.assert_array_equal(
        fa.rope_block(torch.from_numpy(x[0, 64:128]), 64, theta).numpy(),
        fa.rope_block(torch.from_numpy(x[0]), 0, theta)[64:128].numpy())


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kh", [2, 1])
def test_plain_backward_kernels_match_autograd(kh, causal, rope):
    """``reference_bwd_dq_v2``/``reference_bwd_dkv_v2`` (the v2 dq and dk/dv
    kernels' plain versions, from lse and delta = rowsum(dO * O) - g_lse)
    equal the autograd of ``reference_attention_v2_lse``: the transpose
    rotation and the group sum are right."""
    theta = THETA if rope else None
    q, k, v, g, g_lse = (torch.from_numpy(x) for x in
                         _inputs(5, "float32", kh, (1, 4, 40, 16)))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = fa.reference_attention_v2_lse(qg, kg, vg, causal, theta)
    torch.autograd.backward((out, lse), (g, g_lse))
    delta = (g * out.detach()).sum(-1) - g_lse
    lse = lse.detach()
    dq = fa.reference_bwd_dq_v2(q, k, v, g, lse, delta, causal, theta)
    dk, dv = fa.reference_bwd_dkv_v2(q, k, v, g, lse, delta, causal, theta)
    for got, ref in ((dq, qg.grad), (dk, kg.grad), (dv, vg.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def _split(x):
    """x = hi + lo in bf16 halves, as the kernels' pre-pass splits it."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulated_bf16_backward(q, k, v, g, lse, delta, causal, theta,
                            lo=True):
    """The bf16 v2 backward kernels' arithmetic in plain f32 torch: with
    rope, q and k rotated and split into hi + lo, the scores from three
    products (from the hi planes alone when not ``lo``) and dS K, dS^T Q on
    the hi planes; p and ds rounded to bf16; dk and dv summed over each KV
    head's G query heads; dq and dk through the transpose rotation."""
    grp = q.shape[1] // k.shape[1]
    qf, kf = q.float(), k.float()
    if theta is not None:
        (q_hi, q_lo), (k_hi, k_lo) = (_split(fa.rope_block(x, 0, theta))
                                      for x in (qf, kf))
        if not lo:
            q_lo, k_lo = torch.zeros_like(q_lo), torch.zeros_like(k_lo)
    else:
        q_hi, k_hi = qf, kf
        q_lo, k_lo = torch.zeros_like(qf), torch.zeros_like(kf)
    k_hi, k_lo, vr = (x.repeat_interleave(grp, dim=1)
                      for x in (k_hi, k_lo, v))
    mm = lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b)  # noqa: E731
    s = ((mm(q_hi, k_hi) + mm(q_hi, k_lo) + mm(q_lo, k_hi))
         * q.shape[-1] ** -0.5)
    if causal:
        n = s.shape[-1]
        s = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), s,
                        fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(g, vr) - delta[..., None]) * q.shape[-1] ** -0.5
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds16, k_hi)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, q_hi)
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, g)
    b, kh, s_len, d = k.shape
    dk, dv = (x.view(b, kh, grp, s_len, d).sum(2) for x in (dk, dv))
    if theta is not None:
        dq, dk = (fa.rope_block(x, 0, theta, sign=-1.0) for x in (dq, dk))
    return dq, dk, dv


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("kh", [4, 2, 1])  # G 1 / 2 / 4
def test_bf16_backward_rounding_within_its_bound(kh, rope, causal, d):
    """The bf16 v2 backward kernels' roundings, emulated in plain torch on
    bf16 values (``_emulated_bf16_backward``), move each gradient by no
    more than ``reference_bwd_rounding_v2``'s term plus 1e-6 of the
    largest value (f32 summation order) from the f32 plain versions; and
    the rounding does move them.  With rope, dq goes past v1's plain 2^-8
    term on the rotated, repeated inputs: the split's and the hi plane's
    terms are needed."""
    theta = THETA if rope else None
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)) for x in
                         _inputs(9 + kh, "bfloat16", kh, (2, 4, 100, d)))
    out, lse = fa.reference_attention_v2_lse(q, k, v, causal, theta)
    delta = (g * out).sum(-1) - g_lse
    got = _emulated_bf16_backward(q, k, v, g, lse, delta, causal, theta)
    ref = (fa.reference_bwd_dq_v2(q, k, v, g, lse, delta, causal, theta),
           *fa.reference_bwd_dkv_v2(q, k, v, g, lse, delta, causal, theta))
    terms = fa.reference_bwd_rounding_v2(q, k, v, g, lse, delta, causal,
                                         theta)
    for name, x, r, t in zip(("dq", "dk", "dv"), got, ref, terms):
        assert x.shape == r.shape == t.shape, name
        diff = (x - r).abs()
        assert bool((diff <= t + 1e-6 * r.abs().max()).all()), name
        assert float(diff.max()) > 1e-6 * float(r.abs().max()), name
    if rope:
        v1_dq = fa.reference_bwd_rounding(*fa._v2_inputs(q, k, v, theta), g,
                                          lse, delta, causal)[0]
        slack = 1e-6 * ref[0].abs().max()
        assert bool(((got[0] - ref[0]).abs() > v1_dq + slack).any())


def _beyond_bound(got, q, k, v, g, lse, delta, causal, theta):
    """Per gradient (dq, dk, dv), the largest ratio of its distance from
    the f32 plain version to 2^-7 |r| + ``reference_bwd_rounding_v2``'s
    term + 1e-4 max|r|, the limit the bf16 kernels are held to."""
    ref = (fa.reference_bwd_dq_v2(q, k, v, g, lse, delta, causal, theta),
           *fa.reference_bwd_dkv_v2(q, k, v, g, lse, delta, causal, theta))
    terms = fa.reference_bwd_rounding_v2(q, k, v, g, lse, delta, causal,
                                         theta)
    return [float(((x.float() - r).abs()
                   / (2.0 ** -7 * r.abs() + t + 1e-4 * r.abs().max())).max())
            for x, r, t in zip(got, ref, terms)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kh", [4, 2, 1])  # G 1 / 2 / 4
def test_bf16_backward_needs_the_lo_products(kh, causal, d):
    """With rope, the scores' lo products are what keeps the bf16 backward
    within its bound once scores spread: at q and k twice as wide as unit
    normals (scores of standard deviation 4), the emulated kernels stay
    within ``reference_bwd_rounding_v2``'s limit, and the same arithmetic
    with the scores from the hi planes alone goes past it in every
    gradient (each rounded rotated value is off by up to 2^-8, so each
    score by up to 2^-8 scale sum_i |q_i k_i|, which the bound's split term
    does not cover)."""
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)) for x in
                         _inputs(30 + kh, "bfloat16", kh, (2, 4, 100, d)))
    q, k = 2 * q, 2 * k  # exact: still bf16 values
    out, lse = fa.reference_attention_v2_lse(q, k, v, causal, THETA)
    delta = (g * out).sum(-1) - g_lse
    args = (q, k, v, g, lse, delta, causal, THETA)
    split = _beyond_bound(_emulated_bf16_backward(*args), *args)
    hi_only = _beyond_bound(_emulated_bf16_backward(*args, lo=False), *args)
    assert max(split) <= 1.0, split
    assert min(hi_only) > 1.0, hi_only


def test_rope_split_plain_version():
    """The pre-pass's plain version, which ``flash_v2_rope_split`` takes for
    CPU tensors: q's hi and lo planes, then k's, each hi the rotated value
    rounded to bf16 and hi + lo within 2^-16 of it."""
    q, k, _, _, _ = (torch.from_numpy(np.asarray(x, np.float32)) for x in
                     _inputs(22, "bfloat16", 2, (2, 4, 70, 32)))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    fa.reset_counts()
    planes = fa.flash_v2_rope_split(q, k, THETA)
    assert fa.plain_count == 1 and fa.prepass_counts[
        "flash_v2_rope_split"] == 0
    assert planes.dtype == torch.bfloat16
    assert planes.numel() == 2 * (q.numel() + k.numel())
    n = q.numel()
    for x, (hi, lo) in ((q, (planes[:n], planes[n:2 * n])),
                        (k, (planes[2 * n:2 * n + k.numel()],
                             planes[2 * n + k.numel():]))):
        r = fa.rope_block(x.float(), 0, THETA).reshape(-1)
        assert torch.equal(hi, r.to(torch.bfloat16))
        rebuilt = hi.float() + lo.float()
        assert bool(((rebuilt - r).abs() <= 2.0 ** -16 * r.abs()).all())


@pytest.mark.parametrize("causal", [True, False])
def test_rounding_bound_reduces_to_v1(causal):
    """At G 1 without rope the v2 bound is ``reference_bwd_rounding``'s,
    value for value; with rope it is larger."""
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)) for x in
                         _inputs(21, "bfloat16", 4, (1, 4, 70, 16)))
    out, lse = fa.reference_attention_lse(q, k, v, causal)
    delta = (g * out).sum(-1) - g_lse
    v1 = fa.reference_bwd_rounding(q, k, v, g, lse, delta, causal)
    v2 = fa.reference_bwd_rounding_v2(q, k, v, g, lse, delta, causal)
    for a, b in zip(v1, v2):
        assert torch.equal(a, b)
    roped = fa.reference_bwd_rounding_v2(q, k, v, g, lse, delta, causal,
                                         THETA)
    assert all(float(t.sum()) > float(a.sum()) for t, a in zip(roped, v1))


def test_validation_errors():
    """The reference's errors (``tests/test_flash_v2.py``), on the CPU."""
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(13, "float32", 4))
    with pytest.raises(ValueError, match="multiple of KV heads"):
        fa.flash_attention_v2(q, k[:, :3], v[:, :3], causal=True)
    with pytest.raises(ValueError, match="k/v shape mismatch"):
        fa.flash_attention_v2(q, k, v[:, :1], causal=True)
    with pytest.raises(ValueError, match="even head dim"):
        fa.flash_attention_v2(q[..., :15], k[..., :15], v[..., :15],
                              causal=True, rope_theta=THETA)


def test_no_knobs_routes_to_v1(monkeypatch):
    """KH == H, P == 1, no rope: the v2 entry is the v1 entry's call; any
    knob on takes the v2 plain version (one plain call each)."""
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(14, "float32", 4))
    calls = []
    v1 = fa.flash_attention_lse
    monkeypatch.setattr(fa, "flash_attention_lse",
                        lambda *a, **kw: calls.append(a) or v1(*a, **kw))
    fa.reset_counts()
    got = fa.flash_attention_v2_lse(q, k, v, causal=True)
    assert len(calls) == 1 and fa.plain_count == 1
    for x, r in zip(got, fa.reference_attention_lse(q, k, v, True)):
        assert torch.equal(x, r)
    fa.flash_attention_v2_lse(q, k, v, causal=True, q_pipeline=2)
    fa.flash_attention_v2_lse(q, k[:, :2], v[:, :2], causal=True)
    assert len(calls) == 1 and fa.plain_count == 3
    assert sum(fa.launch_counts.values()) == 0


def test_plan():
    assert fa.flash_v2_plan(128, torch.bfloat16, 2) == (64, 64, None)
    assert fa.flash_v2_plan(16, torch.float32, 1, 64, 64) == (64, 64, None)
    assert "q_pipeline 3" in fa.flash_v2_plan(128, torch.bfloat16, 3)[2]
    assert "head dim 48" in fa.flash_v2_plan(48, torch.bfloat16, 2)[2]
    assert "compiled for 64x64" in fa.flash_v2_plan(128, torch.float32, 1,
                                                    16, 16)[2]


@pytest.mark.parametrize("n_kv_heads,rope,grouped,pipeline", [
    (2, True, True, 2), (2, False, True, 0), (2, True, False, 0),
    (2, False, False, 2), (0, True, True, 2), (0, False, True, 1),
    (2, False, False, 0), (1, False, True, 0),
])
def test_describe_train_attention_knobs_match_reference(n_kv_heads, rope,
                                                        grouped, pipeline):
    """The path's name, knob list included, is the reference's for the
    same configuration; the tile is the port's own 64x64."""
    dims = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=n_kv_heads, d_head=16, d_ff=64, max_seq=64,
                flash_fuse_rope=rope, flash_kv_grouped=grouped,
                flash_q_pipeline=pipeline)
    ref = jax_fa.describe_train_attention(JaxConfig(
        **dims, flash_block_q=16, flash_block_k=16, dtype=jnp.float32))
    got = fa.describe_train_attention(TransformerConfig(
        **dims, dtype=torch.float32))
    name = re.compile(r"flash-v[12](\[[^\]]*\])? blocks ")
    assert name.match(ref).group(0) == name.match(got).group(0), (ref, got)
    assert got.endswith("blocks 64x64")


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc`` header changes the library's hash, so a source
    that includes it never loads a stale build; system headers are not
    followed."""
    from k8s_gpu_tpu_torch.ops import _build

    real = _build._source_bytes(_build.CSRC / "flash_attention_v2.cu", set())
    assert (_build.CSRC / "flash_common.cuh").read_bytes() in real
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n#include <math.h>\n')
    (tmp_path / "h.cuh").write_text('#include "k.cu"\nint a;\n')
    before = _build._source_bytes(tmp_path / "k.cu", set())
    (tmp_path / "h.cuh").write_text('#include "k.cu"\nint b;\n')
    assert _build._source_bytes(tmp_path / "k.cu", set()) != before


def test_describe_names_rejected_pipeline():
    cfg = TransformerConfig(n_heads=4, n_kv_heads=2, d_head=16,
                            flash_kv_grouped=True, flash_q_pipeline=3)
    assert fa.describe_train_attention(cfg).startswith(
        "flash-v2 rejected on the card (q_pipeline 3")


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py holds them on the card)")
    return torch.device("cuda")


def _vs_f32_plain(data, causal, rope, pipeline, device):
    """Kernel outputs and the plain version's in float32 on the same
    values, as numpy."""
    q, k, v, g, g_lse = data
    got = _torch_side(q, k, v, g, g_lse, causal, rope, pipeline, device)
    wide = [np.asarray(x, np.float32) for x in (q, k, v, g)]
    q32, k32, v32 = (torch.from_numpy(x).to(device).requires_grad_()
                     for x in wide[:3])
    out, lse = fa.reference_attention_v2_lse(q32, k32, v32, causal,
                                             THETA if rope else None)
    torch.autograd.backward(
        (out, lse), (torch.from_numpy(wide[3]).to(device),
                     torch.from_numpy(g_lse).to(device)))
    ref = [x.detach().cpu().numpy()
           for x in (out, lse, q32.grad, k32.grad, v32.grad)]
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,s,pipeline,causal", [
    (4, 1, 100, 2, True),    # MQA, a ragged tile in every member
    (4, 2, 130, 1, True),    # GQA, P 1
    (3, 3, 130, 2, True),    # MHA: 3 tiles, the last block's item masked
    (4, 2, 100, 2, False),
])
def test_cuda_kernels_match_plain_version(cuda, dtype, d, h, kh, s,
                                          pipeline, causal):
    """Every templated head width in both types with rope, a non-zero lse
    cotangent.  Against the plain version in float32 on the same values,
    relative to the largest value of each output: float32 within 1e-4
    (summation order); bf16 out within 2^-7 (one rounding), gradients
    within 2^-6 (one rounding, and delta from the bf16 output); lse (f32
    on both sides) within 1e-5."""
    fa.reset_counts()
    got, ref = _vs_f32_plain(_inputs(3, dtype, kh, (2, h, s, d)), causal,
                             True, pipeline, cuda)
    assert fa.launch_counts == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_v2_fwd": 1, "flash_v2_bwd_dq": 1, "flash_v2_bwd_dkv": 1}
    assert fa.plain_count == 0
    for name, r, x in zip(("out", "lse", "dq", "dk", "dv"), ref, got):
        if dtype == "float32":
            rel = 1e-4
        else:
            rel = {"out": 2.0 ** -7, "lse": 1e-5}.get(name, 2.0 ** -6)
        assert np.abs(x - r).max() <= rel * np.abs(r).max(), name


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,pipeline,causal,rope", [
    (4, 4, 2, True, True),    # G 1: a block's two tiles are neighbours
    (4, 2, 1, True, True),    # G 2
    (4, 1, 2, True, True),    # G 4 (MQA)
    (4, 1, 1, False, True),
    (4, 2, 2, False, False),  # no rope: the lo halves are zero
])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_bf16_forward_on_tensor_cores(cuda, d, s, h, kh, pipeline,
                                           causal, rope):
    """The bf16 v2 forward kernel (q and k rotated in f32 and kept as bf16
    hi + lo halves, S from three mma.sync products, p rounded to bf16
    before P.V) alone against the plain version in float32 on the same
    values, element by element: out within 2^-7 |r| + 2^-8 (P.|V|) + 1e-4
    max|r|, as v1's; lse within 1e-5 of its largest value plus the split's
    bound on a score, 3 * 2^-16 * scale * sum_i |q_i k_i| at the row's
    largest (each half holds x to 2^-16 of |x|, and lo_q lo_k is
    dropped)."""
    theta = THETA if rope else None
    q, k, v = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
               for x in _inputs(7, "bfloat16", kh, (2, h, s, d))[:3])
    fa.reset_counts()
    out, lse = fa.flash_v2_forward(
        *(t.to(torch.bfloat16) for t in (q, k, v)), causal, theta, pipeline)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_v2_fwd"] == 1 and fa.plain_count == 0
    ref, ref_lse = fa.reference_attention_v2_lse(q, k, v, causal, theta)
    pv = fa.reference_attention_v2_lse(q, k, v.abs(), causal, theta)[0]
    limit = 2.0 ** -7 * ref.abs() + 2.0 ** -8 * pv + 1e-4 * ref.abs().max()
    assert bool(((out.float() - ref).abs() <= limit).all())
    qr, kr, _ = fa._v2_inputs(q, k, v, theta)
    split = 3 * 2.0 ** -16 * d ** -0.5 * torch.einsum(
        "bhqd,bhkd->bhqk", qr.abs(), kr.abs()).amax(-1)
    assert bool(((lse - ref_lse).abs()
                 <= 1e-5 * ref_lse.abs().max() + split).all())


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,pipeline,causal,rope", [
    (4, 4, 2, True, True),    # G 1: a block's two tiles are neighbours
    (4, 2, 1, True, True),    # G 2
    (4, 1, 2, True, True),    # G 4 (MQA)
    (4, 1, 1, False, True),
    (4, 2, 2, False, False),  # no rope: no lo planes, no rotation
])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_bf16_backward_on_tensor_cores(cuda, d, s, h, kh, pipeline,
                                            causal, rope):
    """The bf16 v2 dq and dk/dv kernels (tensor cores; with rope one
    pre-pass of hi + lo planes for both, three products for the scores,
    dS K and dS^T Q on the hi planes, the transpose rotation on the f32
    accumulators) alone against the plain versions in float32 on the same
    values and the same lse and delta, element by element: within 2^-7 |r|
    (the output's own rounding) + ``reference_bwd_rounding_v2``'s term +
    1e-4 max|r| (summation order)."""
    theta = THETA if rope else None
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
                         for x in _inputs(8, "bfloat16", kh, (2, h, s, d)))
    out, lse = fa.reference_attention_v2_lse(q, k, v, causal, theta)
    delta = ((g * out).sum(-1) - g_lse).contiguous()
    fa.reset_counts()
    low = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    planes = fa.flash_v2_rope_split(*low[:2], theta) if rope else None
    dq = fa.flash_v2_backward_dq(*low, lse, delta, causal, theta, pipeline,
                                 planes)
    dk, dv = fa.flash_v2_backward_dkv(*low, lse, delta, causal, theta,
                                      planes)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_v2_bwd_dq"] == 1
    assert fa.launch_counts["flash_v2_bwd_dkv"] == 1 and fa.plain_count == 0
    assert fa.prepass_counts["flash_v2_rope_split"] == int(rope)
    ref = (fa.reference_bwd_dq_v2(q, k, v, g, lse, delta, causal, theta),
           *fa.reference_bwd_dkv_v2(q, k, v, g, lse, delta, causal, theta))
    terms = fa.reference_bwd_rounding_v2(q, k, v, g, lse, delta, causal,
                                         theta)
    for name, x, r, t in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, terms):
        limit = 2.0 ** -7 * r.abs() + t + 1e-4 * r.abs().max()
        assert bool(((x.float() - r).abs() <= limit).all()), name


def _hi_planes_only(planes, q, k):
    """The pre-pass's planes (q's hi and lo, then k's) with both lo planes
    zeroed: the kernels then take the scores from the hi planes alone."""
    planes = planes.clone()
    planes[q.numel():2 * q.numel()] = 0
    planes[2 * q.numel() + k.numel():] = 0
    return planes


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,pipeline,causal", [
    (4, 4, 2, True), (4, 2, 1, True), (4, 1, 2, False)])
@pytest.mark.parametrize("s", [100, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_bf16_backward_takes_the_lo_products(cuda, d, s, h, kh,
                                                  pipeline, causal):
    """The bf16 v2 dq and dk/dv kernels compute the scores' lo products:
    at q and k twice as wide as unit normals (scores of standard deviation
    4, where ``test_bf16_backward_needs_the_lo_products`` shows them
    needed) every gradient stays within 2^-7 |r| +
    ``reference_bwd_rounding_v2``'s term + 1e-4 max|r| of the f32 plain
    version, and the same kernels given the pre-pass's planes with the lo
    halves zeroed go past that limit in every gradient."""
    q, k, v, g, g_lse = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
                         for x in _inputs(31, "bfloat16", kh, (2, h, s, d)))
    q, k = 2 * q, 2 * k  # exact: still bf16 values
    out, lse = fa.reference_attention_v2_lse(q, k, v, causal, THETA)
    delta = ((g * out).sum(-1) - g_lse).contiguous()
    low = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    planes = fa.flash_v2_rope_split(*low[:2], THETA)
    ratios = []
    for given in (planes, _hi_planes_only(planes, *low[:2])):
        dq = fa.flash_v2_backward_dq(*low, lse, delta, causal, THETA,
                                     pipeline, given)
        dk, dv = fa.flash_v2_backward_dkv(*low, lse, delta, causal, THETA,
                                          given)
        ratios.append(_beyond_bound((dq, dk, dv), q, k, v, g, lse, delta,
                                    causal, THETA))
    assert max(ratios[0]) <= 1.0, ratios
    assert min(ratios[1]) > 1.0, ratios


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pipeline", "head_dim", "dtype", "blocks"])
def test_cuda_rejects_what_the_kernels_do_not_take(cuda, case):
    shape, dtype, kw = (1, 4, 64, 64), torch.bfloat16, {"q_pipeline": 2}
    if case == "pipeline":
        kw = {"q_pipeline": 3}
    elif case == "head_dim":
        shape = (1, 4, 64, 48)
    elif case == "dtype":
        dtype = torch.float16
    else:
        kw = dict(kw, block_q=128, block_k=128)
    q = torch.randn(shape, device=cuda).to(dtype)
    k = q[:, :2].contiguous()
    fa.reset_counts()
    with pytest.raises(ValueError):
        fa.flash_attention_v2_lse(q, k, k, rope_theta=THETA, **kw)
    assert sum(fa.launch_counts.values()) == 0 and fa.plain_count == 0
