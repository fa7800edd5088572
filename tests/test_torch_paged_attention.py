"""The port's paged attention against the JAX reference.

On the CPU the port's ``paged_attention`` is its plain version; it is held
against the JAX ``paged_attention`` run through the Pallas interpreter
(``interpret=True``, as the reference's own tests run it) and against the
port's ``paged_attention_reference``.  Tolerance: atol 2e-5 in float32 —
the kernel's online softmax sums in another order than the gather path.

The CUDA kernel itself has no CPU mode: its tests are marked ``gpu`` and
skip here; ``chip_smoke.py`` holds it against the plain version on the
card at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.ops.paged_attention import paged_attention as jax_paged
from k8s_gpu_tpu_torch.ops import paged_attention as pa

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

PAGE = 8


def _case(B, Sq, H, KH, Dh, MP, seed=0, quant=False, page=PAGE):
    """Random pool and valid tables (row b owns blocks 1 + b*MP ...; block
    0 is the trash block), as numpy arrays for both frameworks."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * MP
    c = {
        "q": rng.standard_normal((B, Sq, H, Dh)).astype(np.float32),
        "k": rng.standard_normal((NB, KH, page, Dh)).astype(np.float32),
        "v": rng.standard_normal((NB, KH, page, Dh)).astype(np.float32),
        "pages": np.asarray([[1 + b * MP + j for j in range(MP)]
                             for b in range(B)], np.int32),
        "k_scale": None, "v_scale": None,
    }
    if quant:
        for name in ("k", "v"):
            amax = np.abs(c[name]).max(-1)
            s = np.maximum(amax, 1e-8) / 127.0
            c[name] = np.clip(np.round(c[name] / s[..., None]), -127,
                              127).astype(np.int8)
            c[name + "_scale"] = s.astype(np.float32)
    return c


def _both(c, start, kv_start, t_hi):
    """(JAX interpret-mode kernel, port wrapper, port plain version)."""
    start = np.asarray(start, np.int32)
    kv_start = np.asarray(kv_start, np.int32)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    ref = jax_paged(
        j(c["q"]), j(c["k"]), j(c["v"]), j(c["pages"]), j(start),
        j(kv_start), page=PAGE, t_hi=t_hi, k_scale=j(c["k_scale"]),
        v_scale=j(c["v_scale"]), interpret=True,
    )
    args = (t(c["q"]), t(c["k"]), t(c["v"]), t(c["pages"]), t(start),
            t(kv_start))
    kw = dict(page=PAGE, t_hi=t_hi, k_scale=t(c["k_scale"]),
              v_scale=t(c["v_scale"]))
    return (np.asarray(ref), pa.paged_attention(*args, **kw).numpy(),
            pa.paged_attention_reference(*args, **kw).numpy())


@pytest.mark.parametrize("H,KH,Sq", [
    (2, 2, 1),   # MHA decode
    (4, 2, 1),   # GQA decode
    (4, 1, 3),   # MQA, a multi-token window
    (4, 2, 5),   # GQA window
])
def test_matches_reference_kernel(H, KH, Sq):
    c = _case(3, Sq, H, KH, 16, 4)
    t_hi = 3 * PAGE
    ref, got, plain = _both(c, [t_hi - Sq, PAGE + 1, 2 * PAGE - Sq],
                            [0, 2, PAGE], t_hi)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(plain, ref, atol=2e-5)


@pytest.mark.parametrize("n_pages", [1, 2, 4])
def test_ragged_t_hi(n_pages):
    t_hi = n_pages * PAGE
    c = _case(2, 1, 2, 2, 16, 4, seed=1)
    ref, got, _ = _both(c, [t_hi - 1, max(t_hi - PAGE, 0)], [0, 0], t_hi)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_trash_block_and_cross_tenant_isolation():
    """Tables end after two live pages and point at trash block 0 past
    that; a bucket wider than either row streams the trash block masked.
    Large values in the trash block and NaN in every block no row owns
    (another tenant's live data) change nothing, bit for bit."""
    c = _case(2, 1, 2, 2, 16, 4, seed=2)
    c["pages"] = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    start, kv_start, t_hi = [2 * PAGE - 1, PAGE + 3], [0, 0], 4 * PAGE
    ref, got, _ = _both(c, start, kv_start, t_hi)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    for name in ("k", "v"):
        c[name] = c[name].copy()
        c[name][0] = 1e4
        c[name][5:] = np.nan
    args = [torch.from_numpy(c[n]) for n in ("q", "k", "v", "pages")]
    got_p = pa.paged_attention(
        *args, torch.tensor(start, dtype=torch.int32),
        torch.tensor(kv_start, dtype=torch.int32), page=PAGE, t_hi=t_hi)
    np.testing.assert_array_equal(got_p.numpy(), got)


def test_int8_kv_matches_reference_kernel():
    c = _case(2, 1, 4, 2, 16, 3, seed=3, quant=True)
    t_hi = 3 * PAGE
    ref, got, plain = _both(c, [t_hi - 1, 2 * PAGE], [0, 0], t_hi)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(plain, ref, atol=2e-5)


def test_supported_matrix_for_the_card():
    shape = (2, 1, 8, 128)
    ok = dict(page=64, t_hi=128, max_pages=4)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert pa.supported(shape, bf16, bf16, **ok)
    assert pa.supported(shape, f32, f32, **ok)
    assert pa.supported(shape, bf16, i8, **ok)
    assert pa.supported((2, 512, 32, 64), bf16, i8, page=16, t_hi=48,
                        max_pages=3)
    # Geometry: partial page, no page, table too narrow.
    assert not pa.supported(shape, bf16, bf16, page=64, t_hi=96,
                            max_pages=4)
    assert not pa.supported(shape, bf16, bf16, page=64, t_hi=0, max_pages=4)
    assert not pa.supported(shape, bf16, bf16, page=64, t_hi=320,
                            max_pages=4)
    # Tiling: head width, page granularity, types.  Mosaic's (sublane,
    # 128) rule is gone: Dh 64 and an int8 page of 16 are fine here.
    assert not pa.supported((2, 1, 8, 32), bf16, bf16, **ok)
    assert not pa.supported(shape, bf16, bf16, page=8, t_hi=64,
                            max_pages=8)
    assert not pa.supported(shape, torch.float16, torch.float16, **ok)
    assert not pa.supported(shape, bf16, f32, **ok)


def test_geometry_fallbacks_are_counted():
    c = _case(2, 1, 2, 2, 16, 4, seed=4)
    start, kv_start = [PAGE, 2 * PAGE + 1], [0, 0]
    args = [torch.from_numpy(c[n]) for n in ("q", "k", "v", "pages")]
    args += [torch.tensor(start, dtype=torch.int32),
             torch.tensor(kv_start, dtype=torch.int32)]
    pa.reset_counts()
    pa.paged_attention(*args, page=PAGE, t_hi=2 * PAGE)
    assert (pa.launch_count, pa.fallback_count) == (0, 0)  # CPU: plain
    out = pa.paged_attention(*args, page=PAGE, t_hi=2 * PAGE - 3)
    assert pa.fallback_count == 1                          # partial page
    assert pa.launch_count == 0
    assert not pa.geometry_ok(page=PAGE, t_hi=5 * PAGE, max_pages=4)
    ref = pa.paged_attention_reference(*args, page=PAGE, t_hi=2 * PAGE - 3)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py holds it on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_cuda_kernel_matches_plain_version(cuda, kind):
    """float32 or bf16 q, a pool of q's type or int8, GQA, a 2-token
    window, ragged rows.  Held against the plain version in float32 on
    the same values: float32 output within atol 1e-4 (summation order
    only); bf16 output within atol 1e-5 + rtol 2**-7, since the kernel
    keeps scores and probabilities in f32 and only rounds its output."""
    page = 16
    c = _case(3, 2, 8, 2, 64, 4, seed=5, quant=kind == "int8", page=page)
    qt = torch.float32 if kind == "f32" else torch.bfloat16

    def dev(x):
        return None if x is None else torch.from_numpy(x).to(cuda)

    k, v = dev(c["k"]), dev(c["v"])
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    args = (dev(c["q"]).to(qt), k, v, dev(c["pages"]),
            torch.tensor([4 * page - 2, 40, 17], dtype=torch.int32,
                         device=cuda),
            torch.tensor([0, 3, 0], dtype=torch.int32, device=cuda))
    kw = dict(page=page, t_hi=4 * page, k_scale=dev(c["k_scale"]),
              v_scale=dev(c["v_scale"]))
    before = pa.launch_count
    out = pa.paged_attention(*args, **kw)
    assert pa.launch_count == before + 1
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_attention_reference(*wide, **kw).cpu().numpy()
    got = out.float().cpu().numpy()
    if kind == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("t_hi,max_pages", [(2 * 16 - 3, 4), (5 * 16, 4)])
def test_cuda_bad_geometry_raises(cuda, t_hi, max_pages):
    """On the card the geometry fall-back is gone: a partial page or a
    table narrower than t_hi // page raises, and nothing is counted."""
    c = _case(2, 1, 2, 2, 64, max_pages, seed=6, page=16)
    args = [torch.from_numpy(c[n]).to(cuda) for n in ("q", "k", "v",
                                                      "pages")]
    args += [torch.tensor([16, 17], dtype=torch.int32, device=cuda),
             torch.zeros(2, dtype=torch.int32, device=cuda)]
    pa.reset_counts()
    with pytest.raises(ValueError):
        pa.paged_attention(*args, page=16, t_hi=t_hi)
    assert (pa.launch_count, pa.fallback_count) == (0, 0)
