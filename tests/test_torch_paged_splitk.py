"""The paged kernel's two routes: the split planner, the split-K combine,
the window route's roundings, and the admission geometry against JAX.

On the CPU the kernel's arithmetic is held through its plain emulations
in ``ops/paged_attention.py``: ``tile_pages`` and ``split_ranges`` (the
pages each block reads), ``reference_splitk`` (per-split f32 partials
merged in split order) and ``reference_p_rounding`` (the bound of the
window route's one new rounding, p * v_scale to bf16).  Tolerances:
float32 merges against the one-pass plain version within 1e-6 of the
largest value (summation order only); the JAX interpreter against the
port's plain version within 2e-5 (as ``test_torch_paged_attention.py``).

The ``gpu`` tests hold both CUDA routes against the plain version on the
card and skip here (the kernel has no CPU mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.ops.paged_attention import paged_attention as jax_paged
from k8s_gpu_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)


def _pool(rng, B, Sq, H, KH, Dh, MP, page, quant=False, bf16_grid=False):
    """Random q, pools and tables (row b owns blocks 1 + b*MP ...; block 0
    is the trash block) as numpy arrays."""
    NB = 1 + B * MP
    c = {
        "q": rng.standard_normal((B, Sq, H, Dh)).astype(np.float32),
        "k": rng.standard_normal((NB, KH, page, Dh)).astype(np.float32),
        "v": rng.standard_normal((NB, KH, page, Dh)).astype(np.float32),
        "pages": np.asarray([[1 + b * MP + j for j in range(MP)]
                             for b in range(B)], np.int32),
        "k_scale": None, "v_scale": None,
    }
    if bf16_grid:
        for name in ("q", "k", "v"):
            c[name] = torch.from_numpy(c[name]).bfloat16().float().numpy()
    if quant:
        for name in ("k", "v"):
            amax = np.abs(c[name]).max(-1)
            s = np.maximum(amax, 1e-8) / 127.0
            c[name] = np.clip(np.round(c[name] / s[..., None]), -127,
                              127).astype(np.int8)
            c[name + "_scale"] = s.astype(np.float32)
    return c


def _torch(c, start, kv_start, dev="cpu"):
    def t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    args = (t(c["q"]), t(c["k"]), t(c["v"]), t(c["pages"]),
            torch.tensor(start, dtype=torch.int32, device=dev),
            torch.tensor(kv_start, dtype=torch.int32, device=dev))
    return args, t(c["k_scale"]), t(c["v_scale"])


# -- the split planner -------------------------------------------------------

@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("B,G,Sq", [(8, 1, 1), (3, 4, 1), (2, 4, 4),
                                    (1, 2, 100), (2, 1, 300)])
@pytest.mark.parametrize("n_sms", [1, 132])
def test_split_planner_covers_the_visible_range(page, B, G, Sq, n_sms):
    KH, t_hi = 2, 32 * page
    rng = np.random.default_rng(B * 1000 + G * 100 + Sq + page)
    start = rng.integers(0, t_hi - Sq, B)
    start[0] = t_hi - Sq                        # a full row
    kv_start = rng.integers(0, 2 * page, B)
    kv_start[0] = 0
    for dtype in (torch.float32, torch.bfloat16):
        design, rows, tiles, splits, min_pages = pa.plan(
            (B, Sq, G * KH, 64), dtype, KH, page=page, t_hi=t_hi,
            n_sms=n_sms)
        R = Sq * G
        assert design == ("cuda-splitk" if R <= 16 else "cuda-mma"
                          if dtype == torch.bfloat16 else "cuda-fma")
        assert tiles == -(-R // rows) and 1 <= splits <= t_hi // page
        assert splits <= pa.MAX_SPLITS
        assert min_pages == max(1, pa.MIN_SPLIT_POSITIONS // page)
        for b in range(B):
            st, kv = int(start[b]), int(kv_start[b])
            for r0 in range(0, R, rows):
                r_last = min(R, r0 + rows) - 1
                p_lo, p_hi = pa.tile_pages(st, kv, r0, r_last, G=G, page=page,
                                           t_hi=t_hi)
                first = min(st + r0 // G, t_hi - 1)
                if kv > first:                  # a row that sees nothing
                    assert (p_lo, p_hi) == (0, t_hi // page)
                    continue
                hi = min(t_hi, st + r_last // G + 1)
                assert (p_lo, p_hi) == (kv // page, -(-hi // page))
                runs = pa.split_ranges(p_lo, p_hi, splits, min_pages)
                assert 1 <= len(runs) <= splits
                if len(runs) > 1:               # long enough to split
                    assert all(s1 - s0 >= min_pages for s0, s1 in runs)
                assert runs[0][0] == p_lo and runs[-1][1] == p_hi
                for (a0, a1), (b0, _) in zip(runs, runs[1:]):
                    assert a1 == b0                 # whole pages, in order
                for s0, s1 in runs:
                    assert s0 <= s1
                    if s1 > s0:                     # never past the last row
                        assert s0 * page <= st + r_last // G


def test_split_planner_one_split_when_short():
    f32 = torch.float32
    # One page below t_hi: one split whatever the card.
    assert pa.plan((1, 1, 8, 128), f32, 8, page=64, t_hi=64,
                   n_sms=132)[3] == 1
    # Enough blocks already: one split.
    assert pa.plan((64, 1, 8, 128), f32, 8, page=64, t_hi=2048,
                   n_sms=132)[3] == 1
    # The decode shape: 64 blocks of (b, kh) -> 4 splits, the count
    # nearest 264 blocks; each at least 4 pages of 64.
    assert pa.plan((8, 1, 8, 128), torch.bfloat16, 8, page=64, t_hi=2048,
                   n_sms=132) == ("cuda-splitk", 16, 1, 4, 4)
    # The admission window on the tensor cores: 8 row tiles x 8 KV heads.
    assert pa.plan((1, 512, 8, 128), torch.bfloat16, 8, page=64,
                   t_hi=2048, n_sms=132) == ("cuda-mma", 64, 8, 4, 4)
    # At most one split a page, and at most MAX_SPLITS.
    assert pa.plan((1, 512, 8, 128), torch.bfloat16, 8, page=16,
                   t_hi=32, n_sms=132).splits == 2
    assert pa.plan((1, 1, 1, 128), torch.bfloat16, 1, page=16,
                   t_hi=4096, n_sms=132).splits == pa.MAX_SPLITS
    # A range shorter than two splits' worth of pages takes one; a cold
    # admission's first row tile (one page) writes its output directly.
    assert pa.split_ranges(0, 7, 4, 4) == [(0, 7)]
    assert pa.split_ranges(0, 1, 4, 4) == [(0, 1)]
    assert pa.split_ranges(0, 8, 4, 4) == [(0, 4), (4, 8)]


@pytest.mark.parametrize("case,start,Sq,want", [
    # decode at full length: 32 pages, 4 splits a row
    ("decode", [2047] * 8, 1, [[4]] * 8),
    # the window ending the cache: 25 to 32 pages a tile, 4 splits each
    ("window", [1536], 512, [[4] * 8]),
    # a cold admission: tile i sees i + 1 pages, so one split each but
    # the last (8 pages, two runs of 4)
    ("admit_cold", [0], 512, [[1] * 7 + [2]]),
])
def test_tile_splits_at_the_phase3_shapes(case, start, Sq, want):
    """The splits the planner's tiles take at chip_smoke's bf16 decode,
    window and cold-admission shapes (H = KH 8, page 64, t_hi 2048; 4
    splits planned, at least 4 pages each): the count a run reports."""
    cut = pa.plan((len(start), Sq, 8, 128), torch.bfloat16, 8, page=64,
                  t_hi=2048, n_sms=132)
    assert cut.splits == 4 and cut.min_pages == 4
    got = pa.tile_splits(start, [0] * len(start), Sq=Sq, G=1,
                         rows=cut.rows, splits=cut.splits,
                         min_pages=cut.min_pages, page=64, t_hi=2048)
    assert got == want


# -- the combine -------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 2, 3, 7, 12])
@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("quant", [False, True])
def test_splitk_combine_matches_one_pass(splits, rows, quant):
    """Per-split f32 partials merged in split order equal the one-pass
    plain version within 1e-6 of the largest value.  Row 2's window lies
    before its kv_start (it sees nothing: the uniform mean of V over all
    t_hi slots, finite); 12 splits of at most 8 pages leave some empty."""
    page, MP = 8, 8
    t_hi = MP * page
    c = _pool(np.random.default_rng(splits * 10 + rows), 4, 3, 4, 2, 16,
              MP, page, quant=quant)
    start, kv_start = [t_hi - 3, 13, 2, 30], [0, 3, 20, 9]
    args, ks, vs = _torch(c, start, kv_start)
    kw = dict(page=page, t_hi=t_hi, k_scale=ks, v_scale=vs)
    ref = pa.paged_attention_reference(*args, **kw)
    got = pa.reference_splitk(*args, splits=splits, rows=rows, **kw)
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * scale)


def test_splitk_empty_split_and_masked_row_stay_finite():
    """A split with no slot gives m = -1e30, l = 0; a row that sees
    nothing gives m = -1e30 in every split: neither turns into NaN."""
    page, MP = 8, 2
    c = _pool(np.random.default_rng(7), 1, 1, 2, 2, 16, MP, page)
    c["pages"][0, 1] = 0                          # a trash-block slot
    args, _, _ = _torch(c, [3], [12])             # query before kv_start
    out = pa.reference_splitk(*args, page=page, t_hi=page * MP, splits=5,
                              rows=16)
    ref = pa.paged_attention_reference(*args, page=page, t_hi=page * MP)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    # The uniform mean over every slot, the trash block's too.
    v = torch.from_numpy(c["v"])[torch.from_numpy(c["pages"][0]).long()]
    mean = v.transpose(0, 1).reshape(2, -1, 16).mean(1)
    np.testing.assert_allclose(out[0, 0].numpy(), mean.numpy(), atol=1e-6)


# -- the window route's roundings --------------------------------------------

def _window_emulation(q, k, v, ks, vs, mask, scale):
    """The tensor-core route's arithmetic, one pass: bf16 q and raw K/V
    (int8 -> bf16 is exact), f32 products, K's scale on the score column
    after the product, V's scale into p before p is rounded to bf16, l
    from the f32 p.  q [R, D], k, v [T, D], ks, vs [T], mask [R, T]."""
    s = (q.bfloat16().float() @ k.bfloat16().float().T) * scale * ks[None]
    s = torch.where(mask, s, pa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = (p * vs[None]).bfloat16().float()
    return (pv @ v.bfloat16().float()) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G", [1, 4])
def test_window_rounding_within_its_bound(quant, G):
    """The emulation of the window route stays within the float32 plain
    version plus ``reference_p_rounding`` (+ 1e-5 of the largest value
    for summation order), at an admission window of 24 queries."""
    page, MP, KH, Dh, Sq = 16, 4, 2, 32, 24
    t_hi = MP * page
    c = _pool(np.random.default_rng(11 + G), 1, Sq, KH * G, KH, Dh, MP,
              page, quant=quant, bf16_grid=True)
    start, kv_start = [20], [3]
    args, k_s, v_s = _torch(c, start, kv_start)
    kw = dict(page=page, t_hi=t_hi, k_scale=k_s, v_scale=v_s)
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_attention_reference(*wide, **kw)
    bound = pa.reference_p_rounding(*args, **kw)
    q, k_pool, v_pool, pages = args[:4]
    tbl = pages[0].long()
    t = torch.arange(t_hi)
    got = torch.empty_like(ref)
    for kh in range(KH):
        k = k_pool[tbl, kh].reshape(t_hi, Dh).float()
        v = v_pool[tbl, kh].reshape(t_hi, Dh).float()
        ks = k_s[tbl, kh].reshape(t_hi) if quant else torch.ones(t_hi)
        vs = v_s[tbl, kh].reshape(t_hi) if quant else torch.ones(t_hi)
        for g in range(G):
            qr = q[0, :, kh * G + g]
            pos = start[0] + torch.arange(Sq)
            mask = (t[None] <= pos[:, None]) & (t[None] >= kv_start[0])
            got[0, :, kh * G + g] = _window_emulation(qr, k, v, ks, vs,
                                                      mask, Dh ** -0.5)
    diff = (got - ref).abs()
    assert bool((bound > 0).all())
    assert bool((diff <= bound + 1e-5 * ref.abs().max()).all())
    # The term is what the rounding needs: without it the check fails.
    assert bool((diff > 1e-5 * ref.abs().max()).any())


# -- the admission geometry against the JAX package --------------------------

@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("H,KH", [(2, 2), (4, 2), (4, 1)])
def test_admission_window_matches_reference_kernel(kind, H, KH):
    """A cold admission as ``extend_multi`` makes it: a window from
    position 0, read bound t_hi far past it, the table's tail on the trash
    block.  The JAX Pallas kernel (interpreter) and the port's plain
    version agree in float32 within 2e-5; the pool holds bf16 values or
    int8 with its scales."""
    page, MP, Sq, Dh = 8, 8, 12, 16
    c = _pool(np.random.default_rng(H * 10 + KH), 1, Sq, H, KH, Dh, MP,
              page, quant=kind == "int8", bf16_grid=kind == "bf16")
    c["pages"][0, 2:] = 0                      # the window's two pages
    start, kv_start, t_hi = [0], [0], MP * page
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    ref = np.asarray(jax_paged(
        j(c["q"]), j(c["k"]), j(c["v"]), j(c["pages"]),
        jnp.asarray(start, jnp.int32), jnp.asarray(kv_start, jnp.int32),
        page=page, t_hi=t_hi, k_scale=j(c["k_scale"]),
        v_scale=j(c["v_scale"]), interpret=True))
    args, ks, vs = _torch(c, start, kv_start)
    kw = dict(page=page, t_hi=t_hi, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(pa.paged_attention(*args, **kw).numpy(), ref,
                               atol=2e-5)
    split = pa.reference_splitk(*args, splits=3, rows=16, **kw)
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py holds it on the card)")
    return torch.device("cuda")


# (B, Sq, H, KH): R = 1 and 4 (decode route), 16 (decode route, 4-token
# window), 80 (the window route in bf16, 16-row tiles in f32).
ROUTE_SHAPES = [(3, 1, 8, 8), (3, 1, 8, 2), (2, 4, 8, 2), (2, 40, 4, 2)]
# A tp rank's heads of the flagship's 8 on a serving mesh (tp 4: 2, tp 2:
# 4) at the serving batch, decode and the verify window at K 4: fewer
# (batch row, KV head) pairs, so the planner gives a tile more splits.
TP_LOCAL_SHAPES = [(8, 1, 2, 2), (8, 1, 4, 4), (8, 5, 2, 2), (8, 5, 4, 4)]


def _gpu_case(cuda, shape, kind, page, seed=0, Dh=64):
    """Rows: one full; one whose last visible position sits mid-page with
    a kv_start inside its first page; one short.  Returns args, kwargs and
    the owned-block mask."""
    B, Sq, H, KH = shape
    MP = 8
    t_hi = MP * page
    c = _pool(np.random.default_rng(seed), B, Sq, H, KH, Dh, MP, page,
              quant=kind == "int8")
    c["pages"][1, 5:] = 0                      # row 1 owns 5 pages
    start = [t_hi - Sq, 4 * page + page // 2 - Sq + 1, 3]
    start = [max(0, start[b % 3]) for b in range(B)]
    kv_start = [(0, 3, 0)[b % 3] for b in range(B)]
    args, ks, vs = _torch(c, start, kv_start, dev=cuda)
    qt = torch.float32 if kind == "f32" else torch.bfloat16
    q, k, v = args[:3]
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    args = (q.to(qt), k, v) + args[3:]
    owned = torch.zeros(k.shape[0], dtype=torch.bool)
    owned[torch.from_numpy(c["pages"][c["pages"] > 0]).long()] = True
    return args, dict(page=page, t_hi=t_hi, k_scale=ks, v_scale=vs), owned


def _limit(args, kw, design, ref32):
    """Per-element limit against the float32 plain version ``ref32``."""
    if args[0].dtype == torch.float32:
        return torch.full_like(ref32, 1e-4)
    lim = 1e-5 + 2.0 ** -7 * ref32.abs()
    if design == "cuda-mma":
        lim = lim + pa.reference_p_rounding(*args, **kw)
    return lim


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_cuda_routes_match_plain_version(cuda, shape, kind, page, Dh):
    """Each route against the plain version in float32 on the same values:
    f32 within 1e-4 (summation order); bf16 and int8 within 1e-5 + 2^-7
    |r| (the output's rounding), plus ``reference_p_rounding`` on the
    tensor cores."""
    args, kw, _ = _gpu_case(cuda, shape, kind, page, Dh=Dh)
    design = pa.plan(args[0].shape, args[0].dtype, args[1].shape[1],
                     page=page, t_hi=kw["t_hi"], n_sms=pa.sm_count(cuda))[0]
    before = pa.launch_count
    out = pa.paged_attention(*args, **kw)
    assert pa.launch_count == before + 1
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_attention_reference(*wide, **kw)
    diff = (out.float() - ref).abs()
    assert bool((diff <= _limit(args, kw, design, ref)).all()), float(
        diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_cuda_two_calls_bitwise_equal(cuda, shape, kind):
    """The last split merges the partials in split order: the result does
    not depend on which block finished last."""
    args, kw, _ = _gpu_case(cuda, shape, kind, 16, seed=1)
    n = kw["t_hi"] // 16
    first = pa._launch(*args, 16, kw["t_hi"], kw["k_scale"], kw["v_scale"],
                       splits=n)
    for _ in range(3):
        again = pa._launch(*args, 16, kw["t_hi"], kw["k_scale"],
                           kw["v_scale"], splits=n)
        assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_cuda_one_split_and_many_agree(cuda, shape, kind):
    """One split against one a page: float32 within summation order
    (1e-5 of the largest value); bf16 within each side's output rounding
    and, on the tensor cores, p's rounding (p is rounded against each
    split's own maximum)."""
    args, kw, _ = _gpu_case(cuda, shape, kind, 16, seed=2)
    t_hi = kw["t_hi"]
    design = pa.plan(args[0].shape, args[0].dtype, args[1].shape[1],
                     page=16, t_hi=t_hi, n_sms=pa.sm_count(cuda))[0]
    one, many = (pa._launch(*args, 16, t_hi, kw["k_scale"], kw["v_scale"],
                            splits=s).float() for s in (1, t_hi // 16))
    diff = (one - many).abs()
    if kind == "f32":
        assert float(diff.max()) <= 1e-5 * float(one.abs().max())
    else:
        wide = [a.float() if a.is_floating_point() else a for a in args]
        ref = pa.paged_attention_reference(*wide, **kw)
        lim = 2 * (_limit(args, kw, design, ref) - 1e-5) + 1e-5
        assert bool((diff <= lim).all()), float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES + TP_LOCAL_SHAPES)
def test_cuda_splits_used_match_the_planner(cuda, shape, kind, page, blind):
    """The splits each tile took, as the kernel counts them, equal
    ``tile_splits`` (the Python mirror of the kernel's split_positions),
    for every KV head, with the planner's splits and with one a page;
    ``blind`` gives the last row queries that see nothing."""
    B, Sq, H, KH = shape
    args, kw, _ = _gpu_case(cuda, shape, kind, page, seed=5)
    if blind:
        start, kv_start = args[4].clone(), args[5].clone()
        start[-1], kv_start[-1] = 30, 30 + Sq // 2 + 1
        args = args[:4] + (start, kv_start)
    t_hi = kw["t_hi"]
    cut = pa.plan(args[0].shape, args[0].dtype, KH, page=page, t_hi=t_hi,
                  n_sms=pa.sm_count(cuda))
    for splits, min_pages in ((None, cut.min_pages), (t_hi // page, 1)):
        _, used = pa._launch(*args, page, t_hi, kw["k_scale"],
                             kw["v_scale"], splits=splits,
                             count_splits=True)
        want = pa.tile_splits(
            args[4].tolist(), args[5].tolist(), Sq=Sq, G=H // KH,
            rows=cut.rows, splits=splits or cut.splits, min_pages=min_pages,
            page=page, t_hi=t_hi)
        assert used.tolist() == [[row] * KH for row in want]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_cuda_trash_and_foreign_blocks_unread(cuda, shape, kind):
    """Large values in trash block 0 and NaN in every block no row owns
    (in the scales of an int8 pool) change nothing, bit for bit, with the
    planner's splits and with one a page."""
    args, kw, owned = _gpu_case(cuda, shape, kind, 16, seed=3)
    foreign = ~owned
    foreign[0] = False
    bad = dict(kw)
    q, k, v = args[:3]
    if kind == "int8":
        for key in ("k_scale", "v_scale"):
            t = kw[key].clone()
            t[0] = 1e4
            t[foreign.to(t.device)] = float("nan")
            bad[key] = t
    else:
        k, v = k.clone(), v.clone()
        for t in (k, v):
            t[0] = 1e4
            t[foreign.to(t.device)] = float("nan")
    poisoned = (q, k, v) + args[3:]
    for splits in (None, kw["t_hi"] // 16):
        out = pa._launch(*args, 16, kw["t_hi"], kw["k_scale"],
                         kw["v_scale"], splits=splits)
        out_p = pa._launch(*poisoned, 16, kw["t_hi"], bad["k_scale"],
                           bad["v_scale"], splits=splits)
        assert torch.equal(out, out_p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_cuda_rows_that_see_nothing(cuda, shape, kind):
    """The last batch row's first queries lie before its kv_start: they
    see no position and get the mean of V over every slot below t_hi, as
    in the reference, while its later queries (in the same row tile where
    Sq > 1) see the rest.  Held as in the route test, with the planner's
    splits and with one a page."""
    B, Sq, H, KH = shape
    args, kw, _ = _gpu_case(cuda, shape, kind, 16, seed=4)
    start, kv_start = args[4].clone(), args[5].clone()
    start[-1], kv_start[-1] = 30, 30 + Sq // 2 + 1
    args = args[:4] + (start, kv_start)
    design = pa.plan(args[0].shape, args[0].dtype, KH, page=16,
                     t_hi=kw["t_hi"], n_sms=pa.sm_count(cuda))[0]
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_attention_reference(*wide, **kw)
    for splits in (None, kw["t_hi"] // 16):
        out = pa._launch(*args, 16, kw["t_hi"], kw["k_scale"],
                         kw["v_scale"], splits=splits)
        assert bool(torch.isfinite(out).all())
        diff = (out.float() - ref).abs()
        assert bool((diff <= _limit(args, kw, design, ref)).all()), float(
            diff.max())
