"""The port's speculative math (``serve/speculative.py``, the n-gram draft
of ``serve/executor.py``, the adaptive window of ``serve/scheduler.py``)
against the JAX reference.

- ``ngram_propose`` equals the reference's, token for token, on random
  and edge-case histories: rows within K + 1 of max_seq, unwritten
  history, no match, and garbage rows past max_seq; the history's
  window write clamps backwards as ``dynamic_update_slice`` does;
- ``reject_row`` given the reference's own uniforms and Gumbel draws
  returns the same accept count and correction token, and its residual is
  the reference's formula (atol 1e-7); its empirical first-token
  distribution matches p (chi-square, fixed seed, p-value > 1e-3);
- ``warped_probs`` within 1e-6 of the reference's; ``_adaptive_k`` picks
  the same K for the same rolling windows;
- ``distill_draft``'s final loss and parameters after 1, 3 and 4 steps
  (hard labels and KL) match the reference's from the same initial draft
  and prompts (loss rtol 1e-5, parameters atol 1e-5);
- on the card (``gpu``): the paged kernel at the verify windows of the
  paged spec cell (``chip_smoke.py`` phase 3's cases, K 2, 4, 8 and a GQA
  window of 20 folded rows), against the plain version in float32 on the
  same values and bit for bit under poisoned blocks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import scheduler as jax_sched
from k8s_gpu_tpu.serve import speculative as jax_spec
from k8s_gpu_tpu.serve.engine import SamplingConfig as JaxSampling
from k8s_gpu_tpu.serve.executor import ngram_propose as jax_ngram
from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import scheduler, speculative
from k8s_gpu_tpu_torch.serve.engine import SamplingConfig
from k8s_gpu_tpu_torch.serve.executor import (
    _write_window_clamped, ngram_propose,
)

torch.set_num_threads(1)


# -- the n-gram draft --------------------------------------------------------

def _jax_rows(hist, token, pos, k):
    return np.stack([np.asarray(jax_ngram(jnp.asarray(h), jnp.int32(t),
                                          jnp.int32(p), k))
                     for h, t, p in zip(hist, token, pos)])


def _histories(seed, S=48, rows=12):
    """Histories of a small alphabet (so n-grams repeat), written up to
    each row's position, -1 past it; row kinds: random, a repeating
    cycle, all unwritten, a row at max_seq - 1, rows within K + 1 of the
    end, and garbage rows past max_seq."""
    rng = np.random.default_rng(seed)
    hist = np.full((rows, S), -1, np.int32)
    pos = rng.integers(3, S - 1, rows)
    pos[1], pos[2], pos[3], pos[4] = S - 1, S - 3, S + 5, 0
    pos[5] = S - 2
    for b in range(rows):
        n = min(pos[b], S)
        if b == 6:
            hist[b, :n] = np.tile([4, 7, 9], S)[:n]
        elif b != 4:
            hist[b, :n] = rng.integers(0, 5, n)
    hist[7, :10] = -1                      # a left pad
    token = rng.integers(0, 5, rows).astype(np.int32)
    return hist, token, pos.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_ngram_propose_matches_reference(seed, k):
    hist, token, pos = _histories(seed)
    want = _jax_rows(hist, token, pos, k)
    got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(token),
                        torch.from_numpy(pos), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_history_write_clamps_backwards():
    """The emitted window lands at pos + 1, and within K + 1 of max_seq
    its start clamps back over older history, as the reference's
    ``dynamic_update_slice`` does (a truncating slice would not)."""
    S, W = 16, 5
    hist = np.arange(3 * S, dtype=np.int32).reshape(3, S)
    pos = np.asarray([2, S - 3, S + 4], np.int32)
    e = np.full((3, W), -7, np.int32) - np.arange(W, dtype=np.int32)
    want = np.stack([np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(h), jnp.asarray(v), (int(p) + 1,)))
        for h, v, p in zip(hist, e, pos)])
    got = torch.from_numpy(hist.copy())
    _write_window_clamped(got, torch.from_numpy(pos) + 1,
                          torch.from_numpy(e))
    np.testing.assert_array_equal(got.numpy(), want)


# -- rejection sampling ------------------------------------------------------

def _pq(seed, K=4, V=9):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(V), K + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(V) * 0.5, K).astype(np.float32)
    g = np.asarray([rng.choice(V, p=q[i] / q[i].sum()) for i in range(K)],
                   np.int32)
    return p, q, g


def _ref_residual(p, q, a):
    q_ext = np.concatenate([q, np.zeros_like(q[:1])], 0)
    res = np.maximum(p - q_ext, 0.0)[a]
    norm = res.sum()
    return res / max(norm, 1e-30) if norm > 1e-9 else p[a]


@pytest.mark.parametrize("seed", range(8))
def test_reject_row_matches_reference_on_its_draws(seed):
    p, q, g = _pq(seed)
    if seed == 7:
        q[:2] = p[:2]                       # p == q: accept both
    key = jax.random.PRNGKey(seed)
    a_ref, x_ref = jax_spec.reject_row(key, jnp.asarray(p), jnp.asarray(q),
                                       jnp.asarray(g))
    ka, kc = jax.random.split(key)
    u = np.array(jax.random.uniform(ka, (g.size,)))
    gum = np.array(jax.random.gumbel(kc, (p.shape[1],), jnp.float32))
    a, x = speculative.reject_row(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(g),
        uniforms=torch.from_numpy(u), gumbel=torch.from_numpy(gum))
    assert a == int(a_ref) and int(x) == int(x_ref)
    res = speculative.residual(torch.from_numpy(p), torch.from_numpy(q), a)
    np.testing.assert_allclose(res.numpy(), _ref_residual(p, q, a),
                               atol=1e-7)


def test_reject_row_is_exact_in_distribution():
    """Leviathan's theorem on the port's own draws: the first emitted
    token of an adversarial draft is distributed as p.  Chi-square over
    20000 rows from one generator; the p-value must exceed 1e-3."""
    from scipy.stats import chisquare

    V, K, N = 4, 2, 20000
    p1 = torch.tensor([0.5, 0.25, 0.15, 0.10])
    q1 = torch.tensor([0.05, 0.05, 0.45, 0.45])
    p, q = p1.expand(K + 1, V), q1.expand(K, V)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(V)
    for _ in range(N):
        g = torch.multinomial(q1, K, replacement=True, generator=gen)
        a, x = speculative.reject_row(p, q, g, gen)
        counts[int(g[0]) if a > 0 else int(x)] += 1
    assert chisquare(counts, p1.numpy() * N).pvalue > 1e-3, counts


def test_rejection_sample_uses_a_generator_a_row():
    p, q, g = _pq(3)
    P, Q, G = (torch.from_numpy(np.stack([x, x])) for x in (p, q, g))
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, x = speculative.rejection_sample(P, Q, G, gens)
    assert int(a[0]) == int(a[1]) and int(x[0]) == int(x[1])


@pytest.mark.parametrize("cfg", [dict(temperature=0.7),
                                 dict(temperature=1.3, top_k=5),
                                 dict(temperature=0.9, top_p=0.8)])
def test_warped_probs_matches_reference(cfg):
    logits = np.random.default_rng(4).normal(size=(3, 32)).astype(
        np.float32) * 3
    want = np.asarray(jax_spec.warped_probs(jnp.asarray(logits),
                                            JaxSampling(**cfg)))
    got = speculative.warped_probs(torch.from_numpy(logits),
                                   SamplingConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# -- the adaptive window ------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.02, 0.1, 0.4])
@pytest.mark.parametrize("rate", [0.05, 0.3, 0.6, 0.9, 0.99])
@pytest.mark.parametrize("k0,freeze", [(4, 0), (2, 0), (8, 0), (4, 100)])
def test_adaptive_k_matches_reference(rate, ratio, k0, freeze):
    import collections

    def state():
        windows = collections.deque(maxlen=64)
        for _ in range(40):
            windows.append((8, int(round(8 * rate))))
        return types.SimpleNamespace(
            _spec_recent=windows, _spec_freeze=freeze,
            _spec_k_active=k0, _draft_ratio=ratio)

    ref, got = state(), state()
    want = jax_sched.SchedulerMixin._adaptive_k(ref)
    assert scheduler.SchedulerMixin._adaptive_k(got) == want
    assert (got._spec_freeze, len(got._spec_recent)) == (
        ref._spec_freeze, len(ref._spec_recent))


# -- distillation --------------------------------------------------------------

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_head=16,
            d_ff=64, max_seq=48)


@pytest.fixture(scope="module")
def target():
    jm = JaxLM(JaxConfig(**DIMS, use_flash=False, remat=False,
                         dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**DIMS, remat=False,
                                         dtype=torch.float32), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


@pytest.mark.parametrize("steps,hard", [(1, True), (4, True), (3, False)])
def test_distill_draft_matches_reference(target, steps, hard):
    """Greedy trajectories from two prompts, the reference's default
    draft (2 layers, half width) from the reference's initial weights:
    the last step's loss and the trained weights agree."""
    jm, jp, tm, tp = target
    prompts = np.asarray([[3, 5, 7], [11, 2, 9]], np.int32)
    key = jax.random.PRNGKey(7)
    kw = dict(steps=steps, seq_len=24, data_temperature=0.0,
              hard_labels=hard, prompts=prompts)
    _, jdp, jloss = jax_spec.distill_draft(jm, jp, key=key, **kw)
    dcfg = JaxConfig(**dict(DIMS, n_layers=2, d_model=32, d_ff=64),
                     use_flash=False, remat=False, dtype=jnp.float32)
    init = JaxLM(dcfg).init(jax.random.split(key)[0])
    stats = {}
    _, tdp, tloss = speculative.distill_draft(
        tm, tp, init_params=params_from_numpy(
            jax.tree.map(np.asarray, init), "cpu"), stats=stats, **kw)
    assert stats["steps"] == steps
    assert tloss == pytest.approx(jloss, rel=1e-5)
    got = params_to_numpy(tdp)
    want = jax.tree.map(np.asarray, jdp)
    for name in ("embed", "head"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5)
    for name, leaf in want["blocks"].items():
        np.testing.assert_allclose(got["blocks"][name], leaf, atol=1e-5,
                                   err_msg=name)


def test_distill_draft_stops_at_target_agreement(target):
    """With an agreement target the step budget is a cap: the check runs
    every 25 steps, and a reachable target stops the run early."""
    _, _, tm, tp = target
    stats = {}
    speculative.distill_draft(
        tm, tp, steps=400, seq_len=16, data_temperature=0.0,
        hard_labels=True, prompts=[[3, 5, 7]], target_agreement=0.5,
        lr=1e-2, stats=stats)
    assert stats["steps"] % 25 == 0 and stats["steps"] < 400
    assert stats["agreement"] >= 0.5


# -- on the card: the verify windows through the paged kernel ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged kernel has no CPU mode "
                    "(chip_smoke.py phase 3 holds the same cases)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K,H", [(2, 8), (4, 8), (8, 8), (4, 32)])
def test_cuda_verify_windows_match_plain_version(cuda, K, H):
    """B 8, Sq K + 1, KH 8, Dh 128, page 64, t_hi 2048 over the paged spec
    cell's tables (starts 1025-1073, one window across the page boundary
    at 1088, one row from kv_start 197): within atol 1e-5 + rtol 2^-7 of
    the plain version in float32 (plus the p rounding on the tensor
    cores), bit for bit with trash at 1e4 and unowned blocks NaN, and the
    splits each tile took equal the planner's."""
    import chip_smoke
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=cuda).manual_seed(K * H)
    ops, owned = chip_smoke._pa_case(
        torch, gen, B=8, Sq=K + 1, H=H, KH=8, Dh=128, page=64, t_hi=2048,
        dtype=torch.bfloat16, quant=False, layout="spec", dev=cuda)
    args = (ops["q"], ops["k"], ops["v"], ops["pages"], ops["start"],
            ops["kv_start"])
    kw = dict(page=64, t_hi=2048)
    cut = pa.plan(ops["q"].shape, torch.bfloat16, 8, page=64, t_hi=2048,
                  n_sms=pa.sm_count(cuda))
    assert cut.design == ("cuda-splitk" if (K + 1) * H // 8 <= 16
                          else "cuda-mma")
    before = pa.launch_count
    out = pa.paged_attention(*args, **kw)
    assert pa.launch_count == before + 1
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_attention_reference(*wide, **kw)
    lim = 1e-5 + 2.0 ** -7 * ref.abs()
    if cut.design == "cuda-mma":
        lim = lim + pa.reference_p_rounding(*args, **kw)
    assert bool(((out.float() - ref).abs() <= lim).all())
    bad = chip_smoke._poisoned(ops, owned)
    out_p = pa.paged_attention(bad["q"], bad["k"], bad["v"], bad["pages"],
                               bad["start"], bad["kv_start"], **kw)
    assert torch.equal(out_p, out)
    _, used = pa._launch(*args, 64, 2048, None, None, count_splits=True)
    want = pa.tile_splits(
        ops["start"].tolist(), ops["kv_start"].tolist(), Sq=K + 1,
        G=H // 8, rows=cut.rows, splits=cut.splits,
        min_pages=cut.min_pages, page=64, t_hi=2048)
    assert used.tolist() == [[row] * 8 for row in want]
