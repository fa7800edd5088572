"""The port's training step against the JAX package, on the CPU at float32.

The same parameters (the JAX ``init``, carried across by ``convert.py``)
and the same tokens go through both sides.  Tolerances:
- loss and gradients: atol 2e-5 on a loss of ~4 and gradients up to ~1
  (the two frameworks sum in other orders; with ``use_flash`` the JAX side
  runs its Pallas kernels through the interpreter, whose online softmax
  sums in yet another order);
- three ``Trainer`` steps: losses within 2e-5 and parameters / EMA within
  2e-5 after AdamW at lr 1e-3 (an update of about lr per element, so a
  wrong moment, bias correction, clip or schedule shows as ~1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.data import TokenLoader as JaxTokenLoader
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, mesh_from_devices
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train import evaluate_lm as jax_evaluate_lm
from k8s_gpu_tpu.train.runner import make_schedule as jax_make_schedule
from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
from k8s_gpu_tpu_torch.data.loader import TokenLoader, write_tokens
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import attention as fa
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer, evaluate_lm
from k8s_gpu_tpu_torch.train.runner import (
    make_schedule, model_flops_per_step, tree_leaves,
)

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=16)
TOL = 2e-5


def _models(use_flash=True, n_kv_heads=0):
    jm = JaxLM(JaxConfig(**DIMS, n_kv_heads=n_kv_heads, use_flash=use_flash,
                         dtype=jnp.float32))
    tm = TransformerLM(TransformerConfig(**DIMS, n_kv_heads=n_kv_heads,
                                         use_flash=use_flash,
                                         dtype=torch.float32), device="cpu")
    return jm, tm


def _tokens(seed, batch, seq=DIMS["max_seq"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq + 1)).astype(
        np.int32)


def _assert_trees_close(got: dict, ref: dict, atol):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_close(got[k], ref[k], atol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("use_flash,n_kv_heads", [
    (True, 0), (False, 0), (True, 2),
])
def test_loss_and_grads_match_reference(use_flash, n_kv_heads):
    jm, tm = _models(use_flash, n_kv_heads)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(0, 2)
    ref_loss, ref_grads = jax.value_and_grad(jm.loss)(
        jp, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fa.reset_counts()
    loss = tm.loss(params, torch.from_numpy(toks[:, :-1]),
                   torch.from_numpy(toks[:, 1:]))
    loss.backward()
    # Remat: the backward recomputes each block's attention.
    assert fa.plain_count == (2 * DIMS["n_layers"] if use_flash else 0)
    assert abs(loss.item() - float(ref_loss)) < TOL
    ref_leaves = jax.tree.leaves(ref_grads)   # sorted-key order, as ours
    assert len(ref_leaves) == len(leaves)
    for p, r in zip(leaves, ref_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), atol=TOL)


def test_trainer_fit_matches_reference(tmp_path):
    """Token file -> loader -> three Trainer steps (warmup 1, EMA on) on
    both sides.  The file holds one batch, served unshuffled every step,
    and the first step's learning rate is 0 (optax reads the schedule
    before counting the step): losses 1 and 2 are equal.  Losses, final
    parameters and the EMA agree."""
    path = write_tokens(tmp_path / "toks.bin", _tokens(1, 4).reshape(-1))
    jm, tm = _models()
    tc = dict(warmup_steps=1, learning_rate=1e-3, ema_decay=0.5)
    jtr = JaxTrainer(jm, mesh=mesh_from_devices(jax.devices()[:1],
                                                MeshConfig(dp=1)),
                     train_config=JaxTrainConfig(**tc))
    jtr.init(jax.random.PRNGKey(0))
    ttr = Trainer(tm, TrainConfig(**tc), device="cpu")
    ttr.init(params=jax.tree.map(np.asarray, jtr.params))
    kw = dict(seq_len=16, batch_size=4, shuffle=False)
    with JaxTokenLoader(path, backend="python", **kw) as jl:
        ref = jtr.fit(jl, 3, log_every=2)
    with TokenLoader(path, **kw) as tl:
        got = ttr.fit(tl, 3, log_every=2)
    assert len(got) == 3 and got[0] == got[1] != got[2]
    np.testing.assert_allclose(got, ref, atol=TOL)
    _assert_trees_close(params_to_numpy(ttr.params),
                        jax.tree.map(np.asarray, jtr.params), TOL)
    _assert_trees_close(params_to_numpy(ttr.ema),
                        jax.tree.map(np.asarray, jtr.ema), TOL)


def test_grad_accum_strided_matches_full_batch():
    _, tm = _models()
    toks = torch.from_numpy(_tokens(2, 4))
    runs = {}
    for accum in (1, 2):
        tr = Trainer(tm, TrainConfig(warmup_steps=1, learning_rate=1e-3,
                                     grad_accum_steps=accum), device="cpu")
        tr.init(seed=0)
        losses = [tr.step(toks[:, :-1], toks[:, 1:]) for _ in range(3)]
        runs[accum] = (losses, params_to_numpy(tr.params))
    np.testing.assert_allclose(runs[2][0], runs[1][0], atol=TOL)
    _assert_trees_close(runs[2][1], runs[1][1], TOL)


def test_step_many_chains_steps():
    """``step_many`` over stacked batches is the same chain of steps."""
    _, tm = _models()
    toks = torch.from_numpy(np.stack([_tokens(7, 2), _tokens(8, 2)]))
    runs = []
    for many in (False, True):
        tr = Trainer(tm, TrainConfig(warmup_steps=1, learning_rate=1e-3),
                     device="cpu")
        tr.init(seed=0)
        if many:
            last = tr.step_many(toks[:, :, :-1], toks[:, :, 1:])
        else:
            last = [tr.step(t[:, :-1], t[:, 1:]) for t in toks][-1]
        runs.append((last, params_to_numpy(tr.params)))
    assert runs[0][0] == runs[1][0]
    _assert_trees_close(runs[1][1], runs[0][1], 0.0)


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 5), ("cosine", 5), ("cosine", 0), ("constant", 0),
])
def test_schedule_matches_reference(schedule, warmup):
    kw = dict(schedule=schedule, warmup_steps=warmup, learning_rate=2e-3,
              decay_steps=20, min_lr_frac=0.1)
    got = make_schedule(TrainConfig(**kw))
    ref = jax_make_schedule(JaxTrainConfig(**kw))
    counts = range(0, 40, 3)
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(ref(c)) for c in counts], rtol=1e-6,
                               atol=1e-12)
    # The first step's rate: 0 under a warmup, and 0 for good under
    # optax's degenerate zero-step linear warmup.
    assert (got(0) == 0.0) == (warmup > 0 or schedule == "constant")


def test_evaluate_lm_matches_reference():
    jm, tm = _models()
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batches = [_tokens(4, 2), _tokens(5, 3)]
    ref = jax_evaluate_lm(jm, jp, batches)
    got = evaluate_lm(tm, params, batches)
    assert got["tokens"] == ref["tokens"] == 5 * DIMS["max_seq"]
    assert abs(got["nll"] - ref["nll"]) < TOL
    assert abs(got["perplexity"] / ref["perplexity"] - 1) < 1e-4


def test_training_params_are_f32_and_serving_keeps_its_dtype():
    cfg = TransformerConfig(**DIMS, dtype=torch.bfloat16)
    tm = TransformerLM(cfg, device="cpu")
    assert tm.init(0)["blocks"]["wq"].dtype == torch.bfloat16
    tr = Trainer(tm, device="cpu")
    tr.init(seed=0)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in tree_leaves(tr.params))
    toks = torch.from_numpy(_tokens(6, 2))
    loss = tr.step(toks[:, :-1], toks[:, 1:])        # bf16 compute
    assert np.isfinite(loss)


def test_flops_and_unported_options(monkeypatch):
    flagship = TransformerConfig(vocab_size=16384, d_model=1024, n_layers=16,
                                 n_heads=8, d_head=128, d_ff=4096,
                                 max_seq=2048)
    flops = model_flops_per_step(flagship, 302_000_000, 24)
    assert 9.8e13 < flops < 1.0e14
    # An MoE model constructs; its FLOPs count every expert's parameters
    # (6 N_total, the reference's convention), not the active ones.
    moe = TransformerLM(TransformerConfig(**DIMS, num_experts=4),
                        device="cpu")
    n_moe = sum(p.numel() for p in tree_leaves(moe.init(0)))
    n_dense = sum(p.numel() for p in tree_leaves(
        TransformerLM(TransformerConfig(**DIMS), device="cpu").init(0)))
    assert n_moe == n_dense + DIMS["n_layers"] * (
        3 * 3 * DIMS["d_model"] * DIMS["d_ff"] + 4 * DIMS["d_model"])
    assert (model_flops_per_step(moe.cfg, n_moe, 2)
            - model_flops_per_step(moe.cfg, n_dense, 2)
            == 6.0 * (n_moe - n_dense) * 2 * DIMS["max_seq"])
    model = TransformerLM(TransformerConfig(**DIMS, remat_policy="save_attn"),
                          device="cpu")
    assert model.cfg.remat_policy == "save_attn"
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM(TransformerConfig(**DIMS, remat_policy="sometimes"),
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TransformerLM(TransformerConfig(**DIMS), device="cpu"))


# -- remat_policy="save_attn" ------------------------------------------------

V2_DIMS = dict(DIMS, n_kv_heads=2, d_head=16, max_seq=64)
V2_KNOBS = dict(flash_fuse_rope=True, flash_kv_grouped=True,
                flash_q_pipeline=2)


def _loss_and_grads(model, params, toks):
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    fa.reset_counts()
    loss = model.loss(params, torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    loss.backward()
    return loss.item(), [p.grad.clone() for p in leaves], fa.plain_count


@pytest.mark.parametrize("dims,knobs", [
    (DIMS, {}), (DIMS, dict(use_flash=False)), (V2_DIMS, V2_KNOBS),
    (V2_DIMS, dict(flash_kv_grouped=True)),
])
def test_save_attn_matches_full(dims, knobs):
    """The same loss, and gradients within 1e-6 (of each leaf's largest,
    at least 1): the backward differentiates the saved attention output
    with the plain versions of the dq and dk/dv kernels, where "full"
    differentiates a recomputed plain forward.  Flash attention's plain
    version runs once per layer instead of twice."""
    params = TransformerLM(TransformerConfig(**dims, dtype=torch.float32),
                           device="cpu").init(0, dtype=torch.float32)
    toks = _tokens(9, 2, dims["max_seq"])
    runs = {}
    for policy in ("full", "save_attn"):
        model = TransformerLM(TransformerConfig(
            **dims, **knobs, remat_policy=policy, dtype=torch.float32),
            device="cpu")
        runs[policy] = _loss_and_grads(model, params, toks)
    (la, ga, ca), (lb, gb, cb) = runs["full"], runs["save_attn"]
    assert la == lb
    flash = knobs.get("use_flash", True)
    assert (ca, cb) == ((2 * dims["n_layers"], dims["n_layers"]) if flash
                        else (0, 0))
    for a, b in zip(ga, gb):
        limit = 1e-6 * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= limit


@pytest.mark.parametrize("v2", [False, True])
def test_save_attn_matches_reference(v2):
    """Loss and gradients against the reference's ``save_attn`` (its
    Pallas kernels through the interpreter) within ``TOL``."""
    dims, knobs = (V2_DIMS, V2_KNOBS) if v2 else (DIMS, {})
    blocks = dict(flash_block_q=16, flash_block_k=16) if v2 else {}
    jm = JaxLM(JaxConfig(**dims, **knobs, **blocks, remat_policy="save_attn",
                         dtype=jnp.float32))
    tm = TransformerLM(TransformerConfig(**dims, **knobs,
                                         remat_policy="save_attn",
                                         dtype=torch.float32), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(10, 2, dims["max_seq"])
    ref_loss, ref_grads = jax.value_and_grad(jm.loss)(
        jp, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    loss, grads, plain = _loss_and_grads(tm, params, toks)
    assert plain == dims["n_layers"]
    assert abs(loss - float(ref_loss)) < TOL
    for g, r in zip(grads, jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU "
                    "mode (chip_smoke.py counts them on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("v2", [False, True])
def test_cuda_save_attn_launches_one_forward_per_layer(cuda, v2):
    """bf16 on the card: one flash forward, one dq and one dk/dv launch
    per layer (v2 with its two pre-passes, one for each direction), no
    plain call, and the loss and gradients of "full" within phase 7's
    bf16 limits (loss 1e-2, gradient norm 5e-2)."""
    dims = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                d_head=32, d_ff=256, max_seq=128)
    knobs = dict(V2_KNOBS, n_kv_heads=2) if v2 else {}
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 256, (2, 129), generator=gen).to(cuda)
    params = TransformerLM(TransformerConfig(**dims, **knobs), device=cuda
                           ).init(0, dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    runs = {}
    for policy in ("full", "save_attn"):
        model = TransformerLM(TransformerConfig(**dims, **knobs,
                                                remat_policy=policy),
                              device=cuda)
        leaves = tree_leaves(params)
        fa.reset_counts()
        loss = model.loss(params, toks[:, :-1], toks[:, 1:])
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[policy] = (loss.item(), grads, dict(fa.launch_counts),
                        fa.prepass_counts["flash_v2_rope_split"],
                        fa.plain_count)
    loss, grads, launches, prepasses, plain = runs["save_attn"]
    prefix = "flash_v2_" if v2 else "flash_"
    want = {name: 0 for name in launches}
    want.update({f"{prefix}fwd": 2, f"{prefix}bwd_dq": 2,
                 f"{prefix}bwd_dkv": 2})
    assert launches == want and plain == 0
    assert prepasses == (4 if v2 else 0)
    assert runs["full"][2][f"{prefix}fwd"] == 4
    assert abs(loss - runs["full"][0]) <= 1e-2
    for g, f in zip(grads, runs["full"][1]):
        assert float((g - f).float().norm() / f.float().norm()) <= 5e-2
