"""The port's flash-v2 training path against the JAX package, on the CPU
at float32.

The reference's tiny v2 configuration (``tests/test_flash_v2.py``
``_model_cfg``: 2 layers, 4 heads over 2 KV heads, S 64) with its three
knobs, the same parameters (the JAX ``init``, carried across by
``convert.py``) and the same tokens on both sides.  The JAX side runs its
v2 Pallas kernels through the interpreter at 16x16 blocks; the port's
plain version has no tiles.  Tolerances as ``tests/test_torch_train.py``:
loss and gradients atol 2e-5, three ``Trainer`` steps' losses and
parameters atol 2e-5 after AdamW at lr 1e-3.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, mesh_from_devices
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.models import transformer as tm_mod
from k8s_gpu_tpu_torch.ops import attention as fa
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
from k8s_gpu_tpu_torch.train.runner import tree_leaves

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=64, max_seq=64, use_flash=True)
KNOBS = dict(flash_fuse_rope=True, flash_kv_grouped=True, flash_q_pipeline=2)
TOL = 2e-5


def _models(**knobs):
    jm = JaxLM(JaxConfig(**DIMS, **knobs, flash_block_q=16, flash_block_k=16,
                         dtype=jnp.float32))
    tm = TransformerLM(TransformerConfig(**DIMS, **knobs,
                                         dtype=torch.float32), device="cpu")
    return jm, tm


def _tokens(seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"],
                        (batch, DIMS["max_seq"] + 1)).astype(np.int32)


@pytest.mark.parametrize("knobs", [
    KNOBS, dict(flash_fuse_rope=True), dict(flash_kv_grouped=True),
    dict(flash_q_pipeline=2),
], ids=["all", "rope", "gqa", "pipeline"])
def test_loss_and_grads_match_reference(knobs):
    jm, tm = _models(**knobs)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(0)
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
    assert fa.plain_count == 2 * DIMS["n_layers"]
    assert abs(loss.item() - float(ref_loss)) < TOL
    ref_leaves = jax.tree.leaves(ref_grads)   # sorted-key order, as ours
    assert len(ref_leaves) == len(leaves)
    for p, r in zip(leaves, ref_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), atol=TOL)


def test_trainer_matches_reference():
    """Three all-knobs ``Trainer`` steps (warmup 1) on both sides: the
    losses agree within 2e-5, and so does every parameter whose first
    gradient exceeds 1e-5.  AdamW divides each element's moment by its own
    root mean square, so an element whose gradient is ~1e-7 (10^6 below
    its leaf's largest) moves by ~lr whichever way summation-order noise
    of ~1e-8 tips it; those elements are held within the two steps' most
    movement, 2 lr."""
    jm, tm = _models(**KNOBS)
    lr = 1e-3
    tc = dict(warmup_steps=1, learning_rate=lr)
    jtr = JaxTrainer(jm, mesh=mesh_from_devices(jax.devices()[:1],
                                                MeshConfig(dp=1)),
                     train_config=JaxTrainConfig(**tc))
    jtr.init(jax.random.PRNGKey(0))
    ttr = Trainer(tm, TrainConfig(**tc), device="cpu")
    ttr.init(params=jax.tree.map(np.asarray, jtr.params))
    toks = _tokens(1)
    x, y = toks[:, :-1], toks[:, 1:]
    first = jax.grad(jm.loss)(jtr.params, jnp.asarray(x), jnp.asarray(y))
    ref = [float(jtr.step(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    got = [ttr.step(torch.from_numpy(x), torch.from_numpy(y))
           for _ in range(3)]
    assert got[0] == got[1] != got[2]       # the first step's rate is 0
    np.testing.assert_allclose(got, ref, atol=TOL)
    for g, r, g0 in zip(jax.tree.leaves(params_to_numpy(ttr.params)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jtr.params)),
                        jax.tree.leaves(first)):
        diff = np.abs(g - r)
        assert diff[np.abs(np.asarray(g0)) > 1e-5].max(initial=0) <= TOL
        assert diff.max() <= 2 * lr


def test_trainer_logs_attention_path(caplog):
    _, tm = _models(**KNOBS)
    tr = Trainer(tm, TrainConfig(warmup_steps=1), device="cpu")
    tr.init(seed=0)
    toks = torch.from_numpy(_tokens(2))
    with caplog.at_level(logging.INFO, logger="k8s_gpu_tpu_torch.train"):
        tr.step(toks[:, :-1], toks[:, 1:])
    msgs = [r.message for r in caplog.records
            if "attention path" in r.message]
    assert msgs and "flash-v2[rope,gqa=2,pipeline=2] blocks 64x64" in msgs[0]


@pytest.mark.parametrize("n_kv_heads,knobs,want", [
    # (kv heads, knobs) -> (entry, rope fused, K/V heads it is given)
    (2, KNOBS, ("v2", True, 2)),
    (2, dict(flash_fuse_rope=True), ("v2", True, 4)),
    (2, dict(flash_kv_grouped=True), ("v2", False, 2)),
    (2, dict(flash_q_pipeline=2), ("v2", False, 4)),
    (0, dict(flash_kv_grouped=True), ("v1", False, 4)),   # G = 1: no knob
    (2, dict(flash_q_pipeline=1), ("v1", False, 4)),
    (2, {}, ("v1", False, 4)),
])
def test_attention_routes_as_the_reference(monkeypatch, n_kv_heads, knobs,
                                           want):
    """The model takes v2 under the reference's condition (use_flash, a
    knob on, 1-D positions), rotates outside only when rope is not fused
    and repeats K/V only when not grouped."""
    seen = []

    def spy(name, fn):
        def call(q, k, v, **kw):
            seen.append((name, kw.get("rope_theta") is not None,
                         k.shape[1]))
            return fn(q, k, v, **kw)
        monkeypatch.setattr(tm_mod, name, call)

    spy("flash_attention", fa.flash_attention)
    spy("flash_attention_v2", fa.flash_attention_v2)
    cfg = TransformerConfig(**dict(DIMS, n_kv_heads=n_kv_heads), **knobs,
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    entry = {"v1": "flash_attention", "v2": "flash_attention_v2"}[want[0]]
    model.forward(model.init(0), torch.from_numpy(_tokens(3)[:, :-1]))
    assert seen == [(entry, *want[1:])] * DIMS["n_layers"]
