"""The port's Switch top-1 MoE against the JAX package, on the CPU at
float32: the MoE MLP, the training step, int8 weights and bundles.

The same weights (the JAX ``init``, carried across by ``convert.py``)
and the same numpy inputs go through both sides.  Tolerances:
- ``_moe_mlp``: y within 1e-5 absolute, aux within 1e-6, the same tokens
  dropped (rows of y exactly 0), and gradients of a scalar of (y, aux)
  with respect to x, the router and the expert leaves within 1e-5 of
  each gradient's norm, at capacity that binds (factor 0.5 and 1.0), at
  full capacity, with and without padded rows;
- the loss and per-leaf gradients of a 2-layer MoE LM under remat
  ``full`` and ``save_attn`` (the JAX side's flash kernels through the
  Pallas interpreter): atol 2e-5, as ``test_torch_train.py``; three
  ``Trainer`` steps: losses and parameters within 2e-5;
- ``quantize_params``: equal ``q``, scales within a float32 ulp; int8 and
  bundle streams byte-identical.
The port builds no ``[G, E, cap]`` dispatch tensor and takes no host
sync (``nonzero``, ``.item()``, boolean masking) on the MoE path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, mesh_from_devices
from k8s_gpu_tpu.platform.assets import AssetStore
from k8s_gpu_tpu.serve import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve import export_servable as jax_export
from k8s_gpu_tpu.serve import load_servable as jax_load
from k8s_gpu_tpu.serve import quantize_params as jax_quantize
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import attention as fa
from k8s_gpu_tpu_torch.serve import (
    InferenceEngine, export_servable, load_servable, quantize_params,
)
from k8s_gpu_tpu_torch.serve.bundle import _flatten
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
from k8s_gpu_tpu_torch.train.runner import tree_leaves

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=16, num_experts=4)
TOL = 2e-5
EXPERT_LEAVES = ("gate", "e_wi_gate", "e_wi_up", "e_wo")


def _pair(use_flash=False, **extra):
    """(JAX model, JAX params, port model, port params), one weight set."""
    jm = JaxLM(JaxConfig(**DIMS, use_flash=use_flash, dtype=jnp.float32,
                         **extra))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**DIMS, use_flash=use_flash,
                                         dtype=torch.float32, **extra),
                       device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, batch, seq=DIMS["max_seq"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq + 1)).astype(
        np.int32)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.linalg.norm(np.asarray(got) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


# -- the MoE MLP ---------------------------------------------------------------

MLP_SHAPE = (3, 16)          # B, S: G = 48 tokens over 4 experts


def _mlp_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*MLP_SHAPE, DIMS["d_model"])).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.ones(MLP_SHAPE, bool)
    mask[1, :5] = False          # a left-padded row
    mask[2, :3] = False
    return x, w, mask


# binds: real tokens are dropped (at factor 1.0 the padded rows leave
# every expert within its 12 slots).
@pytest.mark.parametrize("factor,full,masked,binds", [
    (0.5, False, False, True), (0.5, False, True, True),
    (1.0, False, False, True), (1.0, False, True, False),
    (1.25, True, True, False),
])
def test_moe_mlp_matches_reference(factor, full, masked, binds):
    jm, jp, tm, tp = _pair(capacity_factor=factor)
    x, w, mask = _mlp_inputs()
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"])
    tlp = {k: v[0].clone().requires_grad_(True)
           for k, v in tp["blocks"].items()}
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None

    def ref_scalar(xx, lp):
        y, aux = jm._moe_mlp(xx, lp, full_capacity=full, token_mask=jmask)
        return (y * w).sum() + 3.0 * aux, (y, aux)

    (_, (ref_y, ref_aux)), (ref_gx, ref_glp) = jax.value_and_grad(
        ref_scalar, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jlp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm._moe_mlp(tx, tlp, full_capacity=full, token_mask=tmask)
    ((y * torch.from_numpy(w)).sum() + 3.0 * aux).backward()

    ref_y = np.asarray(ref_y)
    np.testing.assert_allclose(y.detach().numpy(), ref_y, atol=1e-5)
    assert abs(aux.item() - float(ref_aux)) <= 1e-6
    dropped = (ref_y == 0).all(-1)
    np.testing.assert_array_equal((y.detach().numpy() == 0).all(-1), dropped)
    padded = (~mask).sum() if masked else 0
    assert not masked or dropped[~mask].all()
    assert (dropped.sum() > padded) == binds
    assert _rel(tx.grad.numpy(), ref_gx) <= 1e-5
    for name in EXPERT_LEAVES:
        assert _rel(tlp[name].grad.numpy(), ref_glp[name]) <= 1e-5, name


class _OpLog(TorchDispatchMode):
    """Every aten op called, and the largest tensor any op returned."""

    def __init__(self):
        super().__init__()
        self.ops, self.largest = set(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(func.overloadpacket.__name__)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_index_dispatch_builds_no_dense_tensor_and_never_syncs():
    """At G = 256 tokens the reference's one-hot dispatch is G x E x cap
    = 81,920 values; the port's largest tensor is the experts' [E, cap,
    d_ff] activations.  No op on the path waits for the card: no
    ``nonzero`` (boolean indexing), ``.item()`` or ``masked_select``."""
    _, _, tm, tp = _pair()
    lp = {k: v[0] for k, v in tp["blocks"].items()}
    B, S, E = 8, 32, DIMS["num_experts"]
    G, cap = B * S, int(1.25 * B * S / E)
    x = torch.randn(B, S, DIMS["d_model"])
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[0, :7] = False
    with torch.enable_grad(), _OpLog() as log:
        xg = x.clone().requires_grad_(True)
        y, aux = tm._moe_mlp(xg, lp, token_mask=mask)
        (y.sum() + aux).backward()
    assert log.largest < G * E * cap
    assert log.largest == E * cap * DIMS["d_ff"]
    assert not log.ops & {"nonzero", "_local_scalar_dense", "masked_select",
                          "masked_scatter", "one_hot"}
    assert y.shape == x.shape


# -- the training step -------------------------------------------------------

@pytest.mark.parametrize("policy", ["full", "save_attn"])
def test_loss_and_grads_match_reference(policy):
    jm, jp, tm, tp = _pair(use_flash=True, remat_policy=policy)
    toks = _tokens(0, 2)
    ref_loss, ref_grads = jax.value_and_grad(jm.loss)(
        jp, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    fa.reset_counts()
    loss = tm.loss(tp, torch.from_numpy(toks[:, :-1]),
                   torch.from_numpy(toks[:, 1:]))
    loss.backward()
    # One flash forward a layer and step under save_attn, two under full.
    fwd = 1 if policy == "save_attn" else 2
    assert fa.plain_count == fwd * DIMS["n_layers"]
    assert abs(loss.item() - float(ref_loss)) < TOL
    ref_leaves = jax.tree.leaves(ref_grads)   # sorted-key order, as ours
    assert len(ref_leaves) == len(leaves)
    for p, r in zip(leaves, ref_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), atol=TOL)
    gate = tp["blocks"]["gate"].grad
    assert gate is not None and float(gate.abs().max()) > 0.0


def test_aux_loss_matches_reference_and_reaches_the_router():
    """The forward's aux is the layers' mean (the reference's ``aux /
    n_layers``), and its gradient alone moves the router under both
    remat policies (``_SaveAttnBlock`` carries it as a second output)."""
    jm, jp, tm, tp = _pair()
    toks = _tokens(3, 2)
    _, ref_aux = jm.forward(jp, jnp.asarray(toks[:, :-1]))
    _, aux = tm.forward(tp, torch.from_numpy(toks[:, :-1]))
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 and float(aux) > 0.0
    grads = {}
    for policy in ("full", "save_attn"):
        tmp = TransformerLM(TransformerConfig(
            **DIMS, use_flash=False, remat_policy=policy,
            dtype=torch.float32), device="cpu")
        gate = tp["blocks"]["gate"].clone().requires_grad_(True)
        params = dict(tp, blocks=dict(tp["blocks"], gate=gate))
        _, a = tmp.forward_train(params, torch.from_numpy(toks[:, :-1]))
        a.backward()
        grads[policy] = gate.grad
    assert float(grads["full"].abs().max()) > 0.0
    torch.testing.assert_close(grads["save_attn"], grads["full"], rtol=0,
                               atol=1e-7)


def test_save_attn_gradients_equal_full():
    """The same loss, and gradients within 1e-6 of each leaf's largest (at
    least 1), as ``test_torch_train.py``'s dense case: the backward
    differentiates the saved attention output with the plain versions of
    the dq and dk/dv kernels."""
    toks = _tokens(4, 2)
    grads = {}
    for policy in ("full", "save_attn"):
        _, _, tm, tp = _pair(use_flash=True, remat_policy=policy)
        leaves = tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = tm.loss(tp, torch.from_numpy(toks[:, :-1]),
                       torch.from_numpy(toks[:, 1:]))
        loss.backward()
        grads[policy] = (loss.item(), [p.grad for p in leaves])
    (la, ga), (lb, gb) = grads["full"], grads["save_attn"]
    assert la == lb
    for a, b in zip(ga, gb):
        limit = 1e-6 * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= limit


def test_trainer_steps_match_reference():
    """Three ``Trainer`` steps (warmup 1, lr 1e-3) on both sides: losses
    and the final parameters agree."""
    jm, _, tm, _ = _pair(use_flash=True)
    tc = dict(warmup_steps=1, learning_rate=1e-3)
    jtr = JaxTrainer(jm, mesh=mesh_from_devices(jax.devices()[:1],
                                                MeshConfig(dp=1)),
                     train_config=JaxTrainConfig(**tc))
    jtr.init(jax.random.PRNGKey(0))
    ttr = Trainer(tm, TrainConfig(**tc), device="cpu")
    ttr.init(params=jax.tree.map(np.asarray, jtr.params))
    batches = [_tokens(10 + i, 4) for i in range(3)]
    ref = [jtr.step(jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:]))
           for b in batches]
    got = [ttr.step(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
           for b in batches]
    np.testing.assert_allclose(got, [float(r) for r in ref], atol=TOL)
    ref_params = jax.tree.map(np.asarray, jtr.params)
    got_params = params_to_numpy(ttr.params)
    for (name, g), (_, r) in zip(_flatten(got_params), _flatten(ref_params)):
        np.testing.assert_allclose(g, r, atol=TOL, err_msg=name)


def test_init_shapes_and_router_type():
    """The reference's leaves and shapes; the router stays float32 in a
    bf16 serving tree."""
    jm = JaxLM(JaxConfig(**DIMS))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    got = tm.init(0)
    assert {k: tuple(v.shape) for k, v in _flatten(got)} == {
        k: tuple(v.shape) for k, v in _flatten(ref)}
    assert got["blocks"]["gate"].dtype == torch.float32
    assert got["blocks"]["e_wo"].dtype == torch.bfloat16
    assert "wi_gate" not in got["blocks"] and tm.cfg.moe


# -- int8 weights ----------------------------------------------------------

def _assert_same_quantized(ref_tree, got_tree):
    ref, got = dict(_flatten(ref_tree)), dict(_flatten(got_tree))
    assert sorted(ref) == sorted(got)
    for name, r in ref.items():
        r = np.asarray(r)
        g = got[name].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if name.endswith("/s"):
            # One float32 ulp of the scale.
            np.testing.assert_array_less(np.abs(g - r),
                                         np.spacing(r) * 1.0001, name)
        else:
            np.testing.assert_array_equal(g, r, name)


def test_quantize_params_matches_reference():
    _, jp, _, tp = _pair()
    qp = quantize_params(tp)
    _assert_same_quantized(jax_quantize(jp), qp)
    for name in ("e_wi_gate", "e_wi_up", "e_wo"):
        assert qp["blocks"][name]["q"].dtype == torch.int8
    # The router and the norms stay float.
    for name in ("gate", "ln1", "ln2"):
        assert torch.is_tensor(qp["blocks"][name])


def test_int8_moe_streams_match_reference():
    """Greedy generation over int8 MoE weights (dequantized through
    ``wt``), a left-padded batch row included; ``int8_compute`` is
    refused for MoE, as in the reference."""
    jm, jp, tm, tp = _pair()
    jq, tq = jax_quantize(jp), quantize_params(tp)
    prompt = np.random.default_rng(5).integers(1, 60, (2, 9)).astype(
        np.int32)
    ref = JaxEngine(jm).generate(jq, jnp.asarray(prompt), max_new_tokens=6,
                                 pad_left=2)
    got = InferenceEngine(tm, device="cpu").generate(
        tq, torch.from_numpy(prompt), max_new_tokens=6, pad_left=2)
    assert got.tokens.tolist() == np.asarray(ref.tokens).tolist()
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(tm, int8_compute=True, device="cpu")


# -- bundles -----------------------------------------------------------------

BUNDLE = dict(vocab_size=300, d_model=32, n_layers=2, n_heads=2, d_head=16,
              d_ff=64, max_seq=64, num_experts=4, capacity_factor=2.0)
PROMPT = [1, 5, 9, 2, 7]


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.dtype(f"i{x.element_size()}"))
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.dtype(f"i{a.dtype.itemsize}"))


def _assert_bit_equal(a: dict, b: dict):
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_reference_moe_bundle_loads_in_the_port(tmp_path, kind):
    store = AssetStore(tmp_path)
    jm = JaxLM(JaxConfig(**BUNDLE, use_flash=False, remat=False,
                         dtype=jnp.bfloat16 if kind == "bfloat16"
                         else jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    if kind == "bfloat16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    if kind == "int8":
        jp = jax_quantize(jp)
    jax_export(store, "ml", "moe", jm, jp)
    model, params, _ = load_servable(store, "ml", "moe", device="cpu")
    assert model.cfg.capacity_factor == 2.0 and model.cfg.num_experts == 4
    _assert_bit_equal(params, jax.tree.map(np.asarray, jp))
    if kind != "bfloat16":
        ref = JaxEngine(jm).generate(jp, jnp.asarray([PROMPT]),
                                     max_new_tokens=6)
        got = InferenceEngine(model, device="cpu").generate(
            params, torch.tensor([PROMPT]), max_new_tokens=6)
        assert got.tokens.tolist() == np.asarray(ref.tokens).tolist()


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_port_moe_bundle_loads_in_the_reference(tmp_path, kind):
    store = AssetStore(tmp_path)
    tm = TransformerLM(TransformerConfig(**BUNDLE, dtype=torch.bfloat16),
                       device="cpu")
    params = tm.init(0)
    if kind == "int8":
        params = quantize_params(params)
    export_servable(store, "ml", "moe", tm, params)
    jm, jp, _ = jax_load(store, "ml", "moe")
    assert jm.cfg.capacity_factor == 2.0 and jm.cfg.num_experts == 4
    _assert_bit_equal(params, jax.tree.map(np.asarray, jp))
    # And back: the port reads its own bundle bit for bit.
    _, again, _ = load_servable(store, "ml", "moe", device="cpu")
    _assert_bit_equal(again, params)
