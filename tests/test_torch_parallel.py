"""The port's parallel plane in one process, against the JAX package: the
mesh's sizes and errors, the sharding rules and logical axes, each
rank's shards against the reference's ``devices_indices_map``, the
zigzag tables, the ZeRO-1 axis, the trainer's attention path, bundles
with the sequence-parallel field, the consumers that take every axis
(the LoRA model and the CNN, a meshed trainer's state) and what the
port still refuses, as the reference does (serving on a mesh beyond dp
and tp; Ulysses' and the ring's shapes).  A mesh with more than one rank needs
a process group, so the meshes here are stand-ins with a
``DeviceMesh``'s shape attributes and coordinates;
``test_torch_multihost.py`` and ``test_torch_tensor_parallel.py`` run
the real ones across processes.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.ops.attention import (
    describe_train_attention as jax_describe,
)
from k8s_gpu_tpu.parallel import mesh as jax_mesh_mod
from k8s_gpu_tpu.parallel.ring_attention import _zigzag_perms as jax_perms
from jax.sharding import NamedSharding

from k8s_gpu_tpu.parallel.sharding import ParamRules as JaxRules
from k8s_gpu_tpu.parallel.sharding import logical_to_spec as jax_to_spec
from k8s_gpu_tpu.parallel.ulysses import ulysses_grouped_ok as jax_grouped_ok
from k8s_gpu_tpu.platform.assets import AssetStore
from k8s_gpu_tpu.serve import export_servable as jax_export
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train.runner import _check_kv_tp as jax_check_kv_tp
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops.attention import describe_train_attention
from k8s_gpu_tpu_torch.parallel import mesh as mesh_mod
from k8s_gpu_tpu_torch.parallel.mesh import AXES, MeshConfig
from k8s_gpu_tpu_torch.parallel.ring_attention import _zigzag_perms
from k8s_gpu_tpu_torch.parallel.sharding import (
    ParamRules, logical_to_spec, shard_params,
)
from k8s_gpu_tpu_torch.parallel.ulysses import ulysses_grouped_ok
from k8s_gpu_tpu_torch.serve.bundle import load_servable
from k8s_gpu_tpu_torch.train import LoraConfig, LoraModel, TrainConfig, Trainer
from k8s_gpu_tpu_torch.train.runner import tree_leaves, zero1_dim

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=16)


def fake_mesh(coords=None, **sizes):
    """A stand-in with a ``DeviceMesh``'s shape attributes, this rank's
    ``coords`` (0 on every axis by default) and a token for each group
    (what the port reads before any collective)."""
    shape = [sizes.get(a, 1) for a in AXES]
    coords = coords or {}
    return SimpleNamespace(
        mesh_dim_names=AXES, mesh=np.zeros(shape),
        get_local_rank=lambda a: coords.get(a, 0),
        get_group=lambda a: ("group", a),
        port_groups={axes: ("group", axes)
                     for axes in mesh_mod.GROUPED_AXES})


def _jax_mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jax_mesh_mod.mesh_from_devices(jax.devices()[:n],
                                          jax_mesh_mod.MeshConfig(**sizes))


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("sizes,n", [
    ({}, 8), (dict(dp=2, sp=2), 4), (dict(dp=-1, sp=2, tp=2), 8),
    (dict(dp=1, pp=2, sp=2), 4), (dict(sp=0), 4), (dict(sp=3), 8),
    (dict(dp=2, sp=2), 8), (dict(dp=-1, sp=-1), 4),
])
def test_mesh_config_resolve_matches_reference(sizes, n):
    got = _outcome(lambda: MeshConfig(**sizes).resolve(n))
    want = _outcome(lambda: jax_mesh_mod.MeshConfig(**sizes).resolve(n))
    assert got == want


@pytest.mark.parametrize("sizes,slices", [
    (dict(dp=4), 3), (dict(dp=2, sp=2), 4), (dict(dp=4), 2),
    (dict(dp=1, tp=4), 2),
])
def test_multislice_validation_matches_reference(monkeypatch, sizes,
                                                 slices):
    """dp must be a multiple of the slice count; a valid layout goes on
    to build the mesh (here stopped before any process group)."""
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 4)
    monkeypatch.setattr(mesh_mod, "build_mesh",
                        lambda config, **kw: "built")
    got = _outcome(lambda: mesh_mod.multislice_mesh(MeshConfig(**sizes),
                                                    slices))
    want = _outcome(lambda: jax_mesh_mod.multislice_mesh(
        jax_mesh_mod.MeshConfig(**sizes), slices,
        devices=jax.devices()[:4]))
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got == "built"


def test_one_rank_world_needs_no_mesh():
    assert mesh_mod.build_mesh(MeshConfig()) is None
    assert mesh_mod.mesh_shape(None) == {a: 1 for a in AXES}
    with pytest.raises(ValueError, match="want 2 devices"):
        mesh_mod.build_mesh(MeshConfig(), n_devices=2)


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("num_experts", [0, 4])
def test_logical_axes_and_specs_match_reference(num_experts):
    cfg = dict(DIMS, num_experts=num_experts)
    axes = TransformerLM(TransformerConfig(**cfg), device="cpu").logical_axes()
    jaxes = JaxLM(JaxConfig(**cfg)).logical_axes()
    assert axes == jaxes
    rules = {"embed": "dp"}
    for got_rules, want_rules in ((ParamRules(), JaxRules()),
                                  (ParamRules(dict(ParamRules().rules,
                                                   **rules)),
                                   JaxRules(dict(JaxRules().rules,
                                                 **rules)))):
        assert logical_to_spec(got_rules, axes) == _spec_tree(
            jax_to_spec(want_rules, jaxes))


def test_lora_logical_axes_match_reference():
    jm = JaxLM(JaxConfig(**DIMS))
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    for targets in (("wq", "wv"), ("wq", "wo", "wi_gate", "head")):
        got = LoraModel(tm, tm.init(0), LoraConfig(rank=4, targets=targets))
        want = JaxLoraModel(jm, jm.init(jax.random.PRNGKey(0)),
                            JaxLoraConfig(rank=4, targets=targets))
        assert got.logical_axes() == want.logical_axes()


@pytest.mark.parametrize("n", range(1, 9))
def test_zigzag_perms_match_reference(n):
    assert _zigzag_perms(n) == jax_perms(n)


@pytest.mark.parametrize("h,kh,sizes", [
    (8, 2, dict(sp=2)), (8, 2, dict(sp=4)), (8, 4, dict(sp=2, tp=2)),
    (8, 2, dict(sp=2, tp=2)), (6, 4, dict(sp=2)), (8, 8, dict(sp=8)),
])
def test_ulysses_grouped_ok_matches_reference(h, kh, sizes):
    assert ulysses_grouped_ok(h, kh, fake_mesh(**sizes)) == jax_grouped_ok(
        h, kh, _jax_mesh(**sizes))


@pytest.mark.parametrize("sp_attention,rope", [
    ("ring", False), ("ring", True), ("ulysses", True),
])
def test_describe_sp_attention_matches_reference(sp_attention, rope):
    kw = dict(DIMS, sp_attention=sp_attention, flash_fuse_rope=rope)
    got = describe_train_attention(TransformerConfig(**kw),
                                   seq_sharded=True)
    assert got == jax_describe(JaxConfig(**kw), seq_sharded=True)


def test_zero1_axis_matches_reference():
    """The axis each moment is cut along, against the JAX Trainer's
    ZeRO-1 shardings of its AdamW moments on a dp 4 mesh."""
    cfg = dict(DIMS, d_model=48, n_kv_heads=2)
    jtr = JaxTrainer(JaxLM(JaxConfig(**cfg)), mesh=_jax_mesh(dp=4),
                     train_config=JaxTrainConfig(zero1=True))
    jtr.init(jax.random.PRNGKey(0))
    mu = jtr.opt_state[1][0].mu
    want = [next((i for i, a in enumerate(leaf.sharding.spec) if a == "dp"),
                 None) for leaf in jax.tree.leaves(mu)]
    tm = TransformerLM(TransformerConfig(**cfg), device="cpu")
    rules = ParamRules()
    got = [zero1_dim(tuple(p.shape), rules.spec(ax), 4) for p, ax in zip(
        tree_leaves(tm.init(0)), tree_leaves(tm.logical_axes()))]
    assert got == want and None not in got


@pytest.mark.parametrize("pp,v", [(2, 1), (2, 2), (4, 2)])
def test_stage_cut_holds_the_virtual_stages_of_each_rank(pp, v):
    """pp rank d holds virtual stages c P + d for c < v (interleaved
    1F1B's chunks; v 1 is the contiguous cut), chunk c at rows [c Lc,
    (c+1) Lc) of its blocks; the leaves pp leaves whole stay whole."""
    L = 8
    tm = TransformerLM(TransformerConfig(**{**DIMS, "n_layers": L}),
                       device="cpu")
    params = tm.init(0)
    # Each layer's ln1 scale holds its layer index.
    params["blocks"]["ln1"] = torch.arange(L, dtype=torch.float32)[
        :, None].expand(L, DIMS["d_model"]).clone()
    lc = L // (pp * v)
    for d in range(pp):
        local = shard_params(params, tm.logical_axes(),
                             fake_mesh({"pp": d}, pp=pp),
                             virtual_stages=v)
        want = [(c * pp + d) * lc + i for c in range(v) for i in range(lc)]
        assert local["blocks"]["ln1"][:, 0].tolist() == want
        assert local["head"].shape == params["head"].shape


def test_stage_cut_refuses_chunks_that_do_not_divide_the_layers():
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    with pytest.raises(ValueError, match="2 layers not divisible by 2·2 "
                       "chunks"):
        shard_params(tm.init(0), tm.logical_axes(), fake_mesh(pp=2),
                     virtual_stages=2)


def test_shard_params_keeps_dp_and_sp_replicas_whole():
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    params = tm.init(0)
    assert shard_params(params, tm.logical_axes(), None) is params
    local = shard_params(params, tm.logical_axes(), fake_mesh(dp=2, sp=2))
    for a, b in zip(tree_leaves(local), tree_leaves(params)):
        assert a.shape == b.shape


def _leaves(tree):
    """A tree's tensors in a fixed order, an int8 leaf's q before s."""
    if torch.is_tensor(tree):
        return [tree]
    return [t for k in sorted(tree) for t in _leaves(tree[k])]


# (leaf, dimension tp cuts, whether its scale keeps that dimension).
INT8_CUTS = (("wq", 2, True), ("wo", 1, False), ("wi_gate", 2, True),
             ("wo_mlp", 1, False))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_int8_tree_is_quantized_whole_then_cut(monkeypatch, moe):
    """``shard_params`` of the whole quantized tree at tp 4 (one head a
    rank): ``q`` is the whole ``q``'s cut, ``s`` is cut only where it
    keeps the dimension (size-1 scale dims stay whole), ``gather_params``
    (its all-gather stood in by the four ranks' shards) gives back the
    whole quantized tree, and quantizing a rank's float shard instead
    gives ``wo`` (and the experts' ``e_wo``) other scales: the reason
    for the order."""
    from k8s_gpu_tpu_torch.parallel import sharding
    from k8s_gpu_tpu_torch.serve.quant import quantize_params

    tm = TransformerLM(TransformerConfig(**DIMS, num_experts=4 if moe
                                         else 0), device="cpu")
    whole = tm.init(0, dtype=torch.float32)
    axes = tm.logical_axes()
    quant = quantize_params(whole)
    tp = 4
    meshes = [fake_mesh({"tp": r}, tp=tp) for r in range(tp)]
    shards = [shard_params(quant, axes, m) for m in meshes]
    cuts = ((("e_wi_gate", 3, True), ("e_wo", 2, False)) if moe
            else INT8_CUTS)
    for r, sh in enumerate(shards):
        for name, dim, kept in cuts:
            got, want = sh["blocks"][name], quant["blocks"][name]
            assert torch.equal(got["q"], want["q"].chunk(tp, dim)[r])
            assert torch.equal(got["s"], want["s"].chunk(tp, dim)[r]
                               if kept else want["s"])
        for name, dim in (("head", 1), ("embed", 0)):
            for part in ("q", "s"):
                assert torch.equal(sh[name][part],
                                   quant[name][part].chunk(tp, dim)[r])
    parts = {(t.data_ptr(), tuple(t.shape), t.stride()): list(ts)
             for ts in zip(*(_leaves(sh) for sh in shards))
             for t in ts[:1]}
    monkeypatch.setattr(sharding, "all_gather", lambda t, group: parts[
        (t.data_ptr(), tuple(t.shape), t.stride())])
    back = sharding.gather_params(shards[0], axes, meshes[0])
    for a, b in zip(_leaves(back), _leaves(quant), strict=True):
        assert torch.equal(a, b)
    name = "e_wo" if moe else "wo"
    own = [quantize_params(shard_params(whole, axes, m))["blocks"][name]["s"]
           for m in meshes]
    assert not all(torch.equal(s, quant["blocks"][name]["s"]) for s in own)


def test_sp_attention_bundle_loads(tmp_path):
    store = AssetStore(tmp_path)
    jm = JaxLM(JaxConfig(**DIMS, sp_attention="ulysses", dtype=jnp.float32))
    jax_export(store, "ml", "lm", jm, jm.init(jax.random.PRNGKey(0)))
    model, params, _ = load_servable(store, "ml", "lm", device="cpu")
    assert model.cfg.sp_attention == "ulysses"
    assert params["embed"].shape == (DIMS["vocab_size"], DIMS["d_model"])


@pytest.mark.parametrize("sizes", [
    dict(tp=2), dict(ep=2), dict(pp=2), dict(dp=2, tp=2),
    dict(dp=2, pp=2), dict(ep=2, tp=2), dict(pp=2, tp=2),
])
def test_meshes_beyond_dp_and_sp_name_the_next_slice(sizes):
    """tp, ep and pp, which the transformer runs: every consumer of the
    training plane takes them now and no refusal names a next slice.
    The LoRA model's and the CNN's Trainers cut their leaves by their
    logical axes (the adapters over stages and heads, the CNN's hidden
    layer over tp), and a meshed trainer's checkpoint template has the
    whole tree's shapes without a gather.  Serving beyond dp and tp
    still refuses, with the reference's reason; on dp and tp alone the
    serving engine takes the mesh."""
    from k8s_gpu_tpu_torch.models.cnn import CnnConfig, SmallCnn
    from k8s_gpu_tpu_torch.serve.batcher import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.engine import InferenceEngine

    mesh = fake_mesh(**sizes)
    tp, pp = sizes.get("tp", 1), sizes.get("pp", 1)
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    lora = LoraModel(tm, tm.init(0), LoraConfig(rank=2))
    tr = Trainer(lora, TrainConfig(), device="cpu", mesh=mesh)
    tr.init(0)
    assert tuple(tr.params["blocks"]["wq"]["b"].shape) == (
        DIMS["n_layers"] // pp, 2, DIMS["n_heads"] * DIMS["d_head"] // tp)
    cnn = Trainer(SmallCnn(CnnConfig(dtype=torch.float32), device="cpu"),
                  TrainConfig(), device="cpu", mesh=mesh)
    cnn.init(0)
    assert cnn.params["fc1"].shape[1] == CnnConfig().d_hidden // tp
    if "ep" in sizes or "pp" in sizes:
        with pytest.raises(NotImplementedError,
                           match="the reference serves on dp and tp"):
            ContinuousBatcher(tm, tm.init(0), mesh=mesh, device="cpu")
    else:
        assert InferenceEngine(tm, mesh=mesh, device="cpu").kv_heads == (
            DIMS["n_heads"] // sizes["tp"])
    tr = Trainer(tm, TrainConfig(), device="cpu", mesh=mesh)
    tr.init(0)
    whole = tm.init(0, dtype=torch.float32)
    assert [t.shape for t in tree_leaves(tr.checkpoint_like())] == [
        t.shape for t in tree_leaves(whole)]


# Meshes of four ranks whose weights are cut, each with a model that
# runs there (the GQA dense model; MoE with 4 experts).
SHARD_CASES = [
    (dict(dp=2, tp=2), dict(n_kv_heads=2)),
    (dict(sp=2, tp=2), dict(n_kv_heads=2)),
    (dict(ep=2, tp=2), dict(num_experts=4)),
    (dict(dp=2, ep=2), dict(num_experts=4)),
    (dict(pp=2, tp=2), dict(n_kv_heads=2)),
    (dict(dp=2, pp=2), {}),
]


@pytest.mark.parametrize("sizes,knobs", SHARD_CASES)
def test_shards_match_reference_devices_indices_map(sizes, knobs):
    """Each mesh position's shard of every leaf is the block that the
    reference's ``NamedSharding(mesh, spec).devices_indices_map`` places
    on the device at that position, so the shards tile the whole tree
    (the round trip through ``gather_params`` runs across processes in
    ``test_torch_tensor_parallel.py``)."""
    import itertools

    cfg = dict(DIMS, **knobs)
    tm = TransformerLM(TransformerConfig(**cfg), device="cpu")
    params = tm.init(0, dtype=torch.float32)
    axes = tm.logical_axes()
    jmesh = _jax_mesh(**sizes)
    rules = JaxRules()
    names = [a for a in AXES if a in sizes]
    for pos in itertools.product(*(range(sizes[a]) for a in names)):
        coords = dict(zip(names, pos))
        local = shard_params(params, axes, fake_mesh(coords, **sizes))
        device = jmesh.devices[tuple(coords.get(a, 0) for a in AXES)]
        for got, whole, ax in zip(tree_leaves(local), tree_leaves(params),
                                  tree_leaves(axes)):
            index = NamedSharding(jmesh, rules.spec(ax)).devices_indices_map(
                tuple(whole.shape))[device]
            assert torch.equal(got, whole[index])


@pytest.mark.parametrize("kw,seq,error,match", [
    (dict(sp_attention="ulysses", n_heads=3, n_kv_heads=3), 8, ValueError,
     "ulysses needs local heads (3/1=3) divisible by sp=2; use ring "
     "attention instead"),
    (dict(remat_policy="save_attn"), 7, ValueError,
     "local seq 7 must be even for zigzag ring"),
    (dict(sp_attention="striped"), 8, ValueError,
     "unknown sp_attention 'striped'; expected 'ring' or 'ulysses'"),
])
def test_sp_mesh_refusals(kw, seq, error, match):
    """What an sp mesh refuses is the reference's: heads Ulysses cannot
    regroup, a block the zigzag ring cannot halve (under ``save_attn``
    too), an unknown ``sp_attention``; each raises before any transfer."""
    import re

    tm = TransformerLM(TransformerConfig(**{**DIMS, **kw}), device="cpu")
    toks = torch.zeros((1, seq), dtype=torch.long)
    with pytest.raises(error, match=re.escape(match)):
        tm.loss(tm.init(0), toks, toks, mesh=fake_mesh(dp=2, sp=2))


def test_meshed_trainer_keeps_no_checkpointable_state():
    """On a mesh that cuts nothing (dp alone, no ZeRO-1) a trainer's
    state is every rank's whole state: ``opt_state`` reads it without a
    collective and equals a one-device trainer's, its checkpoint
    template is host memory of the same shapes, and loading whole trees
    gives back the same parameters."""
    toks = np.random.default_rng(0).integers(0, 64, (4, 17))
    trainers = []
    for mesh in (None, fake_mesh(dp=2)):
        tr = Trainer(TransformerLM(TransformerConfig(
            **DIMS, dtype=torch.float32), device="cpu"),
            TrainConfig(warmup_steps=1, learning_rate=1e-3), device="cpu",
            mesh=mesh)
        tr.init(0)
        trainers.append(tr)
    one, meshed = trainers
    one.step(toks[:, :-1], toks[:, 1:])
    state = one.opt_state
    meshed.load_gathered_state(one.gathered_params(), state)
    assert meshed.opt_state["count"] == state["count"] == 1
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(meshed.opt_state[key]),
                        tree_leaves(state[key])):
            assert torch.equal(a, b)
    like = meshed.checkpoint_like()
    for a, b in zip(tree_leaves(like), tree_leaves(one.params)):
        assert a.device.type == "cpu" and a.shape == b.shape
    for a, b in zip(tree_leaves(meshed.params), tree_leaves(one.params)):
        assert torch.equal(a, b) and a.requires_grad


def test_mesh_config_on_one_rank_is_the_one_device_step():
    """``mesh_config`` on a world of one builds no mesh: the step is the
    one-device step, bit for bit."""
    toks = np.random.default_rng(0).integers(0, 64, (4, 17))
    runs = []
    for kw in ({}, dict(mesh_config=MeshConfig(dp=-1))):
        tr = Trainer(TransformerLM(TransformerConfig(
            **DIMS, dtype=torch.float32), device="cpu"),
            TrainConfig(warmup_steps=1, learning_rate=1e-3, zero1=True),
            device="cpu", **kw)
        tr.init(0)
        assert tr.mesh is None
        runs.append([tr.step(toks[:, :-1], toks[:, 1:]) for _ in range(2)]
                    + tree_leaves(tr.params))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert torch.equal(a, b)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the parallel plane's entry points raise unless asked
    for the CPU."""
    from k8s_gpu_tpu_torch.parallel import collectives, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: collectives.psum_smoke(),
                 lambda: collectives.all_reduce_bandwidth_probe(),
                 lambda: multihost.spawn_local_cluster(print, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert collectives.psum_smoke(device="cpu") == {
        "ok": True, "n_devices": 1, "result": 0.0,
        "wall_s": pytest.approx(0.0, abs=1.0)}
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"


def test_kv_heads_that_tp_does_not_divide_raise_the_reference_error():
    """GQA x tp: KV heads that tp does not divide raise at the Trainer,
    before any parameter is cut, with the reference's words."""
    cfg = dict(DIMS, n_kv_heads=1)
    with pytest.raises(ValueError) as want:
        jax_check_kv_tp(JaxConfig(**cfg), _jax_mesh(tp=2))
    with pytest.raises(ValueError) as got:
        Trainer(TransformerLM(TransformerConfig(**cfg), device="cpu"),
                TrainConfig(), device="cpu", mesh=fake_mesh(tp=2))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("mesh", [None, fake_mesh(dp=2)],
                         ids=["no-mesh", "sp1"])
def test_ring_on_one_sp_rank_goes_through_the_flash_wrapper(kv_heads, mesh):
    """sp 1: the ring is one causal flash call (v2 for grouped K/V), the
    wrapper's plain version on the CPU, equal to the reference's oracle
    on the same inputs."""
    from k8s_gpu_tpu.parallel.ring_attention import (
        plain_causal_attention as jax_plain,
    )
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.ring_attention import ring_attention

    rng = np.random.default_rng(kv_heads)
    q = rng.standard_normal((2, 4, 16, 8), dtype=np.float32)
    k, v = (rng.standard_normal((2, kv_heads, 16, 8), dtype=np.float32)
            for _ in range(2))
    g = 4 // kv_heads
    want = np.asarray(jax_plain(jnp.asarray(q), jnp.repeat(k, g, axis=1),
                                jnp.repeat(v, g, axis=1)))
    fa.reset_counts()
    got = ring_attention(*(torch.from_numpy(t) for t in (q, k, v)), mesh)
    assert fa.plain_count == 1
    assert not any(fa.launch_counts.values())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_cnn_loss_takes_a_dp_mesh_and_refuses_sp(monkeypatch):
    """The Trainer hands every model's loss its mesh: the CNN's loss is
    unchanged over dp, and on sp, where the Trainer hands a rank its H
    block of each image, the loss gathers the whole images back (the
    reference computes every image whole): given its half and the
    group's halves, a rank's loss is the whole images' loss."""
    from k8s_gpu_tpu_torch.models import cnn

    model = cnn.SmallCnn(device="cpu")
    params = model.init(0)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 28, 28, 1), dtype=np.float32))
    labels = torch.tensor([1, 3])
    dp = fake_mesh(dp=2)
    whole = model.loss(params, images, labels)
    assert torch.equal(model.loss(params, images, labels, mesh=dp), whole)
    halves = list(images.chunk(2, 1))
    monkeypatch.setattr(cnn, "all_gather", lambda t, group: (
        [t, halves[1]] if group == ("group", "sp") else None))
    got = model.loss(params, halves[0], labels, mesh=fake_mesh(dp=1, sp=2))
    assert torch.equal(got, whole)
