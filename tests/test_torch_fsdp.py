"""Rule tables that cut parameters over the data axes (fsdp) in one
process, against the JAX package: each mesh position's shard under such
a table against the reference's ``devices_indices_map``, a tuple
``("dp", "sp")`` cut's round trip through ``gather_params`` (its
all-gathers run by four threads standing in for the ranks), which tables
the port refuses (``check_rules``) and which specs (``cut_axes``), the
``Trainer``'s refusal of ZeRO-1 under fsdp, and its ``batch_specs``.
``test_torch_mesh_state.py`` trains these tables across processes.
"""

import itertools
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from k8s_gpu_tpu.parallel import mesh as jax_mesh_mod
from k8s_gpu_tpu.parallel.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES
from k8s_gpu_tpu.parallel.sharding import ParamRules as JaxRules
from k8s_gpu_tpu_torch.models import (
    CnnConfig, SmallCnn, TransformerConfig, TransformerLM,
)
from k8s_gpu_tpu_torch.parallel import mesh as mesh_mod
from k8s_gpu_tpu_torch.parallel import sharding
from k8s_gpu_tpu_torch.parallel.mesh import AXES
from k8s_gpu_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, ParamRules, check_rules, cut_axes, shard_params,
)
from k8s_gpu_tpu_torch.train import LoraConfig, LoraModel, TrainConfig, Trainer
from k8s_gpu_tpu_torch.train.runner import tree_leaves, tree_paths

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=16)


def fake_mesh(coords=None, **sizes):
    """A stand-in with a ``DeviceMesh``'s shape attributes, this rank's
    ``coords`` and a token for each group (``test_torch_parallel.py``'s)."""
    shape = [sizes.get(a, 1) for a in AXES]
    coords = coords or {}
    return SimpleNamespace(
        mesh_dim_names=AXES, mesh=np.zeros(shape),
        get_local_rank=lambda a: coords.get(a, 0),
        get_group=lambda a: ("group", a),
        port_groups={axes: ("group", axes)
                     for axes in mesh_mod.GROUPED_AXES})


def _rules(table):
    return ParamRules({**DEFAULT_RULES, **table})


def _jax_mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jax_mesh_mod.mesh_from_devices(jax.devices()[:n],
                                          jax_mesh_mod.MeshConfig(**sizes))


# (mesh sizes, model knobs, rules over the defaults): fsdp's tables as
# the reference writes them, a tuple in both orders of the data axes, and
# a data axis after a weight axis in one entry.
FSDP_SHARD_CASES = [
    (dict(dp=2, tp=2), dict(n_kv_heads=2), {"embed": "dp"}),
    (dict(dp=4), {}, {"embed": "dp"}),
    (dict(dp=2, pp=2), {}, {"embed": "dp"}),
    (dict(dp=2, ep=2), dict(num_experts=4), {"embed": "dp"}),
    (dict(dp=2, sp=2), {}, {"embed": ("dp", "sp")}),
    (dict(dp=2, sp=2), {}, {"embed": ("sp", "dp")}),
    (dict(dp=2, sp=2), {}, {"embed": "sp"}),
    (dict(dp=2, tp=2), dict(n_kv_heads=2), {"kv": "dp"}),
    (dict(dp=2, tp=2), {}, {"mlp": ("tp", "dp"), "vocab": ("tp", "dp")}),
]


@pytest.mark.parametrize("sizes,knobs,table", FSDP_SHARD_CASES)
def test_fsdp_shards_match_reference_devices_indices_map(sizes, knobs,
                                                         table):
    """Each mesh position's shard of every leaf under a table that cuts
    parameters over dp and sp is the block the reference's
    ``NamedSharding(mesh, spec).devices_indices_map`` places on the
    device at that position: a tuple's parts are major to minor (rank
    (d, s) of ``("dp", "sp")`` holds part d·sp + s)."""
    cfg = dict(DIMS, **knobs)
    tm = TransformerLM(TransformerConfig(**cfg), device="cpu")
    params = tm.init(0, dtype=torch.float32)
    axes = tm.logical_axes()
    jmesh = _jax_mesh(**sizes)
    jrules = JaxRules({**JAX_DEFAULT_RULES, **table})
    names = [a for a in AXES if a in sizes]
    for pos in itertools.product(*(range(sizes[a]) for a in names)):
        coords = dict(zip(names, pos))
        check_rules(_rules(table), fake_mesh(coords, **sizes), axes)
        local = shard_params(params, axes, fake_mesh(coords, **sizes),
                             _rules(table))
        device = jmesh.devices[tuple(coords.get(a, 0) for a in AXES)]
        for got, whole, ax in zip(tree_leaves(local), tree_leaves(params),
                                  tree_leaves(axes)):
            index = NamedSharding(jmesh, jrules.spec(ax)).devices_indices_map(
                tuple(whole.shape))[device]
            assert torch.equal(got, whole[index])


class _ThreadGroups:
    """``all_gather`` for ranks run as threads: each thread's coordinates
    in ``local``, every group a set of threads that differ only along
    its axis, meeting at a barrier a call."""

    def __init__(self, sizes):
        self.sizes, self.local = sizes, threading.local()
        self.barrier = threading.Barrier(int(np.prod(list(sizes.values()))))
        self.posted: dict = {}

    def all_gather(self, t, group):
        axis = group[1]
        me = self.local.coords
        key = tuple(sorted((a, c) for a, c in me.items() if a != axis))
        self.posted[(key, me[axis])] = t.clone()
        self.barrier.wait()
        parts = [self.posted[(key, i)] for i in range(self.sizes[axis])]
        self.barrier.wait()
        return parts


def test_tuple_cut_round_trips_through_gather_params(monkeypatch):
    """Four ranks of dp 2 x sp 2 cut the tree under ``"embed": ("dp",
    "sp")`` and join it again: every rank's ``gather_params`` gives back
    the whole tree bit for bit (the minor axis's parts rejoin first)."""
    sizes = dict(dp=2, sp=2)
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    params = tm.init(0, dtype=torch.float32)
    axes, rules = tm.logical_axes(), _rules({"embed": ("dp", "sp")})
    groups = _ThreadGroups(sizes)
    monkeypatch.setattr(sharding, "all_gather", groups.all_gather)
    out, errors = {}, []

    def rank(coords):
        try:
            groups.local.coords = coords
            mesh = fake_mesh(coords, **sizes)
            local = shard_params(params, axes, mesh, rules)
            assert local["final_norm"].shape == (DIMS["d_model"] // 4,)
            out[tuple(coords.values())] = sharding.gather_params(
                local, axes, mesh, rules)
        except Exception as e:                  # reported below
            errors.append(e)
            groups.barrier.abort()

    threads = [threading.Thread(target=rank, args=(dict(dp=d, sp=s),))
               for d in range(2) for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(out) == 4
    for back in out.values():
        for a, b in zip(tree_leaves(back), tree_leaves(params), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("sizes,table,match", [
    (dict(dp=2, tp=2), {"mlp": None},
     "rules map 'mlp' to None where the default maps it to 'tp'"),
    (dict(dp=2, tp=2), {"heads": "dp"},
     "rules map 'heads' to 'dp' where the default maps it to 'tp'"),
    (dict(dp=2, ep=2), {"experts": None},
     "rules map 'experts' to None where the default maps it to 'ep'"),
    (dict(dp=2, pp=2), {"embed": "pp"},
     "rules map 'embed' to 'pp' where the default maps it to None"),
    (dict(dp=2, tp=2), {"mlp": ("dp", "tp")},
     "a data axis before the weight axis 'tp' in one entry"),
])
def test_tables_that_move_a_weight_axis_raise(sizes, table, match):
    """A table the reference runs but the port does not: a weight axis
    moved, or a data axis before the weight axis in one entry; the error
    names the logical axis and what it moved."""
    tm = TransformerLM(TransformerConfig(**DIMS, num_experts=4
                                         if "ep" in sizes else 0),
                       device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        check_rules(_rules(table), fake_mesh(**sizes), tm.logical_axes())


@pytest.mark.parametrize("sizes,table", [
    (dict(dp=4), {"mlp": None}),        # tp is 1: nothing moves
    (dict(dp=2, tp=2), {"embed": "dp"}),
    (dict(dp=2, sp=2), {"embed": ("sp", "dp"), "kv": "sp"}),
    (dict(dp=2, tp=2), {"mlp": ("tp", "dp")}),
    (None, {"mlp": None, "heads": "dp"}),  # one device: no layout
])
def test_tables_that_move_only_data_axes_pass(sizes, table):
    tm = TransformerLM(TransformerConfig(**DIMS), device="cpu")
    mesh = fake_mesh(**sizes) if sizes else None
    check_rules(_rules(table), mesh, tm.logical_axes())


@pytest.mark.parametrize("spec,match", [
    (("pp", "dp", "tp", "dp"), "has duplicate entries for `dp`"),
    ((("dp", "sp"), "sp"), "has duplicate entries for `sp`"),
    (("fsdp", None), "names 'fsdp', not an axis of the mesh"),
])
def test_cut_axes_refuses_what_named_sharding_refuses(spec, match):
    with pytest.raises(ValueError, match=match):
        cut_axes(spec, fake_mesh(dp=2, tp=2))


def test_cut_axes_lists_a_tuple_major_first():
    assert cut_axes((None, ("tp", "dp"), "sp"),
                    fake_mesh(dp=2, sp=2, tp=2)) == [
        (1, "tp"), (1, "dp"), (2, "sp")]
    # Axes of size 1 cut nothing.
    assert cut_axes((("dp", "sp"),), fake_mesh(dp=2)) == [(0, "dp")]


def _trainer(mesh, rules=None, zero1=False, batch_specs=None, cnn=False):
    model = (SmallCnn(CnnConfig(dtype=torch.float32), device="cpu") if cnn
             else TransformerLM(TransformerConfig(**DIMS,
                                                  dtype=torch.float32),
                                device="cpu"))
    return Trainer(model, TrainConfig(warmup_steps=1, zero1=zero1),
                   device="cpu", mesh=mesh, rules=rules,
                   batch_specs=batch_specs)


def test_zero1_under_fsdp_raises_at_init():
    """The reference's ``DuplicateSpecError``: ZeRO-1 would cut a dp-cut
    leaf's moments over dp again; the port's ``init`` names the leaf and
    the spec."""
    tr = _trainer(fake_mesh(dp=2), _rules({"embed": "dp"}), zero1=True)
    with pytest.raises(ValueError, match=r"zero1 on blocks/wk: "
                       r"PartitionSpec\('pp', 'dp', 'tp', 'dp'\) has "
                       r"duplicate entries for `dp`"):
        tr.init(0)


def test_trainer_keeps_its_rules_and_cuts_by_them():
    """``rules`` and ``batch_specs`` are public attributes; on dp 2 the
    fsdp table halves every ``embed`` dimension a rank holds, and
    ``n_params`` and ``checkpoint_like`` still count the whole tree."""
    rules = _rules({"embed": "dp"})
    tr = _trainer(fake_mesh({"dp": 1}, dp=2), rules)
    assert tr.rules is rules and tr.batch_specs is None
    assert _trainer(None).rules.rules == DEFAULT_RULES
    tr.init(0)
    d = DIMS["d_model"]
    assert tuple(tr.params["blocks"]["wq"].shape) == (2, d // 2, 4, 8)
    assert tuple(tr.params["embed"].shape) == (64, d // 2)
    cuts = dict(zip(tree_paths(tr.params), tr.data_cuts))
    assert cuts["embed"] == [(1, "dp")] and cuts["blocks/wq"] == [(1, "dp")]
    one = _trainer(None)
    one.init(0)
    assert tr.n_params() == one.n_params()
    for a, b in zip(tree_leaves(tr.checkpoint_like()),
                    tree_leaves(one.params)):
        assert a.shape == b.shape


@pytest.mark.parametrize("specs,rows", [
    (None, [2, 2]), ((("dp",), ("dp",)), [2, 2]), (((), ()), [4, 4]),
    (((), ("dp",)), [4, 2]), ((("tp",), ("dp",)), [4, 2]),
])
def test_batch_specs_place_rows(specs, rows):
    """A spec naming dp on the rows cuts them over dp (as the inferred
    layout does); one that leaves them whole, or cuts them over another
    axis, hands every dp rank all rows (the model's loss is the global
    mean either way); set after construction too."""
    tr = _trainer(fake_mesh({"dp": 1}, dp=2, tp=2))
    tr.batch_specs = specs
    x = np.arange(4 * 16).reshape(4, 16)
    got = tr.shard_batch(x, x)
    assert [len(t) for t in got] == rows
    if rows[0] == 2:
        assert torch.equal(got[0], torch.as_tensor(x[2:]))


@pytest.mark.parametrize("specs,match", [
    ((("batch",), ("dp",)), "names 'batch', not an axis of the mesh"),
    ((("dp",), ("dp",)), "dim 0 of the batch \\(3, 16\\) does not divide"),
    ((("dp", None, None), ("dp",)), "has more entries than the array"),
    ((("dp",),), "1 batch specs for 2 arrays"),
])
def test_batch_specs_raise_where_device_put_raises(specs, match):
    tr = _trainer(fake_mesh(dp=2), batch_specs=specs)
    x = np.zeros((3, 16), dtype=np.int64) if "divide" in match else \
        np.zeros((4, 16), dtype=np.int64)
    with pytest.raises(ValueError, match=match):
        tr.shard_batch(x, x)


def test_lora_adapters_take_the_trainer_rules():
    """The LoRA model's adapters are cut by the trainer's rules (A's
    input dimension over dp under the fsdp table), while the frozen base
    keeps the default layout the loss reads."""
    base_model = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                               device="cpu")
    base = base_model.init(0, dtype=torch.float32)
    lora = LoraModel(base_model, base, LoraConfig(rank=4))
    mesh = fake_mesh(dp=2)
    tr = Trainer(lora, TrainConfig(warmup_steps=1), device="cpu", mesh=mesh,
                 rules=_rules({"embed": "dp"}))
    tr.init(0)
    assert tuple(tr.params["blocks"]["wq"]["a"].shape) == (
        2, DIMS["d_model"] // 2, 4)
    shards, _ = lora._on_mesh(mesh)
    assert shards["blocks"]["wq"].shape == base["blocks"]["wq"].shape
