"""The state of a meshed trainer, its checkpoints, ``save_attn`` on every
mesh, and the CNN and the LoRA model on the axes the reference trains
them on: the port across processes, against the JAX package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
``torch_state_worker.run_all`` once for the module; the JAX package
trains the same cases on four of the eight virtual CPU devices
meanwhile, from the same numpy inputs and parameters, all in float32.
Each transformer case is a 3-step ``Trainer`` under
``remat_policy="save_attn"`` (dp 2 x tp 2 with ZeRO-1 and an EMA, the
ring and Ulysses over sp 2 x tp 2, MoE over ep 2 x tp 2, GPipe, 1F1B and
interleaved 1F1B over pp 2 x tp 2, interleaved 1F1B over pp 4), held
within 1e-5 against the JAX ``save_attn`` Trainer and against the port's
own full-remat run; the gathered optimizer state too, on every case,
the CNN's and LoRA's included.
The dp 2 x tp 2 run's checkpoint is written shard-wise (each block
once, by the lowest rank that holds it; its files assemble into the
whole trees bit for bit) and resumes onto pp 2 x tp 2, onto dp 4 under
the fsdp table and onto one device, and 2 more steps equal the JAX
Trainer's uninterrupted 5; a one-device checkpoint resumes onto dp 2 x
tp 2.  No save or resume calls a collective that moves a tensor, and a
save that fails on one rank leaves ``latest_step`` where it was.

Rule tables that cut parameters over the data axes (fsdp, ``"embed"``
on dp or on ``("dp", "sp")``) train against the JAX ``Trainer`` given
the same rules: dp 2 x tp 2 with an EMA, dp 4, the ring over dp 2 x sp
2 under ``save_attn``, 1F1B over dp 2 x pp 2, MoE over dp 2 x ep 2 and
LoRA over dp 2 x pp 2; each rank holds only its slices between steps;
the fsdp checkpoint resumes onto the same targets.  ``batch_specs``
(set after construction, and replicated) give the reference's losses.
Tables that move a weight axis (``"mlp": None`` with ZeRO-1 and an EMA,
``"experts": None``, ``"vocab": None``) or name a data axis before it
(``("dp", "tp")``) train against the JAX ``Trainer`` too, and the last
one's checkpoint resumes under the default rules.  ZeRO-1 over a leaf
the rules cut over dp raises in both packages.
"""

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_state_worker as W
from k8s_gpu_tpu.models import CnnConfig as JaxCnnConfig
from k8s_gpu_tpu.models import SmallCnn as JaxCnn
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from k8s_gpu_tpu.parallel.mesh import mesh_from_devices
from k8s_gpu_tpu.parallel.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES
from k8s_gpu_tpu.parallel.sharding import ParamRules as JaxRules
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu_torch.convert import params_to_numpy
from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster
from k8s_gpu_tpu_torch.train.checkpoint import CheckpointManager

TOL = 1e-5
WORKERS = 4
PP_CASES = {name for name, mesh, *_ in W.CASES if "pp" in mesh}


def _jax_mesh(mesh_name):
    return mesh_from_devices(jax.devices()[:WORKERS],
                             JaxMeshConfig(**W.MESHES[mesh_name]))


def _jax_model(knobs, pipelined=False):
    """The reference model of a case under ``save_attn``; a pipelined
    case's attention through the plain reference, as its own pipeline
    tests run it on the CPU (the port's CPU path takes the plain
    versions of the kernels either way)."""
    extra = dict(use_flash=False) if pipelined else {}
    return JaxLM(JaxConfig(**{**W.DIMS, "remat_policy": "save_attn",
                              **knobs}, dtype=jnp.float32, **extra))


def _adam(opt_state) -> dict:
    """optax's ``ScaleByAdamState`` inside the chain, as numpy."""
    adam = next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
        if hasattr(s, "mu"))
    return {"count": int(adam.count),
            "mu": jax.tree.map(np.asarray, adam.mu),
            "nu": jax.tree.map(np.asarray, adam.nu)}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _adapters(lora_model) -> dict:
    """The reference's adapter init with B drawn non-zero, as the meshed
    LoRA tests draw it (B = 0 leaves A's gradient 0 at first, then at the
    size of AdamW's epsilon, where its update is ill-conditioned)."""
    tree = _numpy(lora_model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    for ab in tree["blocks"].values():
        ab["b"] = rng.normal(0.0, 0.05, ab["b"].shape).astype(np.float32)
    return tree


def _jax_rules(table):
    return JaxRules({**JAX_DEFAULT_RULES, **table})


def _jax_specs(specs):
    """The port's batch specs (tuples of axis names) as PartitionSpecs."""
    from jax.sharding import PartitionSpec as P

    return tuple(P(*spec) for spec in specs)


def _jax_steps(jtr, toks) -> list:
    return [float(jtr.step(t[:, :-1], t[:, 1:])) for t in toks]


def _fsdp_refusal(mesh_name, train, table, toks):
    """What the JAX Trainer does with a FSDP_REFUSALS case: the error
    ``init`` raises, or the losses of 3 steps."""
    try:
        jtr = JaxTrainer(_jax_model({}, True), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train),
                         rules=_jax_rules(table))
        jtr.init(jax.random.PRNGKey(0))
    except Exception as e:       # DuplicateSpecError is no ValueError
        return (type(e).__name__, str(e))
    return _jax_steps(jtr, toks)


def _started(jtr, tree):
    """A JAX trainer from the numpy parameters the port starts from (its
    EMA too), at the shardings its rules give them."""
    shardings = jax.tree.map(lambda a: a.sharding, jtr.params)
    jtr.params = jax.device_put(tree, shardings)
    if jtr.ema is not None:
        jtr.ema = jax.device_put(tree, shardings)
    return jtr


def _fsdp_reference(inp, cnn, lora_model) -> dict:
    """The JAX side of the fsdp, batch-spec and refusal cases, run in a
    thread beside the other cases: each JAX Trainer given the case's
    rules (and batch specs) and the port's starting parameters."""
    ref = {}
    for name, mesh_name, knobs, train, table, _ in W.FSDP_CASES:
        jtr = JaxTrainer(_jax_model(knobs, True), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train),
                         rules=_jax_rules(table))
        jtr.init(jax.random.PRNGKey(0))
        _started(jtr, inp["params"][name])
        toks = inp["tokens"][name]
        ref[name] = {"losses": _jax_steps(jtr, toks[:W.STEPS]),
                     "params": _numpy(jtr.params), **_adam(jtr.opt_state),
                     "ema": _numpy(jtr.ema)}
        if name == W.FSDP_CKPT_CASE:
            more = _jax_steps(jtr, toks[W.STEPS:])
            ref["fsdp_resumed"] = {"losses": more,
                                   "params": _numpy(jtr.params),
                                   **_adam(jtr.opt_state),
                                   "ema": _numpy(jtr.ema)}
    name, mesh_name, _ = W.LORA_FSDP_CASE
    jtr = JaxTrainer(lora_model, mesh=_jax_mesh(mesh_name),
                     train_config=JaxTrainConfig(**W.TRAIN),
                     rules=_jax_rules(W.FSDP))
    jtr.init(jax.random.PRNGKey(1))
    _started(jtr, inp["params"][name][1])
    ref[name] = {"losses": _jax_steps(jtr, inp["tokens"][name][:W.STEPS]),
                 "params": _numpy(jtr.params), **_adam(jtr.opt_state)}
    for name, mesh_name, model, table, specs in W.BATCH_SPEC_CASES:
        jtr = JaxTrainer(cnn if model == "cnn" else _jax_model(model, True),
                         mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN),
                         rules=_jax_rules(table))
        jtr.batch_specs = _jax_specs(specs)
        jtr.init(jax.random.PRNGKey(0))
        _started(jtr, inp["params"][name])
        if model == "cnn":
            losses = [float(jtr.step(x, y))
                      for x, y in zip(inp["images"], inp["labels"])]
        else:
            losses = _jax_steps(jtr, inp["tokens"][name][:W.STEPS])
        ref[name] = {"losses": losses, "params": _numpy(jtr.params)}
    toks = inp["tokens"][W.CASES[0][0]][:W.STEPS]
    ref["fsdp_refusals"] = {
        name: _fsdp_refusal(mesh_name, train, table, toks)
        for name, mesh_name, train, table in W.FSDP_REFUSALS}
    return ref


def _moved_reference(inp) -> dict:
    """The JAX side of the moved-table cases, in a thread of its own:
    each JAX Trainer given the case's rules and the port's starting
    parameters; the checkpoint case's 2 more steps."""
    ref = {}
    for name, mesh_name, knobs, train, table, _ in W.MOVED_CASES:
        jtr = JaxTrainer(_jax_model(knobs, True), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train),
                         rules=_jax_rules(table))
        jtr.init(jax.random.PRNGKey(0))
        _started(jtr, inp["params"][name])
        toks = inp["tokens"][name]
        ref[name] = {"losses": _jax_steps(jtr, toks[:W.STEPS]),
                     "params": _numpy(jtr.params), **_adam(jtr.opt_state),
                     "ema": _numpy(jtr.ema)}
        if name == W.MOVED_CKPT_CASE:
            more = _jax_steps(jtr, toks[W.STEPS:])
            ref["moved_resumed"] = {"losses": more,
                                    "params": _numpy(jtr.params),
                                    **_adam(jtr.opt_state),
                                    "ema": _numpy(jtr.ema)}
    return ref


def _refusal(mesh_name, knobs, toks):
    try:
        jtr = JaxTrainer(_jax_model(knobs, True), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN))
        jtr.init(jax.random.PRNGKey(0))
        jtr.step(toks[:, :-1], toks[:, 1:])
        return None
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the JAX package's results): the cluster
    runs in a thread, and the JAX side of the fsdp cases and of the
    moved-table cases in two others, while JAX trains the other cases
    here."""
    jax_trainers, params = {}, {}
    for name, mesh_name, knobs, train in W.CASES:
        jtr = JaxTrainer(_jax_model(knobs, name in PP_CASES),
                         mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train))
        jtr.init(jax.random.PRNGKey(0))
        jax_trainers[name] = jtr
        params[name] = _numpy(jtr.params)
    cnn = JaxCnn(JaxCnnConfig(**W.CNN, dtype=jnp.float32))
    params["cnn"] = _numpy(cnn.init(jax.random.PRNGKey(0)))
    lora_models = {}
    for name, _, knobs in W.LORA_CASES:
        base = JaxLM(JaxConfig(**{**W.DIMS, **knobs}, dtype=jnp.float32,
                               use_flash=False)).init(jax.random.PRNGKey(0))
        lm = JaxLoraModel(JaxLM(JaxConfig(**{**W.DIMS, **knobs},
                                          dtype=jnp.float32,
                                          use_flash=False)),
                          base, JaxLoraConfig(**W.LORA))
        lora_models[name] = lm
        params[name] = (_numpy(base), _adapters(lm))
    for name, _, knobs, *_ in W.FSDP_CASES + W.MOVED_CASES:
        params[name] = _numpy(_jax_model(knobs, True).init(
            jax.random.PRNGKey(0)))
    name, mesh_name, knobs = W.LORA_FSDP_CASE
    base = JaxLM(JaxConfig(**{**W.DIMS, **knobs}, dtype=jnp.float32,
                           use_flash=False)).init(jax.random.PRNGKey(0))
    lora_models[name] = JaxLoraModel(
        JaxLM(JaxConfig(**{**W.DIMS, **knobs}, dtype=jnp.float32,
                        use_flash=False)), base, JaxLoraConfig(**W.LORA))
    params[name] = (_numpy(base), _adapters(lora_models[name]))
    for name, _, model, _, _ in W.BATCH_SPEC_CASES:
        params[name] = (params["cnn"] if model == "cnn" else _numpy(
            _jax_model(model, True).init(jax.random.PRNGKey(0))))
    inp = W.make_inputs(0, params, str(tmp_path_factory.mktemp("ckpt")))
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=600.0, device="cpu")
        fsdp = pool.submit(_fsdp_reference, inp, cnn,
                           lora_models[W.LORA_FSDP_CASE[0]])
        moved = pool.submit(_moved_reference, inp)
        ref = {}
        for name, *_ in W.CASES:
            jtr = jax_trainers[name]
            toks = inp["tokens"][name]
            losses = [float(jtr.step(t[:, :-1], t[:, 1:]))
                      for t in toks[:W.STEPS]]
            ref[name] = {"losses": losses, "params": _numpy(jtr.params),
                         **_adam(jtr.opt_state), "ema": _numpy(jtr.ema)}
            if name == W.CKPT_CASE:
                more = [float(jtr.step(t[:, :-1], t[:, 1:]))
                        for t in toks[W.STEPS:]]
                ref["resumed"] = {"losses": more,
                                  "params": _numpy(jtr.params),
                                  **_adam(jtr.opt_state),
                                  "ema": _numpy(jtr.ema)}
        for mesh_name in W.CNN_MESHES:
            jtr = JaxTrainer(cnn, mesh=_jax_mesh(mesh_name),
                             train_config=JaxTrainConfig(**W.TRAIN))
            jtr.init(jax.random.PRNGKey(0))
            losses = [float(jtr.step(x, y))
                      for x, y in zip(inp["images"], inp["labels"])]
            ref[("cnn", mesh_name)] = {"losses": losses,
                                       "params": _numpy(jtr.params),
                                       **_adam(jtr.opt_state)}
        for name, mesh_name, _ in W.LORA_CASES:
            jtr = JaxTrainer(lora_models[name], mesh=_jax_mesh(mesh_name),
                             train_config=JaxTrainConfig(**W.TRAIN))
            jtr.init(jax.random.PRNGKey(1))
            jtr.params = jax.device_put(params[name][1],
                                        jax.tree.map(lambda a: a.sharding,
                                                     jtr.params))
            losses = [float(jtr.step(t[:, :-1], t[:, 1:]))
                      for t in inp["tokens"][name][:W.STEPS]]
            ref[name] = {"losses": losses, "params": _numpy(jtr.params),
                         **_adam(jtr.opt_state)}
        toks = inp["tokens"][W.CASES[0][0]][0]
        ref["refusals"] = {name: _refusal(mesh_name, knobs, toks)
                           for name, mesh_name, knobs in W.REFUSALS}
        ref.update(fsdp.result())
        ref.update(moved.result())
        return ranks.result(), ref, inp


def _assert_tree_close(got, want, atol=TOL, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=atol,
                                   err_msg=path)


def _assert_moments_close(got, want):
    """The count, and ``mu`` and ``nu`` leaf by leaf within TOL of each
    leaf's largest magnitude as well as within TOL: AdamW's parameters
    hardly move when every gradient is scaled alike, so a sum counted
    twice over an axis shows only here, and ``nu`` sits far below TOL."""
    assert got["count"] == want["count"] == W.STEPS
    for key in ("mu", "nu"):
        _assert_tree_close(got[key], want[key])
        for g, w in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(want[key])):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                err_msg=key)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_save_attn_trainer_matches_reference(runs, case):
    """Every rank's losses and gathered parameters after 3 ``save_attn``
    steps against the JAX ``save_attn`` Trainer on the same mesh."""
    ranks, ref, _ = runs
    name = case[0]
    for r in ranks:
        run = r["cases"][(name, "save_attn")]
        np.testing.assert_allclose(run["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(run["params"], ref[name]["params"])


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_save_attn_equals_full_remat(runs, case):
    """The replay's gradients are full remat's: the same losses and
    gathered parameters after 3 steps, on every rank."""
    ranks, _, _ = runs
    name = case[0]
    for r in ranks:
        save, full = (r["cases"][(name, p)] for p in W.POLICIES)
        np.testing.assert_allclose(save["losses"], full["losses"], atol=TOL)
        _assert_tree_close(save["params"], full["params"])


def _expected_forwards(case, coords) -> tuple[int, int]:
    """(save_attn, full) attention forwards a rank runs over the steps:
    one a layer it holds and microbatch under save_attn (the ring at sp 2:
    3 block attends, hop 0 and hop 1's two), two under full remat, but for
    1F1B's last virtual stage, whose forward is fused into its backward
    tick (one)."""
    name, mesh_name, knobs, _ = case
    sizes = W.MESHES[mesh_name]
    pp = sizes.get("pp", 1)
    layers = knobs.get("n_layers", W.DIMS["n_layers"]) // pp
    if pp == 1:
        micro = 1
    else:
        micro = knobs.get("pp_microbatches") or pp
    per = 3 if name.endswith("_ring") else 1
    save = layers * micro * per * W.STEPS
    full = 2 * save
    if pp > 1 and knobs.get("pp_schedule", "1f1b") == "1f1b" \
            and coords["pp"] == pp - 1:
        v = knobs.get("pp_virtual_stages", 1)
        full -= layers // v * micro * W.STEPS
    return save, full


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_save_attn_runs_each_attention_forward_once(runs, case):
    """On the CPU each attention forward is one plain call
    (``plain_count``; the replay's backward calls none): under
    ``save_attn`` one a layer and microbatch, no hop of the ring again;
    under full remat two, as the chip's launch counts show for the
    kernels."""
    ranks, _, _ = runs
    name = case[0]
    for r in ranks:
        save, full = (r["cases"][(name, p)]["plain_calls"]
                      for p in W.POLICIES)
        want = _expected_forwards(case, r["cases"][(name, "full")]["coords"])
        assert (save, full) == want


def test_sp_counters_count_once_per_layer_and_forward(runs):
    """Ulysses broadcasting grouped K/V counts ``ulysses_kv_heads`` once a
    layer and forward under both policies, never on the replay; the ring
    counts nothing."""
    ranks, _, _ = runs
    for r in ranks:
        for policy in W.POLICIES:
            assert r["cases"][("sp2tp2_ulysses", policy)][
                "ulysses_kv_heads"] == W.DIMS["n_layers"] * W.STEPS
            assert r["cases"][("sp2tp2_ring", policy)][
                "ulysses_kv_heads"] == 0


@pytest.mark.parametrize("name", W.OPT_STATE_CASES)
def test_meshed_opt_state_matches_reference(runs, name):
    """``Trainer.opt_state`` on a mesh is the whole tree on every rank:
    the count and the moments (ZeRO-1's dp slices joined, the tp, ep and
    pp shards joined, interleaved stages in layer order) against optax's
    ``ScaleByAdamState`` after 3 steps."""
    ranks, ref, _ = runs
    for r in ranks:
        _assert_moments_close(r["cases"][(name, "save_attn")]["state"],
                              ref[name])


def test_meshed_ema_matches_reference(runs):
    """The gathered EMA of the dp 2 x tp 2 run against the JAX Trainer's
    shadow after 3 steps."""
    ranks, ref, _ = runs
    for r in ranks:
        _assert_tree_close(r["cases"][(W.CKPT_CASE, "save_attn")]["state"][
            "ema"], ref[W.CKPT_CASE]["ema"])


def _indices(runs) -> np.ndarray:
    """The indices [start, stop) runs spell, in order."""
    return np.concatenate([np.arange(a, b) for a, b in runs])


def test_meshed_checkpoint_keeps_the_one_device_layout(runs):
    """(Named for the layout it had.)  The dp 2 x tp 2 checkpoint is
    written shard-wise: rank files and a manifest of the mesh, the
    count and each leaf's whole shape, with no temporary directory
    left.  Every element of every leaf of the parameters, both moments
    and the EMA lies in exactly one block of one file, so the files hold
    one copy of the state; assembled on one device they are the ranks'
    gathered trees bit for bit."""
    ranks, _, inp = runs
    root = os.path.join(inp["ckpt_dir"], str(W.STEPS))
    assert not [p for p in os.listdir(inp["ckpt_dir"])
                if p.startswith(".tmp")]
    with open(os.path.join(root, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["count"] == W.STEPS
    assert {a: n for a, n in manifest["mesh"].items() if n > 1} == \
        W.MESHES[W.CKPT_CASE]
    assert sorted(os.listdir(root)) == sorted(["manifest.json",
                                               *manifest["files"]])
    assert set(manifest["leaves"]) == {"params", "mu", "nu", "ema"}
    stored = 0
    for name, blocks in manifest["files"].items():
        flat = torch.load(os.path.join(root, name), weights_only=True)
        assert set(flat) == set(blocks)
        for key, held in blocks.items():
            assert tuple(flat[key].shape) == tuple(
                sum(b - a for a, b in r) for r in held)
            stored += flat[key].numel()
    whole = 0
    for kind, leaves in manifest["leaves"].items():
        for path, meta in leaves.items():
            seen = np.zeros(meta["shape"], dtype=np.int64)
            for blocks in manifest["files"].values():
                held = blocks.get(f"{kind}/{path}")
                if held is not None:
                    seen[np.ix_(*(_indices(r) for r in held))] += 1
            assert (seen == 1).all(), f"{kind}/{path}"
            whole += seen.size
    assert stored == whole
    _assert_assembles(inp["ckpt_dir"],
                      ranks[0]["cases"][(W.CKPT_CASE, "save_attn")])


def _assert_assembles(directory, want):
    """Step STEPS under ``directory``, assembled on one device
    (``CheckpointManager.restore``), is a run's gathered parameters,
    moments and EMA bit for bit."""
    like = jax.tree.map(lambda a: torch.empty(a.shape), want["params"])
    ema_like = like if want["state"]["ema"] is not None else None
    out = CheckpointManager(directory).restore(
        like, {"mu": like, "nu": like}, step=W.STEPS, ema_like=ema_like)
    params, opt, step = out[0], out[1], out[-1]
    assert step == W.STEPS and opt["count"] == W.STEPS
    pairs = [(params, want["params"]), (opt["mu"], want["state"]["mu"]),
             (opt["nu"], want["state"]["nu"])]
    if ema_like is not None:
        pairs.append((out[2], want["state"]["ema"]))
    for got, expect in pairs:
        got = params_to_numpy(got)
        assert jax.tree.structure(got) == jax.tree.structure(expect)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(expect)):
            assert np.array_equal(g, w)


def test_interleaved_checkpoint_holds_runs_of_layers(runs):
    """The interleaved 1F1B run (pp 2 x tp 2, 2 virtual stages a rank)
    saves shard-wise: a pp rank's block of a stacked leaf is two runs of
    layers (virtual stages d and 2 + d), and the files assemble into the
    ranks' gathered trees bit for bit."""
    ranks, _, inp = runs
    directory = os.path.join(inp["ckpt_dir"], "interleaved")
    with open(os.path.join(directory, str(W.STEPS), "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["virtual_stages"] == 2
    layers = next(c for c in W.CASES
                  if c[0] == W.INTERLEAVED_CKPT_CASE)[2]["n_layers"]
    lc = layers // 4
    runs_of = sorted(tuple(map(tuple, blocks["params/blocks/wq"][0]))
                     for blocks in manifest["files"].values()
                     if "params/blocks/wq" in blocks)
    assert runs_of == [((0, lc), (2 * lc, 3 * lc))] * 2 + [
        ((lc, 2 * lc), (3 * lc, 4 * lc))] * 2
    _assert_assembles(directory,
                      ranks[0]["cases"][(W.INTERLEAVED_CKPT_CASE,
                                         "save_attn")])


def test_save_and_restore_move_no_tensor_bytes(runs):
    """No save or resume of a meshed checkpoint (dp 2 x tp 2 with ZeRO-1
    and an EMA, the moved table's) calls a collective of
    torch.distributed that moves a tensor: only small objects cross
    between ranks.  The counting sees a gather of the same trainer's
    parameters, so it would see one in a save."""
    ranks, _, _ = runs
    for r in ranks:
        run = r["cases"][(W.CKPT_CASE, "save_attn")]
        assert run["save_calls"] == {}
        assert sum(run["gather_calls"].values()) > 0
        assert r["moved"]["save_calls"] == {}
        assert r["moved"]["resumed"]["calls"] == {}
        for where, got in r["resumes"].items():
            assert got["calls"] == {}, where


def test_failed_rank_leaves_latest_step(runs):
    """A save whose write raises on rank 1 raises on every rank (rank 1
    its own error, the others naming rank 1), commits nothing and leaves
    no temporary directory: ``latest_step`` stays the last good step."""
    ranks, _, inp = runs
    for r in ranks:
        got = r["cases"][(W.CKPT_CASE, "save_attn")]["failed_save"]
        want = ("OSError: disk full on rank 1" if r["rank"] == 1
                else "RuntimeError: checkpoint failed on rank 1")
        assert got["raised"] is not None and got["raised"].startswith(want)
        assert got["latest"] == W.STEPS
        assert W.FAILED_STEP not in got["steps"]
    assert not os.path.exists(os.path.join(inp["ckpt_dir"],
                                           f".tmp-{W.FAILED_STEP}"))


@pytest.mark.parametrize("where", W.RESUMES)
def test_checkpoint_resumes_across_meshes(runs, where):
    """The dp 2 x tp 2 checkpoint after step 3, resumed onto pp 2 x tp 2
    (1F1B) and onto one device over a fresh init: 2 more steps give the
    JAX Trainer's uninterrupted steps 4 and 5, its parameters, moments,
    count and EMA."""
    ranks, ref, _ = runs
    want = ref["resumed"]
    held = [r["resumes"][where] for r in ranks if where in r["resumes"]]
    assert held
    for got in held:
        assert got["step"] == W.STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        assert got["count"] == want["count"] == W.STEPS + W.RESUMED_STEPS
        for key in ("mu", "nu", "ema"):
            _assert_tree_close(got[key], want[key])


def test_restore_onto_sharded_mesh(runs):
    """The reference's ``test_restore_onto_sharded_mesh``: saved from one
    device, resumed onto dp 2 x tp 2 over another init; the next step's
    loss is the one-device trainer's (within 1e-5, where the reference
    holds 2e-2 under bf16)."""
    ranks, _, _ = runs
    want = ranks[0]["one_to_mesh"]["want_loss"]
    for r in ranks:
        assert r["one_to_mesh"]["step"] == 5
        assert abs(r["one_to_mesh"]["got_loss"] - want) < TOL


def test_one_device_checkpoint_resumes_shard_wise_onto_mesh(runs):
    """The one-device files resumed through a meshed ``attach_to_trainer``
    (each rank reads only its runs of them, no tensor collective): the
    next step's loss is the one-device trainer's and the whole-tree
    restore's, on every rank."""
    ranks, _, _ = runs
    want = ranks[0]["one_to_mesh"]["want_loss"]
    for r in ranks:
        got = r["one_to_mesh"]
        assert got["attach_step"] == 5 and got["attach_calls"] == {}
        assert got["attach_loss"] == got["got_loss"]
        assert abs(got["attach_loss"] - want) < TOL


@pytest.mark.parametrize("mesh_name", W.CNN_MESHES)
def test_cnn_trainer_matches_reference(runs, mesh_name):
    """The CNN's Trainer on tp (fc1 and fc2 cut), on ep and pp (nothing
    cut), and on sp (images laid out over H and gathered whole): losses,
    gathered parameters and optimizer state after 3 steps against the
    JAX Trainer."""
    ranks, ref, _ = runs
    want = ref[("cnn", mesh_name)]
    for r in ranks:
        got = r["cnn"][mesh_name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        _assert_moments_close(got, want)
        tp = W.MESHES[mesh_name].get("tp", 1)
        assert got["shapes"]["fc1"][1] == W.CNN["d_hidden"] // tp
        assert got["shapes"]["fc2"][0] == W.CNN["d_hidden"] // tp


@pytest.mark.parametrize("case", W.LORA_CASES, ids=lambda c: c[0])
def test_lora_trainer_matches_reference(runs, case):
    """The LoRA model on pp (GPipe, the adapters cut over stages), on pp x
    tp and on ep with an MoE base: losses, gathered adapters and their
    optimizer state after 3 steps against the JAX Trainer."""
    ranks, ref, _ = runs
    name, mesh_name, _ = case
    sizes = W.MESHES[mesh_name]
    for r in ranks:
        got = r["lora"][name]
        np.testing.assert_allclose(got["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(got["params"], ref[name]["params"])
        _assert_moments_close(got, ref[name])
        hd = W.DIMS["n_heads"] * W.DIMS["d_head"] // sizes.get("tp", 1)
        assert got["wq_b"] == (W.DIMS["n_layers"] // sizes.get("pp", 1),
                               W.LORA["rank"], hd)


@pytest.mark.parametrize("refusal", W.REFUSALS, ids=lambda c: c[0])
def test_remaining_refusals_match_reference(runs, refusal):
    """What the meshed trainer still refuses under ``save_attn`` is what
    the reference refuses (MoE and sp do not compose with pp), with its
    error type and message on every rank."""
    ranks, ref, _ = runs
    want = ref["refusals"][refusal[0]]
    assert want is not None
    for r in ranks:
        assert r["refusals"][refusal[0]] == want


def _paths(tree, prefix=""):
    """{"/"-joined key path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _local_shapes(whole, axes, table, sizes) -> dict:
    """Each leaf's shape on a rank of a mesh of ``sizes``: its whole
    shape, each dimension divided by the sizes of the mesh axes the
    reference's spec names there."""
    rules = _jax_rules(table)
    axes = _paths(jax.tree.map(lambda ax: ax, axes,
                               is_leaf=lambda x: isinstance(x, tuple)))
    out = {}
    for path, leaf in _paths(whole).items():
        spec = tuple(rules.spec(axes[path]))
        shape = list(np.shape(leaf))
        for dim, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            shape[dim] //= int(np.prod([sizes.get(a, 1) for a in names
                                        if a is not None]))
        out[path] = tuple(shape)
    return out


def _fsdp_case(name):
    return next(c for c in W.FSDP_CASES if c[0] == name)


@pytest.mark.parametrize("case", W.FSDP_CASES, ids=lambda c: c[0])
def test_fsdp_trainer_matches_reference(runs, case):
    """A rule table that cuts parameters over the data axes (``"embed"``
    on dp, or on ``("dp", "sp")``): every rank's losses, gathered
    parameters, gathered optimizer state and EMA after 3 steps against
    the JAX Trainer given the same rules on the same mesh."""
    ranks, ref, _ = runs
    name = case[0]
    want = ref[name]
    for r in ranks:
        got = r["fsdp"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        _assert_moments_close(got, want)
        if case[3].get("ema_decay"):
            _assert_tree_close(got["ema"], want["ema"])


@pytest.mark.parametrize("case", W.FSDP_CASES, ids=lambda c: c[0])
def test_fsdp_ranks_hold_their_slices(runs, case):
    """Between steps each rank holds only its part of every leaf the
    rules cut, over the data axes too: its parameters, both moments and
    its EMA at the shapes the reference's spec gives a device; the
    ``embed`` dimension at d_model / dp (/ sp for the tuple)."""
    ranks, ref, _ = runs
    name, mesh_name, knobs, _, table, _ = case
    sizes = W.MESHES[mesh_name]
    axes = _jax_model(knobs).logical_axes()
    want = _local_shapes(ref[name]["params"], axes, table, sizes)
    cut = int(np.prod([sizes.get(a, 1) for a in
                       np.atleast_1d(table["embed"])]))
    assert want["final_norm"] == (W.DIMS["d_model"] // cut,)
    for r in ranks:
        shapes = r["fsdp"][name]["shapes"]
        for kind in shapes:
            assert shapes[kind] == want, kind


@pytest.mark.parametrize("where", W.RESUMES)
def test_fsdp_checkpoint_resumes_across_meshes(runs, where):
    """The fsdp dp 2 x tp 2 checkpoint after step 3 holds the whole tree;
    resumed under the default rules onto pp 2 x tp 2 (1F1B) and onto one
    device, 2 more steps give the JAX fsdp Trainer's uninterrupted steps
    4 and 5: losses, parameters, moments, count and EMA."""
    ranks, ref, _ = runs
    want = ref["fsdp_resumed"]
    held = [r["fsdp"][("resumed", where)] for r in ranks
            if ("resumed", where) in r["fsdp"]]
    assert held
    for got in held:
        assert got["step"] == W.STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        assert got["count"] == want["count"] == W.STEPS + W.RESUMED_STEPS
        for key in ("mu", "nu", "ema"):
            _assert_tree_close(got[key], want[key])


def test_lora_fsdp_matches_reference(runs):
    """The LoRA model over dp 2 x pp 2 (GPipe) with the adapters cut over
    dp by the fsdp table (the base keeps the default layout): losses,
    gathered adapters and their optimizer state against the JAX Trainer
    given the same rules, and each rank's adapter slices."""
    ranks, ref, _ = runs
    name, mesh_name, knobs = W.LORA_FSDP_CASE
    sizes = W.MESHES[mesh_name]
    lora = JaxLoraModel(JaxLM(JaxConfig(**{**W.DIMS, **knobs},
                                        dtype=jnp.float32)),
                        {}, JaxLoraConfig(**W.LORA))
    want = _local_shapes(ref[name]["params"], lora.logical_axes(), W.FSDP,
                         sizes)
    assert want["blocks/wq/a"][1] == W.DIMS["d_model"] // sizes["dp"]
    for r in ranks:
        got = r["fsdp_consumers"][name]
        np.testing.assert_allclose(got["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(got["params"], ref[name]["params"])
        _assert_moments_close(got, ref[name])
        assert got["shapes"]["params"] == want


@pytest.mark.parametrize("case", W.BATCH_SPEC_CASES, ids=lambda c: c[0])
def test_batch_specs_match_reference(runs, case):
    """``batch_specs`` decide where the batch lies, never the result: the
    CNN with ``("dp",)`` set after construction and the fsdp transformer
    with replicated specs give the JAX Trainer's losses and parameters;
    a rank takes its rows under ``("dp",)`` and every row under
    ``()``."""
    ranks, ref, _ = runs
    name, mesh_name, _, _, specs = case
    dp = W.MESHES[mesh_name]["dp"]
    for r in ranks:
        got = r["fsdp_consumers"][name]
        np.testing.assert_allclose(got["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(got["params"], ref[name]["params"])
        assert got["rows"] == [W.GLOBAL_BATCH // dp if spec else
                               W.GLOBAL_BATCH for spec in specs]


def test_fsdp_with_zero1_raises_in_both_packages(runs):
    """ZeRO-1 would cut a dp-cut leaf's moments over dp again: the
    reference's ``init`` raises ``DuplicateSpecError`` for the first such
    leaf, and the port's raises a ValueError naming the leaf and the
    same duplicate spec, on every rank."""
    ranks, ref, _ = runs
    kind, msg = ref["fsdp_refusals"]["fsdp_zero1"]
    assert kind == "DuplicateSpecError"
    spec = msg[msg.index("PartitionSpec("):msg.index(" has duplicate")]
    for r in ranks:
        got = r["fsdp_refusals"]["fsdp_zero1"]
        assert got is not None and got[0] == "ValueError"
        assert "zero1 on blocks/" in got[1]
        assert spec.replace("PartitionSpec", "") in got[1].replace(
            "PartitionSpec", "")
        assert "has duplicate entries for `dp`" in got[1]


def test_table_moving_a_weight_axis_raises_in_the_port_only(runs):
    """(Named when the port refused the table.)  ``"mlp": None`` on dp 2
    x tp 2 leaves the MLP whole on every tp rank; with ZeRO-1 and an EMA
    it trains in both packages alike: every rank's losses, gathered
    parameters, moments and EMA within 1e-5 of the JAX Trainer's."""
    ranks, ref, _ = runs
    want = ref["mlp_whole"]
    assert np.isfinite(want["losses"]).all()
    for r in ranks:
        got = r["moved"]["mlp_whole"]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        _assert_moments_close(got, want)
        _assert_tree_close(got["ema"], want["ema"])


# The leaves each MOVED_CASES table re-cuts once a step.
MOVED_LEAVES = {
    "mlp_whole": {"blocks/wi_gate", "blocks/wi_up", "blocks/wo_mlp"},
    "moved_mlp_dp_tp": {"blocks/wi_gate", "blocks/wi_up", "blocks/wo_mlp"},
    "moved_experts_whole": {"blocks/e_wi_gate", "blocks/e_wi_up",
                            "blocks/e_wo"},
    "moved_vocab_whole": {"embed", "head"},
}


@pytest.mark.parametrize("case", W.MOVED_CASES, ids=lambda c: c[0])
def test_moved_table_matches_reference(runs, case):
    """A table that moves a weight axis, or names dp before tp: every
    rank's losses, gathered parameters, optimizer state and EMA after 3
    steps within 1e-5 of the JAX Trainer given the same rules, and the
    port re-cuts exactly the leaves whose layout differs."""
    ranks, ref, _ = runs
    name, _, _, train, _, _ = case
    want = ref[name]
    for r in ranks:
        got = r["moved"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        _assert_moments_close(got, want)
        if train.get("ema_decay"):
            _assert_tree_close(got["ema"], want["ema"])
        assert set(got["moved"]) == MOVED_LEAVES[name]


@pytest.mark.parametrize("case", W.MOVED_CASES, ids=lambda c: c[0])
def test_moved_table_ranks_hold_their_blocks(runs, case):
    """Between steps each rank holds the block of every leaf the table
    gives it (parameters, moments, EMA): the reference's shapes, the MLP
    whole over tp under ``"mlp": None``."""
    ranks, ref, _ = runs
    name, mesh_name, knobs, train, table, _ = case
    sizes = W.MESHES[mesh_name]
    axes = _jax_model(knobs).logical_axes()
    want = _local_shapes(ref[name]["params"], axes, table, sizes)
    for r in ranks:
        shapes = r["moved"][name]["shapes"]
        assert shapes["params"] == want
        if not train.get("zero1"):
            assert shapes["mu"] == shapes["nu"] == want
        if "ema" in shapes:
            assert shapes["ema"] == want
    if name == "mlp_whole":
        assert want["blocks/wi_up"][2] == W.DIMS["d_ff"]


def test_moved_table_replicas_stay_equal(runs):
    """Under ``"mlp": None`` the MLP rests whole on every rank: its
    parameters and EMA are equal on all four after 3 steps, and ZeRO-1's
    moment slices on the ranks of one dp coordinate."""
    ranks, _, _ = runs
    held = [r["moved"]["mlp_whole"] for r in ranks]
    for kind in ("params", "ema", "mu", "nu"):
        for path in W.MLP_LEAVES:
            for h in held[1:]:
                if kind in ("mu", "nu") and \
                        h["coords"]["dp"] != held[0]["coords"]["dp"]:
                    continue
                assert np.array_equal(h["held"][kind][path],
                                      held[0]["held"][kind][path]), (
                    kind, path)


def test_moved_checkpoint_resumes_under_default_rules(runs):
    """The ``("dp", "tp")`` table's checkpoint after step 3, resumed on dp
    2 x tp 2 under the default rules over a fresh init: 2 more steps give
    the JAX Trainer's uninterrupted steps 4 and 5 under the moved table:
    losses, parameters, moments, count and EMA."""
    ranks, ref, _ = runs
    want = ref["moved_resumed"]
    for r in ranks:
        got = r["moved"]["resumed"]
        assert got["step"] == W.STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        _assert_tree_close(got["params"], want["params"])
        assert got["count"] == want["count"] == W.STEPS + W.RESUMED_STEPS
        for key in ("mu", "nu", "ema"):
            _assert_tree_close(got[key], want[key])


def test_moved_table_with_zero1_raises_in_both_packages(runs):
    """ZeRO-1 under ``"mlp": ("dp", "tp")``: the reference's ``init``
    raises ``DuplicateSpecError`` for the first MLP leaf, and the port's
    a ValueError naming it and the same spec, on every rank."""
    ranks, ref, _ = runs
    kind, msg = ref["fsdp_refusals"]["moved_zero1"]
    assert kind == "DuplicateSpecError"
    spec = msg[msg.index("PartitionSpec("):msg.index(" has duplicate")]
    for r in ranks:
        got = r["fsdp_refusals"]["moved_zero1"]
        assert got is not None and got[0] == "ValueError"
        assert "zero1 on blocks/wi_gate" in got[1]
        assert spec.replace("PartitionSpec", "") in got[1].replace(
            "PartitionSpec", "")
