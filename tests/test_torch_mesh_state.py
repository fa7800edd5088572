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
The dp 2 x tp 2 run's checkpoint resumes onto pp 2 x tp 2 and onto one
device, and 2 more steps equal the JAX Trainer's uninterrupted 5; a
one-device checkpoint resumes onto dp 2 x tp 2.
"""

import functools
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
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster

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
    runs in a thread while JAX trains the same cases here."""
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
    inp = W.make_inputs(0, params, str(tmp_path_factory.mktemp("ckpt")))
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=600.0, device="cpu")
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


def test_meshed_checkpoint_keeps_the_one_device_layout(runs):
    """The dp 2 x tp 2 checkpoint holds the one-device files, keyed by
    path, at the whole tree's shapes, written once."""
    _, ref, inp = runs
    root = os.path.join(inp["ckpt_dir"], str(W.STEPS))
    assert sorted(os.listdir(root)) == ["ema.pt", "opt_state.pt",
                                        "params.pt"]
    assert not [p for p in os.listdir(inp["ckpt_dir"])
                if p.startswith(".tmp")]
    flat = torch.load(os.path.join(root, "params.pt"), weights_only=True)
    want = ref[W.CKPT_CASE]["params"]
    assert flat["blocks/wq"].shape == want["blocks"]["wq"].shape
    assert flat["embed"].shape == want["embed"].shape
    opt = torch.load(os.path.join(root, "opt_state.pt"), weights_only=True)
    assert opt["count"] == W.STEPS and set(opt["mu"]) == set(flat)


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
