"""The port's pipeline axis across processes, against the JAX package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
every case of ``torch_pp_worker.run_all`` once for the module; the JAX
package trains the same cases on four of the eight virtual CPU devices
meanwhile, from the same numpy inputs and parameters, all in float32.
Each case is a 3-step ``Trainer``: GPipe on dp 2 x pp 2 (with 2
accumulated microbatches), 1F1B on pp 2 x tp 2 with the GQA v2 knobs,
1F1B on dp 2 x pp 2 with ZeRO-1, and interleaved 1F1B on pp 4 with 2
virtual stages.  Losses and gathered parameters are held within 1e-5,
as are the step-1 gradients against ``jax.grad`` of the one-device loss
and GPipe's ``forward`` logits.  The same spawn checks where the
gradients of the leaves replicated over pp land and the reference's
refusals; the tick tables are checked without a process group.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pp_worker as W
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel import pipeline as jax_pipeline
from k8s_gpu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from k8s_gpu_tpu.parallel.mesh import mesh_from_devices
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.parallel import pipeline
from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster

TOL = 1e-5
WORKERS = 4


def _jax_mesh(mesh_name):
    return mesh_from_devices(jax.devices()[:WORKERS],
                             JaxMeshConfig(**W.MESHES[mesh_name]))


def _jax_model(knobs):
    """The reference model of a case, its attention through the plain
    reference (as its own pipeline tests run it on the CPU; the flash
    knobs then take no effect there, and the port's CPU path takes the
    plain versions of the kernels)."""
    return JaxLM(JaxConfig(**{**W.DIMS, **knobs}, dtype=jnp.float32,
                           use_flash=False))


def _jax_refusal(mesh_name, knobs, train, toks, start=None):
    """The reference's error for a refusal case; ``start``: a trainer
    whose parameters it may take instead of an init (same mesh and
    shapes; it raises before any step runs)."""
    try:
        jtr = JaxTrainer(_jax_model(knobs), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train))
        if start is None:
            jtr.init(jax.random.PRNGKey(0))
        else:
            jtr.params, jtr.opt_state = start.params, start.opt_state
        jtr.step(toks[:, :-1], toks[:, 1:])
        return None
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the JAX package's results): the cluster
    runs in a thread while JAX trains the same cases here."""
    trainers, params = {}, {}
    for name, mesh_name, knobs, train, _ in W.CASES:
        jtr = JaxTrainer(_jax_model(knobs), mesh=_jax_mesh(mesh_name),
                         train_config=JaxTrainConfig(**W.TRAIN, **train))
        jtr.init(jax.random.PRNGKey(0))
        trainers[name] = jtr
        params[name] = jax.tree.map(np.asarray, jtr.params)
    inp = W.make_inputs(0, params)
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=480.0, device="cpu")
        ref = {}
        base = trainers[W.REFUSAL_BATCH]
        toks = inp["tokens"][W.REFUSAL_BATCH][0]
        ref["refusals"] = {
            name: _jax_refusal(mesh_name, knobs, train, toks,
                               base if mesh_name == "dp2pp2"
                               and "num_experts" not in knobs else None)
            for name, mesh_name, knobs, train in W.REFUSALS}
        gname = W.CASES[0][0]
        jm, mesh = _jax_model(W.CASES[0][2]), _jax_mesh(W.CASES[0][1])
        logits, _ = jax.jit(lambda p, t: jm.forward(p, t, mesh))(
            trainers[gname].params, inp["forward_tokens"])
        ref["forward_logits"] = np.asarray(logits)
        for name, _, knobs, _, _ in W.CASES:
            jtr = trainers[name]
            t0 = inp["tokens"][name][0]
            grads = jax.jit(jax.grad(_jax_model(knobs).loss))(
                params[name], t0[:, :-1], t0[:, 1:])
            ref[name] = {
                "losses": [float(jtr.step(t[:, :-1], t[:, 1:]))
                           for t in inp["tokens"][name]],
                "params": jax.tree.map(np.asarray, jtr.params),
                "grads": jax.tree.map(np.asarray, grads)}
        return ranks.result(), ref


def _assert_tree_close(got, want, atol, path="", scaled=False):
    """Every leaf within ``atol``, or with ``scaled`` within ``atol``
    times the leaf's largest magnitude (at least 1)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}", scaled)
    else:
        want = np.asarray(want)
        tol = atol * max(1.0, float(np.abs(want).max())) if scaled else atol
        np.testing.assert_allclose(got, want, atol=tol, err_msg=path)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_pipelined_trainer_matches_reference(runs, case):
    """Every rank's losses and gathered parameters after 3 steps against
    the JAX Trainer on the same mesh shape and schedule."""
    ranks, ref = runs
    name = case[0]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(r[name]["params"], ref[name]["params"], TOL)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_step_gradients_match_one_device_grad(runs, case):
    """The gradients AdamW is handed at step 1, gathered over tp and pp,
    against ``jax.grad`` of the reference's one-device loss on the same
    batch, within 1e-5 of each leaf's largest gradient (float32
    summation order; the embedding's reach 3 before the clip): AdamW's
    update hardly sees a gradient's scale, so this is where a leaf
    counted twice shows."""
    ranks, ref = runs
    name = case[0]
    for r in ranks:
        _assert_tree_close(r[name]["grads"], ref[name]["grads"], TOL,
                           scaled=True)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_replicated_leaves_get_one_copy_of_the_gradient_on_every_pp_rank(
        runs, case):
    """The embedding, the final norm and the head are whole on every pp
    rank, and each pp rank must leave the step with the same gradient of
    them, that of one copy of the loss: GPipe runs the tail on every pp
    rank after the share, where a sum over pp would count the head and
    the norm pp times; 1F1B makes them on one stage only, where no sum
    would leave the other ranks without."""
    ranks, ref = runs
    name = case[0]
    pp = W.MESHES[case[1]]["pp"]
    for r in ranks:
        for leaf in W.REPLICATED:
            got = r[name]["replicated"][leaf]
            twin = next(o[name]["replicated"][leaf] for o in ranks
                        if o[name]["coords"]["tp"] == r[name]["coords"]["tp"]
                        and o[name]["coords"]["pp"] == 0)
            assert np.array_equal(got, twin), (
                f"{leaf}: pp rank {r[name]['coords']['pp']} holds another "
                "gradient than pp rank 0")
            whole = r[name]["grads"][leaf]
            want = np.asarray(ref[name]["grads"][leaf])
            ratio = np.linalg.norm(whole) / np.linalg.norm(want)
            assert abs(ratio - 1) < 1e-4, (
                f"{leaf}: the gradient on pp rank {r[name]['coords']['pp']}"
                f" is {ratio:.3f}x one copy's (a sum over the {pp} pp "
                f"copies would be {pp}x, none 0x)")


def test_1f1b_keeps_the_reference_ring_of_stage_inputs(runs):
    """1F1B holds at most 2 P - 1 stage inputs (interleaved: 2 P v - 1
    chunk inputs) and runs the table's ticks; GPipe, under autograd,
    keeps none of its own.  The interleaved rank holds its 2 chunks of 1
    layer, and every rank counts the whole model's parameters."""
    ranks, _ = runs
    for name, mesh_name, knobs, _, batch in W.CASES:
        pp = W.MESHES[mesh_name]["pp"]
        v = knobs.get("pp_virtual_stages", 1)
        M = knobs.get("pp_microbatches") or (
            pp if knobs.get("pp_schedule") == "gpipe" else
            2 * pp if batch // W.MESHES[mesh_name]["dp"] % (2 * pp) == 0
            else pp)
        for r in ranks:
            run = r[name]
            if knobs.get("pp_schedule") == "gpipe":
                assert run["live_inputs"] == 0
                assert run["ticks"] == pipeline.forward_ticks(M, pp, v)
            else:
                assert 0 < run["live_inputs"] <= 2 * pp * v - 1
                assert run["ticks"] == pipeline.pipeline_ticks(M, pp, v)
            assert run["n_params"] == sum(
                np.asarray(x).size
                for x in jax.tree.leaves(r[name]["params"]))
    for r in ranks:
        layers = r["interleaved_pp4v2"]["block_shape"][0]
        assert layers == 2


def test_gpipe_forward_gives_full_logits_on_every_rank(runs):
    """``forward`` on dp 2 x pp 2: each rank's [B/dp, S, V] logits
    against the JAX pipelined forward's, aux 0."""
    ranks, ref = runs
    for r in ranks:
        dp = r["gpipe_dp2pp2"]["coords"]["dp"]
        want = np.split(ref["forward_logits"], 2, axis=0)[dp]
        np.testing.assert_allclose(r["forward"]["logits"], want, atol=TOL)
        assert r["forward"]["aux"] == 0.0


@pytest.mark.parametrize("refusal", W.REFUSALS, ids=lambda c: c[0])
def test_pipeline_refusals_match_reference(runs, refusal):
    """MoE + pp, sp + pp, an unknown ``pp_schedule``, accumulation under
    1F1B, virtual stages that do not divide the layers and a batch that
    does not divide into the microbatches: the reference's error type
    and message on every rank."""
    ranks, ref = runs
    name = refusal[0]
    want = ref["refusals"][name]
    assert want is not None
    for r in ranks:
        assert r["refusals"][name] == want


@pytest.mark.parametrize("pp,v", [(p, v) for p in (2, 4) for v in (1, 2, 3)])
def test_tick_table(pp, v):
    """For M from P to 3 P: every (chunk, microbatch) runs its forward
    once and its backward once, on its own device (virtual stage c P +
    d); each hop lands one tick later on the next virtual stage (the
    forward) or the previous one (the backward); each backward follows
    its forward (on the last virtual stage, in the same tick); no tick
    runs more than one of each a device.  The tick count is the
    reference's ``classic_ticks_fine`` at v = 1 and its
    ``interleaved_ticks`` when P divides M; otherwise the reference's
    count falls short of the table's last backward (ROADMAP queue 3)."""
    S = pp * v
    for M in range(pp, 3 * pp + 1):
        table = pipeline.tick_table(M, pp, v)
        fwd, bwd = {}, {}
        for i, row in enumerate(table):
            for d, (f, b) in enumerate(row):
                for seen, cj in ((fwd, f), (bwd, b)):
                    if cj is not None:
                        key = (cj[0] * pp + d, cj[1])
                        assert key not in seen, (M, key)
                        seen[key] = i
        every = {(s, j) for s in range(S) for j in range(M)}
        assert set(fwd) == every and set(bwd) == every, M
        for (s, j), t in fwd.items():
            if s < S - 1:
                assert fwd[(s + 1, j)] == t + 1
            if s > 0:
                assert bwd[(s - 1, j)] == bwd[(s, j)] + 1
            assert bwd[(s, j)] >= t + (s < S - 1)
        T = pipeline.pipeline_ticks(M, pp, v)
        assert len(table) == T == max(bwd.values()) + 1
        assert pipeline.forward_ticks(M, pp, v) == max(fwd.values()) + 1
        assert pipeline.interleaved_ticks(M, pp, v) == \
            jax_pipeline.interleaved_ticks(M, pp, v)
        if v == 1:
            assert T == jax_pipeline.classic_ticks_fine(M, pp) == \
                pipeline.classic_ticks_fine(M, pp)
        elif M % pp == 0:
            assert T == jax_pipeline.interleaved_ticks(M, pp, v)
        else:
            assert T > jax_pipeline.interleaved_ticks(M, pp, v)
