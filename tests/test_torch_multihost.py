"""The port's parallel plane across processes, against the JAX package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
every case of ``torch_parallel_worker.run_all`` once for the module; the
JAX package computes the same cases on four of the eight virtual CPU
devices meanwhile, from the same numpy inputs.  Tolerances, the
reference's own (``tests/test_ring_attention.py``): attention outputs
within 2e-5 and gradients within 3e-5 at float32; the ``Trainer`` over
dp 2 x sp 2 (ZeRO-1, ``grad_accum_steps`` 2, GQA, 3 steps at lr 1e-3):
losses and parameters within 1e-5.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_worker as W
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from k8s_gpu_tpu.parallel.mesh import mesh_from_devices
from k8s_gpu_tpu.parallel.ring_attention import ring_attention as jax_ring
from k8s_gpu_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster

ATTN_OUT_TOL, ATTN_GRAD_TOL, TRAIN_TOL = 2e-5, 3e-5, 1e-5
WORKERS = 4


def _jax_mesh(name):
    return mesh_from_devices(jax.devices()[:WORKERS],
                             JaxMeshConfig(**W.MESHES[name]))


def _jax_trainer():
    model = JaxLM(JaxConfig(**W.DIMS, dtype=jnp.float32))
    return JaxTrainer(model, mesh=_jax_mesh("dp2sp2"),
                      train_config=JaxTrainConfig(**W.TRAIN, zero1=True))


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the JAX package's results): the cluster
    runs in a thread while JAX computes the same cases here."""
    jtr = _jax_trainer()
    jtr.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtr.params)
    inp = W.make_inputs(0, params)
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=240.0, device="cpu")
        ref = {}
        fns = {"ring": jax_ring, "ulysses": jax_ulysses}
        for name, fn, mesh_name, _ in W.ATTN_CASES:
            a, mesh = inp["attn"][name], _jax_mesh(mesh_name)

            def f(q, k, v, fn=fns[fn], mesh=mesh, g=a["g"]):
                o = fn(q, k, v, mesh)
                return (o * g).sum(), o

            (_, o), grads = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True))(a["q"], a["k"], a["v"])
            ref[name] = dict(o=o, dq=grads[0], dk=grads[1], dv=grads[2])
        ref["ulysses_errors"] = []
        for name, heads in W.ULYSSES_ERRORS:
            a = inp["attn"][name]
            with pytest.raises(ValueError) as err:
                jax_ulysses(*(a[t][:, :heads] for t in "qkv"),
                            _jax_mesh("sp4"))
            ref["ulysses_errors"].append(str(err.value))
        ref["losses"] = [float(jtr.step(t[:, :-1], t[:, 1:]))
                         for t in inp["tokens"]]
        ref["params"] = jax.tree.map(np.asarray, jtr.params)
        return ranks.result(), ref


def _assemble(ranks, key, field, mesh_name):
    """The global array of ``field`` from every rank's block."""
    dp, sp = W.MESHES[mesh_name]["dp"], W.MESHES[mesh_name]["sp"]
    grid = [[None] * sp for _ in range(dp)]
    for r in ranks:
        i, j = r["coords"][mesh_name]
        grid[i][j] = r[key][field]
    return np.concatenate([np.concatenate(row, axis=2) for row in grid],
                          axis=0)


@pytest.mark.parametrize("case", W.ATTN_CASES, ids=lambda c: c[0])
def test_sp_attention_matches_reference(runs, case):
    ranks, ref = runs
    name, _, mesh_name, _ = case
    for field, tol in (("o", ATTN_OUT_TOL), ("dq", ATTN_GRAD_TOL),
                       ("dk", ATTN_GRAD_TOL), ("dv", ATTN_GRAD_TOL)):
        np.testing.assert_allclose(
            _assemble(ranks, name, field, mesh_name),
            np.asarray(ref[name][field]), atol=tol, err_msg=field)


def test_ulysses_divisibility_errors_match_reference(runs):
    ranks, ref = runs
    for r in ranks:
        assert r["ulysses_errors"] == ref["ulysses_errors"]
    assert all("divisible by sp=4" in e for e in ref["ulysses_errors"])


def _assert_tree_close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=atol)


@pytest.mark.parametrize("zero1", [True, False])
def test_meshed_trainer_matches_reference(runs, zero1):
    """dp 2 x sp 2, ring, GQA with rope outside, grad_accum_steps 2: the
    JAX Trainer's losses and parameters (its ZeRO-1 leaves the update as
    it is, so both port runs are held to the same reference)."""
    ranks, ref = runs
    for r in ranks:
        run = r[f"trainer_zero1_{zero1}"]
        np.testing.assert_allclose(run["losses"], ref["losses"],
                                   atol=TRAIN_TOL)
        _assert_tree_close(run["params"], ref["params"], TRAIN_TOL)
        # The ring at sp 2: 3 flash calls a layer and forward (hop 0 and
        # the two of hop 1), each forward run twice (remat), per
        # microbatch and step; rope kept outside once a layer a forward.
        layers, accum = W.DIMS["n_layers"], W.TRAIN["grad_accum_steps"]
        assert run["plain_calls"] == 3 * 2 * layers * accum * W.STEPS
        assert run["sp_fused_rope"] == layers * accum * W.STEPS


def test_zero1_on_and_off_give_the_same_parameters(runs):
    ranks, _ = runs
    for r in ranks:
        on, off = r["trainer_zero1_True"], r["trainer_zero1_False"]
        assert on["losses"] == off["losses"]
        _assert_tree_close(on["params"], off["params"], 0.0)
        # ZeRO-1 halves each moment along its largest free axis (the
        # embedding [V, D] along D, V being named for tp; wq [L, D, H,
        # Dh] along D).
        assert sum(np.prod(s) for s in on["moments"]) * 2 == sum(
            np.prod(s) for s in off["moments"])
    first = ranks[0]["trainer_zero1_True"]["params"]
    for r in ranks[1:]:
        _assert_tree_close(r["trainer_zero1_True"]["params"], first, 0.0)


def test_psum_smoke_over_four_ranks(runs):
    ranks, _ = runs
    for r in ranks:
        out = r["psum_smoke"]
        assert out["ok"] and out["n_devices"] == WORKERS
        assert out["result"] == float(sum(range(WORKERS)))


def test_bandwidth_probes_over_four_ranks(runs):
    """Each mesh axis of size 2 timed on its own group, into the given
    registry's series; the whole-mesh probe over the four ranks."""
    ranks, _ = runs
    for r in ranks:
        assert set(r["per_axis"]) == {"dp", "sp"}
        for axis, row in r["per_axis"].items():
            assert row["devices"] == 2 and row["transport"] == "gloo"
            assert row["seconds"] > 0 and row["bytes_per_second"] > 0
            assert r["per_axis_series"][axis] == (row["bytes_per_second"],
                                                  1)
        probe = r["all_reduce_probe"]
        assert probe["n_devices"] == WORKERS and probe["time_s"] > 0
        assert probe["bytes"] == 1024 * 1024 and probe["algo_gbps"] > 0


def test_workloads_over_four_ranks(runs):
    """The built-in workloads: the device report, and one dp-sharded
    step whose loss every rank agrees on."""
    ranks, _ = runs
    assert [r["device_report"] for r in ranks] == [
        {"process_index": i, "process_count": WORKERS,
         "global_devices": WORKERS, "local_devices": 1}
        for i in range(WORKERS)]
    losses = {r["train_step"]["loss"] for r in ranks}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert {r["train_step"]["global_devices"] for r in ranks} == {WORKERS}
