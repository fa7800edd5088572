"""The port's tensor and expert axes across processes, against the JAX
package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
every case of ``torch_tp_worker.run_all`` once for the module; the JAX
package trains the same cases on four of the eight virtual CPU devices
meanwhile, from the same numpy inputs and parameters.  Each case is a
3-step float32 ``Trainer`` at lr 1e-3 (warmup 1): dp 2 x tp 2 (ZeRO-1,
``grad_accum_steps`` 2, GQA with the v2 knobs), sp 2 x tp 2 through the
ring and through Ulysses, ep 2 x tp 2 MoE, dp 2 x ep 2 MoE at a capacity
that drops tokens, and the multislice dp 2 x tp 2 mesh.  Losses and
gathered parameters are held within 1e-5 (the dp x sp trainer's
tolerance), as are ``forward``'s gathered logits on the dp 2 x tp 2
mesh.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_worker as W
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from k8s_gpu_tpu.parallel.mesh import mesh_from_devices, multislice_mesh
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.parallel.multihost import spawn_local_cluster

TOL = 1e-5
WORKERS = 4


def _jax_mesh(mesh_name):
    devices = jax.devices()[:WORKERS]
    if mesh_name == "multislice":
        return multislice_mesh(JaxMeshConfig(dp=2, tp=2), W.SLICES,
                               devices=devices)
    return mesh_from_devices(devices, JaxMeshConfig(**W.MESHES[mesh_name]))


def _jax_model(knobs):
    return JaxLM(JaxConfig(**W.DIMS, **knobs, dtype=jnp.float32))


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the JAX package's results): the cluster
    runs in a thread while JAX trains the same cases here."""
    trainers, params = {}, {}
    for name, mesh_name, knobs, train in W.CASES:
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
        knobs = dict(W.CASES[0][2])
        logits, _ = jax.jit(_jax_model(knobs).forward)(
            params["dp2tp2"], inp["forward_tokens"])
        ref["forward_logits"] = np.asarray(logits)
        for name, _, _, _ in W.CASES:
            jtr = trainers[name]
            ref[name] = {
                "losses": [float(jtr.step(t[:, :-1], t[:, 1:]))
                           for t in inp["tokens"][name]],
                "params": jax.tree.map(np.asarray, jtr.params)}
        return ranks.result(), ref


def _assert_tree_close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=atol)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_meshed_trainer_matches_reference(runs, case):
    """Every rank's losses and gathered parameters after 3 steps against
    the JAX Trainer on the same mesh shape."""
    ranks, ref = runs
    name = case[0]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], ref[name]["losses"],
                                   atol=TOL)
        _assert_tree_close(r[name]["params"], ref[name]["params"], TOL)


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_whole_leaves_agree_on_every_rank(runs, case):
    """The leaves tp and ep leave whole (norm scales, the MoE router, and
    on the ep mesh without tp every dense leaf) are bit-equal on every
    rank after each step: their gradients were averaged over the batch
    group only, where the ranks of a tp or ep group already agree."""
    ranks, _ = runs
    name = case[0]
    first = ranks[0][name]["whole"]
    assert len(first) == W.STEPS and all(first)
    for r in ranks[1:]:
        for got, want in zip(r[name]["whole"], first):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_shards_are_cut_over_tp_and_ep(runs):
    """A rank holds its part of each cut leaf: on dp 2 x tp 2 the
    embedding's rows and wq's heads halve; on ep 2 x tp 2 the experts and
    their F both halve; on dp 2 x ep 2 only the experts do.  On every
    mesh ``gather_params`` gives back, bit for bit, the tree that
    ``shard_params`` cut."""
    ranks, _ = runs
    assert all(r[name]["round_trip"] for r in ranks for name, *_ in W.CASES)
    V, D, E, F = (W.DIMS["vocab_size"], W.DIMS["d_model"], 4,
                  W.DIMS["d_ff"])
    for r in ranks:
        shapes = r["dp2tp2"]["shapes"]
        assert (V // 2, D) in shapes and (D, V // 2) in shapes
        assert (2, D, 2, W.DIMS["d_head"]) in shapes        # wq, H/tp
        assert (2, D, 1, W.DIMS["d_head"]) in shapes        # wk, KH/tp
        assert (2, E // 2, D, F // 2) in r["ep2tp2_moe"]["shapes"]
        assert (2, E // 2, D, F) in r["dp2ep2_moe_drops"]["shapes"]


def test_moe_drops_follow_the_global_order(runs):
    """At capacity 1.0 over dp 2 x ep 2 tokens are dropped, and more of
    the second dp block's (later in the global order) than of the
    first's: the capacity and the slots are the global microbatch's.
    The gathered parameters above match the reference only so."""
    ranks, _ = runs
    by_dp = {}
    for r in ranks:
        run = r["dp2ep2_moe_drops"]
        by_dp.setdefault(run["coords"]["dp"], set()).add(sum(run["drops"]))
    assert all(len(v) == 1 for v in by_dp.values())   # ep ranks agree
    first, second = by_dp[0].pop(), by_dp[1].pop()
    assert first + second > 0 and second > first


def test_ulysses_counts_the_kv_head_fallback(runs):
    """sp 2 x tp 2 with 4 heads and 2 KV heads: KV/tp = 1 does not divide
    by sp, so Ulysses broadcasts K/V and counts ``ulysses_kv_heads`` once
    a layer and forward, as the reference's ``ulysses_grouped_ok``
    decides; the ring keeps them grouped and counts nothing."""
    ranks, _ = runs
    for r in ranks:
        assert r["sp2tp2_ulysses"]["ulysses_kv_heads"] == (
            W.DIMS["n_layers"] * W.STEPS)
        assert r["sp2tp2_ring"]["ulysses_kv_heads"] == 0


def test_forward_gathers_the_logits(runs):
    """``forward`` on dp 2 x tp 2: each rank's [B/dp, S, V] logits, the
    vocabulary slices gathered over tp, against the JAX forward."""
    ranks, ref = runs
    for r in ranks:
        dp = r["dp2tp2"]["coords"]["dp"]
        want = np.split(ref["forward_logits"], 2, axis=0)[dp]
        np.testing.assert_allclose(r["dp2tp2"]["forward_logits"], want,
                                   atol=TOL)
