"""The port's serving on a mesh across processes, against the JAX package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
every case of ``torch_serve_worker.run_all`` once for the module, on
the reference tests' tiny float32 model; the JAX package serves the
same requests meanwhile, from the same numpy weights.  The port's
meshed greedy streams are held token for token to the JAX batcher on
the same mesh (tp 4 through the paged kernel, dp 2 x tp 2 on both
pools) and to the JAX batcher without a mesh (tp 4 through the gather
read, the multislice dp 2 x tp 2 mesh, n-gram speculation, int8 KV, an
adapter bank), which the reference's own tests hold equal to its meshed
streams.  Every rank's tokens are equal, a sampled request's too; each
rank's pool slice is the matching part of a one-rank pool; the engine's
``generate``, a meshed ``LmServer`` and a LoRA fine-tune over dp 2 x tp
2 agree with the reference; and what a serving mesh refuses says so.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_worker as W
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from k8s_gpu_tpu.parallel.mesh import mesh_from_devices
from k8s_gpu_tpu.parallel.sharding import shard_params as jax_shard
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve import InferenceEngine as JaxEngine
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train.lora import LoraAdapter as JaxAdapter
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig
from k8s_gpu_tpu_torch.parallel.multihost import (
    serve_ranks, spawn_local_cluster,
)
from k8s_gpu_tpu_torch.serve import ContinuousBatcher

torch.set_num_threads(1)

TOL = 1e-5
WORKERS = 4
JM = JaxLM(JaxConfig(**W.DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
PRECACHED = [ord(c) for c in "(%)+"]
# The JAX batchers the cases are held to: (mesh or None, knobs, the
# cases whose greedy requests each serves).  The unsharded paged one
# carries the adapter bank (its base rows are the bank-less stream, the
# reference's own rule) and stands for the unsharded dense pool too (the
# reference's tests hold both pools to one greedy oracle); it also
# serves the prompt that extends the meshed server's /precache'd prefix.
ORACLES = (
    ("tp4", dict(W.PAGED, attn_impl="paged_kernel"), ("tp4_paged_kernel",)),
    ("dp2tp2", {}, ("dp2tp2_dense",)),
    ("dp2tp2", dict(W.PAGED, slots=3), ("dp2tp2_paged",)),
    (None, dict(W.PAGED), ("tp4_paged_gather", "tp4_ngram", "tp4_adapters",
                           "multislice_dp2tp2_dense")),
    (None, dict(W.PAGED, kv_quant=True), ("tp4_kv_quant",)),
)


def _jax_mesh(name):
    return mesh_from_devices(jax.devices()[:WORKERS],
                             JaxMeshConfig(**W.MESHES[name]))


def _adapter():
    """The reference's init with B drawn non-zero (B = 0 serves the base
    model)."""
    tree = JaxAdapter(JaxLoraConfig(rank=W.LORA_RANK)).init(
        jax.random.PRNGKey(1), JP)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(5)
    for ab in tree["blocks"].values():
        ab["b"] = rng.normal(0.0, 0.05, ab["b"].shape).astype(np.float32)
    return tree


def _jax_streams(oracle, adapter) -> dict:
    """One JAX batcher's streams of its cases' greedy requests, by case
    (``after_precache``: the unsharded paged one's extra prompt)."""
    mesh_name, knobs, names = oracle
    params, kw = JP, dict(knobs)
    if mesh_name is not None:
        kw["mesh"] = _jax_mesh(mesh_name)
        params = jax_shard(JP, JM.logical_axes(), kw["mesh"])
    if "tp4_adapters" in names:
        kw["adapters"] = {W.ADAPTER: (adapter,
                                      JaxLoraConfig(rank=W.LORA_RANK))}
    reqs = {name: [r for r in W.requests_of(name) if r[2] == 0.0]
            for name in names}
    if "multislice_dp2tp2_dense" in names:
        reqs["after_precache"] = [(PRECACHED + [42], 3, 0.0, 0, None)]
    b = JaxBatcher(JM, params, **{"slots": W.SLOTS, **kw}).start()
    try:
        hs = {name: [b.submit(p, max_new_tokens=n, adapter=a)
                     for p, n, _, _, a in rs] for name, rs in reqs.items()}
        return {name: [h.result() for h in h_] for name, h_ in hs.items()}
    finally:
        b.stop()


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the JAX package's results, the inputs):
    the cluster runs in a thread while JAX serves the same requests
    here."""
    lcfg = JaxLoraConfig(rank=W.LORA_RANK, targets=W.LORA_TARGETS)
    jtr = JaxTrainer(JaxLoraModel(JM, JP, lcfg),
                     mesh=mesh_from_devices(jax.devices()[:1],
                                            JaxMeshConfig(dp=1)),
                     train_config=JaxTrainConfig(**W.LORA_TRAIN))
    jtr.init(jax.random.PRNGKey(2))
    adapter = _adapter()
    grad_start = jax.tree.map(np.asarray, JaxAdapter(lcfg).init(
        jax.random.PRNGKey(3), JP))
    rng = np.random.default_rng(6)
    for ab in [*grad_start["blocks"].values(), grad_start["head"]]:
        ab["b"] = rng.normal(0.0, 0.05, ab["b"].shape).astype(np.float32)
    inp = W.make_inputs(0, jax.tree.map(np.asarray, JP), adapter,
                        jax.tree.map(np.asarray, jtr.params), grad_start)
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(
            1 + len(ORACLES)) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=300.0, device="cpu")
        # The JAX batchers side by side: each spends most of its time
        # compiling.
        streams = [pool.submit(_jax_streams, oracle, adapter)
                   for oracle in ORACLES]
        ref = {}
        ref["generate"] = np.asarray(JaxEngine(JM).generate(
            JP, jnp.asarray(inp["gen_prompt"]),
            max_new_tokens=W.GEN_NEW).tokens)
        ref["lora_losses"] = [
            float(jtr.step(jnp.asarray(t[:, :-1]), jnp.asarray(t[:, 1:])))
            for t in inp["lora_tokens"]]
        ref["lora_params"] = jax.tree.map(np.asarray, jtr.params)
        toks = inp["lora_tokens"][0]
        ref["lora_grads"] = jax.tree.map(np.asarray, jax.grad(
            lambda lp: JaxLoraModel(JM, JP, lcfg).loss(
                lp, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])))(
            grad_start))
        ref["kv_heads"] = _refusal(lambda: JaxEngine(
            JaxLM(JaxConfig(**W.DIMS, n_kv_heads=2, use_flash=False,
                            dtype=jnp.float32)), mesh=_jax_mesh("tp4")))
        for f in streams:
            ref.update(f.result())
        return ranks.result(), ref, inp


def _refusal(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _greedy(name, streams):
    return [s for s, r in zip(streams, W.requests_of(name)) if r[2] == 0.0]


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_greedy_streams_match_reference(runs, case):
    """The leader's greedy streams, token for token, against the JAX
    batcher on the same mesh (tp 4 kernel, dp 2 x tp 2) or without one;
    the paged cases admitted the pair's second by its shared blocks."""
    ranks, ref, _ = runs
    name = case[0]
    got = ranks[0][name]
    assert _greedy(name, got["streams"]) == ref[name]
    if "paged" in name or name in ("tp4_ngram", "tp4_kv_quant"):
        assert got["paths"].get("paged_shared", 0) >= 1, got["paths"]
    if name == "tp4_adapters":
        # Adapter rows take the reference's unshared plan.
        assert got["paths"].get("cold", 0) == 2, got["paths"]


@pytest.mark.parametrize("case", W.CASES, ids=lambda c: c[0])
def test_every_rank_computes_the_same_tokens(runs, case):
    """Each device call's outputs (first tokens, log-probs, the rounds'
    tokens) are equal on every rank: the sampled request (temperature
    0.9, seed 7) draws the same stream everywhere, and it is whole."""
    ranks, _, _ = runs
    name = case[0]
    first = ranks[0][name]["record"]
    assert first and ranks[1][name]["streams"] is None
    for r in ranks[1:]:
        mine = r[name]["record"]
        assert [n for n, _ in mine] == [n for n, _ in first]
        for (_, a), (_, b) in zip(mine, first):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    if case[3]:
        sampled = ranks[0][name]["streams"][-1]
        assert len(sampled) == W.SAMPLED[1]
        assert all(0 <= t < W.DIMS["vocab_size"] for t in sampled)


POOL_CASES = [c for c in W.CASES if c[4]]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: c[0])
def test_pool_slices_match_one_rank_pool(runs, case):
    """Each rank's pool holds its rows (dp, dense pool) and KV heads (tp)
    of the port's one-rank pool after the same requests."""
    ranks, _, inp = runs
    name, mesh_name, knobs = case[:3]
    tm = W._model()
    b = ContinuousBatcher(tm, params_from_numpy(inp["params"], "cpu"),
                          device="cpu", **{"slots": W.SLOTS, **knobs})
    hs = [b.submit(p, max_new_tokens=n, temperature=t, seed=s)
          for p, n, t, s, _ in W.requests_of(name)]
    b.start()
    try:
        [h.result() for h in hs]
    finally:
        b.stop()
    whole = {k: v.numpy() for k, v in b._dev["cache"].items()}
    tp = W.MESHES[mesh_name]["tp"]
    dp = W.MESHES[mesh_name]["dp"] if "dense" in name else 1
    for r in ranks:
        c = r["coords"][mesh_name]
        for key, arr in whole.items():
            rows = np.split(arr, dp, axis=1)[c["dp"] if dp > 1 else 0]
            want = np.split(rows, tp, axis=2)[c["tp"]]
            np.testing.assert_allclose(r[name]["pool"][key], want,
                                       atol=TOL)


def test_engine_mesh_generate_matches_unsharded(runs):
    """``InferenceEngine(mesh=).generate`` at tp 4 on every rank against
    the JAX engine without a mesh."""
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["generate"], ref["generate"])


def test_lora_fine_tune_on_tp_matches_reference(runs):
    """Three LoRA steps over dp 2 x tp 2 (B cut on the heads, A of wo
    on its input, the head's B on the vocabulary): losses and gathered
    adapters within 1e-5 of the JAX fine-tune over the whole batch."""
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["lora"]["losses"], ref["lora_losses"],
                                   atol=TOL)
        want = ref["lora_params"]
        for t, ab in want["blocks"].items():
            for h in ("a", "b"):
                np.testing.assert_allclose(r["lora"]["params"]["blocks"][t][h],
                                           ab[h], atol=TOL)
        for h in ("a", "b"):
            np.testing.assert_allclose(r["lora"]["params"]["head"][h],
                                       want["head"][h], atol=TOL)
    # Each rank's B of wq holds half the heads (tp 2).
    assert ranks[0]["lora"]["shapes"]["wq"][-1] == (
        W.DIMS["n_heads"] * W.DIMS["d_head"] // 2)


def test_lora_gradients_on_tp_match_reference(runs):
    """The adapters' gradients over dp 2 x tp 2 (each rank's rows,
    averaged over dp, gathered over tp) against ``jax.grad`` of the
    JAX LoRA loss over the whole batch, from a tree whose B is not zero:
    AdamW's first update hardly sees a gradient's scale, so only this
    catches a half tp leaves whole that missed its sum over tp."""
    ranks, ref, _ = runs
    for r in ranks:
        got, want = r["lora"]["grads"], ref["lora_grads"]
        for t, ab in want["blocks"].items():
            for h in ("a", "b"):
                np.testing.assert_allclose(got["blocks"][t][h], ab[h],
                                           atol=TOL)
        for h in ("a", "b"):
            np.testing.assert_allclose(got["head"][h], want["head"][h],
                                       atol=TOL)


def test_meshed_lm_server(runs):
    """A meshed ``LmServer`` over dp 2 x tp 2: HTTP on rank 0 only, the
    streamed and plain /generate streams and a prompt extending a
    /precache'd prefix against the reference, and a 501 naming the
    ROADMAP item for export, import and /prefill."""
    ranks, ref, _ = runs
    srv = ranks[0]["server"]
    assert all(r["server"]["port"] is None for r in ranks[1:])
    assert srv["streams"] == ref["multislice_dp2tp2_dense"]
    assert srv["precache"] == (200, {"cached_tokens": len(PRECACHED)})
    assert srv["after_precache"] == (200, ref["after_precache"][0])
    assert srv["paths"].get("prefix_suffix") == 1, srv["paths"]
    for path, (code, err) in srv["refused"].items():
        assert code == 501 and "item 11, step 4b" in err, (path, err)


REFUSALS = {
    "kv_heads": ("ValueError", None),
    "slots": ("ValueError", "slots=3 must divide over 'dp'=2"),
    "moe": ("NotImplementedError", "an MoE model: not ported yet"),
    "draft": ("NotImplementedError", "draft=(model, params)"),
    "int8": ("NotImplementedError", "int8 weights"),
    "export": ("NotImplementedError", "block migration"),
    "precomputed": ("NotImplementedError", "disaggregated prefill"),
    "sp": ("NotImplementedError", "sp>1: the reference serves on dp and tp"),
    "ep": ("NotImplementedError", "ep>1: the reference serves on dp and tp"),
    "pp": ("NotImplementedError", "pp>1: the reference serves on dp and tp"),
}


@pytest.mark.parametrize("what", REFUSALS)
def test_serving_mesh_refusals(runs, what):
    """What a serving mesh refuses, on every rank: the reference's
    message where it has one (``n_kv_heads`` over tp), else the ROADMAP
    item."""
    ranks, ref, _ = runs
    kind, text = REFUSALS[what]
    for r in ranks:
        got = r["refusals"][what]
        assert got is not None and got[0] == kind, got
        if what == "kv_heads":
            assert got == ref["kv_heads"]
        else:
            assert text in got[1], got
        if kind == "NotImplementedError":
            assert "ROADMAP.md queue 1 item 11, step 4" in got[1], got


@pytest.mark.parametrize("configs", [
    (MeshConfig(dp=-1, tp=2),),
    (MeshConfig(dp=1, tp=4), MeshConfig(dp=1, tp=2)),
], ids=["size_left_open", "two_worlds"])
def test_serve_ranks_refuses_meshes_it_cannot_size(configs):
    """``serve_ranks`` starts as many ranks as the meshes span: every
    axis given, and one world for all of them; it refuses before any
    process starts."""
    with pytest.raises(ValueError):
        serve_ranks(print, *configs, device="cpu")
