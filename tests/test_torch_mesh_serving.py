"""The port's serving on a mesh across processes, against the JAX package.

One cluster of four gloo ranks on the CPU (``spawn_local_cluster``) runs
every case of ``torch_serve_worker.run_all`` once for the module, on
the reference tests' tiny float32 model; the JAX package serves the
same requests meanwhile, from the same numpy weights.  The port's
meshed greedy streams are held token for token to the JAX batcher on
the same mesh (tp 4 through the paged kernel, dp 2 x tp 2 on both
pools) and to the JAX batcher without a mesh (tp 4 through the gather
read, the multislice dp 2 x tp 2 mesh, n-gram and neural speculation,
int8 KV, an adapter bank, the in-process prefill pool's handovers, MoE
and int8 weights), which the reference's own tests hold equal to its
meshed streams; the neural cases' drafted and accepted counts are a JAX
batcher's with the same draft.  Every rank's tokens are equal, a
sampled request's too; each rank's pool slice is the matching part of a
one-rank pool; a meshed export carries whole heads, matches a one-rank
export, and its import serves the reference's stream; the engine's
``generate`` (plain, MoE, int8 weights, ``int8_compute``), a meshed
``LmServer`` and a LoRA fine-tune over dp 2 x tp 2 agree with the
reference; and what a serving mesh refuses is what the reference
refuses.
"""

import base64
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
from k8s_gpu_tpu.serve.quant import quantize_params as jax_quantize
from k8s_gpu_tpu.serve.speculative import int8_draft as jax_int8_draft
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train.lora import LoraAdapter as JaxAdapter
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig
from k8s_gpu_tpu_torch.parallel.multihost import (
    serve_ranks, spawn_local_cluster,
)
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, LmServer
from k8s_gpu_tpu_torch.serve.migrate import pack, payload_bytes

torch.set_num_threads(1)

TOL = 1e-5
WORKERS = 4
JM = JaxLM(JaxConfig(**W.DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
JMOE = JaxLM(JaxConfig(**W.DIMS, **W.MOE, use_flash=False,
                       dtype=jnp.float32))
JPMOE = JMOE.init(jax.random.PRNGKey(4))
JD = JaxLM(JaxConfig(**W.DRAFT_DIMS, use_flash=False, dtype=jnp.float32))
# The target's embedding, head and first layer.
JPD = dict(JP, blocks={k: v[:1] for k, v in JP["blocks"].items()})
PRECACHED = [ord(c) for c in "(%)+"]
# The JAX batchers the cases are held to: (mesh or None, knobs, the
# cases whose greedy requests each serves, the model: None the base one,
# "neural" with the draft, "moe", "int8" the base weights quantized).
# The unsharded paged one carries the adapter bank (its base rows are
# the bank-less stream, the reference's own rule) and stands for the
# unsharded dense pool too (the reference's tests hold both pools to one
# greedy oracle); it also serves the prompts that extend the meshed
# server's /precache'd prefix and the imported blocks.  The speculative
# and handover cases' greedy streams are its plain ones (SAME_STREAMS);
# the neural batcher gives their drafted and accepted counts.
ORACLES = (
    ("tp4", dict(W.PAGED, attn_impl="paged_kernel"), ("tp4_paged_kernel",),
     None),
    ("dp2tp2", {}, ("dp2tp2_dense",), None),
    ("dp2tp2", dict(W.PAGED, slots=3), ("dp2tp2_paged",), None),
    (None, dict(W.PAGED), ("tp4_paged_gather", "tp4_ngram", "tp4_adapters",
                           "multislice_dp2tp2_dense"), None),
    (None, dict(W.PAGED, kv_quant=True), ("tp4_kv_quant",), None),
    (None, dict(spec_k=W.SPEC_K), ("neural",), "neural"),
    (None, {}, ("moe",), "moe"),
    (None, dict(W.PAGED), ("tp4_int8_weights",), "int8"),
)
SAME_STREAMS = {"tp4_neural": "tp4_paged_gather",
                "dp2tp2_neural_dense": "tp4_paged_gather",
                "tp4_disagg": "tp4_paged_gather",
                "tp4_moe_paged": "moe", "dp2tp2_moe_dense": "moe"}


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
    mesh_name, knobs, names, kind = oracle
    model, params, kw = JM, JP, dict(knobs)
    if kind == "neural":
        kw["draft"] = (JD, JPD)
    elif kind == "moe":
        model, params = JMOE, JPMOE
    elif kind == "int8":
        params = jax_quantize(JP)
    if mesh_name is not None:
        kw["mesh"] = _jax_mesh(mesh_name)
        params = jax_shard(JP, JM.logical_axes(), kw["mesh"])
    if "tp4_adapters" in names:
        kw["adapters"] = {W.ADAPTER: (adapter,
                                      JaxLoraConfig(rank=W.LORA_RANK))}
    reqs = {name: [r for r in W.requests_of(
                name if name in dict((c[0], c) for c in W.CASES)
                else "tp4_paged_gather") if r[2] == 0.0]
            for name in names}
    if "multislice_dp2tp2_dense" in names:
        reqs["after_precache"] = [(PRECACHED + [42], 3, 0.0, 0, None)]
        reqs["after_import"] = [(*W.AFTER_IMPORT, 0.0, 0, None)]
    b = JaxBatcher(model, params, **{"slots": W.SLOTS, **kw})
    # Queued before start(), as the port's cases are.
    hs = {name: [b.submit(p, max_new_tokens=n, adapter=a)
                 for p, n, _, _, a in rs] for name, rs in reqs.items()}
    b.start()
    try:
        out = {name: [h.result() for h in h_] for name, h_ in hs.items()}
        if kind == "neural":
            st = b.spec_stats
            out["neural_counts"] = (st["drafted"], st["accepted"])
        return out
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
                        jax.tree.map(np.asarray, jtr.params), grad_start,
                        jax.tree.map(np.asarray, JPD),
                        jax.tree.map(np.asarray, JPMOE))
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(
            2 + len(ORACLES)) as pool:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [tests_dir, os.environ.get("PYTHONPATH", "")]))
        ranks = pool.submit(spawn_local_cluster,
                            functools.partial(W.run_all, inp), WORKERS,
                            timeout=300.0, device="cpu")
        # The JAX batchers side by side: each spends most of its time
        # compiling.
        streams = [pool.submit(_jax_streams, oracle, adapter)
                   for oracle in ORACLES]
        kinds = pool.submit(_jax_generate, inp["gen_prompt"])
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
        ref["generate_kinds"] = kinds.result()
        for f in streams:
            ref.update(f.result())
        for name, like in SAME_STREAMS.items():
            ref[name] = ref[like]
        return ranks.result(), ref, inp


def _jax_generate(prompt) -> dict:
    """The JAX engine's (tokens, prompt logits) without a mesh for each
    meshed ``generate`` but the plain one."""
    out = {}
    for name, (model, params, kw) in {
            "moe": (JMOE, JPMOE, {}),
            "int8": (JM, jax_quantize(JP), {}),
            "int8_compute": (JM, jax_int8_draft(JP),
                             {"int8_compute": True})}.items():
        got = JaxEngine(model, **kw).generate(
            params, jnp.asarray(prompt), max_new_tokens=W.GEN_NEW)
        out[name] = (np.asarray(got.tokens), np.asarray(got.prompt_logits))
    return out


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
    if ("paged" in name and "moe" not in name) or name in (
            "tp4_ngram", "tp4_kv_quant", "tp4_int8_weights"):
        assert got["paths"].get("paged_shared", 0) >= 1, got["paths"]
    if name == "tp4_adapters":
        # Adapter rows take the reference's unshared plan.
        assert got["paths"].get("cold", 0) == 2, got["paths"]
    n = len(W.REQUESTS)
    if "moe" in name or "neural" in name:
        # MoE shares no blocks; the neural cases prefill every draft row.
        assert got["paths"] == {"cold": n}, got["paths"]
    if "neural" in name:
        assert got["spec"] == ref["neural_counts"] and got["spec"][1] > 0
    if name == "tp4_disagg":
        # The pool's four handovers and a whole row, cut on each rank.
        assert got["paths"] == {"precomputed": n + 1}, got["paths"]
        assert got["streams"][n] == ref[name][0]


def test_refused_handover_leaves_no_held_row(runs):
    """A pool handover that the full pending queue refuses after every
    rank prefilled its heads: the submitter gets ``Overloaded`` and no
    rank keeps the row (or any other) once the case is served."""
    ranks, _, _ = runs
    assert ranks[0]["tp4_disagg"]["refused"] == "Overloaded"
    assert [r["tp4_disagg"]["held"] for r in ranks] == [0] * len(ranks)


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
        np.testing.assert_array_equal(r["generate"]["plain"][0],
                                      ref["generate"])


# int8_compute's limit: the port's unmeshed int8 engine test's.
GENERATE_TOL = {"moe": TOL, "int8": TOL, "int8_compute": 1e-4}


@pytest.mark.parametrize("kind", GENERATE_TOL)
def test_engine_mesh_generate_moe_and_int8(runs, kind):
    """The engine at tp 4 on every rank (one head a rank) with the MoE
    model, int8 weights (the whole tree quantized, then cut) and int8
    products (the row-parallel ones' scale and int32 sums taken over
    tp): tokens equal and the gathered prompt logits within the limit of
    the JAX engine's without a mesh."""
    ranks, ref, _ = runs
    toks, logits = ref["generate_kinds"][kind]
    for r in ranks:
        got_t, got_l = r["generate"][kind]
        np.testing.assert_array_equal(got_t, toks)
        np.testing.assert_allclose(got_l, logits, atol=GENERATE_TOL[kind])


def _slices_payload(ranks, name):
    """The payload a one-rank pool holding the ranks' values sends: each
    registered block's heads joined in tp order."""
    export = ranks[0][name]["export"]
    order = sorted(ranks, key=lambda r: r["coords"]["tp4"]["tp"])
    pool = ranks[0][name]["pool"]
    blocks = [(bytes.fromhex(h), {
        leaf: np.concatenate([r[name]["pool"][leaf][:, blk] for r in order],
                             axis=1)
        for leaf in pool}) for h, blk in export["blocks"].items()]
    geometry = {leaf: {"dtype": "float32",
                       "shape": (a.shape[0], a.shape[2] * len(order),
                                 *a.shape[3:])}
                for leaf, a in pool.items()}
    return payload_bytes(pack({"page_size": W.PAGE, "geometry": geometry,
                               "blocks": blocks}))


def test_meshed_export_carries_whole_heads(runs):
    """tp 4's export of its registered blocks is byte for byte the
    payload of a one-rank pool holding the ranks' values (each block's
    heads gathered in rank order), and it names the blocks a one-rank
    batcher's export of the same requests names, their values within
    1e-5."""
    import json

    ranks, _, inp = runs
    name = "tp4_paged_kernel"
    got = ranks[0][name]["export"]["payload"]
    assert got == _slices_payload(ranks, name)
    b = ContinuousBatcher(W._model(), params_from_numpy(inp["params"], "cpu"),
                          device="cpu", **{"slots": W.SLOTS, **W.KERNEL})
    hs = [b.submit(p, max_new_tokens=n) for p, n in W.REQUESTS]
    b.start()
    try:
        [h.result() for h in hs]
        one = pack(b.run_quiesced(b.migrate_export))
    finally:
        b.stop()
    meshed = json.loads(got)
    assert meshed["geometry"] == one["geometry"]
    assert [x["hash"] for x in meshed["blocks"]] == [
        x["hash"] for x in one["blocks"]]
    assert meshed["blocks"]
    for m, o in zip(meshed["blocks"], one["blocks"]):
        for leaf in o["data"]:
            np.testing.assert_allclose(
                np.frombuffer(base64.b64decode(m["data"][leaf]), np.float32),
                np.frombuffer(base64.b64decode(o["data"][leaf]), np.float32),
                atol=TOL)


def test_meshed_import_serves_the_reference_stream(runs):
    """The export imported into a new tp 4 batcher (every rank writing
    its heads): a prompt over the two imported pages shares them and
    streams what the JAX batcher streams."""
    import json

    ranks, ref, _ = runs
    got = ranks[0]["tp4_paged_kernel"]["import"]
    n_blocks = len(json.loads(ranks[0]["tp4_paged_kernel"]["export"][
        "payload"])["blocks"])
    assert got["imported"] == n_blocks > 0
    assert got["paths"] == {"paged_shared": 1}, got["paths"]
    assert got["stream"] == ref["after_import"][0]


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
    /precache'd prefix against the reference, and export, import and
    /prefill answering as a one-rank server on the same pool does."""
    ranks, ref, inp = runs
    srv = ranks[0]["server"]
    assert all(r["server"]["port"] is None for r in ranks[1:])
    assert srv["streams"] == ref["multislice_dp2tp2_dense"]
    assert srv["precache"] == (200, {"cached_tokens": len(PRECACHED)})
    assert srv["after_precache"] == (200, ref["after_precache"][0])
    assert srv["paths"].get("prefix_suffix") == 1, srv["paths"]
    one = LmServer(W._model(), params_from_numpy(inp["params"], "cpu"),
                   BpeTokenizer([]), slots=W.SLOTS, device="cpu").start()
    try:
        want = W._routes(one.port)
    finally:
        one.stop()
    assert srv["routes"] == want
    assert all(code == 400 for code, _ in want.values()), want


REFUSALS = {
    "kv_heads": ("ValueError", None),
    "draft_kv_heads": ("ValueError", None),
    "slots": ("ValueError", "slots=3 must divide over 'dp'=2"),
    "sp": ("NotImplementedError", "sp>1: the reference serves on dp and tp"),
    "ep": ("NotImplementedError", "ep>1: the reference serves on dp and tp"),
    "pp": ("NotImplementedError", "pp>1: the reference serves on dp and tp"),
}


@pytest.mark.parametrize("what", REFUSALS)
def test_serving_mesh_refusals(runs, what):
    """What a serving mesh refuses, on every rank: what the reference
    refuses, with its message where it has one (``n_kv_heads`` over tp,
    the target's or the draft's: the reference builds the draft's engine
    on the mesh too)."""
    ranks, ref, _ = runs
    kind, text = REFUSALS[what]
    for r in ranks:
        got = r["refusals"][what]
        assert got is not None and got[0] == kind, got
        if what in ("kv_heads", "draft_kv_heads"):
            assert got == ref["kv_heads"]
        else:
            assert text in got[1], got
        if kind == "NotImplementedError":
            assert "the reference serves on dp and tp" in got[1], got


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
