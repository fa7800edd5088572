"""The rank side of ``tests/test_torch_mesh_serving.py``: what each gloo
rank of the spawned CPU cluster runs.  It imports torch, numpy and the
port only (the workers load no JAX); the test module holds the results
against the JAX package.

Each batcher case builds the port's ``ContinuousBatcher(mesh=...)`` on
this rank's shards of the same weights; rank 0 queues the case's
requests before ``start()`` (so no admission of them is solo), collects
their streams and stops, which ends the other ranks' loops.  Every rank
records what each device call returned (``Seam.record``), so the test
holds every rank's tokens equal.  ``run_all`` returns, per case and
rank, the streams, the records, the admission paths and, for the pool
cases, this rank's slice of the pool; then the engine's ``generate``,
a 3-step LoRA fine-tune over dp 2 x tp 2, a meshed ``LmServer`` over
HTTP, and the refusals' messages.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np

DIMS = dict(vocab_size=128, d_model=48, n_layers=2, n_heads=4, d_head=12,
            d_ff=96, max_seq=64)
PAGE, BLOCKS, SLOTS = 8, 16, 2
MESHES = {"tp4": dict(dp=1, tp=4), "dp2tp2": dict(dp=2, tp=2)}
SLICES = 2
_PREFIX = list(range(40, 56))
# (prompt, max_new): a pair sharing two pages, queued after two others
# so the second of the pair is planned once the first registered them.
REQUESTS = [
    ([5, 9, 17, 23], 6),
    ([2, 4, 8, 16, 32], 6),
    (_PREFIX + [7, 11], 5),
    (_PREFIX + [13], 5),
]
# One sampled request: every rank must draw the same stream.
SAMPLED = ([4, 5], 6, 0.9, 7)
PAGED = dict(paged_blocks=BLOCKS, page_size=PAGE)
# (name, mesh, batcher knobs, sampled request too, pool kept)
CASES = (
    ("tp4_paged_gather", "tp4", dict(PAGED, attn_impl="gather"), True,
     False),
    ("tp4_paged_kernel", "tp4", dict(PAGED, attn_impl="paged_kernel"),
     False, True),
    ("dp2tp2_dense", "dp2tp2", {}, True, True),
    # The paged pool is whole on every dp group: 3 slots over dp 2.
    ("dp2tp2_paged", "dp2tp2", dict(PAGED, attn_impl="paged_kernel",
                                    slots=3), False, True),
    ("multislice_dp2tp2_dense", "multislice", {}, False, False),
    ("tp4_ngram", "tp4", dict(PAGED, attn_impl="paged_kernel",
                              draft="ngram", spec_k=3), False, False),
    ("tp4_kv_quant", "tp4", dict(PAGED, attn_impl="paged_kernel",
                                 kv_quant=True), False, False),
    ("tp4_adapters", "tp4", dict(PAGED, attn_impl="paged_kernel"), False,
     False),
)
ADAPTER = "ft"
LORA_TARGETS = ("wq", "wk", "wv", "wo", "wi_gate", "wo_mlp", "head")
LORA_RANK = 4
LORA_TRAIN = dict(warmup_steps=1, learning_rate=5e-3)
LORA_BATCH, LORA_SEQ, LORA_STEPS = 4, 16, 3
GEN_PROMPT_SHAPE, GEN_NEW = (2, 7), 5


def make_inputs(seed: int, params: dict, adapter: dict,
                lora_start: dict, lora_grad_start: dict) -> dict:
    """Every input of the run from ``seed``; the trees come from the JAX
    package's inits as numpy: the base ``params``, the served
    ``adapter`` (B drawn non-zero), the fine-tune's ``lora_start`` and
    the tree the gradients are taken at (B drawn non-zero, so every
    half has a gradient)."""
    rng = np.random.default_rng(seed)
    v = DIMS["vocab_size"]
    return dict(
        params=params, adapter=adapter, lora_start=lora_start,
        lora_grad_start=lora_grad_start,
        gen_prompt=rng.integers(0, v, GEN_PROMPT_SHAPE).astype(np.int32),
        lora_tokens=rng.integers(0, v, (LORA_STEPS, LORA_BATCH,
                                        LORA_SEQ + 1)).astype(np.int32))


def requests_of(name: str) -> list:
    """(prompt, max_new, temperature, seed, adapter) of a case, in
    submission order."""
    out = [(p, n, 0.0, 0, None) for p, n in REQUESTS]
    if name == "tp4_adapters":
        out = [(p, n, 0.0, 0, ADAPTER if i % 2 else None)
               for i, (p, n) in enumerate(REQUESTS)]
    if dict((c[0], c[3]) for c in CASES)[name]:
        p, n, t, s = SAMPLED
        out.append((p, n, t, s, None))
    return out


def _numpy(x):
    import torch

    if isinstance(x, (list, tuple)):
        return [_numpy(v) for v in x]
    return x.numpy().copy() if torch.is_tensor(x) else x


def _model(**knobs):
    import torch

    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(**DIMS, **knobs,
                                           dtype=torch.float32),
                         device="cpu")


def _serve(model, params, mesh, name, knobs, adapters=None) -> dict:
    """One batcher case on this rank (module docstring)."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher

    shards = shard_params(params, model.logical_axes(), mesh)
    b = ContinuousBatcher(model, shards, mesh=mesh, adapters=adapters,
                          eos_id=-1, device="cpu", **{"slots": SLOTS,
                                                      **knobs})
    b._seam.record = []
    if knobs.get("draft") == "ngram":
        # Always speculate: the gate reads the leader's clock.
        b.ngram_breakeven = 0.0
        b._ngram_next_meas = {"plain": float("inf"), "spec": float("inf")}
    streams = None
    if b.is_leader:
        handles = [b.submit(p, max_new_tokens=n, temperature=t, seed=s,
                            adapter=a)
                   for p, n, t, s, a in requests_of(name)]
        b.start()
        streams = [h.result() for h in handles]
        b.stop()
    else:
        b.start().wait()
    dist.barrier()
    return {"streams": streams, "record": [_numpy(r)
                                           for r in b._seam.record],
            "paths": dict(b.admission_paths),
            "pool": {k: v.numpy().copy() for k, v in
                     b._dev["cache"].items()}}


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _server(model, params, mesh) -> dict:
    """A meshed ``LmServer`` on the dense pool over dp 2 x tp 2: HTTP on
    rank 0 only; /precache, then the requests (the first streamed), then
    the three routes a mesh refuses."""
    from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve import LmServer

    shards = shard_params(params, model.logical_axes(), mesh)
    srv = LmServer(model, shards, BpeTokenizer([]), slots=SLOTS, mesh=mesh,
                   device="cpu").start()
    if srv.port is None:
        srv.wait()
        return {"port": None}
    out = {"port": srv.port, "streams": [], "refused": {}}
    try:
        code, body = _post(srv.port, "/precache", {"prompt": "(%)+"})
        out["precache"] = (code, json.loads(body))
        for i, (p, n) in enumerate(REQUESTS):
            code, body = _post(srv.port, "/generate",
                               {"prompt_ids": p, "max_new_tokens": n,
                                "stream": i == 0})
            lines = [json.loads(x) for x in body.splitlines() if x]
            out["streams"].append(
                [ev["id"] for ev in lines if "id" in ev] if i == 0
                else lines[0]["ids"])
        code, body = _post(srv.port, "/generate",
                           {"prompt": "(%)+*", "max_new_tokens": 3})
        out["after_precache"] = (code, json.loads(body)["ids"])
        for path in ("/admin/export", "/admin/import", "/prefill"):
            code, body = _post(srv.port, path, {"prompt_ids": [1, 2]})
            out["refused"][path] = (code, json.loads(body)["error"])
        out["paths"] = dict(srv.batcher.admission_paths)
    finally:
        srv.stop()
    return out


def _generate(model, params, mesh, prompt) -> np.ndarray:
    import torch

    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine(model, mesh=mesh, device="cpu")
    out = eng.generate(shard_params(params, model.logical_axes(), mesh),
                       torch.from_numpy(prompt), max_new_tokens=GEN_NEW)
    return out.tokens.numpy()


def _lora(model, params, mesh, inp) -> dict:
    """A 3-step LoRA fine-tune of the whole batch on dp 2 x tp 2."""
    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.train import (
        LoraConfig, LoraModel, TrainConfig, Trainer,
    )

    lm = LoraModel(model, params, LoraConfig(rank=LORA_RANK,
                                             targets=LORA_TARGETS))
    tr = Trainer(lm, TrainConfig(**LORA_TRAIN), device="cpu", mesh=mesh)
    tr.init(params=inp["lora_start"])
    losses = [tr.step(t[:, :-1], t[:, 1:]) for t in inp["lora_tokens"]]
    return {"losses": losses,
            "params": params_to_numpy(tr.gathered_params()),
            "shapes": {k: tuple(v["b"].shape)
                       for k, v in tr.params["blocks"].items()},
            "grads": _lora_grads(lm, mesh, inp)}


def _lora_grads(lm, mesh, inp) -> dict:
    """The adapters' gradients of the loss over the first batch at
    ``lora_grad_start``: this rank's rows, averaged over dp, gathered
    over tp (a half tp leaves whole sums its ranks' parts through
    ``copy_to``)."""
    import torch

    from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
    from k8s_gpu_tpu_torch.parallel.collectives import all_reduce
    from k8s_gpu_tpu_torch.parallel.mesh import (
        axis_group, axis_rank, axis_size,
    )
    from k8s_gpu_tpu_torch.parallel.sharding import (
        gather_params, shard_params,
    )
    from k8s_gpu_tpu_torch.train.runner import tree_map

    axes, dp = lm.logical_axes(), axis_size(mesh, "dp")
    tree = tree_map(lambda t: t.clone().requires_grad_(True), shard_params(
        params_from_numpy(inp["lora_grad_start"], "cpu"), axes, mesh))
    rows = torch.from_numpy(inp["lora_tokens"][0]).chunk(dp)[
        axis_rank(mesh, "dp")]
    lm.loss(tree, rows[:, :-1], rows[:, 1:], mesh=mesh).backward()
    grads = tree_map(lambda t: all_reduce(t.grad.clone(),
                                          axis_group(mesh, "dp")) / dp, tree)
    return params_to_numpy(gather_params(grads, axes, mesh))


def _refusals(meshes, params) -> dict:
    """Each refusal's (exception type, message), or None when nothing
    was raised."""
    import torch

    from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher, InferenceEngine

    def caught(fn):
        try:
            fn()
        except Exception as e:
            return type(e).__name__, str(e)
        return None

    tp4, dp2tp2 = meshes["tp4"], meshes["dp2tp2"]
    model = _model()
    shards = shard_params(params, model.logical_axes(), tp4)
    out = {
        "kv_heads": caught(lambda: InferenceEngine(
            _model(n_kv_heads=2), mesh=tp4, device="cpu")),
        "slots": caught(lambda: ContinuousBatcher(
            model, params, slots=3, mesh=dp2tp2, device="cpu")),
        "moe": caught(lambda: ContinuousBatcher(
            _model(num_experts=4), params, mesh=tp4, device="cpu")),
        "draft": caught(lambda: ContinuousBatcher(
            model, shards, mesh=tp4, draft=(model, shards), device="cpu")),
        "int8": caught(lambda: ContinuousBatcher(
            model, dict(shards, head={"q": shards["head"],
                                      "s": shards["head"]}),
            mesh=tp4, device="cpu")),
    }
    b = ContinuousBatcher(model, shards, slots=SLOTS, mesh=tp4,
                          **PAGED, device="cpu")
    out["export"] = caught(lambda: b.migrate_export())
    out["precomputed"] = caught(lambda: b.submit_precomputed(
        {}, torch.zeros(1, DIMS["vocab_size"]), 4, 0))
    for axis in ("sp", "ep", "pp"):
        mesh = build_mesh(MeshConfig(dp=1, tp=2, **{axis: 2}),
                          device_type="cpu")
        out[axis] = caught(lambda: InferenceEngine(model, mesh=mesh,
                                                   device="cpu"))
    return out


def run_all(inp: dict) -> dict:
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_from_numpy
    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, axis_rank, build_mesh, multislice_mesh,
    )
    from k8s_gpu_tpu_torch.train import LoraConfig

    torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    meshes["multislice"] = multislice_mesh(MeshConfig(dp=2, tp=2), SLICES,
                                           device_type="cpu")
    model = _model()
    params = params_from_numpy(inp["params"], "cpu")
    adapters = {ADAPTER: (inp["adapter"], LoraConfig(rank=LORA_RANK))}
    out = {"rank": dist.get_rank(),
           "coords": {name: {a: axis_rank(m, a) for a in ("dp", "tp")}
                      for name, m in meshes.items()}}
    for name, mesh_name, knobs, _, _ in CASES:
        out[name] = _serve(model, params, meshes[mesh_name], name, knobs,
                           adapters if name == "tp4_adapters" else None)
    out["server"] = _server(model, params, meshes["dp2tp2"])
    dist.barrier()
    out["generate"] = _generate(model, params, meshes["tp4"],
                                inp["gen_prompt"])
    out["lora"] = _lora(model, params, meshes["dp2tp2"], inp)
    out["refusals"] = _refusals(meshes, params)
    return out
