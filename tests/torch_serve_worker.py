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
rank, the streams, the records, the admission paths, the speculative
counts and, for the pool cases, this rank's slice of the pool; then the
engine's ``generate`` (plain, MoE, int8 weights, ``int8_compute``), a
3-step LoRA fine-tune over dp 2 x tp 2, a meshed ``LmServer`` over
HTTP, and the refusals' messages.  The neural cases serve with a tiny
draft, the MoE cases the MoE model, ``tp4_int8_weights`` the whole tree
quantized and then cut, and ``tp4_disagg`` takes its requests through a
meshed ``DisaggregatedLm`` and the first again as a whole row prefilled
off the mesh, then one more handover that the full pending queue
refuses (no rank may keep its row); ``tp4_paged_kernel`` also exports
its blocks and imports them into a new meshed batcher, which serves a
prompt over the imported prefix.
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
KERNEL = dict(PAGED, attn_impl="paged_kernel")
# The neural draft: the target's first layer, embedding and head (so it
# agrees with the target often enough to accept), KV heads over tp 4.
DRAFT_DIMS = dict(DIMS, n_layers=1)
MOE = dict(num_experts=4, capacity_factor=1.25)
SPEC_K = 3
# A prompt over the two pages of _PREFIX that the import brings back.
AFTER_IMPORT = (_PREFIX + [19, 3], 5)
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
    # Unshared, so every admission prefills the draft as the dense
    # pool's cold ones do, and both neural cases draft alike.
    ("tp4_neural", "tp4", dict(KERNEL, prefix_cache=False, spec_k=SPEC_K),
     False, False),
    ("dp2tp2_neural_dense", "dp2tp2", dict(spec_k=SPEC_K), False, False),
    ("tp4_moe_paged", "tp4", KERNEL, False, False),
    ("dp2tp2_moe_dense", "dp2tp2", {}, False, False),
    ("tp4_int8_weights", "tp4", KERNEL, False, False),
    ("tp4_disagg", "tp4", KERNEL, False, False),
)
ADAPTER = "ft"
LORA_TARGETS = ("wq", "wk", "wv", "wo", "wi_gate", "wo_mlp", "head")
LORA_RANK = 4
LORA_TRAIN = dict(warmup_steps=1, learning_rate=5e-3)
LORA_BATCH, LORA_SEQ, LORA_STEPS = 4, 16, 3
GEN_PROMPT_SHAPE, GEN_NEW = (2, 7), 5


def make_inputs(seed: int, params: dict, adapter: dict,
                lora_start: dict, lora_grad_start: dict, draft: dict,
                moe: dict) -> dict:
    """Every input of the run from ``seed``; the trees come from the JAX
    package's inits as numpy: the base ``params``, the served
    ``adapter`` (B drawn non-zero), the fine-tune's ``lora_start``, the
    tree the gradients are taken at (B drawn non-zero, so every half has
    a gradient), the neural ``draft`` and the ``moe`` model's."""
    rng = np.random.default_rng(seed)
    v = DIMS["vocab_size"]
    return dict(
        params=params, adapter=adapter, lora_start=lora_start,
        lora_grad_start=lora_grad_start, draft=draft, moe=moe,
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


def _model(dims=DIMS, **knobs):
    import torch

    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(**dims, **knobs,
                                           dtype=torch.float32),
                         device="cpu")


def _shards(model, params, mesh, int8: bool = False):
    """This rank's shards of ``params`` (``int8``: of the whole tree
    quantized)."""
    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve.quant import (
        quantize_params, shard_quantized,
    )

    if int8:
        return shard_quantized(quantize_params(params), model.logical_axes(),
                               mesh)
    return shard_params(params, model.logical_axes(), mesh)


def _case_model(name, inp):
    """(model, whole params, knobs) a case serves beyond its own."""
    from k8s_gpu_tpu_torch.convert import params_from_numpy

    if "moe" in name:
        return _model(**MOE), params_from_numpy(inp["moe"], "cpu"), {}
    model, params = _model(), params_from_numpy(inp["params"], "cpu")
    if "neural" in name:
        dm = _model(DRAFT_DIMS)
        return model, params, {"draft": (dm, params_from_numpy(
            inp["draft"], "cpu"))}
    return model, params, {}


def _serve(mesh, name, knobs, inp, adapters=None) -> dict:
    """One batcher case on this rank (module docstring)."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.serve import ContinuousBatcher, DisaggregatedLm

    model, params, extra = _case_model(name, inp)
    if "draft" in extra:
        dm, dp = extra["draft"]
        extra["draft"] = (dm, _shards(dm, dp, mesh))
    shards = _shards(model, params, mesh, int8="int8" in name)
    if "disagg" in name:
        # The pool's handovers and the whole row fill the pending queue:
        # one more handover is refused after every rank prefilled it.
        extra["max_pending"] = len(requests_of(name)) + 1
    b = ContinuousBatcher(model, shards, mesh=mesh, adapters=adapters,
                          eos_id=-1, device="cpu", **{"slots": SLOTS,
                                                      **knobs, **extra})
    # Every handover is held before start(): one row a request.
    pool = (DisaggregatedLm(model, shards, batcher=b,
                            inflight_cap=len(requests_of(name)) + 1).start()
            if "disagg" in name else None)
    b._seam.record = []
    if knobs.get("draft") == "ngram":
        # Always speculate: the gate reads the leader's clock.
        b.ngram_breakeven = 0.0
        b._ngram_next_meas = {"plain": float("inf"), "spec": float("inf")}
    streams = spec = export = refused = None
    if b.is_leader:
        if pool is not None:
            # Each handover is queued before start(), as the others, and
            # the first request again as a whole row.
            handles = [pool.submit(p, max_new_tokens=n)
                       for p, n, _, _, _ in requests_of(name)]
            handles.append(_whole_row(b, model, params, *REQUESTS[0]))
            refused = _refused_handover(pool, *REQUESTS[1])
        else:
            handles = [b.submit(p, max_new_tokens=n, temperature=t, seed=s,
                                adapter=a)
                       for p, n, t, s, a in requests_of(name)]
        b.start()
        streams = [h.result() for h in handles]
        st = b.spec_stats
        spec = (st["drafted"], st["accepted"])
        if name == "tp4_paged_kernel":
            export = _export(b)
        if pool is not None:
            pool.stop()
        b.stop()
    else:
        b.start().wait()
    dist.barrier()
    out = {"streams": streams, "spec": spec, "refused": refused,
           "held": len(b._seam.held),
           "record": [_numpy(r) for r in b._seam.record],
           "paths": dict(b.admission_paths),
           "pool": {k: v.numpy().copy() for k, v in
                    b._dev["cache"].items()}}
    if name == "tp4_paged_kernel":
        out["export"] = export
        out["import"] = _import(model, shards, mesh, knobs, export)
    return out


def _whole_row(b, model, params, prompt, new):
    """``prompt`` handed over as a whole row (every KV head), prefilled
    off the mesh by a one-rank engine in the paged side's form (one
    right-padded extend over the bucket): each rank splices its heads."""
    import torch

    from k8s_gpu_tpu_torch.serve import InferenceEngine
    from k8s_gpu_tpu_torch.serve.scheduler import _suffix_bucket

    eng = InferenceEngine(model, max_seq=b.engine.max_seq, device="cpu")
    n = len(prompt)
    ids = torch.zeros((1, min(_suffix_bucket(n), eng.max_seq)),
                      dtype=torch.int32)
    ids[0, :n] = torch.tensor(prompt)
    zero = torch.zeros(1, dtype=torch.int32)
    row = eng.empty_cache(1)
    _, logits = eng.extend_multi(params, row, ids, zero, zero, zero)
    return b.submit_precomputed(row, logits[:, n - 1], n, 0,
                                max_new_tokens=new)


def _refused_handover(pool, prompt, new) -> str:
    """A handover the full pending queue refuses (``Overloaded``) after
    every rank held its heads of the row: the error's name."""
    try:
        pool.submit(prompt, max_new_tokens=new)
    except Exception as e:
        return type(e).__name__
    return "admitted"


def _export(b) -> dict:
    """The leader's export of every registered block: the payload's
    canonical bytes and each chain hash's block id."""
    from k8s_gpu_tpu_torch.serve.migrate import pack, payload_bytes

    snap = b.run_quiesced(b.migrate_export)
    return {"payload": payload_bytes(pack(snap)),
            "blocks": {h.hex(): blk for h, blk in b._pool.registered()}}


def _import(model, shards, mesh, knobs, export) -> dict:
    """A new meshed batcher on every rank: the leader imports the export
    and serves AFTER_IMPORT over the imported prefix."""
    import json

    import torch.distributed as dist

    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.migrate import unpack

    b = ContinuousBatcher(model, shards, mesh=mesh, eos_id=-1, device="cpu",
                          **{"slots": SLOTS, **knobs})
    out = None
    if b.is_leader:
        b.start()
        parsed = unpack(json.loads(export["payload"]))
        n = b.run_quiesced(lambda: b.migrate_import(parsed))
        p, new = AFTER_IMPORT
        out = {"imported": n,
               "stream": b.submit(p, max_new_tokens=new).result(),
               "paths": dict(b.admission_paths)}
        b.stop()
    else:
        b.start().wait()
    dist.barrier()
    return out


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
    the block routes (``_routes``)."""
    from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
    from k8s_gpu_tpu_torch.parallel.sharding import shard_params
    from k8s_gpu_tpu_torch.serve import LmServer

    shards = shard_params(params, model.logical_axes(), mesh)
    srv = LmServer(model, shards, BpeTokenizer([]), slots=SLOTS, mesh=mesh,
                   device="cpu").start()
    if srv.port is None:
        srv.wait()
        return {"port": None}
    out = {"port": srv.port, "streams": []}
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
        out["routes"] = _routes(srv.port)
        out["paths"] = dict(srv.batcher.admission_paths)
    finally:
        srv.stop()
    return out


ROUTES = ("/admin/export", "/admin/import", "/prefill")


def _routes(port: int) -> dict:
    """What the block routes answer a short prompt: (code, body)."""
    out = {}
    for path in ROUTES:
        code, body = _post(port, path, {"prompt_ids": [1, 2]})
        out[path] = (code, json.loads(body))
    return out


# The engine's generate on tp 4: name -> (model knobs, int8 weights,
# int8_compute).
GENERATE = {"plain": ({}, False, False), "moe": (MOE, False, False),
            "int8": ({}, True, False), "int8_compute": ({}, True, True)}


def _generate(mesh, inp) -> dict:
    """Each ``GENERATE`` engine's (tokens, prompt logits) on every
    rank."""
    import torch

    from k8s_gpu_tpu_torch.serve import InferenceEngine

    out = {}
    for name, (knobs, int8, compute) in GENERATE.items():
        model, params, _ = _case_model("moe" if knobs else name, inp)
        eng = InferenceEngine(model, mesh=mesh, int8_compute=compute,
                              device="cpu")
        got = eng.generate(_shards(model, params, mesh, int8),
                           torch.from_numpy(inp["gen_prompt"]),
                           max_new_tokens=GEN_NEW)
        out[name] = (got.tokens.numpy(), got.prompt_logits.numpy())
    return out


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
        "draft_kv_heads": caught(lambda: ContinuousBatcher(
            model, shards, mesh=tp4, draft=(_model(n_kv_heads=2), shards),
            device="cpu")),
        "slots": caught(lambda: ContinuousBatcher(
            model, params, slots=3, mesh=dp2tp2, device="cpu")),
    }
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
        out[name] = _serve(meshes[mesh_name], name, knobs, inp,
                           adapters if name == "tp4_adapters" else None)
    out["server"] = _server(model, params, meshes["dp2tp2"])
    dist.barrier()
    out["generate"] = _generate(meshes["tp4"], inp)
    out["lora"] = _lora(model, params, meshes["dp2tp2"], inp)
    out["refusals"] = _refusals(meshes, params)
    return out
