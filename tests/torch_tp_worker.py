"""The rank side of ``tests/test_torch_tensor_parallel.py``: what each gloo
rank of the spawned CPU cluster runs.  It imports torch, numpy and the
port only (the workers load no JAX); the test module holds the results
against the JAX package.

Each case is a 3-step float32 ``Trainer`` over the global batch on a
mesh of four ranks with tp or ep above 1; ``run_all`` returns, per case
and rank, the losses, the gathered parameters, the leaves tp and ep
leave whole after each step, and what the case counts (dropped tokens,
fallbacks, plain attention calls).
"""

from __future__ import annotations

import numpy as np

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=16)
GQA = dict(flash_kv_grouped=True, flash_fuse_rope=True)
MOE = dict(num_experts=4)
MESHES = {"dp2tp2": dict(dp=2, tp=2), "sp2tp2": dict(dp=1, sp=2, tp=2),
          "ep2tp2": dict(dp=1, ep=2, tp=2), "dp2ep2": dict(dp=2, ep=2)}
# (name, mesh, model knobs, train knobs); "multislice" is dp 2 x tp 2
# built by multislice_mesh over 2 slices.
CASES = (
    ("dp2tp2", "dp2tp2", GQA, dict(zero1=True, grad_accum_steps=2)),
    ("sp2tp2_ring", "sp2tp2", GQA, {}),
    ("sp2tp2_ulysses", "sp2tp2", dict(GQA, sp_attention="ulysses"), {}),
    ("ep2tp2_moe", "ep2tp2", MOE, {}),
    # Capacity 1.0 binds: the dropped tokens depend on the global order.
    ("dp2ep2_moe_drops", "dp2ep2", dict(MOE, capacity_factor=1.0), {}),
    ("multislice_dp2tp2", "multislice", {}, {}),
)
SLICES = 2
TRAIN = dict(warmup_steps=1, learning_rate=1e-3)
GLOBAL_BATCH, STEPS = 4, 3


def make_inputs(seed: int, params: dict) -> dict:
    """Every input of the run, from ``seed``; ``params[case]`` is the
    case's starting tree (numpy, from the JAX package's init)."""
    rng = np.random.default_rng(seed)
    toks = {name: rng.integers(0, DIMS["vocab_size"],
                               (STEPS, GLOBAL_BATCH, DIMS["max_seq"] + 1)
                               ).astype(np.int32)
            for name, *_ in CASES}
    fwd = rng.integers(0, DIMS["vocab_size"],
                       (GLOBAL_BATCH, DIMS["max_seq"])).astype(np.int32)
    return dict(tokens=toks, forward_tokens=fwd, params=params)


def _whole(tree, cuts) -> list:
    """The leaves no mesh axis cuts (``cuts``: each leaf's, the
    ``Trainer``'s), as numpy, in leaf order."""
    from k8s_gpu_tpu_torch.train.runner import tree_leaves

    return [p.detach().numpy().copy()
            for p, c in zip(tree_leaves(tree), cuts) if not c]


def run_all(inp: dict) -> dict:
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, axis_rank, build_mesh, multislice_mesh,
    )
    from k8s_gpu_tpu_torch.parallel.sharding import (
        gather_params, shard_params,
    )
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.runner import tree_leaves, tree_map
    from k8s_gpu_tpu_torch.utils.metrics import global_metrics

    torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    meshes["multislice"] = multislice_mesh(MeshConfig(dp=2, tp=2), SLICES,
                                           device_type="cpu")
    out = {"rank": dist.get_rank()}
    for name, mesh_name, knobs, train in CASES:
        mesh = meshes[mesh_name]
        model = TransformerLM(TransformerConfig(**DIMS, **knobs,
                                                dtype=torch.float32),
                              device="cpu")
        drops, moe = [], model._moe_mlp

        def counting(x, lp, _moe=moe, _drops=drops, **kw):
            y, aux = _moe(x, lp, **kw)
            _drops.append(int((y == 0).all(-1).sum()))
            return y, aux

        model._moe_mlp = counting
        start = tree_map(torch.from_numpy, inp["params"][name])
        axes = model.logical_axes()
        back = gather_params(shard_params(start, axes, mesh), axes, mesh)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(back), tree_leaves(start)))
        tr = Trainer(model, TrainConfig(**TRAIN, **train), device="cpu",
                     mesh=mesh)
        tr.init(params=inp["params"][name])
        fa.reset_counts()
        kv0 = global_metrics.counter("flash_fallback_total",
                                     reason="ulysses_kv_heads")
        losses, kept_whole = [], []
        for t in inp["tokens"][name]:
            losses.append(tr.step(t[:, :-1], t[:, 1:]))
            kept_whole.append(_whole(tr.params, tr.leaf_cuts))
        run = {"losses": losses, "whole": kept_whole,
               "round_trip": round_trip,
               "params": params_to_numpy(tr.gathered_params()),
               "shapes": [tuple(p.shape) for p in tree_leaves(tr.params)],
               "plain_calls": fa.plain_count,
               "ulysses_kv_heads": global_metrics.counter(
                   "flash_fallback_total", reason="ulysses_kv_heads") - kv0,
               "drops": drops,
               "coords": {a: axis_rank(mesh, a)
                          for a in ("dp", "ep", "sp", "tp")}}
        if name == "dp2tp2":
            # forward's gathered logits on the starting parameters.
            tr0 = Trainer(TransformerLM(TransformerConfig(
                **DIMS, **knobs, dtype=torch.float32), device="cpu"),
                TrainConfig(**TRAIN), device="cpu", mesh=mesh)
            tr0.init(params=inp["params"][name])
            toks = torch.from_numpy(inp["forward_tokens"]).chunk(
                2, 0)[axis_rank(mesh, "dp")]
            logits, _ = tr0.model.forward(tr0.params, toks, mesh)
            run["forward_logits"] = logits.numpy()
        out[name] = run
    return out
