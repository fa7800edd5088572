"""The rank side of ``tests/test_torch_pipeline.py``: what each gloo rank
of the spawned CPU cluster runs.  It imports torch, numpy and the port
only (the workers load no JAX); the test module holds the results
against the JAX package.

Each case is a 3-step float32 ``Trainer`` over the global batch on a
mesh of four ranks with pp above 1 (GPipe's with 2 accumulated
microbatches); ``run_all`` returns, per case and
rank, the losses, the gathered parameters, the gradients AdamW was
handed at step 1 (this rank's leaves replicated over pp, and the whole
tree gathered), the tick count and the most stage inputs the schedule
held; then GPipe's ``forward`` logits and the message of each refusal.
"""

from __future__ import annotations

import numpy as np

DIMS = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=16)
GQA = dict(flash_kv_grouped=True, flash_fuse_rope=True)
MESHES = {"dp2pp2": dict(dp=2, pp=2), "pp2tp2": dict(dp=1, pp=2, tp=2),
          "pp4": dict(dp=1, pp=4), "pp2sp2": dict(dp=1, pp=2, sp=2)}
# (name, mesh, model knobs, train knobs, global batch)
CASES = (
    ("gpipe_dp2pp2", "dp2pp2", dict(pp_schedule="gpipe"),
     dict(grad_accum_steps=2), 8),
    ("1f1b_pp2tp2", "pp2tp2", dict(GQA, pp_microbatches=4), {}, 4),
    ("1f1b_dp2pp2_zero1", "dp2pp2", {}, dict(zero1=True), 4),
    ("interleaved_pp4v2", "pp4",
     dict(n_layers=8, pp_virtual_stages=2, pp_microbatches=4), {}, 4),
)
# (name, mesh, model knobs, train knobs): each must raise at init or at
# the first step on REFUSAL_BATCH's batch, with the reference's error.
REFUSALS = (
    ("moe", "dp2pp2", dict(num_experts=4), {}),
    ("sp", "pp2sp2", {}, {}),
    ("unknown_schedule", "dp2pp2", dict(pp_schedule="zero-bubble"), {}),
    ("accum_1f1b", "dp2pp2", {}, dict(grad_accum_steps=2)),
    ("chunks", "pp4", dict(pp_virtual_stages=2), {}),
    ("microbatches", "dp2pp2", dict(pp_schedule="gpipe", pp_microbatches=3),
     {}),
)
REFUSAL_BATCH = "1f1b_dp2pp2_zero1"
REPLICATED = ("embed", "final_norm", "head")
TRAIN = dict(warmup_steps=1, learning_rate=1e-3)
STEPS = 3


def make_inputs(seed: int, params: dict) -> dict:
    """Every input of the run, from ``seed``; ``params[case]`` is the
    case's starting tree (numpy, from the JAX package's init)."""
    rng = np.random.default_rng(seed)
    toks = {name: rng.integers(0, DIMS["vocab_size"],
                               (STEPS, batch, DIMS["max_seq"] + 1)
                               ).astype(np.int32)
            for name, _, _, _, batch in CASES}
    fwd = rng.integers(0, DIMS["vocab_size"],
                       (4, DIMS["max_seq"])).astype(np.int32)
    return dict(tokens=toks, forward_tokens=fwd, params=params)


def _model(knobs):
    import torch

    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(**{**DIMS, **knobs},
                                           dtype=torch.float32),
                         device="cpu")


def _recording(trainer) -> list:
    """The gradient trees AdamW is handed, one a step (after the batch
    group's mean)."""
    from k8s_gpu_tpu_torch.train.runner import tree_like

    seen, update = [], trainer.optimizer.update

    def record(params, grads):
        seen.append(tree_like(trainer.params,
                              [g.detach().clone() for g in grads]))
        update(params, grads)

    trainer.optimizer.update = record
    return seen


def run_all(inp: dict) -> dict:
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.parallel import pipeline
    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, axis_rank, build_mesh,
    )
    from k8s_gpu_tpu_torch.parallel.sharding import gather_params
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    out = {"rank": dist.get_rank()}
    for name, mesh_name, knobs, train, _ in CASES:
        mesh = meshes[mesh_name]
        tr = Trainer(_model(knobs), TrainConfig(**TRAIN, **train),
                     device="cpu", mesh=mesh)
        tr.init(params=inp["params"][name])
        seen = _recording(tr)
        losses = [tr.step(t[:, :-1], t[:, 1:]) for t in inp["tokens"][name]]
        grads = gather_params(seen[0], tr.model.logical_axes(), mesh,
                              virtual_stages=tr.model.virtual_stages)
        out[name] = {
            "losses": losses,
            "params": params_to_numpy(tr.gathered_params()),
            "grads": params_to_numpy(grads),
            "replicated": {k: seen[0][k].numpy() for k in REPLICATED},
            "ticks": pipeline.schedule_stats["ticks"],
            "live_inputs": pipeline.schedule_stats["live_inputs"],
            "n_params": tr.n_params(),
            "block_shape": tuple(tr.params["blocks"]["wq"].shape),
            "coords": {a: axis_rank(mesh, a) for a in ("dp", "pp", "tp")}}
    # forward's logits on GPipe's mesh, from the starting parameters.
    tr0 = Trainer(_model(CASES[0][2]), TrainConfig(**TRAIN), device="cpu",
                  mesh=meshes["dp2pp2"])
    tr0.init(params=inp["params"][CASES[0][0]])
    toks = torch.from_numpy(inp["forward_tokens"]).chunk(
        2, 0)[axis_rank(meshes["dp2pp2"], "dp")]
    logits, aux = tr0.model.forward(tr0.params, toks, meshes["dp2pp2"])
    out["forward"] = {"logits": logits.numpy(), "aux": float(aux)}
    out["refusals"] = {}
    toks = inp["tokens"][REFUSAL_BATCH][0]
    for name, mesh_name, knobs, train in REFUSALS:
        try:
            tr = Trainer(_model(knobs), TrainConfig(**TRAIN, **train),
                         device="cpu", mesh=meshes[mesh_name])
            tr.init(0)
            tr.step(toks[:, :-1], toks[:, 1:])
            out["refusals"][name] = None
        except (NotImplementedError, ValueError) as e:
            out["refusals"][name] = (type(e).__name__, str(e))
    return out
