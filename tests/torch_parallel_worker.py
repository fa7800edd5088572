"""The rank side of ``tests/test_torch_multihost.py``: what each gloo rank
of the spawned CPU cluster runs.  It imports torch, numpy and the port
only (the workers load no JAX); the test module holds the results
against the JAX package.

``make_inputs`` draws every input from a numpy seed; ``run_all`` takes
them on every rank and returns that rank's results as numpy.
"""

from __future__ import annotations

import numpy as np

# Attention cases: (name, function, mesh, grouped K/V).
MESHES = {"sp4": dict(dp=1, sp=4), "dp2sp2": dict(dp=2, sp=2)}
ATTN_CASES = (
    ("ring_sp4", "ring", "sp4", False),
    ("ring_sp2", "ring", "dp2sp2", False),
    ("ring_gqa_sp4", "ring", "sp4", True),
    ("ulysses_sp2", "ulysses", "dp2sp2", False),
    ("ulysses_gqa_sp2", "ulysses", "dp2sp2", True),
)
B, H, KH, S, D = 2, 4, 2, 32, 8
# Ulysses over sp 4 refuses 2 heads, and 4 heads with 2 KV heads:
# (case whose q, k, v it takes, the heads it keeps of each).
ULYSSES_ERRORS = (("ring_sp4", 2), ("ulysses_gqa_sp2", 4))
# The trainer: the flagship's shape cut to tiny widths, GQA with the
# flash-v2 knobs (which the sp path runs with rope outside).
DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=16, flash_kv_grouped=True,
            flash_fuse_rope=True)
TRAIN = dict(warmup_steps=1, learning_rate=1e-3, grad_accum_steps=2)
GLOBAL_BATCH, STEPS = 4, 3


def make_inputs(seed: int, params: dict) -> dict:
    """Every input of the run, from ``seed``; ``params`` is the trainer's
    starting tree (numpy, from the JAX package's init)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    attn = {}
    for name, _, _, grouped in ATTN_CASES:
        kh = KH if grouped else H
        attn[name] = dict(q=normal(B, H, S, D), k=normal(B, kh, S, D),
                          v=normal(B, kh, S, D), g=normal(B, H, S, D))
    toks = rng.integers(0, DIMS["vocab_size"],
                        (STEPS, GLOBAL_BATCH, DIMS["max_seq"] + 1))
    return dict(attn=attn, tokens=toks.astype(np.int32), params=params)


def run_all(inp: dict) -> dict:
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.collectives import (
        all_reduce_bandwidth_probe, per_axis_bandwidth_probe, psum_smoke,
    )
    from k8s_gpu_tpu_torch.parallel.multihost import (
        workload_device_report, workload_train_step,
    )
    from k8s_gpu_tpu_torch.parallel.mesh import (
        MeshConfig, axis_rank, build_mesh, mesh_shape,
    )
    from k8s_gpu_tpu_torch.parallel.ring_attention import ring_attention
    from k8s_gpu_tpu_torch.parallel.ulysses import ulysses_attention
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.utils.metrics import (
        MetricsRegistry, global_metrics,
    )

    torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    out = {"rank": dist.get_rank(),
           "coords": {name: (axis_rank(m, "dp"), axis_rank(m, "sp"))
                      for name, m in meshes.items()}}

    def block(x, mesh):
        """This rank's [B/dp, ., S/sp, .] block of a global array."""
        shape = mesh_shape(mesh)
        t = torch.from_numpy(x).chunk(shape["dp"], 0)[axis_rank(mesh, "dp")]
        return t.chunk(shape["sp"], 2)[axis_rank(mesh, "sp")].clone()

    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    for name, fn, mesh_name, _ in ATTN_CASES:
        mesh, a = meshes[mesh_name], inp["attn"][name]
        q, k, v = (block(a[t], mesh).requires_grad_() for t in "qkv")
        o = fns[fn](q, k, v, mesh)
        (o * block(a["g"], mesh)).sum().backward()
        out[name] = {"o": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    out["ulysses_errors"] = []
    for name, heads in ULYSSES_ERRORS:
        a = inp["attn"][name]
        try:
            ulysses_attention(*(block(a[t][:, :heads], meshes["sp4"])
                                for t in "qkv"), meshes["sp4"])
            out["ulysses_errors"].append(None)
        except ValueError as e:
            out["ulysses_errors"].append(str(e))

    cfg = TransformerConfig(**DIMS, dtype=torch.float32)
    for zero1 in (True, False):
        fa.reset_counts()
        rope0 = global_metrics.counter("flash_fallback_total",
                                       reason="sp_fused_rope")
        tr = Trainer(TransformerLM(cfg, device="cpu"),
                     TrainConfig(**TRAIN, zero1=zero1), device="cpu",
                     mesh=meshes["dp2sp2"])
        tr.init(params=inp["params"])
        losses = [tr.step(t[:, :-1], t[:, 1:]) for t in inp["tokens"]]
        out[f"trainer_zero1_{zero1}"] = {
            "losses": losses, "params": params_to_numpy(tr.params),
            "plain_calls": fa.plain_count,
            "sp_fused_rope": global_metrics.counter(
                "flash_fallback_total", reason="sp_fused_rope") - rope0,
            "moments": [tuple(m.shape) for m in tr.optimizer.mu],
        }
    out["psum_smoke"] = psum_smoke(device="cpu")
    reg = MetricsRegistry()
    out["per_axis"] = per_axis_bandwidth_probe(
        meshes["dp2sp2"], mib=0.25, registry=reg, device="cpu")
    out["per_axis_series"] = {
        axis: (reg.gauge("collective_bytes_per_second", axis=axis),
               reg.histogram("collective_seconds", axis=axis,
                             op="psum").n)
        for axis in ("dp", "sp")}
    out["all_reduce_probe"] = all_reduce_bandwidth_probe(
        mib=1, iters=2, device="cpu")
    out["device_report"] = workload_device_report()
    out["train_step"] = workload_train_step(device="cpu")
    return out
