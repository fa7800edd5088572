"""The rank side of ``tests/test_torch_mesh_state.py``: what each gloo
rank of the spawned CPU cluster runs.  It imports torch, numpy and the
port only (the workers load no JAX); the test module holds the results
against the JAX package.

Each transformer case is a 3-step float32 ``Trainer`` on a mesh of four
ranks, run under ``remat_policy="save_attn"`` and again under ``"full"``;
``run_all`` returns, per case, policy and rank, the losses, the gathered
parameters, the gathered optimizer state and EMA, and the plain
attention forwards each step ran.  Then: the ``dp2tp2`` run's checkpoint
resumed onto pp 2 x tp 2 and onto one device for 2 more steps; a
one-device checkpoint resumed onto dp 2 x tp 2; the CNN and the LoRA
model on the meshes the reference trains them on, with their gathered
optimizer state; and the messages of the refusals that remain.

Then the rule tables that cut parameters over the data axes (fsdp):
each ``FSDP_CASES`` case trains 3 steps under one remat policy and
returns, beside what a transformer case returns, the local shapes of
its parameters, moments and EMA; the ``fsdp_dp2tp2`` checkpoint resumes
onto default-rules pp 2 x tp 2 and one device; the LoRA model trains
under the fsdp table; ``BATCH_SPEC_CASES`` train with ``batch_specs``;
``FSDP_REFUSALS`` record what ``init`` raises, or the losses.
"""

from __future__ import annotations

import numpy as np

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=16)
GQA = dict(flash_kv_grouped=True, flash_fuse_rope=True)
MOE = dict(num_experts=4)
MESHES = {"dp2tp2": dict(dp=2, tp=2), "sp2tp2": dict(dp=1, sp=2, tp=2),
          "ep2tp2": dict(dp=1, ep=2, tp=2), "pp2tp2": dict(dp=1, pp=2, tp=2),
          "pp4": dict(dp=1, pp=4), "dp2ep2": dict(dp=2, ep=2),
          "dp2pp2": dict(dp=2, pp=2), "dp2sp2": dict(dp=2, sp=2),
          "pp2sp2": dict(dp=1, pp=2, sp=2), "dp4": dict(dp=4)}
# (name, mesh, model knobs, train knobs): each runs under save_attn and
# under full remat.  dp2tp2 keeps an EMA and ZeRO-1's moments, and its
# checkpoint after step 3 is what the resumes start from.
CASES = (
    ("dp2tp2", "dp2tp2", GQA, dict(zero1=True, ema_decay=0.9)),
    ("sp2tp2_ring", "sp2tp2", GQA, {}),
    ("sp2tp2_ulysses", "sp2tp2", dict(GQA, sp_attention="ulysses"), {}),
    ("ep2tp2_moe", "ep2tp2", MOE, {}),
    ("gpipe_pp2tp2", "pp2tp2", dict(pp_schedule="gpipe"), {}),
    ("1f1b_pp2tp2", "pp2tp2", dict(GQA, pp_microbatches=4), {}),
    ("interleaved_pp2tp2", "pp2tp2",
     dict(n_layers=4, pp_virtual_stages=2, pp_microbatches=4), {}),
    ("interleaved_pp4v2", "pp4",
     dict(n_layers=8, pp_virtual_stages=2, pp_microbatches=4), {}),
)
POLICIES = ("save_attn", "full")
# The cases whose gathered optimizer state is held after 3 steps: all
# (the moments hold the gradients, which AdamW's update barely shows).
OPT_STATE_CASES = tuple(name for name, *_ in CASES)
# Where the dp2tp2 checkpoint resumes ("one": one device, no mesh).
RESUMES = ("pp2tp2", "one")
CKPT_CASE = "dp2tp2"
CNN = dict(c1=4, c2=8, d_hidden=16, in_hw=8)
CNN_MESHES = ("dp2tp2", "dp2ep2", "dp2pp2", "dp2sp2")
LORA = dict(rank=4)
# (name, mesh, base model knobs)
LORA_CASES = (("lora_dp2pp2", "dp2pp2", dict(pp_schedule="gpipe")),
              ("lora_pp2tp2", "pp2tp2", {}),
              ("lora_dp2ep2_moe", "dp2ep2", MOE))
# (name, mesh, model knobs): each must raise at its first step, with the
# reference's error.
REFUSALS = (
    ("save_attn_moe_pp", "dp2pp2", dict(MOE, remat_policy="save_attn")),
    ("save_attn_sp_pp", "pp2sp2", dict(remat_policy="save_attn")),
)
# Rule tables that cut parameters over the data axes (fsdp): each is
# applied over the reference's DEFAULT_RULES.
FSDP = {"embed": "dp"}
FSDP_SP = {"embed": ("dp", "sp")}
# (name, mesh, model knobs, train knobs, rules, remat policy)
FSDP_CASES = (
    ("fsdp_dp2tp2", "dp2tp2", GQA, dict(ema_decay=0.9), FSDP, "full"),
    ("fsdp_dp4", "dp4", {}, {}, FSDP, "full"),
    ("fsdp_dp2sp2_ring", "dp2sp2", GQA, {}, FSDP_SP, "save_attn"),
    ("fsdp_1f1b_dp2pp2", "dp2pp2", {}, {}, FSDP, "full"),
    ("fsdp_dp2ep2_moe", "dp2ep2", MOE, {}, FSDP, "full"),
)
FSDP_CKPT_CASE = "fsdp_dp2tp2"
LORA_FSDP_CASE = ("lora_fsdp_dp2pp2", "dp2pp2", dict(pp_schedule="gpipe"))
# (name, mesh, model ("cnn" or transformer knobs), rules, batch specs):
# the CNN's specs are set after construction, as the reference's
# multihost step sets them.
BATCH_SPEC_CASES = (
    ("cnn_dp4_specs", "dp4", "cnn", {}, (("dp",), ("dp",))),
    ("replicated_dp4", "dp4", {}, FSDP, ((), ())),
)
# (name, mesh, train knobs, rules): fsdp with ZeRO-1 raises in both
# packages; a table that moves a weight axis raises in the port only.
FSDP_REFUSALS = (
    ("fsdp_zero1", "dp2tp2", dict(zero1=True), FSDP),
    ("mlp_whole", "dp2tp2", {}, {"mlp": None}),
)
TRAIN = dict(warmup_steps=1, learning_rate=1e-3)
GLOBAL_BATCH, STEPS, RESUMED_STEPS = 4, 3, 2


def make_inputs(seed: int, params: dict, ckpt_dir: str) -> dict:
    """Every input of the run, from ``seed``; ``params[name]`` is a
    case's starting tree (numpy, from the JAX package's init), the LoRA
    cases' (base, adapters); ``ckpt_dir``: a directory every rank
    reaches."""
    rng = np.random.default_rng(seed)
    steps = STEPS + RESUMED_STEPS
    toks = {name: rng.integers(0, DIMS["vocab_size"],
                               (steps, GLOBAL_BATCH, DIMS["max_seq"] + 1)
                               ).astype(np.int32)
            for name, *_ in (CASES + LORA_CASES + FSDP_CASES
                             + (LORA_FSDP_CASE,) + BATCH_SPEC_CASES)}
    hw = CNN["in_hw"]
    images = rng.normal(size=(STEPS, GLOBAL_BATCH, hw, hw, 1)).astype(
        np.float32)
    labels = rng.integers(0, 10, (STEPS, GLOBAL_BATCH)).astype(np.int32)
    return dict(tokens=toks, images=images, labels=labels, params=params,
                ckpt_dir=ckpt_dir)


def _model(knobs, policy="save_attn"):
    import torch

    from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(
        **{**DIMS, "remat_policy": policy, **knobs}, dtype=torch.float32),
        device="cpu")


def _state(tr) -> dict:
    """The trainer's whole optimizer state and EMA, as numpy."""
    from k8s_gpu_tpu_torch.convert import params_to_numpy

    opt = tr.opt_state
    ema = tr.gathered_ema()
    return {"count": opt["count"], "mu": params_to_numpy(opt["mu"]),
            "nu": params_to_numpy(opt["nu"]),
            "ema": None if ema is None else params_to_numpy(ema)}


def _steps(tr, toks) -> list:
    return [tr.step(t[:, :-1], t[:, 1:]) for t in toks]


def _transformer_cases(inp, meshes) -> dict:
    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.ops import attention as fa
    from k8s_gpu_tpu_torch.parallel.mesh import axis_rank
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer
    from k8s_gpu_tpu_torch.utils.metrics import global_metrics

    out = {}
    for name, mesh_name, knobs, train in CASES:
        mesh = meshes[mesh_name]
        for policy in POLICIES:
            tr = Trainer(_model(knobs, policy), TrainConfig(**TRAIN, **train),
                         device="cpu", mesh=mesh)
            tr.init(params=inp["params"][name])
            kv0 = global_metrics.counter("flash_fallback_total",
                                         reason="ulysses_kv_heads")
            fa.reset_counts()
            losses = _steps(tr, inp["tokens"][name][:STEPS])
            run = {"losses": losses, "plain_calls": fa.plain_count,
                   "params": params_to_numpy(tr.gathered_params()),
                   "ulysses_kv_heads": global_metrics.counter(
                       "flash_fallback_total", reason="ulysses_kv_heads")
                   - kv0,
                   "coords": {a: axis_rank(mesh, a)
                              for a in ("dp", "pp", "ep", "sp", "tp")}}
            if policy == "save_attn" and (name in OPT_STATE_CASES
                                          or name == CKPT_CASE):
                run["state"] = _state(tr)
            if policy == "save_attn" and name == CKPT_CASE:
                attach_to_trainer(tr, inp["ckpt_dir"])[1](STEPS)
            out[(name, policy)] = run
    return out


def _resumes(inp, meshes) -> dict:
    """The CKPT_CASE checkpoint resumed onto each of RESUMES from a fresh
    init of other parameters, then RESUMED_STEPS more steps."""
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer

    _, _, knobs, train = next(c for c in CASES if c[0] == CKPT_CASE)
    toks = inp["tokens"][CKPT_CASE][STEPS:]
    out = {}
    for where in RESUMES:
        if where == "one" and dist.get_rank() != 0:
            continue
        tr = Trainer(_model(knobs), TrainConfig(**TRAIN, **train),
                     device="cpu", mesh=meshes.get(where))
        tr.init(seed=7)
        step = attach_to_trainer(tr, inp["ckpt_dir"])[2]()
        losses = _steps(tr, toks)
        out[where] = {"step": step, "losses": losses,
                      "params": params_to_numpy(tr.gathered_params()),
                      **_state(tr)}
    return out


def _one_device_to_mesh(inp, mesh) -> dict:
    """The counterpart of the reference's ``test_restore_onto_sharded_
    mesh``: rank 0 trains one step on one device and saves it; every rank
    restores it onto dp 2 x tp 2 (over a fresh init of other parameters)
    and takes the next step, which rank 0 also takes on one device."""
    import os

    import torch.distributed as dist

    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import CheckpointManager

    _, _, knobs, _ = next(c for c in CASES if c[0] == CKPT_CASE)
    toks = inp["tokens"][CKPT_CASE]
    root = os.path.join(inp["ckpt_dir"], "one_device")
    out = {}
    if dist.get_rank() == 0:
        t1 = Trainer(_model(knobs), TrainConfig(**TRAIN), device="cpu")
        t1.init(params=inp["params"][CKPT_CASE])
        _steps(t1, toks[:1])
        CheckpointManager(root).save(5, t1.params, t1.opt_state)
        out["want_loss"] = _steps(t1, toks[1:2])[0]
    dist.barrier()
    t2 = Trainer(_model(knobs), TrainConfig(**TRAIN), device="cpu",
                 mesh=mesh)
    t2.init(seed=42)
    like = t2.checkpoint_like()
    params, opt_state, step = CheckpointManager(
        root, distributed=True).restore(
            like, {"count": 0, "mu": like, "nu": like})
    t2.load_gathered_state(params, opt_state)
    out["step"] = step
    out["got_loss"] = _steps(t2, toks[1:2])[0]
    return out


def _cnn_cases(inp, meshes) -> dict:
    import torch

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.models import CnnConfig, SmallCnn
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    out = {}
    for mesh_name in CNN_MESHES:
        tr = Trainer(SmallCnn(CnnConfig(**CNN, dtype=torch.float32),
                              device="cpu"), TrainConfig(**TRAIN),
                     device="cpu", mesh=meshes[mesh_name])
        tr.init(params=inp["params"]["cnn"])
        losses = [tr.step(x, y) for x, y in zip(inp["images"],
                                                inp["labels"])]
        out[mesh_name] = {"losses": losses,
                          "params": params_to_numpy(tr.gathered_params()),
                          **_state(tr),
                          "shapes": {k: tuple(v.shape)
                                     for k, v in tr.params.items()}}
    return out


def _lora_cases(inp, meshes) -> dict:
    from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
    from k8s_gpu_tpu_torch.train import (
        LoraConfig, LoraModel, TrainConfig, Trainer,
    )

    out = {}
    for name, mesh_name, knobs in LORA_CASES:
        base, adapters = inp["params"][name]
        model = LoraModel(_model(knobs, "full"),
                          params_from_numpy(base, "cpu"), LoraConfig(**LORA))
        tr = Trainer(model, TrainConfig(**TRAIN), device="cpu",
                     mesh=meshes[mesh_name])
        tr.init(params=adapters)
        out[name] = {"losses": _steps(tr, inp["tokens"][name][:STEPS]),
                     "params": params_to_numpy(tr.gathered_params()),
                     **_state(tr),
                     "wq_b": tuple(tr.params["blocks"]["wq"]["b"].shape)}
    return out


def _refusals(inp, meshes) -> dict:
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    toks = inp["tokens"][CASES[0][0]][0]
    out = {}
    for name, mesh_name, knobs in REFUSALS:
        try:
            tr = Trainer(_model(knobs), TrainConfig(**TRAIN), device="cpu",
                         mesh=meshes[mesh_name])
            tr.init(0)
            tr.step(toks[:, :-1], toks[:, 1:])
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _rules(table: dict):
    from k8s_gpu_tpu_torch.parallel.sharding import DEFAULT_RULES, ParamRules

    return ParamRules({**DEFAULT_RULES, **table})


def _local_shapes(tr) -> dict:
    """The shapes this rank holds between steps: parameters, AdamW's
    moments and the EMA, by leaf path."""
    from k8s_gpu_tpu_torch.train.runner import tree_leaves, tree_paths

    paths = tree_paths(tr.params)
    out = {"params": dict(zip(paths, (tuple(t.shape)
                                      for t in tree_leaves(tr.params)))),
           "mu": dict(zip(paths, (tuple(t.shape) for t in tr.optimizer.mu))),
           "nu": dict(zip(paths, (tuple(t.shape) for t in tr.optimizer.nu)))}
    if tr.ema is not None:
        out["ema"] = dict(zip(paths, (tuple(t.shape)
                                      for t in tree_leaves(tr.ema))))
    return out


def _fsdp_cases(inp, meshes) -> dict:
    """Each FSDP_CASES case's 3 steps (the checkpoint case saved after
    them), then that checkpoint resumed onto each of RESUMES under the
    default rules for RESUMED_STEPS more."""
    import os

    import torch.distributed as dist

    from k8s_gpu_tpu_torch.convert import params_to_numpy
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
    from k8s_gpu_tpu_torch.train.checkpoint import attach_to_trainer

    root = os.path.join(inp["ckpt_dir"], "fsdp")
    out = {}
    for name, mesh_name, knobs, train, table, policy in FSDP_CASES:
        tr = Trainer(_model(knobs, policy), TrainConfig(**TRAIN, **train),
                     device="cpu", mesh=meshes[mesh_name],
                     rules=_rules(table))
        tr.init(params=inp["params"][name])
        losses = _steps(tr, inp["tokens"][name][:STEPS])
        out[name] = {"losses": losses, "shapes": _local_shapes(tr),
                     "params": params_to_numpy(tr.gathered_params()),
                     **_state(tr)}
        if name == FSDP_CKPT_CASE:
            attach_to_trainer(tr, root)[1](STEPS)
    _, _, knobs, train, _, _ = next(c for c in FSDP_CASES
                                    if c[0] == FSDP_CKPT_CASE)
    toks = inp["tokens"][FSDP_CKPT_CASE][STEPS:]
    for where in RESUMES:
        if where == "one" and dist.get_rank() != 0:
            continue
        tr = Trainer(_model(knobs), TrainConfig(**TRAIN, **train),
                     device="cpu", mesh=meshes.get(where))
        tr.init(seed=3)
        step = attach_to_trainer(tr, root)[2]()
        losses = _steps(tr, toks)
        out[("resumed", where)] = {
            "step": step, "losses": losses,
            "params": params_to_numpy(tr.gathered_params()), **_state(tr)}
    return out


def _fsdp_consumers(inp, meshes) -> dict:
    """The LoRA model under the fsdp table, and BATCH_SPEC_CASES."""
    import torch

    from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
    from k8s_gpu_tpu_torch.models import CnnConfig, SmallCnn
    from k8s_gpu_tpu_torch.train import (
        LoraConfig, LoraModel, TrainConfig, Trainer,
    )

    name, mesh_name, knobs = LORA_FSDP_CASE
    base, adapters = inp["params"][name]
    model = LoraModel(_model(knobs, "full"), params_from_numpy(base, "cpu"),
                      LoraConfig(**LORA))
    tr = Trainer(model, TrainConfig(**TRAIN), device="cpu",
                 mesh=meshes[mesh_name], rules=_rules(FSDP))
    tr.init(params=adapters)
    out = {name: {"losses": _steps(tr, inp["tokens"][name][:STEPS]),
                  "params": params_to_numpy(tr.gathered_params()),
                  "shapes": _local_shapes(tr), **_state(tr)}}
    for name, mesh_name, model, table, specs in BATCH_SPEC_CASES:
        if model == "cnn":
            tr = Trainer(SmallCnn(CnnConfig(**CNN, dtype=torch.float32),
                                  device="cpu"), TrainConfig(**TRAIN),
                         device="cpu", mesh=meshes[mesh_name],
                         rules=_rules(table))
            tr.init(params=inp["params"]["cnn"])
            tr.batch_specs = specs
            batches = list(zip(inp["images"], inp["labels"]))
            losses = [tr.step(x, y) for x, y in batches]
        else:
            tr = Trainer(_model(model, "full"), TrainConfig(**TRAIN),
                         device="cpu", mesh=meshes[mesh_name],
                         rules=_rules(table), batch_specs=specs)
            tr.init(params=inp["params"][name])
            batches = [(t[:, :-1], t[:, 1:])
                       for t in inp["tokens"][name][:STEPS]]
            losses = [tr.step(x, y) for x, y in batches]
        out[name] = {"losses": losses,
                     "params": params_to_numpy(tr.gathered_params()),
                     "rows": [len(b) for b in tr.shard_batch(*batches[0])]}
    return out


def _fsdp_refusals(inp, meshes) -> dict:
    from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

    out = {}
    for name, mesh_name, train, table in FSDP_REFUSALS:
        try:
            tr = Trainer(_model({}, "full"), TrainConfig(**TRAIN, **train),
                         device="cpu", mesh=meshes[mesh_name],
                         rules=_rules(table))
            tr.init(0)
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def run_all(inp: dict) -> dict:
    import torch
    import torch.distributed as dist

    from k8s_gpu_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    torch.set_num_threads(1)
    meshes = {name: build_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    return {"rank": dist.get_rank(),
            "cases": _transformer_cases(inp, meshes),
            "resumes": _resumes(inp, meshes),
            "one_to_mesh": _one_device_to_mesh(inp, meshes["dp2tp2"]),
            "cnn": _cnn_cases(inp, meshes),
            "lora": _lora_cases(inp, meshes),
            "refusals": _refusals(inp, meshes),
            "fsdp": _fsdp_cases(inp, meshes),
            "fsdp_consumers": _fsdp_consumers(inp, meshes),
            "fsdp_refusals": _fsdp_refusals(inp, meshes)}
