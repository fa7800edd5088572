"""In-process workload registry, what a TrainJob's ``workload`` names: the
port of ``k8s_gpu_tpu/train/registry.py``.

A workload is ``fn(spec, placements)`` or ``fn(spec, placements, ctx)``
registered by name, with the reference's six names, ``workload_args``,
defaults and returned keys.  The port's workloads also take
``workload_args["device"]`` (default ``"cuda"``).  ``psum-smoke``
all-reduces over the world this process belongs to (a world of one
without a process group); ``dist-psum-smoke`` spawns ``processes`` ranks
through ``parallel.multihost`` (``workload_args["backend"]``: default
nccl on the card, gloo on the CPU; NCCL refuses two ranks on one card).

The reference draws its data with ``jax.random`` threefry keys, which
torch does not reproduce.  Here each draw comes from a CPU
``torch.Generator`` (the same numbers on every device); ``lm-train-ckpt``
seeds step ``s``'s from ``(data_seed, s)``, so a resumed run computes
exactly the steps an uninterrupted run would.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import torch

_REGISTRY: dict[str, Callable] = {}


def register_workload(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_workload(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def known_workloads() -> list[str]:
    return sorted(_REGISTRY)


def _lm_config(args: dict):
    """The reference's small LM of the LM workloads."""
    from ..models import TransformerConfig

    return TransformerConfig(
        vocab_size=int(args.get("vocab", 256)),
        d_model=int(args.get("d_model", 64)),
        n_layers=int(args.get("layers", 2)),
        n_heads=4,
        d_head=16,
        d_ff=int(args.get("d_ff", 128)),
    )


def _step_seed(data_seed: int, step: int) -> int:
    """32 bits of a hash of (data_seed, step): a CPU generator's
    Mersenne Twister keeps only the low 32 bits of its seed."""
    digest = hashlib.sha256(f"{data_seed}:{step}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


def _tokens(seed: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen).to(device)


# -- built-ins -------------------------------------------------------------

@register_workload("psum-smoke")
def _psum_smoke(spec, placements) -> dict:
    from ..parallel.collectives import psum_smoke

    out = psum_smoke(device=spec.workload_args.get("device", "cuda"))
    if not out["ok"]:
        raise RuntimeError(f"psum smoke failed: {out}")
    return out


@register_workload("dist-psum-smoke")
def _dist_psum(spec, placements) -> dict:
    """Multi-PROCESS psum: N ranks joined through a local coordinator
    (parallel/multihost.py), the worker-pod rendezvous contract run for
    real."""
    from functools import partial

    from ..parallel.multihost import spawn_local_cluster, workload_global_psum

    args = spec.workload_args
    procs = int(args.get("processes", 2))
    devices = int(args.get("devices_per_host", 2))
    device = args.get("device", "cuda")
    out = spawn_local_cluster(
        partial(workload_global_psum, devices_per_host=devices,
                device=device),
        num_processes=procs, device=device, backend=args.get("backend"))
    expected = sum((i + 1) * devices for i in range(procs))
    if any(r["sum"] != expected for r in out):
        raise RuntimeError(f"cross-process psum mismatch: {out}")
    return {
        "processes": procs,
        "global_devices": out[0]["global_devices"],
        "psum": out[0]["sum"],
    }


@register_workload("cnn-train")
def _cnn_train(spec, placements) -> dict:
    from ..models import SmallCnn
    from .runner import TrainConfig, Trainer

    args = spec.workload_args
    steps = int(args.get("steps", 5))
    batch = int(args.get("batch", 16))
    device = args.get("device", "cuda")
    model = SmallCnn(device=device)
    trainer = Trainer(model, TrainConfig(warmup_steps=1, learning_rate=1e-3),
                      device=device)
    trainer.init(0)
    gen = torch.Generator().manual_seed(1)
    labels = torch.randint(0, 10, (batch,), generator=gen)
    images = (torch.randn((batch, 28, 28, 1), generator=gen) * 0.1
              + labels[:, None, None, None] / 10.0)
    images, labels = images.to(trainer.device), labels.to(trainer.device)
    losses = [trainer.step(images, labels) for _ in range(steps)]
    return {"first_loss": losses[0], "last_loss": losses[-1], "steps": steps}


@register_workload("lm-train")
def _lm_train(spec, placements) -> dict:
    from ..models import TransformerLM
    from .runner import TrainConfig, Trainer

    args = spec.workload_args
    steps = int(args.get("steps", 3))
    device = args.get("device", "cuda")
    cfg = _lm_config(args)
    trainer = Trainer(TransformerLM(cfg, device=device),
                      TrainConfig(warmup_steps=1, learning_rate=1e-3),
                      device=device)
    trainer.init(0)
    toks = _tokens(1, (4, 33), cfg.vocab_size, trainer.device)
    losses = [trainer.step(toks[:, :-1], toks[:, 1:]) for _ in range(steps)]
    return {"first_loss": losses[0], "last_loss": losses[-1], "steps": steps}


@register_workload("lora-finetune")
def _lora_finetune(spec, placements) -> dict:
    """LoRA adapters on a frozen base LM, trained on the job's data."""
    from ..models import TransformerLM
    from .lora import LoraConfig, LoraModel, num_params
    from .runner import TrainConfig, Trainer

    args = spec.workload_args
    steps = int(args.get("steps", 3))
    device = args.get("device", "cuda")
    cfg = _lm_config(args)
    base = TransformerLM(cfg, device=device)
    base_params = base.init(0, dtype=torch.float32)
    lm = LoraModel(base, base_params,
                   LoraConfig(rank=int(args.get("rank", 8))))
    trainer = Trainer(lm, TrainConfig(warmup_steps=1, learning_rate=5e-3),
                      device=device)
    trainer.init(1)
    toks = _tokens(2, (4, 33), cfg.vocab_size, trainer.device)
    losses = [trainer.step(toks[:, :-1], toks[:, 1:]) for _ in range(steps)]
    return {
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "steps": steps,
        "adapter_params": num_params(trainer.params),
        "base_params": num_params(base_params),
    }


@register_workload("lm-train-ckpt")
def _lm_train_ckpt(spec, placements, ctx=None) -> dict:
    """Checkpoint-aware LM training: a save every
    ``ctx.checkpoint_interval`` steps, and on a (re)start a resume from
    the latest checkpoint if there is one.  Step ``s``'s tokens come from
    a generator seeded from ``(data_seed, s)``, so the resumed run's loss
    curve continues the interrupted one's."""
    from ..models import TransformerLM
    from .checkpoint import attach_to_trainer
    from .runner import TrainConfig, Trainer

    args = spec.workload_args
    steps = int(args.get("steps", 10))
    batch = int(args.get("batch", 4))
    device = args.get("device", "cuda")
    cfg = _lm_config(args)
    trainer = Trainer(TransformerLM(cfg, device=device),
                      TrainConfig(warmup_steps=1, learning_rate=1e-3),
                      device=device)
    trainer.init(0)

    ckpt_dir = (ctx.checkpoint_dir if ctx else "") or args.get(
        "checkpoint_dir", "")
    interval = (ctx.checkpoint_interval if ctx else 0) or int(
        args.get("interval", 0))
    if not ckpt_dir:
        raise ValueError("lm-train-ckpt needs a checkpoint dir "
                         "(spec.checkpoint_dir or workload_args."
                         "checkpoint_dir)")
    ckpt, save, resume = attach_to_trainer(trainer, ckpt_dir)
    data_seed = int(args.get("data_seed", 7))
    try:
        start = 0
        if ckpt.latest_step() is not None:
            start = resume()
            if ctx:
                ctx.record_resume(start)
        first = last = None
        for step in range(start + 1, steps + 1):
            toks = _tokens(_step_seed(data_seed, step), (batch, 33),
                           cfg.vocab_size, trainer.device)
            loss = trainer.step(toks[:, :-1], toks[:, 1:])
            first = loss if first is None else first
            last = loss
            # Save before the heartbeat: if the slice died during this
            # step, the checkpoint just written is the resume point.
            if interval and step % interval == 0:
                save(step)
                if ctx:
                    ctx.record_checkpoint(step)
            if ctx:
                ctx.heartbeat(step)
    finally:
        ckpt.close()
    return {
        "steps": steps,
        "start_step": start,
        "resumed": start > 0,
        "first_loss": first,
        "last_loss": last,
    }
