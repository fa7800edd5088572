"""Quick check of the port's MoE training step on one GPU.

    python3 tools/torch_moe_check.py [--ab N] [--profile] [--json PATH]
                                     [--device cpu --layers 1 --batch 1]

Builds the v1 flash source and runs ``chip_smoke.py``'s phase 8a (the
flagship's widths with 4 experts at capacity 1.25, batch 24 x 2048, f32
masters, bf16, flash v1, full remat; then ``save_attn``) and prints its
step ms, MFUs, losses, aux and drops.

``--ab N``: N pairs of phase 8a with the MoE MLP's slot cumsum laid out
two ways, in turns scan, inner, inner, scan, ...: ``scan`` takes the
cumsum of the one-hot ``[G, E]`` down its G rows (the layout the
reference's einsum code suggests), ``inner`` is the port's, the one-hot
``[E, G]`` scanned along its inner axis.  Losses, aux and drops must
agree bit for bit; step ms are printed side by side.

``--profile``: one more full-remat MoE step and one dense flagship step
(phase 6's configuration) under torch.profiler: device ms by kernel
class and the top kernels of each.

On the CPU (``--device cpu``, small ``--layers`` and ``--batch``) it
rehearses the same calls; its times are the CPU's, not a device's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from k8s_gpu_tpu_torch.models import transformer as T  # noqa: E402


def moe_mlp_outer_scan(self, x, lp, full_capacity=False, token_mask=None):
    """``TransformerLM._moe_mlp`` with the one-hot laid out [G, E] and its
    slot cumsum taken down dim 0: the same values, the A/B's other side."""
    cfg = self.cfg
    dt = cfg.dtype
    B, S, D = x.shape
    E = cfg.num_experts
    G = B * S
    cap = G if full_capacity else max(1, int(cfg.capacity_factor * G / E))
    xt = x.reshape(G, D)
    probs = torch.softmax(xt.float() @ lp["gate"].float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = (expert[:, None] == torch.arange(E, device=x.device)).float()
    if token_mask is not None:
        onehot = onehot * token_mask.reshape(G, 1).float()
    gate = (probs * onehot).sum(-1)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).long()
    kept = (pos < cap) & (onehot.sum(-1) > 0)
    slot = expert * (cap + 1) + torch.where(kept, pos, cap)
    buf = xt.new_zeros(E * (cap + 1), D).index_copy(0, slot, xt)
    h = buf.view(E, cap + 1, D)[:, :cap]
    g = torch.bmm(h, T.wt(lp["e_wi_gate"], dt))
    u = torch.bmm(h, T.wt(lp["e_wi_up"], dt))
    out = torch.bmm(torch.nn.functional.silu(g) * u, T.wt(lp["e_wo"], dt))
    back = out.reshape(E * cap, D).index_select(
        0, expert * cap + pos.clamp(max=cap - 1))
    y = back.float() * (gate * kept)[:, None]
    aux = (onehot.mean(0) * probs.mean(0)).sum() * E
    return y.reshape(B, S, D).to(dt), aux


def _summary(run: dict) -> dict:
    full = run["full"]
    return {"step_ms": full["step_ms"],
            "save_attn_step_ms": run["save_attn"]["step_ms"],
            "train_mfu_all_experts": full["train_mfu_all_experts"],
            "mfu_active_params": full["mfu_active_params"],
            "peak_memory_gb": full["peak_memory_gb"],
            "losses": full["losses"], "aux": full["aux"],
            "tokens_dropped_per_layer": full["tokens_dropped_per_layer"]}


def _brief(profile: dict) -> dict:
    return {k: profile[k] for k in ("wall_ms", "device_busy_ms",
                                    "device_busy_share",
                                    "device_ms_by_class", "top_kernels")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", type=int, default=0, metavar="N")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=cs.LAYERS)
    ap.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    args = ap.parse_args(argv)

    out = {}
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_moe_check: CUDA is not available", file=sys.stderr)
            return 1
        from k8s_gpu_tpu_torch.ops import _build

        out["gpu"] = cs.gpu_line()
        print(out["gpu"], flush=True)
        _build.load("flash_attention")
        torch.backends.cuda.matmul.allow_tf32 = False
    inner = T.TransformerLM._moe_mlp

    def phase(impl, profile=False):
        T.TransformerLM._moe_mlp = impl
        try:
            return cs.run_moe_train_path(torch, 0, args.layers, args.batch,
                                         device=args.device,
                                         profile=profile)
        finally:
            T.TransformerLM._moe_mlp = inner
            if args.device == "cuda":
                cs._free(torch)

    run = phase(inner, args.profile)
    out["moe"] = _summary(run)
    if args.profile:
        out["moe"]["profile"] = _brief(run["full"]["profile"])
        dense = cs.run_train_path(torch, 0, args.layers, args.batch, 3,
                                  device=args.device, profile=True)
        out["dense"] = {"step_ms": dense["step_ms"],
                        "profile": _brief(dense["profile"])}
    print(json.dumps(out, indent=1), flush=True)
    turns = []
    for i in range(args.ab):
        order = ("scan", "inner") if i % 2 == 0 else ("inner", "scan")
        for name in order + order[::-1]:
            r = _summary(phase(moe_mlp_outer_scan if name == "scan"
                               else inner))
            turns.append({"layout": name, **r})
            print(json.dumps({k: turns[-1][k] for k in
                              ("layout", "step_ms", "save_attn_step_ms")}),
                  flush=True)
    if turns:
        ref = turns[0]
        same = all(t[k] == ref[k] for t in turns
                   for k in ("losses", "aux", "tokens_dropped_per_layer"))
        out["ab"] = {"turns": turns, "outputs_bit_equal": same}
        print(json.dumps({"outputs_bit_equal": same}), flush=True)
        if not same:
            return 1
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
