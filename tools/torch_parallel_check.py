"""Quick check of the port's parallel plane on one GPU.

    python3 tools/torch_parallel_check.py [--json PATH] [--no-phase3]
                                          [--layers N]
                                          [--device cpu --layers 1 --seq 256]

Builds both flash sources, runs ``chip_smoke.py``'s phase 3 cases at the
ring's hop shape (``ring_hop_bf16``: v1, ``ring_hop_gqa_bf16``: v2 with
GQA, both non-causal bf16 with an lse cotangent, rope outside), then
phase 10: NCCL's answer to two ranks on the one card, the NCCL psum
smoke on a world of one, which collectives gloo takes on CUDA tensors,
and four gloo ranks on the card over a dp 2 x sp 2 mesh training the
flagship's v2 configuration at 4096 tokens through ring attention and
Ulysses, the float32 checks and the per-axis bandwidth probe.

On the CPU (``--device cpu`` with a short ``--seq``) it rehearses phase
10 with the plain versions (no NCCL probe, no phase 3, no launch
counts); its times are the CPU's, not a device's.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=cs.LAYERS)
    ap.add_argument("--seq", type=int, default=cs.PAR_SEQ)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-phase3", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    out = {}
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_parallel_check: CUDA is not available",
                  file=sys.stderr)
            return 1
        from concurrent.futures import ThreadPoolExecutor

        from k8s_gpu_tpu_torch.ops import _build

        out["gpu"] = cs.gpu_line()
        print(out["gpu"], flush=True)
        sources = ("flash_attention", "flash_attention_v2")
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        torch.backends.cuda.matmul.allow_tf32 = False
        if not args.no_phase3:
            out["phase3"] = cs.check_ring_hops(torch, args.seed)
    out["parallel_path"] = cs.run_parallel_path(
        torch, args.seed, args.layers, seq=args.seq, device=args.device)
    print(json.dumps({"parallel_path": out["parallel_path"]}), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
