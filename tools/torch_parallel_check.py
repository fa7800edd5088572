"""Quick check of the port's parallel plane on one GPU.

    python3 tools/torch_parallel_check.py [--mesh NAME ...] [--json PATH]
                                          [--no-phase3] [--layers N]
                                          [--device cpu --layers 1 --seq 256]

Builds both flash sources, runs ``chip_smoke.py``'s phase 3 cases at the
ring's hop shape (``ring_hop_bf16``: v1, ``ring_hop_gqa_bf16``: v2 with
GQA, both non-causal bf16 with an lse cotangent, rope outside), at
phase 11's tp-local heads (``tp_local_bf16``, ``tp_local_gqa_bf16``) and
at phase 12's v1 microbatch (``pp_microbatch_bf16``), then the meshes
asked for (default: all), four gloo ranks on the card:

- ``dp2sp2``: phase 10, NCCL's answer to two ranks on the one card, the
  NCCL psum smoke on a world of one, which collectives gloo takes on
  CUDA tensors, and a dp 2 x sp 2 mesh training the flagship's v2
  configuration at 4096 tokens through ring attention and Ulysses, the
  float32 checks and the per-axis bandwidth probe;
- ``dp2tp2``, ``sp2tp2``, ``ep2tp2``: phase 11a, 11b and 11c (the v2
  configuration over dp 2 x tp 2; ring and Ulysses over sp 2 x tp 2;
  MoE over ep 2 x tp 2), each against one rank's whole-batch step;
- ``f32``: phase 11d, the float32 steps against one rank's;
- ``multislice``: phase 11e, one step over dp 2 (2 slices) x tp 2;
- ``gpipe_dp2pp2``, ``1f1b_pp2tp2``, ``interleaved_pp4v2``, ``1f1b_pp4``:
  phase 12a, 12b and 12c (GPipe over dp 2 x pp 2; 1F1B over pp 2 x tp
  2; interleaved 1F1B with 2 virtual stages and classic 1F1B over pp 4),
  each against one rank's whole-batch step;
- ``pp_memory``: 12a's mesh at 8 microbatches under GPipe and 1F1B, the
  peak memory a rank;
- ``pp_f32``: phase 12d, the float32 steps of the three schedules.

On the CPU (``--device cpu`` with a short ``--seq``) it rehearses them
with the plain versions (no NCCL probe, no phase 3, no launch counts);
its times are the CPU's, not a device's.
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

# --mesh NAME -> phase 11's part; phase 12's.
TP_PARTS = {"dp2tp2": "dense", "sp2tp2": "sp", "ep2tp2": "moe",
            "f32": "f32", "multislice": "multislice"}
PP_PARTS = {**{name: name for name in cs.PP_RUNS}, "pp_memory": "memory",
            "pp_f32": "f32"}
MESHES = ("dp2sp2",) + tuple(TP_PARTS) + tuple(PP_PARTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=cs.LAYERS)
    ap.add_argument("--seq", type=int, default=cs.PAR_SEQ,
                    help="the sp meshes' sequence (phase 11a, 11c, the "
                         "dp x tp float32 step and phase 12 take half "
                         "of it)")
    ap.add_argument("--mesh", action="append", choices=MESHES,
                    help="a mesh to run (repeatable; default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-phase3", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    meshes = args.mesh or MESHES
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
    if "dp2sp2" in meshes:
        out["parallel_path"] = cs.run_parallel_path(
            torch, args.seed, args.layers, seq=args.seq, device=args.device)
        print(json.dumps({"parallel_path": out["parallel_path"]}),
              flush=True)
    parts = tuple(TP_PARTS[m] for m in meshes if m in TP_PARTS)
    if parts:
        out["tensor_parallel_path"] = cs.run_tensor_parallel_path(
            torch, args.seed, args.layers, seq=args.seq // 2,
            sp_seq=args.seq, device=args.device, parts=parts)
        print(json.dumps({"tensor_parallel_path":
                          out["tensor_parallel_path"]}), flush=True)
    parts = tuple(PP_PARTS[m] for m in meshes if m in PP_PARTS)
    if parts:
        out["pipeline_path"] = cs.run_pipeline_path(
            torch, args.seed, args.layers, seq=args.seq // 2,
            device=args.device, parts=parts)
        print(json.dumps({"pipeline_path": out["pipeline_path"]}),
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
