"""Quick check of the port's paged-attention CUDA kernel on one GPU.

    python3 tools/torch_paged_check.py [--tree DIR ...] [--serve N]
                                       [--profile] [--host] [--no-phase3]
                                       [--ptxas] [--splits] [--verify]
                                       [--json PATH]

For each ``--tree`` (a checkout of the repo; default this one), in the
order given and each in a process of its own, builds that tree's
``csrc/paged_attention.cu`` and runs ``chip_smoke.py``'s phase 3 (this
checkout's ``check_paged_attention``: the ten cases, each held against
the plain version, with its ms, plain ms, library ms, bound and the
splits its tiles took) on that tree's package.  Give two trees as
``A B B A`` to compare them on one card; a tree older than the split
planner takes ``--no-phase3``.  ``--serve N`` also runs phase 4 (the
serving main path) N times on each tree (tokens/s, time to first
token), ``--profile`` once more under the profiler (device ms by kernel
class, busy share).  ``--host`` instead times the host's share of one
``paged_attention`` call at the decode shape on every tree given, in
one process, rounds of the trees taking turns (``host_us``).
``--no-phase3`` leaves phase 3 out.  ``--ptxas`` prints the registers
and spills of every kernel instance of this checkout's source (``nvcc
-Xptxas -v``) and the dynamic shared memory of each instance family.
``--splits`` times this checkout's kernel at the decode, window and
cold-admission cases with the split count forced (1, 2, 4, 8, 16 and the
planner's), each held against the plain version, with the splits its
tiles took.  ``--verify`` times this checkout's kernel at the verify
windows of speculative serving (``chip_smoke.py``'s paged spec layout,
B 8, Sq 1-9 with G 1 and Sq 1-5 with G 4), each held against the plain
version at phase 3's limits (``chip_smoke.hold_paged``: it raises past
one), with the folded rows, the route, the bound and gather + SDPA.
``--json`` writes every number to PATH.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host_us: calls queued between synchronisations (far fewer than the
# launch queue holds, so the host never waits for the card) and rounds.
HOST_CALLS = 200
HOST_ROUNDS = 40


def _import_tree(tree: str):
    """chip_smoke from this checkout, the package from ``tree``."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(tree))
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    return chip_smoke, pa


def _paged_module(tree: str, alias: str):
    """``tree``'s ``ops/paged_attention`` with its package loaded under
    ``alias``, so that several trees' wrappers (each with its own
    ``_build``, sources and library) live in one process."""
    root = os.path.join(os.path.abspath(tree), "k8s_gpu_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.paged_attention")


def host_us(trees: list[str]) -> list[dict]:
    """Host microseconds a ``paged_attention`` call takes at the decode
    shape (B 8, H = KH 8, Dh 128, page 64, t_hi 2048, bf16) on each
    tree's wrapper and kernel: rounds of HOST_CALLS calls with a
    synchronise only after the last, the trees taking turns, HOST_ROUNDS
    rounds each.  Taking turns in one process puts the host's drift on
    all trees alike; a round that read the card's time instead would
    show the kernel's ms."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops, _ = chip_smoke._pa_case(
        torch, gen, B=8, Sq=1, H=8, KH=8, Dh=128, page=64, t_hi=2048,
        dtype=torch.bfloat16, quant=False, layout="full", dev=dev)
    args = (ops["q"], ops["k"], ops["v"], ops["pages"], ops["start"],
            ops["kv_start"])
    kw = dict(page=64, t_hi=2048)
    mods = [_paged_module(t, f"_tree{i}") for i, t in enumerate(trees)]
    for pa in mods:
        for _ in range(20):
            pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    rounds: list[list[float]] = [[] for _ in mods]
    for _ in range(HOST_ROUNDS):
        for pa, mine in zip(mods, rounds):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                pa.paged_attention(*args, **kw)
            mine.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    out = []
    for tree, mine in zip(trees, rounds):
        row = {"tree": tree, "us_per_call_median": statistics.median(mine),
               "us_per_call_min": min(mine), "us_per_call_max": max(mine),
               "calls_a_round": HOST_CALLS, "rounds": len(mine)}
        if mine is not rounds[0]:
            row["median_minus_first_tree_us"] = statistics.median(
                a - b for a, b in zip(mine, rounds[0]))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def run_one(tree: str, serve: int, profile: bool, phase3: bool) -> dict:
    """Phase 3, ``serve`` plain runs of phase 4 and (``profile``) one
    profiled run on ``tree``'s package."""
    import torch

    chip_smoke, pa = _import_tree(tree)
    from k8s_gpu_tpu_torch.ops import _build

    _build.load("paged_attention")
    out = {}
    if phase3:
        out["rows"] = chip_smoke.check_paged_attention(torch, 0)
    if serve:
        out["serve"] = [chip_smoke.run_main_path(torch, 0, chip_smoke.LAYERS)
                        for _ in range(serve)]
    if profile:
        out["serve_profiled"] = chip_smoke.run_main_path(
            torch, 0, chip_smoke.LAYERS, profile=True)
    return out


def smem_table() -> list[dict]:
    """Dynamic shared memory of every instance family (the library's own
    constants: route, pool type, head width)."""
    sys.path.insert(0, ROOT)
    from k8s_gpu_tpu_torch.ops import paged_attention as pa

    lib = pa._kernel()
    rows = []
    for route, design in ((0, "splitk"), (1, "mma")):
        for dtype, code in pa._DTYPE_CODES.items():
            for dh in (64, 128):
                smem = lib.paged_attention_smem(route, code, dh)
                if smem >= 0:
                    row = {"route": design, "pool": str(dtype)[6:],
                           "Dh": dh, "smem_bytes": smem}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    return rows


def run_splits() -> list[dict]:
    import torch

    chip_smoke, pa = _import_tree(ROOT)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for name, B, Sq, layout in (("decode_bf16", 8, 1, "full"),
                                ("window_bf16", 1, 512, "full"),
                                ("admit_cold_bf16", 1, 512, "cold")):
        ops, _ = chip_smoke._pa_case(
            torch, gen, B=B, Sq=Sq, H=8, KH=8, Dh=128, page=64, t_hi=2048,
            dtype=bf16, quant=False, layout=layout, dev=dev)
        args = (ops["q"], ops["k"], ops["v"], ops["pages"], ops["start"],
                ops["kv_start"])
        kw = dict(page=64, t_hi=2048, k_scale=None, v_scale=None)
        wide = [a.float() if a.is_floating_point() else a for a in args]
        ref = pa.paged_attention_reference(*wide, **kw)
        cut = pa.plan(ops["q"].shape, bf16, 8, page=64, t_hi=2048,
                      n_sms=pa.sm_count(dev))
        for splits in sorted({1, 2, 4, 8, 16, cut.splits}):
            force = None if splits == cut.splits else splits

            def call():
                return pa._launch(*args, 64, 2048, None, None, splits=force)

            out, used = pa._launch(*args, 64, 2048, None, None,
                                   splits=force, count_splits=True)
            err = float((out.float() - ref).abs().max())
            tiles = used[0, 0].tolist()
            ms = chip_smoke.time_cuda(torch, call, 50)
            row = {"case": name, "design": cut.design, "grid_splits": splits,
                   "planned": force is None, "tile_splits": tiles,
                   "ms": ms, "max_abs_err_vs_f32": err}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def run_verify() -> list[dict]:
    import torch

    chip_smoke, pa = _import_tree(ROOT)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for H, sqs in ((8, range(1, 10)), (32, range(1, 6))):
        for sq in sqs:
            ops, _ = chip_smoke._pa_case(
                torch, gen, B=8, Sq=sq, H=H, KH=8, Dh=128, page=64,
                t_hi=2048, dtype=bf16, quant=False, layout="spec", dev=dev)
            args = (ops["q"], ops["k"], ops["v"], ops["pages"],
                    ops["start"], ops["kv_start"])
            kw = dict(page=64, t_hi=2048)
            out = pa.paged_attention(*args, **kw)
            cut = pa.plan(ops["q"].shape, bf16, 8, page=64, t_hi=2048,
                          n_sms=pa.sm_count(dev))
            err, tol, err_f32 = chip_smoke.hold_paged(
                torch, pa, f"verify Sq {sq} G {H // 8}", out, args, kw,
                cut.design)
            bound, by = chip_smoke._pa_bound(ops, page=64, t_hi=2048,
                                             Dh=128)
            row = {"Sq": sq, "G": H // 8, "R": sq * H // 8,
                   "design": cut.design,
                   "ms": chip_smoke.time_cuda(
                       torch, lambda: pa.paged_attention(*args, **kw), 50),
                   "library_ms": chip_smoke.time_cuda(
                       torch, lambda: chip_smoke._pa_library(
                           torch, ops, page=64, t_hi=2048), 30),
                   "bound_ms": bound, "bound_by": by,
                   "max_abs_err": err, "tol": tol,
                   "max_abs_err_vs_f32": err_f32}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="N")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--no-phase3", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one, args.serve, args.profile,
                                 not args.no_phase3)), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke

    out: dict = {"gpu": chip_smoke.gpu_line(), "trees": []}
    print(out["gpu"], flush=True)
    if args.ptxas:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        from torch_flash_check import ptxas_report

        out["ptxas"] = ptxas_report("paged_attention")
        for r in out["ptxas"]:
            print(json.dumps(r), flush=True)
        out["smem"] = smem_table()
    if args.host:
        out["host"] = host_us(args.tree or [ROOT])
    trees = [] if args.host else args.tree or (
        [] if args.splits or args.ptxas or args.verify else [ROOT])
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--serve", str(args.serve)] + ["--profile"] * args.profile
            + ["--no-phase3"] * args.no_phase3,
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        out["trees"].append({"tree": tree, **res})
        print(f"tree {tree}", flush=True)
        for m in res.get("serve", []) + [res.get("serve_profiled")]:
            if m is None:
                continue
            prof = m.get("profile", {})
            print(f"  serve: wall {m['wall_s']:.3f} s, tokens/s "
                  f"{m['tokens_per_s']:.2f}, ttft p50 {m['ttft_s_p50']:.4f} "
                  f"max {m['ttft_s_max']:.4f} s, launches "
                  f"{m['paged_attention_launches']}"
                  + (f", profiled: busy share {prof['device_busy_share']:.4f}"
                     f", device ms by class "
                     f"{json.dumps(prof['device_ms_by_class'])}"
                     if prof else ""), flush=True)
        for r in res.get("rows", []):
            print(f"  {r['case']:16s} {r['design']:12s} "
                  f"splits {r['splits']:2d} of {r['grid_splits']:2d} "
                  f"{json.dumps(r['split_tiles'])} ms {r['ms']:.4f} plain "
                  f"{r['plain_ms']:.3f} library "
                  f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) err_f32 {r['max_abs_err_vs_f32']:.2e}"
                  + (" remade " + " ".join(
                      f"{x['ms']:.4f}/{x['library_ms']:.4f}"
                      for x in r.get("remade_pool_runs", []))),
                  flush=True)
    if args.splits:
        out["splits"] = run_splits()
    if args.verify:
        out["verify"] = run_verify()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
