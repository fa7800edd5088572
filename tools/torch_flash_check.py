"""Quick check of the port's flash-attention CUDA kernels on one GPU.

    python3 tools/torch_flash_check.py

Builds ``k8s_gpu_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_v2.cu`` with ``-Xptxas -v`` (both reports and both
libraries side by side) and prints every kernel instance's registers and
spills, then one row per forward instance (v1 per head width and type, v2
also per pipeline factor) and one per backward instance (v1 dq, dk/dv per
head width and type; v2 dq also per pipeline factor, v2 dk/dv, and the
rope pre-pass) with its registers,
spills, dynamic shared memory and design (``mma``: a bf16 tensor-core
kernel; ``fma``: an f32 one on the CUDA cores).  Then it runs the v1
kernels through ``flash_attention_lse``'s autograd and the v2 kernels through
``flash_attention_v2_lse``'s (with an lse cotangent; v2 with rope, GQA and
both pipeline factors) against the float32 plain versions at small shapes
for every head width in both types, and times the kernels at the training
shape (q [24, 8, 2048, 128] bf16, causal; v2 with k, v [24, 2, 2048, 128],
rope and P = 2): each forward beside its useful TFLOP/s (4 D flops per
visible (query, key) pair) and the SDPA forward on the same shape (v2:
``enable_gqa`` on q and k rotated beforehand), then dq and dk/dv of both
paths (the median of 5 means over 10 calls), with delta = rowsum(dO *
out) of a random dO, beside their TFLOP/s (6 D and 8 D flops a pair) and
the SDPA backward's (fwd + bwd through autograd minus the fwd, 14 D flops
a pair): v2 with
rope (one pre-pass for the pair, timed alone too) and without, dq at P 1
and 2.  Last, the v2 pair's split control at the training shape
(``split_control``): how far each gradient sits from its limit with the
pre-pass's planes and with their lo halves zeroed, at unit-normal q and k
and at twice that width.  A shorter loop than ``chip_smoke.py`` for kernel
work; it prints relative errors and ratios and does not judge them.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from k8s_gpu_tpu_torch.ops import _build  # noqa: E402
from k8s_gpu_tpu_torch.ops import attention as fa  # noqa: E402

SOURCES = ("flash_attention", "flash_attention_v2")


def ptxas_report(name: str) -> list[dict]:
    """One row per kernel instance of ``csrc/<name>.cu``: its demangled
    name, registers and spill bytes, from ``nvcc -Xptxas -v``."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
    print(name, "nvcc rc", proc.returncode, "s", round(time.time() - t0, 1),
          flush=True)
    if proc.returncode:
        print(proc.stderr[-6000:])
    rows: list[dict] = []
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append({"kernel": m.group(1), "spill": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    if shutil.which("c++filt") and rows:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True,
            text=True).stdout.splitlines()
        for row, pretty in zip(rows, names):
            pretty = pretty.replace("(anonymous namespace)::", "")
            row["kernel"] = pretty.split("(")[0].removeprefix("void ")
    return rows


def forward_table(reports: dict) -> None:
    """Registers, spills, shared memory and design of every forward
    instance, matched by kernel name and template arguments."""
    lib1, lib2 = fa._kernel(), fa._kernel_v2()
    lib1.flash_attention_fwd_smem.argtypes = [ctypes.c_int] * 2
    lib2.flash_attention_v2_fwd_smem.argtypes = [ctypes.c_int] * 3
    print("forward instance, registers, spill bytes, dynamic smem bytes, "
          "design")
    for dtype, code in fa._DTYPE_CODES.items():
        design = "mma" if dtype == torch.bfloat16 else "fma"
        for d in fa.HEAD_DIMS:
            for source, pipelines in (("flash_attention", (None,)),
                                      ("flash_attention_v2", fa.Q_PIPELINES)):
                for p in pipelines:
                    if p is None:
                        kern = ("flash_fwd_mma_kernel<%d>" % d
                                if design == "mma"
                                else "flash_fwd_kernel<float, %d>" % d)
                        smem = lib1.flash_attention_fwd_smem(d, code)
                    else:
                        kern = ("flash_v2_fwd_mma_kernel<%d, %d>" % (d, p)
                                if design == "mma" else
                                "flash_v2_fwd_kernel<float, %d, %d>" % (d, p))
                        smem = lib2.flash_attention_v2_fwd_smem(d, p, code)
                    row = next((r for r in reports[source]
                                if r["kernel"].endswith(kern)), {})
                    print(f"  {kern}: {row.get('registers')} registers, "
                          f"{row.get('spill')} spill bytes, {smem} smem, "
                          f"{design}", flush=True)


def _row(reports, source, kern) -> dict:
    return next((r for r in reports[source] if r["kernel"].endswith(kern)),
                {})


def backward_table(reports: dict) -> None:
    """Registers, spills, shared memory and design of every backward
    instance: v1's, then v2's (dq per pipeline factor) and the rope
    pre-pass."""
    lib = fa._kernel()
    lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int] * 3
    lib2 = fa._kernel_v2()
    lib2.flash_attention_v2_bwd_smem.argtypes = [ctypes.c_int] * 4
    print("backward instance, registers, spill bytes, dynamic smem bytes, "
          "design")
    for dtype, code in fa._DTYPE_CODES.items():
        mma = dtype == torch.bfloat16
        design = "mma" if mma else "fma"
        for d in fa.HEAD_DIMS:
            rows = []
            for dkv, kind in enumerate(("dq", "dkv")):
                kern = (f"flash_bwd_{kind}_mma_kernel<{d}>" if mma
                        else f"flash_bwd_{kind}_kernel<float, {d}>")
                rows.append(("flash_attention", kern,
                             lib.flash_attention_bwd_smem(d, code, dkv)))
            for p in fa.Q_PIPELINES:
                kern = (f"flash_v2_bwd_dq_mma_kernel<{d}, {p}>" if mma
                        else f"flash_v2_bwd_dq_kernel<float, {d}, {p}>")
                rows.append(("flash_attention_v2", kern,
                             lib2.flash_attention_v2_bwd_smem(d, code, 0, p)))
            kern = (f"flash_v2_bwd_dkv_mma_kernel<{d}, 2>" if mma
                    else f"flash_v2_bwd_dkv_kernel<float, {d}>")
            rows.append(("flash_attention_v2", kern,
                         lib2.flash_attention_v2_bwd_smem(d, code, 1, 1)))
            for source, kern, smem in rows:
                row = _row(reports, source, kern)
                print(f"  {kern}: {row.get('registers')} registers, "
                      f"{row.get('spill')} spill bytes, {smem} smem, "
                      f"{design}", flush=True)
            if mma:
                row = _row(reports, "flash_attention_v2",
                           f"flash_v2_rope_split_kernel<{d}>")
                print(f"  flash_v2_rope_split_kernel<{d}>: "
                      f"{row.get('registers')} registers, {row.get('spill')} "
                      f"spill bytes, 0 smem, pre-pass", flush=True)


def rel_errors(B, H, S, D, dtype, causal, KH=None, rope=None,
               pipeline=1) -> list[float]:
    """v1 when ``KH`` is None, else v2 with K/V at KH heads."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    kv = (B, KH or H, S, D)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               .requires_grad_() for shape in ((B, H, S, D), kv, kv))
    go = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
    gl = torch.randn(B, H, S, generator=g, device=dev)
    if KH is None:
        o, lse = fa.flash_attention_lse(q, k, v, causal)
    else:
        o, lse = fa.flash_attention_v2_lse(q, k, v, causal=causal,
                                           rope_theta=rope,
                                           q_pipeline=pipeline)
    got = (o, lse) + torch.autograd.grad((o, lse), (q, k, v), (go, gl))
    wide = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o2, l2 = (fa.reference_attention_lse(*wide, causal) if KH is None
              else fa.reference_attention_v2_lse(*wide, causal, rope))
    ref = (o2, l2) + torch.autograd.grad((o2, l2), wide, (go.float(), gl))
    with torch.no_grad():
        return [float((a.float() - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]


def time_ms(fn, iters=5) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def sdpa_ms(q, k, v) -> float:
    """The SDPA forward, causal: a yardstick only, never called by the
    port."""
    import torch.nn.functional as F

    kw = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    with torch.no_grad():
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, **kw), 10)


def sdpa_bwd_ms(q, k, v) -> float:
    """The SDPA backward, causal: fwd + bwd through autograd minus the
    fwd, a yardstick only."""
    import torch.nn.functional as F

    kw = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    g = torch.ones_like(q)

    def both():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, **kw)
        torch.autograd.grad(o, (qg, kg, vg), g)

    return time_ms(both, 10) - sdpa_ms(q, k, v)


def timed_bwd(label, fn, per, d_pairs, sdpa) -> None:
    """A backward kernel's mean over 10 calls, the median of 5 such rounds
    (the rounds' least and largest beside it), with its TFLOP/s (``per`` D
    flops a visible pair: dq 6, dk/dv 8) beside the SDPA backward's
    (14 D)."""
    rounds = sorted(time_ms(fn, 10) for _ in range(5))
    ms = rounds[2]
    print(f"{label} ms", ms, "TFLOP/s", per * d_pairs / ms / 1e9,
          "SDPA bwd ms", sdpa, "TFLOP/s", 14 * d_pairs / sdpa / 1e9,
          "rounds min max", rounds[0], rounds[-1], flush=True)


def split_control(q, k, v, go, theta=1e4) -> None:
    """The v2 backward pair (rope, P 2) held to its limit, 2^-7 |r| +
    ``reference_bwd_rounding_v2``'s term + 1e-4 max|r| against the f32
    plain versions, at q and k as given and twice as wide (scores of 4x
    the standard deviation): the worst ratio of error to limit per
    gradient, with the pre-pass's planes and with their lo halves zeroed
    (the scores from the hi planes alone)."""
    for width in (1, 2):
        qw, kw = width * q, width * k   # exact: still bf16 values
        out, lse = fa.flash_v2_forward(qw, kw, v, True, theta, 2)
        delta = (go.float() * out.float()).sum(-1).contiguous()
        del out
        planes = fa.flash_v2_rope_split(qw, kw, theta)
        hi_only = planes.clone()
        hi_only[q.numel():2 * q.numel()] = 0
        hi_only[2 * q.numel() + k.numel():] = 0
        wide = [t.float() for t in (qw, kw, v, go)]
        with torch.no_grad():
            ref = (fa.reference_bwd_dq_v2(*wide, lse, delta, True, theta),
                   *fa.reference_bwd_dkv_v2(*wide, lse, delta, True, theta))
            terms = fa.reference_bwd_rounding_v2(*wide, lse, delta, True,
                                                 theta)
        del wide
        for label, given in (("planes", planes), ("lo zeroed", hi_only)):
            got = (fa.flash_v2_backward_dq(qw, kw, v, go, lse, delta, True,
                                           theta, 2, given),
                   *fa.flash_v2_backward_dkv(qw, kw, v, go, lse, delta, True,
                                             theta, given))
            ratios = [float(((x.float() - r).abs() / (
                2.0 ** -7 * r.abs() + t + 1e-4 * r.abs().max())).max())
                for x, r, t in zip(got, ref, terms)]
            print(f"v2 split control, q and k x{width}, {label}: worst "
                  "|err| / limit dq dk dv", ["%.3f" % x for x in ratios],
                  flush=True)
        del ref, terms, planes, hi_only
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_check: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    with ThreadPoolExecutor(2 * len(SOURCES)) as pool:
        jobs = [pool.submit(ptxas_report, n) for n in SOURCES]
        builds = [pool.submit(_build.load, n) for n in SOURCES]
        reports = dict(zip(SOURCES, (j.result() for j in jobs)))
        for b in builds:
            b.result()
    print("reports and builds s", round(time.time() - t0, 1), flush=True)
    for name, rows in reports.items():
        for row in rows:
            print(f"  {name}: {row['kernel']}: {row.get('registers')} "
                  f"registers, {row['spill']} spill bytes")
    forward_table(reports)
    backward_table(reports)
    cases = [(2, 3, 100, d, t, True) for d in fa.HEAD_DIMS
             for t in (torch.float32, torch.bfloat16)]
    cases += [(2, 3, 1000, 128, torch.float32, False),
              (2, 3, 1000, 64, torch.bfloat16, False)]
    for case in cases:
        errs = rel_errors(*case)
        print(*case, "rel errs out lse dq dk dv",
              ["%.2e" % e for e in errs], flush=True)
    v2_cases = [((2, 4, 100, d, t, True), dict(KH=1, rope=1e4, pipeline=p))
                for d in fa.HEAD_DIMS for p in fa.Q_PIPELINES
                for t in (torch.float32, torch.bfloat16)]
    v2_cases += [((2, 8, 1000, 128, torch.bfloat16, True),
                  dict(KH=2, rope=1e4, pipeline=2)),
                 ((2, 3, 130, 64, torch.float32, False),
                  dict(KH=3, rope=None, pipeline=2)),
                 ((2, 3, 130, 64, torch.bfloat16, False),
                  dict(KH=3, rope=None, pipeline=2))]
    for case, kw in v2_cases:
        errs = rel_errors(*case, **kw)
        print("v2", *case, kw, "rel errs out lse dq dk dv",
              ["%.2e" % e for e in errs], flush=True)
    B, H, S, D = 24, 8, 2048, 128
    flops = 4 * D * B * H * S * (S + 1) // 2
    q, k, v = (torch.randn(B, H, S, D, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    k2, v2 = k[:, :2].contiguous(), v[:, :2].contiguous()
    for name, fn, lib in (
        ("fwd", lambda: fa.flash_forward(q, k, v, True),
         lambda: sdpa_ms(q, k, v)),
        ("v2 fwd", lambda: fa.flash_v2_forward(q, k2, v2, True, 1e4, 2),
         lambda: sdpa_ms(fa.rope_rotate(q, 1e4), fa.rope_rotate(k2, 1e4),
                         v2)),
        ("v2 fwd P 1", lambda: fa.flash_v2_forward(q, k2, v2, True, 1e4, 1),
         None),
        ("v2 fwd no rope", lambda: fa.flash_v2_forward(q, k2, v2, True, None,
                                                       2),
         lambda: sdpa_ms(q, k2, v2)),
    ):
        ms = time_ms(fn, 10)
        print(name, "ms", ms, "TFLOP/s", flops / ms / 1e9,
              *(("SDPA fwd ms", lib()) if lib else ()), flush=True)
    go = torch.randn_like(q)
    d_pairs = flops // 4             # D x the visible pairs
    out, lse = fa.flash_forward(q, k, v, True)
    delta = (go.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, go, lse, delta)
    sdpa = sdpa_bwd_ms(q, k, v)
    timed_bwd("dq", lambda: fa.flash_backward_dq(*args, True), 6, d_pairs,
              sdpa)
    timed_bwd("dkv", lambda: fa.flash_backward_dkv(*args, True), 8, d_pairs,
              sdpa)
    for rope in (1e4, None):
        out, lse = fa.flash_v2_forward(q, k2, v2, True, rope, 2)
        delta = (go.float() * out.float()).sum(-1).contiguous()
        args = (q, k2, v2, go, lse, delta)
        planes = fa._v2_planes(q, k2, rope, None)
        if planes is not None:
            print("v2 rope pre-pass ms",
                  time_ms(lambda: fa.flash_v2_rope_split(q, k2, rope), 10),
                  flush=True)
        sdpa = sdpa_bwd_ms(*((fa.rope_rotate(q, rope),
                              fa.rope_rotate(k2, rope)) if rope else (q, k2)),
                           v2)
        label = "v2 rope" if rope else "v2 no rope"
        for p in fa.Q_PIPELINES:
            timed_bwd(f"{label} dq P {p}", lambda: fa.flash_v2_backward_dq(
                *args, True, rope, p, planes), 6, d_pairs, sdpa)
        timed_bwd(f"{label} dkv", lambda: fa.flash_v2_backward_dkv(
            *args, True, rope, planes), 8, d_pairs, sdpa)
    del args, planes, out, lse, delta
    split_control(q, k2, v2, go)
    return 0


if __name__ == "__main__":
    sys.exit(main())
