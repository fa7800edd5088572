"""Quick check of the port's flash-attention CUDA kernels on one GPU.

    python3 tools/torch_flash_check.py

Builds ``k8s_gpu_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_v2.cu`` once each with ``-Xptxas -v`` and prints each
kernel instance's registers, shared memory and spills, then runs the v1
kernels through ``flash_attention_lse``'s autograd and the v2 kernels
through ``flash_attention_v2_lse``'s (with an lse cotangent; v2 with rope,
GQA and both pipeline factors) against the float32 plain versions at
small shapes for every head width, and times the forward, dq and dk/dv
kernels of both at the training shape (q [24, 8, 2048, 128] bf16,
causal; v2 with k, v [24, 2, 2048, 128], rope and P = 2).  A shorter loop
than ``chip_smoke.py`` for kernel work; it prints relative errors and
does not judge them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from k8s_gpu_tpu_torch.ops import _build  # noqa: E402
from k8s_gpu_tpu_torch.ops import attention as fa  # noqa: E402


def ptxas_report(name: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
    print(name, "nvcc rc", proc.returncode, "s", round(time.time() - t0, 1))
    print("\n".join(line for line in proc.stderr.splitlines()
                    if "Compiling entry" in line or "registers" in line
                    or "spill" in line or "error" in line))


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


def time_ms(fn, iters=2) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_check: CUDA is not available", file=sys.stderr)
        return 1
    for name in ("flash_attention", "flash_attention_v2"):
        ptxas_report(name)
    t0 = time.time()
    fa._kernel()
    fa._kernel_v2()
    print("build s", round(time.time() - t0, 1), flush=True)
    cases = [(2, 2, 100, d, torch.float32, True) for d in fa.HEAD_DIMS]
    cases += [(2, 3, 1000, 128, torch.float32, False),
              (2, 3, 1000, 64, torch.bfloat16, True)]
    for case in cases:
        errs = rel_errors(*case)
        print(*case, "rel errs out lse dq dk dv",
              ["%.2e" % e for e in errs], flush=True)
    v2_cases = [((2, 4, 100, d, torch.float32, True), dict(KH=1, rope=1e4,
                                                           pipeline=p))
                for d in fa.HEAD_DIMS for p in fa.Q_PIPELINES]
    v2_cases += [((2, 8, 1000, 128, torch.bfloat16, True),
                  dict(KH=2, rope=1e4, pipeline=2)),
                 ((2, 3, 130, 64, torch.float32, False),
                  dict(KH=3, rope=None, pipeline=2))]
    for case, kw in v2_cases:
        errs = rel_errors(*case, **kw)
        print("v2", *case, kw, "rel errs out lse dq dk dv",
              ["%.2e" % e for e in errs], flush=True)
    B, H, S, D = 24, 8, 2048, 128
    q, k, v = (torch.randn(B, H, S, D, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    delta = torch.randn(B, H, S, device="cuda")
    for name, fn in (
        ("fwd", lambda: fa.flash_forward(q, k, v, True)),
        ("dq", lambda: fa.flash_backward_dq(q, k, v, out, lse, delta, True)),
        ("dkv", lambda: fa.flash_backward_dkv(q, k, v, out, lse, delta,
                                              True)),
    ):
        print(name, "ms", time_ms(fn), flush=True)
    k2, v2 = k[:, :2].contiguous(), v[:, :2].contiguous()
    out, lse = fa.flash_v2_forward(q, k2, v2, True, 1e4, 2)
    for name, fn in (
        ("v2 fwd", lambda: fa.flash_v2_forward(q, k2, v2, True, 1e4, 2)),
        ("v2 dq", lambda: fa.flash_v2_backward_dq(q, k2, v2, out, lse, delta,
                                                  True, 1e4, 2)),
        ("v2 dkv", lambda: fa.flash_v2_backward_dkv(q, k2, v2, out, lse,
                                                    delta, True, 1e4)),
    ):
        print(name, "ms", time_ms(fn), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
