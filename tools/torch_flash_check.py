"""Quick check of the port's flash-attention CUDA kernels on one GPU.

    python3 tools/torch_flash_check.py

Builds ``k8s_gpu_tpu_torch/csrc/flash_attention.cu`` once with
``-Xptxas -v`` and prints each kernel instance's registers and spills,
then runs the three kernels through ``flash_attention_lse``'s autograd
(with an lse cotangent) against the float32 plain version at small
shapes for every head width, and times the forward, dq and dk/dv kernels
at the flagship training shape (q, k, v [24, 8, 2048, 128] bf16,
causal).  A shorter loop than ``chip_smoke.py`` for kernel work; it
prints relative errors and does not judge them.
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


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"),
             str(_build.CSRC / "flash_attention.cu")],
            capture_output=True, text=True)
    print("nvcc rc", proc.returncode, "s", round(time.time() - t0, 1))
    print("\n".join(line for line in proc.stderr.splitlines()
                    if "Compiling entry" in line or "registers" in line
                    or "spill" in line or "error" in line))


def rel_errors(B, H, S, D, dtype, causal) -> list[float]:
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
               .requires_grad_() for _ in range(3))
    go = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
    gl = torch.randn(B, H, S, generator=g, device=dev)
    o, lse = fa.flash_attention_lse(q, k, v, causal)
    got = (o, lse) + torch.autograd.grad((o, lse), (q, k, v), (go, gl))
    wide = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o2, l2 = fa.reference_attention_lse(*wide, causal)
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
    ptxas_report()
    t0 = time.time()
    fa._kernel()
    print("build s", round(time.time() - t0, 1), flush=True)
    cases = [(2, 2, 100, d, torch.float32, True) for d in fa.HEAD_DIMS]
    cases += [(2, 3, 1000, 128, torch.float32, False),
              (2, 3, 1000, 64, torch.bfloat16, True)]
    for case in cases:
        errs = rel_errors(*case)
        print(*case, "rel errs out lse dq dk dv",
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
