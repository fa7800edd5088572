"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is one kernel library with a plain C interface
(no PyTorch headers, so a build takes seconds).  ``load(name)`` compiles
a library for ``sm_90a`` at first use into ``build/torch_kernels/`` at
the root of the checkout, under a name that carries a hash of its
source and of the ``csrc`` headers it includes, so an edited source or
header never loads a stale build.  Each build that runs (not a library
already built) is reported to the build listeners with its seconds:
``utils/compat.py install_compile_telemetry`` counts them.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_listeners: list = []


def add_build_listener(fn) -> None:
    """Call ``fn(name, seconds)`` after every library ``nvcc`` builds."""
    _listeners.append(fn)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_bytes(path: Path, seen: set[Path]) -> bytes:
    """``path`` followed by every ``csrc`` header it includes with quotes,
    recursively, each once: what the library's hash covers."""
    seen.add(path)
    data = path.read_bytes()
    for inc in re.findall(rb'^\s*#include\s+"([^"]+)"', data, re.M):
        header = CSRC / inc.decode()
        if header not in seen:
            data += _source_bytes(header, seen)
    return data


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(_source_bytes(src, set())).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    seconds = time.perf_counter() - t0
    for fn in list(_listeners):
        fn(name, seconds)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use.
    Libraries of different names may be loaded from several threads at
    once, so their builds run side by side; two builds of one name race
    harmlessly (each writes its own file, then renames it)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _build(name)
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib
