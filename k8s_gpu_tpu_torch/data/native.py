"""The native host data library: ``native/dataloader.cc`` (the batch
prefetcher, ``dl_*``) and ``native/tokenizer.cc`` (BPE, ``tok_*``),
built with ``g++`` and bound with ctypes, with the prototypes of the
reference's ``data/loader.py`` and ``data/tokenizer.py``.

``load()`` compiles both sources at first use with ``native/Makefile``'s
flags into ``build/torch_native/`` at the root of the checkout, under a
name that carries a hash of the sources, the flags and the compiler's
version (a copy of the checkout on another machine builds its own), and
never writes under ``native/``.  It raises ``RuntimeError`` when the
library cannot be built or loaded (and keeps raising the same error
afterwards); ``available()`` says whether it loads.  Nothing runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "torch_native"
SOURCES = ("dataloader.cc", "tokenizer.cc")
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None

_PROTOTYPES = {
    "dl_open": (ctypes.c_void_p, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64]),
    "dl_next_batch": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_void_p]),
    "dl_num_local_samples": (ctypes.c_uint64, [ctypes.c_void_p]),
    "dl_batches_per_epoch": (ctypes.c_uint64, [ctypes.c_void_p]),
    "dl_close": (None, [ctypes.c_void_p]),
    "tok_train": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint64]),
    "tok_num_merges": (ctypes.c_uint64, [ctypes.c_void_p]),
    "tok_merges": (None, [ctypes.c_void_p, ctypes.c_void_p]),
    "tok_from_merges": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_uint64]),
    "tok_encode": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64, ctypes.c_void_p]),
    "tok_decode": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64, ctypes.c_void_p,
                                    ctypes.c_uint64]),
    "tok_free": (None, [ctypes.c_void_p]),
}


def _build() -> Path:
    """Compile the sources unless their library is already built."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    srcs = [NATIVE_DIR / name for name in SOURCES]
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + version.encode())
    for src in srcs:
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libk8sgputpu-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                           *map(str, srcs)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/{', '.join(SOURCES)}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The ctypes handle of the native library, built on first use."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                for name, (restype, argtypes) in _PROTOTYPES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
            except (OSError, RuntimeError, subprocess.TimeoutExpired,
                    AttributeError) as e:
                _error = f"{type(e).__name__}: {e}"
        if _lib is None:
            raise RuntimeError(f"native library unavailable: {_error}")
        return _lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True
