"""Compile telemetry and thread workarounds: the port of
``k8s_gpu_tpu/utils/compat.py``.

The reference counts XLA's backend compiles and works around a
thread-safety bug of its jaxlib's CPU compiler.  The port compiles one
kind of thing: a kernel library, built by ``nvcc`` from ``csrc/*.cu`` at
its first use (``ops/_build.py``).  A build in the middle of a job is
the same dead air the reference's compiles are, so it is counted under
the reference's names, and the reference's ``CompileStorm`` rule and
the port's ``/debug/profile`` read it unchanged.
"""

from __future__ import annotations

import contextlib
import threading

_install_lock = threading.Lock()
_telemetry_installed = False
_telemetry_registry = None


@contextlib.contextmanager
def large_thread_stack(nbytes: int = 64 << 20):
    """Start threads under an enlarged fixed stack.

    ``threading.stack_size`` is consumed at OS-thread creation inside
    ``Thread.start()`` — NOT at ``Thread()`` construction — so this must
    wrap the ``.start()`` call.  XLA's CPU codegen recurses deeply
    enough to blow a worker thread's default stack (segfault inside
    ``backend_compile_and_load`` with no concurrent compile); the
    growable main-thread stack never hits this, so only spawned
    compile-capable threads need it."""
    try:
        prev = threading.stack_size(nbytes)
    except (ValueError, RuntimeError):
        prev = None
    try:
        yield
    finally:
        if prev is not None:
            threading.stack_size(prev)


def serialize_xla_compiles() -> None:
    """The reference serializes XLA's backend compiles behind a lock,
    because its jaxlib's CPU compiler segfaults when two threads compile
    at once.  The port has no such compiler and so no lock to take: its
    one compile is ``nvcc``, a separate process a build.  ``_build``
    runs the builds of different libraries side by side on purpose, and
    two builds of one library race harmlessly (each writes its own file,
    then renames it over the same name).  Kept, as a no-op, so that
    callers written against the reference run unchanged."""


def install_compile_telemetry(registry=None) -> None:
    """Count every kernel library ``nvcc`` builds (``ops/_build.py``):
    each build bumps ``xla_compiles_total`` and lands its seconds in
    ``xla_compile_seconds``.  A library already built, which is only
    loaded, is a cache hit and counts nothing, as an executable-cache
    hit fires nothing in the reference.

    Steady-state serving and training build nothing after the first
    kernel calls; a nonzero steady-state rate is a job stalled on a
    build, which the ``CompileStorm`` rule in the reference's
    ``utils.alerts.default_rule_pack`` alerts on.

    Idempotent and process-global: the first caller's *registry* wins
    (the default is the process-global registry, right for
    multi-replica processes too: builds are a per-process resource)."""
    global _telemetry_installed, _telemetry_registry
    with _install_lock:
        if _telemetry_installed:
            return
        from ..ops import _build
        from .metrics import global_metrics

        _telemetry_registry = (registry if registry is not None
                               else global_metrics)

        def _on_build(name: str, seconds: float) -> None:
            _telemetry_registry.inc("xla_compiles_total")
            _telemetry_registry.observe("xla_compile_seconds",
                                        float(seconds))

        _build.add_build_listener(_on_build)
        _telemetry_installed = True


def xla_compile_count() -> int:
    """Process-wide build count from the installed telemetry (0 until
    ``install_compile_telemetry`` has run): ``snap =
    xla_compile_count(); ...; assert xla_compile_count() == snap``."""
    if _telemetry_registry is None:
        return 0
    return int(_telemetry_registry.counter("xla_compiles_total"))
