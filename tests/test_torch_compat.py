"""The port's ``utils/compat.py`` against the reference's: the same names,
compile telemetry under the same metric families (counting the kernel
libraries ``nvcc`` builds, ``ops/_build.py``), read by the port's
``/debug/profile`` as the reference's is.  The builds are stubbed: this
machine has no ``nvcc``.
"""

import subprocess
import threading

import pytest

from k8s_gpu_tpu.utils import compat as jax_compat
from k8s_gpu_tpu_torch.ops import _build
from k8s_gpu_tpu_torch.utils import compat
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry
from k8s_gpu_tpu_torch.utils.profiler import profile_snapshot


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A process with no telemetry installed yet, an empty build
    directory and an ``nvcc`` that writes an empty library: returns the
    commands it ran."""
    monkeypatch.setattr(compat, "_telemetry_installed", False)
    monkeypatch.setattr(compat, "_telemetry_registry", None)
    monkeypatch.setattr(_build, "_listeners", [])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    ran = []

    def nvcc(cmd, **kwargs):
        ran.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    return ran


def test_names_match_the_reference():
    for name in ("install_compile_telemetry", "xla_compile_count",
                 "large_thread_stack", "serialize_xla_compiles"):
        assert callable(getattr(jax_compat, name))
        assert callable(getattr(compat, name))


def test_a_build_counts_once_and_a_built_library_not_at_all(fresh):
    """Each library ``nvcc`` builds bumps ``xla_compiles_total`` and lands
    its seconds in ``xla_compile_seconds``; asking again for a library
    already built (the cache) counts nothing.  ``/debug/profile`` reads
    the families."""
    reg = MetricsRegistry()
    compat.install_compile_telemetry(reg)
    assert compat.xla_compile_count() == 0
    lib = _build._build("paged_attention")
    assert lib.exists() and len(fresh) == 1
    assert compat.xla_compile_count() == 1
    assert reg.counter("xla_compiles_total") == 1.0
    hist = reg.histogram("xla_compile_seconds")
    assert hist.n == 1 and hist.total >= 0.0
    assert _build._build("paged_attention") == lib
    assert len(fresh) == 1 and compat.xla_compile_count() == 1
    _build._build("flash_attention")
    assert compat.xla_compile_count() == 2
    snap = profile_snapshot(registry=reg)
    assert snap["compile"]["compiles_total"] == 2.0
    assert snap["compile"]["compile_seconds_sum"] == pytest.approx(
        reg.histogram("xla_compile_seconds").total, abs=1e-9)


def test_install_is_idempotent_and_the_first_registry_wins(fresh):
    """Installed twice, from two threads, with two registries: one
    listener, counting into the first registry only."""
    first, second = MetricsRegistry(), MetricsRegistry()
    compat.install_compile_telemetry(first)
    threads = [threading.Thread(target=compat.install_compile_telemetry,
                                args=(second,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(_build._listeners) == 1
    _build._build("paged_attention")
    assert first.counter("xla_compiles_total") == 1.0
    assert second.counter("xla_compiles_total") == 0.0


def test_a_failed_build_counts_nothing(fresh, monkeypatch):
    reg = MetricsRegistry()
    compat.install_compile_telemetry(reg)
    monkeypatch.setattr(
        _build.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "bad"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._build("paged_attention")
    assert compat.xla_compile_count() == 0


def test_serialize_and_thread_stack_are_harmless(monkeypatch):
    """``serialize_xla_compiles`` takes no lock (the port's builds race
    harmlessly) and stays callable; ``large_thread_stack`` sets the stack
    size for the threads started inside it and puts the previous size
    back (recorded on a stand-in: the size is process-global, and other
    tests' threads may set it meanwhile)."""
    compat.serialize_xla_compiles()
    compat.serialize_xla_compiles()
    calls = []

    def stack_size(n=None):
        calls.append(n)
        return 123 << 20

    monkeypatch.setattr(compat.threading, "stack_size", stack_size)
    with compat.large_thread_stack(8 << 20):
        assert calls == [8 << 20]
    assert calls == [8 << 20, 123 << 20]
