"""Clocks: the port's own copy of ``k8s_gpu_tpu/utils/clock.py``.

The goodput ledger, the phase profiler and the checkpoint manager read
time only through a ``Clock``: ``RealClock`` in production, and in tests
``FakeClock`` (moves only when advanced) or ``TickingFakeClock`` (moves
one dyadic tick per read), so two scripted runs record the same
timeline bit for bit.
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    """Monotonic time source (``now``), epoch time (``wall``) and an
    interruptible wait."""

    def now(self) -> float:
        raise NotImplementedError

    def wall(self) -> float:
        """Epoch seconds for display timestamps.  A fake clock keeps one
        time line (wall == now)."""
        return self.now()

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        """Wait on ``cond`` (already held) up to ``timeout`` clock
        seconds."""
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        """Block for ``seconds`` of this clock's time."""
        deadline = self.now() + max(0.0, seconds)
        cond = threading.Condition()
        with cond:
            while True:
                remaining = deadline - self.now()
                if remaining <= 0:
                    return
                self.wait(cond, remaining)


class RealClock(Clock):
    def now(self) -> float:
        return _time.monotonic()

    def wall(self) -> float:
        return _time.time()

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        cond.wait(timeout)


class FakeClock(Clock):
    """Manually advanced clock: time moves only through ``advance`` and
    ``set_time``."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> None:
        with self._lock:
            self._now += dt

    def set_time(self, t: float) -> None:
        with self._lock:
            self._now = t

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        # A short real-time poll; fake time never moves here.
        cond.wait(0.0005 if timeout is not None else 0.002)


class TickingFakeClock(FakeClock):
    """A ``FakeClock`` whose ``now()`` moves forward one ``tick`` per
    read, so instrumented durations are non-zero and still deterministic.
    The default tick, 2**-9 s, is dyadic: sums of ticks and dyadic
    advances are exact in float and survive ``round(x, 9)``."""

    def __init__(self, start: float = 0.0, tick: float = 0.001953125):
        super().__init__(start)
        self._tick = tick

    def now(self) -> float:
        with self._lock:
            self._now += self._tick
            return self._now
