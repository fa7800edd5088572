"""Seeded fault injection at named sites: the port's own copy of
``FaultPlan``, the injector and ``global_faults`` from
``k8s_gpu_tpu/utils/faults.py``.

Production code calls ``fire(site)`` at a named choke point; a test arms
the site with a seeded ``FaultPlan``.  A disarmed site costs one dict
lookup.  Every decision comes from a ``random.Random(seed)`` private to
the armed site, so a (seed, call sequence) pair always injects the same
schedule.  Kinds: ``error`` and ``timeout`` raise the site's error type;
``slow`` sleeps on the caller's clock (or returns the delay);
``FaultPlan(flaky=N)`` fails the first N calls, then heals.  A site
may honour only some kinds (``fire(only=...)``): a decision of another
kind is not an injection.  Each injection counts in
``faults_injected_total{site,kind}``; ``calls``, ``injected`` and
``sites`` report what each armed site saw.

The port fires the reference's sites on its paths: ``train.preempt``
in ``Trainer.fit``, ``serve.submit`` at both batcher submits, and
``migrate.export``/``migrate.import`` at ``LmServer``'s admin routes.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from .metrics import MetricsRegistry, global_metrics


class InjectedFault(Exception):
    """Default error of a site armed with ``error``/``timeout``; a site
    with a failure type of its own passes it as ``fire(error_type=...)``."""


@dataclass
class FaultPlan:
    """One site's seeded schedule: each call draws once and, under
    ``rate``, injects a kind drawn from ``kinds``.  ``flaky=N`` injects
    ``kinds[0]`` on the first N calls and never after.  ``limit`` caps the
    injections; ``slow_s`` is a ``slow`` decision's delay."""

    seed: int = 0
    rate: float = 1.0
    kinds: tuple = ("error",)
    slow_s: float = 0.05
    flaky: int = 0
    limit: int | None = None


class _ArmedSite:
    __slots__ = ("plan", "rng", "calls", "injected")

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.calls = 0
        self.injected = 0

    def decide(self) -> str | None:
        self.calls += 1
        p = self.plan
        if p.limit is not None and self.injected >= p.limit:
            return None
        if p.flaky > 0:
            kind = p.kinds[0] if self.calls <= p.flaky else None
        else:
            # One draw per call whatever the outcome: the schedule is a
            # function of (seed, call index) alone.
            u = self.rng.random()
            kind = (p.kinds[self.rng.randrange(len(p.kinds))]
                    if u < p.rate else None)
        if kind is not None:
            self.injected += 1
        return kind


class FaultInjector:
    """Named injection sites; ``global_faults`` is the one production
    code fires."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or global_metrics
        self._lock = threading.Lock()
        self._sites: dict[str, _ArmedSite] = {}

    def arm(self, site: str, plan: FaultPlan) -> None:
        with self._lock:
            self._sites[site] = _ArmedSite(plan)

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site, or every site when ``site`` is None."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def fire(self, site: str, error_type: type = InjectedFault,
             clock=None, only: tuple | None = None) -> float:
        """The choke point.  Disarmed: returns 0.0.  An armed decision
        raises ``error_type`` (``error``/``timeout``) or handles ``slow``:
        slept here on ``clock``, else returned for the caller to fold into
        its own schedule.  ``only``: the kinds this site honours; another
        kind's decision passes and is not counted as an injection."""
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return 0.0
            kind = st.decide()
            if kind is not None and only is not None and kind not in only:
                st.injected -= 1
                kind = None
            if kind is None:
                return 0.0
            slow_s = st.plan.slow_s
            n = st.injected
        self.registry.inc("faults_injected_total", site=site, kind=kind)
        if kind == "slow":
            if clock is not None:
                clock.sleep(slow_s)
                return 0.0
            return slow_s
        flavor = "timeout" if kind == "timeout" else "fault"
        raise error_type(f"injected {flavor} at {site} (#{n})")

    def injected(self, site: str) -> int:
        with self._lock:
            st = self._sites.get(site)
            return st.injected if st else 0

    def calls(self, site: str) -> int:
        with self._lock:
            st = self._sites.get(site)
            return st.calls if st else 0

    def sites(self) -> dict:
        """site -> {calls, injected} for every armed site."""
        with self._lock:
            return {name: {"calls": st.calls, "injected": st.injected}
                    for name, st in self._sites.items()}


global_faults = FaultInjector()
