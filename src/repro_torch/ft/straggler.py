"""Straggler detection over step times (port of ``repro.ft.straggler``,
copied as it is).

At pod scale the common failure mode is not a dead chip but a *slow* one
(thermal throttling, a flaky ICI link retraining, a host stealing cycles).
``StragglerMonitor`` keeps a rolling window of per-step wall times (and,
on multi-host, per-host contributions) and flags sustained outliers
against the rolling median.  The escalation policy mirrors production
practice: warn -> recommend re-mesh (drop the slow host via ft/elastic) ->
recommend abort-and-restore.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.obs.metrics import NULL_REGISTRY

# tick times live in the 0.1ms..5s range on CPU test rigs and real
# accelerators alike; a finer ladder than the registry default makes the
# warn/remesh thresholds readable straight off the bucket counts
STEP_TIME_BUCKETS = (1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                     1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0)


@dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    ratio: float
    action: str            # ok | warn | remesh | abort


class StragglerMonitor:
    def __init__(self, *, window: int = 50, warn_ratio: float = 1.5,
                 remesh_ratio: float = 2.5, abort_ratio: float = 5.0,
                 sustained: int = 3, min_window: int = 2,
                 registry=None):
        self.times: deque = deque(maxlen=window)
        self.warn_ratio = warn_ratio
        self.remesh_ratio = remesh_ratio
        self.abort_ratio = abort_ratio
        self.sustained = sustained
        # a median over fewer than min_window samples is not a baseline:
        # observations during warmup are recorded but never escalate
        self.min_window = max(1, min_window)
        self._over = 0
        self._t0: Optional[float] = None
        self.history: list[StragglerReport] = []
        # every observation lands in the histogram — the rolling window is
        # visible in snapshots *before* warn/remesh ever fires
        reg = NULL_REGISTRY if registry is None else registry
        self._h_step = reg.histogram("straggler_step_seconds",
                                     "observed tick critical-path times",
                                     buckets=STEP_TIME_BUCKETS)
        self._g_median = reg.gauge("straggler_median_seconds",
                                   "rolling-window median step time")
        self._g_ratio = reg.gauge("straggler_ratio",
                                  "last step time over rolling median")

    # -- timing hooks --------------------------------------------------------

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> StragglerReport:
        """Close the step opened by :meth:`step_start`.  Tolerant of an
        unpaired call (e.g. right after a :meth:`reset` mid-step): reports
        "ok" without polluting the window instead of asserting."""
        if self._t0 is None:
            rep = StragglerReport(step, 0.0, 0.0, 0.0, "ok")
            self.history.append(rep)
            return rep
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def reset(self, *, clear_window: bool = True):
        """Forget escalation state after a recovery action (re-mesh /
        evacuation): the new regime's step times are a different
        distribution, so the sustained-outlier counter and (by default)
        the rolling window must re-warm rather than judge the new mesh
        against the old one's median."""
        self._over = 0
        self._t0 = None
        if clear_window:
            self.times.clear()

    # -- core ------------------------------------------------------------------

    def observe(self, step: int, step_time: float) -> StragglerReport:
        self._h_step.observe(step_time)
        if len(self.times) < self.min_window:
            # warmup: the window is too short for a meaningful median
            # (median of < 2 samples is just the sample) — record and pass
            self.times.append(step_time)
            self._over = 0
            rep = StragglerReport(step, step_time, step_time, 1.0, "ok")
            self.history.append(rep)
            return rep
        med = statistics.median(self.times)
        ratio = step_time / max(med, 1e-9)
        self._g_median.set(med)
        self._g_ratio.set(ratio)
        # only steady-state samples pollute the window (skip compile steps)
        if ratio < self.warn_ratio:
            self.times.append(step_time)

        if ratio >= self.warn_ratio:
            self._over += 1
        else:
            self._over = 0          # recovery: sustained counter restarts

        action = "ok"
        if self._over >= self.sustained:
            if ratio >= self.abort_ratio:
                action = "abort"
            elif ratio >= self.remesh_ratio:
                action = "remesh"
            else:
                action = "warn"
        rep = StragglerReport(step, step_time, med, ratio, action)
        self.history.append(rep)
        return rep
