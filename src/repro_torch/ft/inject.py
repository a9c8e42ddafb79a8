"""Deterministic fault injection: script device failures into the engine
(port of ``repro.ft.inject``: the same grammar, messages and firing
semantics; the plan comes from ``REPRO_TORCH_FAULT_PLAN``, so a process
that loads both packages never arms one with the other's plan).

The paper validates the MCM daughter board adversarially — IBERT 31-bit
PRBS link stress and exhaustive memory tests — because at scale the
question is not *if* a part degrades but *when*.  This module is that
discipline one level up: a scripted plan of faults the serve engine
replays deterministically, so every recovery path (health-gated
evacuation, straggler escalation, transient-tick retry) is testable on
the CPU, tick-for-tick reproducible.

Plan grammar (``REPRO_TORCH_FAULT_PLAN`` env var, or
:meth:`FaultInjector.parse`)::

    plan   := clause (';' clause)*
    clause := field (',' field)*
    field  := key '=' value

    keys:
      tick    (int, required)  first engine tick the fault is armed at
      kind    (required)       fail | stall | raise | corrupt
      device  (int)            device index the fault is pinned to
                               (required for 'fail'; optional straggler
                               attribution for 'stall')
      times   (int)            how many times the fault fires; defaults:
                               fail -> persistent (a dead device stays
                               dead), stall/raise/corrupt -> 1
      ms      (float)          stall duration per fired tick (default 100)
      target  (kv|params|collective)  what a 'corrupt' fault flips a bit
                               in (required for 'corrupt'): a sealed KV
                               block/slot entry, a params leaf, or the
                               device->host token payload
      seed    (int)            deterministic offset/bit choice for
                               'corrupt' (default 0)

Examples::

    REPRO_TORCH_FAULT_PLAN="tick=6,kind=fail,device=7"       # device 7 dies
    REPRO_TORCH_FAULT_PLAN="tick=4,kind=raise,times=3"       # 3 raises
    REPRO_TORCH_FAULT_PLAN="tick=5,kind=stall,ms=250,times=2,device=3"
    REPRO_TORCH_FAULT_PLAN="tick=6,kind=corrupt,target=kv,seed=7"  # a KV bit

Fault kinds and where they bite:

* ``fail`` — the device fails the next health checks
  (:meth:`FaultInjector.apply_health` overlays ``ft.health`` reports with
  ``HealthReason.INJECTED``).  The engine's health gate escalates to
  evacuation.
* ``stall`` — :meth:`FaultInjector.on_tick` sleeps ``ms`` before the
  decode dispatch, inflating the tick wall time the engine feeds into
  ``StragglerMonitor``; sustained stalls walk the warn -> remesh ladder.
* ``raise`` — :meth:`FaultInjector.on_tick` raises :class:`InjectedFault`
  before the decode dispatch (the donated cache buffers are untouched, as
  they would be when a real dispatch is rejected).  With the engine's
  bounded retry (``tick_retries``), ``times=1`` models a transient error
  that retry absorbs; ``times >= tick_retries + 1`` exhausts the retries
  of one tick and escalates to evacuation — and is then spent, so the
  evacuated engine decodes cleanly.
* ``corrupt`` — silent data corruption: the engine pulls due faults via
  :meth:`FaultInjector.due_corruptions` and flips one deterministic bit
  (seeded by ``seed``) in the named ``target`` — a *sealed* KV block/slot
  entry, a params leaf, or the host copy of the device->host token
  payload.  Nothing raises; the fault is only observable through the
  integrity layer (ft/integrity.py fingerprints + the engine's scrub
  cadence), which is the point: a detection miss would serve garbage.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from repro_torch.ft.health import HealthReason, device_id

KINDS = ("fail", "stall", "raise", "corrupt")
TARGETS = ("kv", "params", "collective")
_PERSISTENT = 1 << 30


class InjectedFault(RuntimeError):
    """Raised by a scripted ``raise`` fault at dispatch time."""


@dataclass
class Fault:
    tick: int                 # first engine tick the fault is armed at
    kind: str                 # fail | stall | raise | corrupt
    device: int = -1          # device index (-1 = unattributed)
    times: int = 0            # 0 -> kind default (fail persistent, else 1)
    ms: float = 100.0         # stall duration per fired tick
    target: str = ""          # corrupt: kv | params | collective
    seed: int = 0             # corrupt: deterministic offset/bit choice
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} is not one of "
                             f"{', '.join(KINDS)}")
        if self.kind == "fail" and self.device < 0:
            raise ValueError("kind=fail needs device=<device index> "
                             "(which device fails its health checks)")
        if self.kind == "corrupt" and self.target not in TARGETS:
            raise ValueError(
                f"kind=corrupt needs target=<{('|'.join(TARGETS))}> "
                f"(got target={self.target!r})")
        if self.target and self.kind != "corrupt":
            raise ValueError(
                f"target= only applies to kind=corrupt faults "
                f"(got kind={self.kind!r}, target={self.target!r})")
        if self.times <= 0:
            self.times = _PERSISTENT if self.kind == "fail" else 1

    def due(self, tick: int) -> bool:
        return tick >= self.tick and self.fired < self.times


class FaultInjector:
    """A scripted plan of :class:`Fault`\\ s the engine consults each tick."""

    def __init__(self, faults):
        self.faults = list(faults)

    # -- construction -------------------------------------------------------

    # key -> converter; the single source of truth the error messages quote
    _KEYS = {"tick": int, "device": int, "times": int, "seed": int,
             "ms": float, "kind": str.lower, "target": str.lower}
    _GRAMMAR = (f"grammar: tick=<int>,kind=<{'|'.join(KINDS)}>"
                f"[,device=<id>][,times=<n>][,ms=<float>]"
                f"[,target=<{'|'.join(TARGETS)}>][,seed=<int>]")

    @classmethod
    def parse(cls, plan: str) -> "FaultInjector":
        """Parse the ``REPRO_TORCH_FAULT_PLAN`` grammar (see module docstring).

        Malformed plans fail *fast and loud* — unknown keys name the valid
        set, bad/non-positive ``times=``/``ms=`` values quote the clause,
        and two clauses arming the same (tick, kind, device) triple are
        rejected as a duplicate (almost always a copy-paste slip that
        would silently double-fire)."""
        faults = []
        seen: dict = {}
        for clause in plan.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            kw: dict = {}
            for fieldspec in clause.split(","):
                if "=" not in fieldspec:
                    raise ValueError(
                        f"fault plan clause {clause!r}: field "
                        f"{fieldspec!r} is not key=value ({cls._GRAMMAR})")
                k, v = (s.strip() for s in fieldspec.split("=", 1))
                conv = cls._KEYS.get(k)
                if conv is None:
                    raise ValueError(
                        f"fault plan clause {clause!r}: unknown fault-plan "
                        f"key {k!r}; valid keys: {', '.join(cls._KEYS)}")
                if k in kw:
                    raise ValueError(
                        f"fault plan clause {clause!r}: key {k!r} given "
                        f"twice")
                try:
                    kw[k] = conv(v)
                except ValueError:
                    raise ValueError(
                        f"fault plan clause {clause!r}: bad value for "
                        f"{k}={v!r} (expected "
                        f"{'float' if conv is float else 'int' if conv is int else 'str'})"
                    ) from None
                if k in ("times", "ms") and kw[k] <= 0:
                    raise ValueError(
                        f"fault plan clause {clause!r}: {k}={v!r} must be "
                        f"positive ({k} counts {'fires' if k == 'times' else 'milliseconds'})")
            if "tick" not in kw or "kind" not in kw:
                raise ValueError(
                    f"fault plan clause {clause!r}: tick= and kind= are "
                    f"required ({cls._GRAMMAR})")
            ident = (kw["tick"], kw["kind"], kw.get("device", -1))
            if ident in seen:
                raise ValueError(
                    f"fault plan clause {clause!r}: duplicate of "
                    f"{seen[ident]!r} — same tick={ident[0]}, "
                    f"kind={ident[1]}, device={ident[2]}; merge them or "
                    f"use times=")
            seen[ident] = clause
            try:
                faults.append(Fault(**kw))
            except ValueError as e:
                raise ValueError(
                    f"fault plan clause {clause!r}: {e}") from None
        if not faults:
            raise ValueError(f"fault plan {plan!r} contains no clauses")
        return cls(faults)

    @classmethod
    def from_env(cls, env_var: str = "REPRO_TORCH_FAULT_PLAN"):
        """An injector from the env plan, or None when the var is unset —
        the engine's default, so any run can be made adversarial without
        touching code."""
        plan = os.environ.get(env_var, "").strip()
        return cls.parse(plan) if plan else None

    # -- engine hooks -------------------------------------------------------

    def _due(self, tick: int, kind: str):
        return [f for f in self.faults if f.kind == kind and f.due(tick)]

    def on_tick(self, tick: int):
        """Fire tick-scoped faults: sleep for due stalls, then raise the
        first due ``raise`` fault.  Called at the top of every dispatch
        attempt, so each retry consumes one fire of a ``raise`` fault."""
        for f in self._due(tick, "stall"):
            f.fired += 1
            time.sleep(f.ms / 1e3)
        for f in self._due(tick, "raise"):
            f.fired += 1
            raise InjectedFault(
                f"injected mid-tick fault at tick {tick} "
                f"(scripted tick={f.tick}, fire {f.fired}/{f.times})")

    def apply_health(self, reports: list, devices: list, tick: int) -> list:
        """Overlay scripted ``fail`` faults onto ``ft.health`` reports:
        a due fault marks its device's report unhealthy with
        ``HealthReason.INJECTED``.  ``devices`` are the torch devices the
        reports were taken over (fault ``device`` matches
        ``ft.health.device_id``: the CUDA index, 0 for the CPU)."""
        for f in self._due(tick, "fail"):
            for rep, dev in zip(reports, devices):
                if device_id(dev) == f.device:
                    f.fired += 1
                    rep.ok = False
                    rep.reason = HealthReason.INJECTED
                    rep.detail = (f"scripted fault (armed tick={f.tick}, "
                                  f"now tick={tick})")
        return reports

    def due_corruptions(self, tick: int, target: str) -> list:
        """Due, unfired ``corrupt`` faults for ``target`` this tick.  The
        caller (serve engine / collect path) marks ``fired`` only once the
        bit flip was actually applied — a kv fault armed before anything
        is sealed stays due until there is state to corrupt, mirroring a
        real upset that by definition hits *resident* data."""
        return [f for f in self._due(tick, "corrupt") if f.target == target]

    def suspect_devices(self) -> set:
        """Device ids implicated by fired device-attributed faults — the
        engine excludes these when a straggler escalation (which carries no
        device attribution of its own) forces an evacuation."""
        return {f.device for f in self.faults
                if f.device >= 0 and f.fired > 0}

    def __repr__(self) -> str:
        return ("FaultInjector(" + "; ".join(
            f"tick={f.tick},kind={f.kind},device={f.device},"
            + (f"target={f.target},seed={f.seed}," if f.target else "")
            + f"times={f.times},fired={f.fired}" for f in self.faults) + ")")
