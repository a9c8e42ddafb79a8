"""Unified observability layer: metrics registry + structured tracer
(port of ``repro.obs``, host code copied as it is).

The paper's MCM is validated by *continuous measurement* — IBERT
bit-error-ratio monitors on every inter-FPGA link, DDR memory tests on
every bank — and the serving stack follows the same discipline: every
subsystem (engine, scheduler, blockpool, fault tolerance)
reports into one :class:`~repro_torch.obs.metrics.MetricsRegistry` and one
:class:`~repro_torch.obs.trace.Tracer` so a single snapshot shows the whole
machine.

``Telemetry`` is the small container the :class:`repro_torch.runtime.Runtime`
hands out (``rt.telemetry()``): a registry, a tracer, and helpers to
export both.  Modules that can run stand-alone (blockpool, scheduler,
straggler monitor) accept ``registry=None`` and fall back to
``NULL_REGISTRY`` so instrumentation is free when nobody is looking.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_fields,
    summarize,
)
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "Span",
    "Telemetry",
    "Tracer",
    "latency_fields",
    "summarize",
]


@dataclass
class Telemetry:
    """Registry + tracer pair owned by a Runtime and shared by its engine.

    Survives ``Runtime.reshape`` (live evacuation builds a new Runtime but
    carries the same Telemetry across), so counters stay monotonic over a
    rebuild and the tick timeline is continuous.
    """

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = field(default_factory=Tracer)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def exposition(self) -> str:
        return self.registry.exposition()

    def describe(self) -> str:
        n = self.registry.describe()
        t = self.tracer
        state = "on" if t.enabled else "off"
        return (f"{n} | tracer {state} "
                f"({len(t.events)}/{t.capacity} spans buffered)")
