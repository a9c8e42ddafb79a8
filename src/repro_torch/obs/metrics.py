"""Typed metrics registry: Counter / Gauge / Histogram with labels (port
of ``repro.obs.metrics``, copied as it is).

Prometheus-flavoured but dependency-free.  Three instrument kinds:

- :class:`Counter` — monotonically non-decreasing; ``inc()`` rejects
  negative deltas and ``set()`` rejects regressions, which is what makes
  "no double-count across tick retry / evacuation replay" checkable: the
  engine only advances counters after a successful dispatch, and the
  instrument itself refuses to go backwards.
- :class:`Gauge` — point-in-time value (queue depth, pool occupancy,
  per-axis link BER).
- :class:`Histogram` — fixed exponential-ish buckets plus a bounded
  sample reservoir so snapshots can report real percentiles (tick time,
  health-check latency) without unbounded memory.

Labelled instruments: ``registry.counter("x", labels=("axis",))`` returns
a family; ``family.labels(axis="data")`` returns the child holding the
value.  Unlabelled instruments skip the indirection.

Shared percentile helpers live here too (:func:`summarize`,
:func:`latency_fields`) — ``engine.latency_summary()`` and
``launch/serve.py`` both route through them so p50/p95/p99 math exists
exactly once.

``NULL_REGISTRY`` is a no-op registry: modules accept ``registry=None``
and substitute it, so instrumentation in pure-host data structures
(blockpool, scheduler) costs one attribute call when observability is
not wired up.
"""
from __future__ import annotations

import math
import threading
from typing import Iterable, Mapping, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY",
    "latency_fields",
    "percentile",
    "summarize",
]


# ---------------------------------------------------------------------------
# shared percentile / summary helpers (single home for p50/p95/p99 math)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy.

    Matches ``numpy.percentile(..., method="linear")`` closely enough for
    latency reporting while staying dependency-free for host-only tools.
    """
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def summarize(values: Sequence[float],
              quantiles: Sequence[float] = (50, 95, 99)) -> dict:
    """Summary dict for a latency series: count/min/max/mean + pNN keys."""
    xs = [float(v) for v in values]
    out: dict = {"count": len(xs)}
    if not xs:
        for q in quantiles:
            out[f"p{_qname(q)}"] = 0.0
        out.update(min=0.0, max=0.0, mean=0.0)
        return out
    out["min"] = min(xs)
    out["max"] = max(xs)
    out["mean"] = sum(xs) / len(xs)
    for q in quantiles:
        out[f"p{_qname(q)}"] = percentile(xs, q)
    return out


def _qname(q: float) -> str:
    return str(int(q)) if float(q).is_integer() else str(q).replace(".", "_")


def latency_fields(name: str, values: Sequence[float],
                   quantiles: Sequence[float] = (50, 95, 99)) -> dict:
    """``{name}_p50 / _p95 / _p99`` fields — the shape shared by
    ``engine.latency_summary()`` and the serve launcher."""
    return {f"{name}_p{_qname(q)}": percentile(values, q)
            for q in quantiles}


# ---------------------------------------------------------------------------
# instruments


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Common base: name, help text, label names, child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, "_Instrument"] = {}
        self._lock = threading.Lock()

    # -- label families ----------------------------------------------------
    def labels(self, **labels: str) -> "_Instrument":
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help)
                child._labelvals = dict(labels)  # type: ignore[attr-defined]
                self._children[key] = child
            return child

    def _iter_series(self):
        """Yield (labels-dict, leaf-instrument) for exposition/snapshot."""
        if self.labelnames:
            for child in self._children.values():
                yield getattr(child, "_labelvals", {}), child
        else:
            yield {}, self

    # -- snapshot / exposition hooks --------------------------------------
    def _value_repr(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def snapshot(self):
        if self.labelnames:
            return [dict(labels=lv, value=leaf._value_repr())
                    for lv, leaf in self._iter_series()]
        return self._value_repr()


class Counter(_Instrument):
    """Monotonically non-decreasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0, "
                             f"got {amount}")
        self._value += amount

    def set(self, value: float) -> None:
        """Monotonic set — used when mirroring an externally-kept count."""
        if value < self._value:
            raise ValueError(f"{self.name}: counter cannot decrease "
                             f"({self._value} -> {value})")
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def _value_repr(self):
        v = self._value
        return int(v) if float(v).is_integer() else v


class Gauge(_Instrument):
    """Point-in-time value; free to move in either direction."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    @property
    def value(self) -> float:
        return self._value

    def _value_repr(self):
        return self._value


# default bucket ladder: microseconds-to-minutes in roughly x4 steps,
# wide enough for tick times (ms) and health checks (us..ms) alike
DEFAULT_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                   1e-1, 5e-1, 1.0, 5.0, 30.0)

_RESERVOIR = 512  # bounded sample tail kept for real percentiles


class Histogram(_Instrument):
    """Bucketed distribution + bounded sample reservoir for percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._samples: list[float] = []
        self._sample_i = 0

    def labels(self, **labels: str) -> "Histogram":
        child = super().labels(**labels)
        child.buckets = self.buckets  # type: ignore[attr-defined]
        if len(child._counts) != len(self.buckets) + 1:  # type: ignore
            child._counts = [0] * (len(self.buckets) + 1)  # type: ignore
        return child  # type: ignore[return-value]

    def observe(self, value: float) -> None:
        v = float(value)
        self._sum += v
        self._count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self._counts[i] += 1
                break
        else:
            self._counts[-1] += 1
        # fixed-size ring over the most recent samples: percentile snapshots
        # track current behaviour, memory stays bounded
        if len(self._samples) < _RESERVOIR:
            self._samples.append(v)
        else:
            self._samples[self._sample_i] = v
        self._sample_i = (self._sample_i + 1) % _RESERVOIR

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        return percentile(self._samples, q)

    def summary(self, quantiles: Sequence[float] = (50, 95, 99)) -> dict:
        out = summarize(self._samples, quantiles)
        # count/sum reflect the full stream, not just the reservoir tail
        out["count"] = self._count
        out["sum"] = self._sum
        return out

    def _value_repr(self):
        return self.summary()


# ---------------------------------------------------------------------------
# registry


class MetricsRegistry:
    """Owns every instrument; one snapshot shows the whole stack."""

    def __init__(self):
        self._instruments: dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    # -- constructors ------------------------------------------------------
    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, Histogram):
                raise TypeError(f"{name}: registered as {inst.kind}, "
                                f"requested histogram")
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Histogram(name, help, labels, buckets)
                self._instruments[name] = inst
            return inst  # type: ignore[return-value]

    def _get_or_make(self, cls, name, help, labels):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise TypeError(f"{name}: registered as {inst.kind}, "
                                f"requested {cls.kind}")
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, labels)
                self._instruments[name] = inst
            return inst

    # -- introspection -----------------------------------------------------
    def get(self, name: str) -> _Instrument | None:
        return self._instruments.get(name)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for inst in self._instruments.values():
            kinds[inst.kind] = kinds.get(inst.kind, 0) + 1
        parts = [f"{n} {k}" for k, n in sorted(kinds.items())]
        return f"{len(self._instruments)} instruments ({', '.join(parts)})" \
            if parts else "0 instruments"

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serialisable {name: value|summary|[labelled series]}."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}

    def exposition(self) -> str:
        """Prometheus-style text exposition."""
        lines: list[str] = []
        for name, inst in sorted(self._instruments.items()):
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for labelvals, leaf in inst._iter_series():
                sfx = _fmt_labels(labelvals)
                if isinstance(leaf, Histogram):
                    cum = 0
                    for b, c in zip(leaf.buckets, leaf._counts):
                        cum += c
                        lines.append(
                            f'{name}_bucket{_fmt_labels(labelvals, le=_le(b))}'
                            f' {cum}')
                    cum += leaf._counts[-1]
                    lines.append(
                        f'{name}_bucket{_fmt_labels(labelvals, le="+Inf")}'
                        f' {cum}')
                    lines.append(f"{name}_sum{sfx} {leaf._sum:g}")
                    lines.append(f"{name}_count{sfx} {leaf._count}")
                else:
                    lines.append(f"{name}{sfx} {leaf._value_repr():g}"
                                 if isinstance(leaf._value_repr(), float)
                                 else f"{name}{sfx} {leaf._value_repr()}")
        return "\n".join(lines) + ("\n" if lines else "")


def _le(b: float) -> str:
    return f"{b:g}"


def _fmt_labels(labels: Mapping[str, str], **extra: str) -> str:
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# null registry: zero-cost stand-in when observability is not wired


class _NullInstrument:
    def labels(self, **_labels):
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self, quantiles: Iterable[float] = (50, 95, 99)) -> dict:
        return summarize([], tuple(quantiles))


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Accepts any instrument request, records nothing."""

    def counter(self, name, help="", labels=()):
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", labels=()):
        return _NULL_INSTRUMENT

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return _NULL_INSTRUMENT

    def get(self, name):
        return None

    def names(self):
        return []

    def __contains__(self, name):
        return False

    def snapshot(self):
        return {}

    def exposition(self):
        return ""

    def describe(self):
        return "null registry"


NULL_REGISTRY = NullRegistry()
