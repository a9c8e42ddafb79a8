"""Pluggable exporters: JSONL event streams, metric dumps, trace files
(port of ``repro.obs.export``).

Two consumers share these helpers:

- ``launch/serve.py`` — ``--events-out`` streams the engine's ft events
  as machine-parseable JSONL (one JSON object per line, default stdout),
  ``--metrics-out`` dumps the registry snapshot (``.json``) or
  Prometheus text exposition (anything else), ``--trace-out`` writes the
  Chrome ``trace_event`` file.
- tests — round-trip the emitted files through ``json.loads``.
"""
from __future__ import annotations

import json
import sys
from typing import IO, Iterable, Mapping

__all__ = [
    "JsonlExporter",
    "dump_metrics",
    "export_chrome_trace",
    "write_events_jsonl",
]


class JsonlExporter:
    """Stream dict events as JSON Lines to a path or file object.

    ``path`` of ``"-"`` (or None) means stdout.  Each ``emit`` writes one
    ``json.dumps`` line and flushes, so a consumer tailing the file sees
    events as they happen.
    """

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._own = False
        if stream is not None:
            self._f = stream
        elif path is None or path == "-":
            self._f = sys.stdout
        else:
            self._f = open(path, "w")
            self._own = True

    def emit(self, event: Mapping) -> None:
        self._f.write(json.dumps(dict(event), default=_jsonable) + "\n")
        self._f.flush()

    def emit_all(self, events: Iterable[Mapping]) -> int:
        n = 0
        for ev in events:
            self.emit(ev)
            n += 1
        return n

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _jsonable(obj):
    # numpy scalars and similar: fall back to their Python value / repr
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return repr(obj)


def write_events_jsonl(events: Iterable[Mapping],
                       path: str | None = None) -> int:
    """One-shot helper: write an event list as JSONL, return the count."""
    with JsonlExporter(path) as ex:
        return ex.emit_all(events)


def dump_metrics(registry, path: str, fmt: str | None = None) -> str:
    """Write a registry to ``path`` as JSON snapshot or text exposition.

    ``fmt`` defaults from the extension: ``.json`` -> JSON, else
    Prometheus text.
    """
    if fmt is None:
        fmt = "json" if path.endswith(".json") else "text"
    if fmt == "json":
        body = json.dumps(registry.snapshot(), indent=2, default=_jsonable)
    elif fmt == "text":
        body = registry.exposition()
    else:
        raise ValueError(f"unknown metrics format: {fmt!r}")
    if path == "-":
        sys.stdout.write(body + ("\n" if not body.endswith("\n") else ""))
    else:
        with open(path, "w") as f:
            f.write(body)
    return path


def export_chrome_trace(tracer, path: str) -> str:
    """Write the tracer's ring buffer as a Chrome ``trace_event`` file."""
    return tracer.export_chrome(path)
