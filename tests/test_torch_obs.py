"""The port's observability layer (``repro_torch.obs``) against the JAX
reference's (``repro.obs``), on the CPU.

The registry, tracer and exporters are host code the port copies, so each
unit case runs on both packages (``pkg``) and the parity cases drive both
with the same operations and compare snapshots, expositions and exports
exactly.  The engine cases run llama3.2-3b's smoke config in f32 through
the port's plain kernels: one metrics snapshot carries every subsystem,
spans nest inside ticks without perturbing the streams, counters stay
exact under retry and evacuation, and a reference engine and a port engine
that serve the same requests register the same instruments with the same
counts.
"""
import json

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.obs.export as ref_export
import repro.obs.metrics as ref_metrics
import repro.obs.trace as ref_trace
import repro_torch.obs as port_obs
import repro_torch.obs.export as port_export
import repro_torch.obs.metrics as port_metrics
import repro_torch.obs.trace as port_trace
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.ft.inject import FaultInjector
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve.engine import EngineStats, Request
from repro_torch.serve.scheduler import Scheduler

PKGS = {"port": (port_metrics, port_trace, port_export, port_obs),
        "reference": (ref_metrics, ref_trace, ref_export, ref_obs)}
ARCH = "llama3.2-3b"
# never-firing straggler thresholds: tests that pin streams must not
# evacuate on a slow tick of a loaded machine
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _cfg():
    return port_smoke(ARCH).scaled(dtype=torch.float32)


def _stream(cfg, request_cls=Request, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [request_cls(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=int(rng.integers(3, 14)),
                                            dtype=np.int32),
                        max_new_tokens=int(rng.integers(4, 9)))
            for i in range(n)]


def _engine(trace=None, injector=None, **rt_kw):
    cfg = _cfg()
    rt = PortRuntime.create(cfg, capacity=32, device="cpu", **rt_kw)
    eng = rt.engine(num_slots=2, trace=trace, injector=injector,
                    tick_retries=2, retry_backoff_s=0.001,
                    straggler_kw=NO_STRAGGLER)
    for r in _stream(cfg):
        eng.submit(r)
    eng.run_to_completion()
    return rt, eng


def _tokens(eng):
    return {r.rid: list(r.generated) for r in eng.finished}


# ---------------------------------------------------------------------------
# metrics registry (both packages)


def test_counter_monotonic(pkg):
    c = pkg[0].Counter("x_total")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    c.set(5)
    with pytest.raises(ValueError):
        c.set(4)
    assert c.value == 5


def test_histogram_buckets_and_reservoir(pkg):
    h = pkg[0].Histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(55.55)
    assert h._counts == [1, 1, 1, 1]
    assert h.percentile(50) == pytest.approx(
        float(np.percentile([0.05, 0.5, 5.0, 50.0], 50)))
    # the reservoir keeps the most recent 512 samples
    for v in range(600):
        h.observe(float(v))
    assert len(h._samples) == 512 and h.count == 604


def test_registry_kind_mismatch_and_null(pkg):
    reg = pkg[0].MetricsRegistry()
    c1 = reg.counter("n_total")
    assert reg.counter("n_total") is c1
    with pytest.raises(TypeError):
        reg.gauge("n_total")
    with pytest.raises(TypeError):
        reg.histogram("n_total")
    assert "n_total" in reg and reg.names() == ["n_total"]
    null = pkg[0].NULL_REGISTRY
    null.counter("whatever").labels(x=1).observe(3)
    assert null.snapshot() == {} and "whatever" not in null


def _drive(m):
    """The same operations on one package's registry."""
    reg = m.MetricsRegistry()
    reg.counter("a_total", "things").inc(2)
    c = reg.counter("events_total", "help", labels=("event",))
    c.labels(event="a").inc()
    c.labels(event="a").inc()
    c.labels(event="b").inc(3)
    h = reg.histogram("h", "lat", buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 9.0):
        h.observe(v)
    hl = reg.histogram("hl", labels=("axis",), buckets=(1.0,))
    hl.labels(axis="data").observe(0.25)
    reg.gauge("g", labels=("axis",)).labels(axis="data").set(1.5)
    reg.gauge("depth").set(4)
    return reg


def test_registry_snapshot_and_exposition_match_reference():
    port, ref = _drive(port_metrics), _drive(ref_metrics)
    assert port.snapshot() == ref.snapshot()
    assert port.exposition() == ref.exposition()
    assert port.describe() == ref.describe()
    text = port.exposition()
    assert 'h_bucket{le="+Inf"} 3' in text and 'g{axis="data"} 1.5' in text


def test_percentile_and_summaries_match_reference():
    xs = np.random.default_rng(0).exponential(size=101).tolist()
    for q in (0, 25, 50, 95, 99, 100):
        assert port_metrics.percentile(xs, q) == \
            ref_metrics.percentile(xs, q)
        assert port_metrics.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert port_metrics.summarize(xs) == ref_metrics.summarize(xs)
    assert port_metrics.latency_fields("itl", xs) == \
        ref_metrics.latency_fields("itl", xs)
    assert port_metrics.summarize([]) == ref_metrics.summarize([])


def test_scheduler_instruments():
    reg = port_metrics.MetricsRegistry()
    sched = Scheduler(token_budget=8, chunk_size=4, registry=reg)

    class R:
        def __init__(self, rid, priority=0):
            self.rid, self.priority = rid, priority

    sched.enqueue(R(1))
    sched.enqueue(R(2, priority=1))
    depths = {s["labels"]["cls"]: s["value"]
              for s in reg.snapshot()["sched_queue_depth"]}
    assert depths == {0: 1, 1: 1}
    assert sched.select() is not None
    assert reg.get("sched_selected_total").value == 1
    assert sched.chunk_tokens(active_decodes=6, remaining=4) == 2
    assert reg.get("sched_shrunk_chunks_total").value == 1
    assert reg.get("sched_budget_utilization").value == pytest.approx(1.0)
    assert sched.chunk_tokens(active_decodes=8, remaining=4) == 0
    assert reg.get("sched_deferred_chunks_total").value == 1


def test_straggler_histogram_visible_before_escalation():
    reg = port_metrics.MetricsRegistry()
    mon = StragglerMonitor(window=8, sustained=3, registry=reg)
    for i in range(5):
        mon.observe(i, 0.01)
    assert reg.get("straggler_step_seconds").count == 5
    assert reg.get("straggler_median_seconds").value == pytest.approx(0.01)
    assert all(r.action == "ok" for r in mon.history)


def test_engine_stats_bind_rejects_regression_and_rebinds():
    reg = port_metrics.MetricsRegistry()
    st = EngineStats()
    st.bind(reg)
    st.tokens_out += 3
    assert reg.get("serve_engine_tokens_out_total").value == 3
    with pytest.raises(ValueError):
        st.tokens_out = 1
    assert st.tokens_out == 3
    b = EngineStats()
    b.bind(reg)
    b.tokens_out += 2
    assert b.tokens_out == 2
    assert reg.get("serve_engine_tokens_out_total").value == 5


# ---------------------------------------------------------------------------
# tracer and exporters (both packages)


def test_spans_nest_ring_and_errors(pkg):
    tr = pkg[1].Tracer()
    assert tr.span("a") is tr.span("b")          # shared null context
    tr = pkg[1].Tracer(enabled=True)
    with tr.span("tick", tick=1):
        with tr.span("dispatch"):
            pass
    assert [s.name for s in tr.events] == ["dispatch", "tick"]
    assert {s.name: s.depth for s in tr.events} == {"tick": 0,
                                                     "dispatch": 1}
    with pytest.raises(RuntimeError):
        with tr.span("bad"):
            raise RuntimeError("boom")
    assert tr.events[-1].args["error"] == "RuntimeError"
    ring = pkg[1].Tracer(capacity=4, enabled=True)
    for i in range(10):
        with ring.span(f"s{i}"):
            pass
    assert [s.name for s in ring.events] == ["s6", "s7", "s8", "s9"]
    assert ring.dropped == 6


def test_chrome_trace_and_jsonl_match_reference(tmp_path):
    out = {}
    for name, (_, trace, export, _) in PKGS.items():
        tr = trace.Tracer(enabled=True)
        with tr.span("tick", tick=1):
            pass
        tr.instant("ft:evacuate", tick=1)
        ct = tr.chrome_trace(pid=1)
        for e in ct["traceEvents"]:
            e.pop("ts"), e.pop("dur", None), e.pop("tid")
        path = str(tmp_path / f"{name}.jsonl")
        with export.JsonlExporter(path) as ex:
            ex.emit({"v": np.int32(7), "f": np.float64(0.5),
                     "regions": [4, 5]})
        reg = port_metrics.MetricsRegistry()
        reg.counter("a_total").inc(2)
        mpath = str(tmp_path / f"{name}.json")
        export.dump_metrics(reg, mpath)
        out[name] = (ct, open(path).read(), open(mpath).read())
    assert out["port"] == out["reference"]
    assert json.loads(out["port"][1]) == {"v": 7, "f": 0.5, "regions": [4, 5]}


def test_telemetry_describe_matches_reference():
    a, b = port_obs.Telemetry(), ref_obs.Telemetry()
    for t in (a, b):
        t.registry.counter("x_total").inc()
        t.tracer.enable()
        with t.tracer.span("tick"):
            pass
    assert a.describe() == b.describe()
    assert a.snapshot() == b.snapshot()


# ---------------------------------------------------------------------------
# the port engine


def test_one_snapshot_surfaces_every_subsystem():
    rt, eng = _engine(kv_layout="paged", scheduler=True)
    snap = rt.telemetry().snapshot()
    for name in ("serve_engine_tokens_out_total", "serve_queue_depth",
                 "sched_selected_total", "sched_budget_utilization",
                 "blockpool_used_blocks", "blockpool_prefix_misses_total",
                 "straggler_step_seconds", "serve_ft_events_total",
                 "blockpool_kv_pool_bytes"):
        assert name in snap, f"snapshot missing {name}"
    assert snap["serve_engine_tokens_out_total"] == eng.stats.tokens_out
    assert snap["blockpool_used_blocks"] == 0.0
    assert "serve_engine_tokens_out_total" in rt.telemetry().exposition()


def test_spans_nest_within_ticks_and_streams_match():
    rt_off, off = _engine(trace=False)
    rt_on, on = _engine(trace=True)
    assert _tokens(off) == _tokens(on)
    assert not rt_off.telemetry().tracer.events
    tr = rt_on.telemetry().tracer
    ticks = tr.spans("tick")
    assert ticks
    ordered = sorted(ticks, key=lambda s: s.ts_us)
    for a, b in zip(ordered, ordered[1:]):
        assert a.ts_us + a.dur_us <= b.ts_us + 1
    names = set()
    for child in tr.events:
        if child.name == "tick" or child.dur_us is None:
            continue
        names.add(child.name)
        owners = [t for t in ticks
                  if t.ts_us <= child.ts_us + 1
                  and child.ts_us + child.dur_us <= t.ts_us + t.dur_us + 1]
        assert len(owners) == 1 and child.depth >= 1, child.name
    assert {"dispatch", "collect", "admit"} <= names
    json.loads(json.dumps(tr.chrome_trace()))


def test_counters_exact_under_retry_and_evacuation(tmp_path):
    _, clean = _engine()
    rt, eng = _engine(injector=FaultInjector.parse(
        "tick=6,kind=raise,times=3"))
    assert eng.stats.evacuations == 1 and eng.stats.tick_retries == 3
    reg = rt.telemetry().registry
    for k in ("ticks", "tokens_out", "admitted", "finished",
              "tick_retries", "evacuations", "streams_replayed"):
        assert reg.get(f"serve_engine_{k}_total").value == \
            getattr(eng.stats, k), k
    assert _tokens(eng) == _tokens(clean)
    evs = {s["labels"]["event"]: s["value"]
           for s in reg.snapshot()["serve_ft_events_total"]}
    assert evs == {"tick_retry": 3, "evacuate": 1}
    assert reg.get("ft_evacuation_seconds").count == 1
    path = str(tmp_path / "events.jsonl")
    n = port_export.write_events_jsonl(eng.ft_events, path)
    kinds = [json.loads(ln)["event"] for ln in open(path)]
    assert n == len(eng.ft_events) and kinds[-1] == "evacuate"


def test_telemetry_describe_in_runtime():
    rt = PortRuntime.create(_cfg(), capacity=32, device="cpu")
    assert "not wired" in rt.describe()
    rt.engine(num_slots=2)
    desc = rt.describe()
    assert "obs       :" in desc and "instruments" in desc \
        and "tracer off" in desc


@pytest.mark.parametrize("kv", [{}, dict(kv_layout="paged",
                                         kv_dtype="int8")])
def test_engine_instruments_match_reference(kv):
    """The same requests and scripted retry through a reference engine and
    a port engine (the reference's params carried over): the same
    instrument names and kinds in one snapshot (but the reference's link
    monitor, ROADMAP queue 1, item 12), and the same engine, block-pool
    and event counts."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.runtime import Runtime as RefRuntime
    from repro.serve.engine import Request as RefRequest
    from repro_torch.bridge import params_from_reference
    pcfg = _cfg()
    rrt = RefRuntime.create(ref_smoke(ARCH).scaled(
        dtype=jax.numpy.float32), shape_kind="decode", capacity=32, **kv)
    prt = PortRuntime.create(pcfg, capacity=32, device="cpu",
                             params=params_from_reference(
                                 jax.tree.map(np.asarray, rrt.params),
                                 pcfg), **kv)
    snaps = {}
    for name, rt, req in (("reference", rrt, RefRequest),
                          ("port", prt, Request)):
        eng = rt.engine(num_slots=2, straggler_kw=NO_STRAGGLER,
                        retry_backoff_s=0.001,
                        injector=_injector(name),
                        **(dict(block_size=8) if kv else {}))
        for r in _stream(pcfg, req):
            eng.submit(r)
        eng.run_to_completion()
        snaps[name] = {k: v for k, v in rt.telemetry().snapshot().items()
                       if not k.startswith("link_")}
    kinds = {n: {k: type(v).__name__ for k, v in s.items()}
             for n, s in snaps.items()}
    assert kinds["port"] == kinds["reference"]
    for k, v in snaps["reference"].items():
        if k.endswith("_total") or k.startswith("blockpool_"):
            assert snaps["port"][k] == v, k


def _injector(name):
    """The same scripted retry in either package's grammar."""
    if name == "port":
        return FaultInjector.parse("tick=4,kind=raise")
    from repro.ft.inject import FaultInjector as RefInjector
    return RefInjector.parse("tick=4,kind=raise")
