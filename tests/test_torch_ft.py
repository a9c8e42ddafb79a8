"""The port's fault tolerance and data integrity (``repro_torch.ft``, the
serve engine's health gate, retries, evacuation, scrub, quarantine and
replay) against the JAX reference, on the CPU.

Host pieces (the fault-plan grammar and its messages, the straggler
ladder, the block pool's quarantine) run the same inputs through both
packages and compare what comes out.  The fingerprints and bit flips
must equal the reference's bit for bit on f32, bf16, int8 and int32
leaves, including a leaf walked in several chunks.  The engine cases run
llama3.2-3b's smoke config in f32 from the reference's params and hold
the port engine's streams and ``ft`` events to the reference engine's
under the same fault plan, on the dense, paged and int8 pools, with the
straggler off on both sides; the port's own recovery cases hold the
faulted streams to a clean run of the port.  Cases the reference needs a
mesh for (mesh shrink, link demotion, collective corruption on a mesh,
burn-in) are not ported (ROADMAP queue 1, items 9 and 12).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.ft import integrity
from repro_torch.ft.health import (DeviceHealth, HealthReason, all_healthy,
                                   check_devices)
from repro_torch.ft.inject import Fault, FaultInjector, InjectedFault
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve.blockpool import NUM_RESERVED, BlockPool
from repro_torch.serve.engine import Request

ARCH = "llama3.2-3b"
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)
# (region, leaf, bit) of a kv flip, regions and replayed rids of a
# detection, replayed rids of an evacuation: what must match the reference
EVENT_KEYS = ("event", "tick", "target", "region", "leaf", "bit", "regions",
              "streams", "replayed", "attempt")


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.ft.health
    import repro.ft.inject
    import repro.ft.integrity
    import repro.ft.straggler
    import repro.runtime
    import repro.serve.blockpool
    import repro.serve.engine
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "health": repro.ft.health, "inject": repro.ft.inject,
            "integrity": repro.ft.integrity,
            "straggler": repro.ft.straggler, "runtime": repro.runtime,
            "blockpool": repro.serve.blockpool, "engine": repro.serve.engine}


def _cfg():
    return port_smoke(ARCH).scaled(dtype=torch.float32)


def _stream(cfg, request_cls=Request, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [request_cls(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=int(rng.integers(3, 14)),
                                            dtype=np.int32),
                        max_new_tokens=int(rng.integers(6, 10)))
            for i in range(n)]


def _run(*, kv_layout="dense", kv_dtype="f32", plan=None, scrub=0,
         straggler_kw=NO_STRAGGLER, rt=None, **kw):
    """Serve ``_stream`` on a port engine; returns it."""
    cfg = _cfg()
    if rt is None:
        rt = PortRuntime.create(cfg, capacity=32, device="cpu",
                                kv_layout=kv_layout, kv_dtype=kv_dtype)
    if rt.kv_layout == "paged":
        kw.setdefault("block_size", 8)
    eng = rt.engine(num_slots=2, scrub_every=scrub,
                    injector=FaultInjector.parse(plan) if plan else None,
                    retry_backoff_s=0.001, straggler_kw=straggler_kw, **kw)
    for r in _stream(cfg):
        eng.submit(r)
    eng.run_to_completion()
    assert len(eng.finished) == 4, "stream dropped"
    return eng


def _tokens(eng):
    return {r.rid: list(r.generated) for r in eng.finished}


def _message(fn, plan):
    with pytest.raises(ValueError) as e:
        fn(plan)
    return str(e.value)


# ---------------------------------------------------------------------------
# fault-plan grammar: the reference's accept / reject lists and messages
# ---------------------------------------------------------------------------


def test_fault_plan_parse_matches_reference(ref):
    plan = ("tick=6,kind=fail,device=7; tick=4,kind=raise,times=3;"
            "tick=5, kind=stall, ms=250, device=3;"
            "tick=6,kind=corrupt,target=kv,seed=7;"
            "tick=8,kind=corrupt,target=PARAMS")
    got = FaultInjector.parse(plan)
    want = ref["inject"].FaultInjector.parse(plan)
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert repr(got) == repr(want)
    kinds = {f.kind: f for f in got.faults}
    assert kinds["fail"].times > 1_000_000 and kinds["stall"].ms == 250.0
    # distinct devices are not duplicates
    FaultInjector.parse("tick=5,kind=stall,device=3;"
                        "tick=5,kind=stall,device=4")


@pytest.mark.parametrize("plan", [
    "tick=3", "kind=raise", "tick=3,kind=melt", "tick=3,kind=fail",
    "tick=x,kind=raise", "tick=3,kind=raise,volts=9", "",
    "tick,kind=raise", "tick=3,kind=corrupt",
    "tick=3,kind=corrupt,target=disk",
    "tick=3,kind=raise,target=kv", "tick=3,kind=raise,times=0",
    "tick=3,kind=stall,ms=-5", "tick=3,kind=stall,ms=fast",
    "tick=3,kind=raise,tick=4", "tick=3,kind=raise; tick=3,kind=raise",
    "tick=5,kind=stall,device=3;tick=5,kind=stall,device=3,ms=9"])
def test_fault_plan_rejects_like_reference(ref, plan):
    """Every malformed plan raises ``ValueError`` with the reference's
    message (which names a JAX device id where the port's names a device
    index)."""
    got = _message(FaultInjector.parse, plan)
    want = _message(ref["inject"].FaultInjector.parse, plan)
    assert got == want.replace("jax device id", "device index")


def test_fault_plan_from_env_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FAULT_PLAN", raising=False)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "tick=2,kind=raise")
    assert FaultInjector.from_env() is None      # the reference's plan
    monkeypatch.setenv("REPRO_TORCH_FAULT_PLAN", "tick=2,kind=raise")
    inj = FaultInjector.from_env()
    assert inj is not None and inj.faults[0].kind == "raise"


def test_fault_firing_semantics():
    f = Fault(tick=3, kind="raise", times=2)
    assert not f.due(2) and f.due(3) and f.due(99)
    inj = FaultInjector([f])
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.on_tick(5)
    inj.on_tick(5)                      # spent
    assert f.fired == 2 and inj.suspect_devices() == set()
    c = FaultInjector.parse("tick=6,kind=corrupt,target=kv,seed=7")
    assert c.due_corruptions(6, "kv") == c.faults
    assert c.due_corruptions(6, "params") == []
    c.faults[0].fired += 1
    assert c.due_corruptions(7, "kv") == []


# ---------------------------------------------------------------------------
# health and the straggler ladder
# ---------------------------------------------------------------------------


def test_health_reports_and_injected_overlay():
    reports = check_devices(["cpu"])
    assert all_healthy(reports) and reports[0].reason is HealthReason.OK
    bad = DeviceHealth(device="3", ok=False, latency_s=0.1,
                       reason=HealthReason.CHECKSUM_MISMATCH, detail="x!=y")
    assert bad.error == "checksum_mismatch: x!=y"
    devs = [torch.device("cpu")]
    inj = FaultInjector.parse("tick=2,kind=fail,device=0")
    assert all(r.ok for r in inj.apply_health(check_devices(devs), devs, 1))
    rep = inj.apply_health(check_devices(devs), devs, 2)[0]
    assert not rep.ok and rep.reason is HealthReason.INJECTED
    assert inj.suspect_devices() == {0}


def test_health_reasons_match_reference(ref):
    assert [(r.name, r.value) for r in HealthReason] == \
        [(r.name, r.value) for r in ref["health"].HealthReason]


@pytest.mark.parametrize("kw,times", [
    (dict(window=8, warn_ratio=1.5, remesh_ratio=2.5, abort_ratio=5.0,
          sustained=2, min_window=2),
     [0.1, 0.1, 0.2, 0.2, 0.3, 0.6, 0.1, 0.2]),
    (dict(min_window=4, sustained=1, warn_ratio=1.1), [5.0, 0.1, 9.0, 0.1]),
    (dict(window=10, warn_ratio=1.5, remesh_ratio=2.5, abort_ratio=5.0,
          sustained=3), [1.0] * 10 + [2.0] * 4 + [3.0] * 4 + [9.0] * 4),
    (dict(window=32, warn_ratio=4.0, remesh_ratio=10.0, abort_ratio=100.0,
          sustained=3), [0.01] * 6 + [0.05] * 3 + [0.2] * 3 + [0.01] * 2)])
def test_straggler_ladder_matches_reference(ref, kw, times):
    """Synthetic step times through both monitors: the same reports."""
    port = StragglerMonitor(**kw)
    want = ref["straggler"].StragglerMonitor(**kw)
    for i, t in enumerate(times):
        a, b = port.observe(i, t), want.observe(i, t)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert list(port.times) == list(want.times)
    port.reset()
    assert port._over == 0 and len(port.times) == 0
    assert port.step_end(0).action == "ok"         # unpaired: tolerated


# ---------------------------------------------------------------------------
# fingerprints and bit flips, bit for bit
# ---------------------------------------------------------------------------


def _leaf(ref, dtype, shape, seed):
    """(reference array, port tensor) of the same values."""
    jnp = ref["jnp"]
    a = np.random.default_rng(seed).normal(size=shape) * 50
    if dtype == "bfloat16":
        r = jnp.asarray(a, jnp.bfloat16)
        p = torch.from_numpy(np.array(r.astype(jnp.float32))).to(
            torch.bfloat16)
        return r, p
    a = a.astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
def test_leaf_fingerprint_and_flip_match_reference(ref, dtype, monkeypatch):
    integ = ref["integrity"]
    r, p = _leaf(ref, dtype, (5, 7, 9), seed=1)
    want = int(ref["jax"].device_get(integ.leaf_fingerprint(r)))
    assert int(integrity.leaf_fingerprint(p)) == want
    assert integrity.host_leaf_fingerprint(np.asarray(r)) == \
        integ.host_leaf_fingerprint(np.asarray(r)) == want
    # the same leaf walked in 37-element chunks (nonzero offsets)
    monkeypatch.setattr(integrity, "CHUNK", 37)
    assert int(integrity.leaf_fingerprint(p)) == want
    width = integrity.bit_width(p.dtype)
    assert width == integ.bit_width(r.dtype)
    for flat, bit in ((0, 0), (100, width - 1), (314, 3)):
        rf = integ.flip_bit(r, flat, bit)
        pf = integrity.flip_bit(p, flat, bit)
        assert int(integrity.leaf_fingerprint(pf)) == int(
            ref["jax"].device_get(integ.leaf_fingerprint(rf))) != want
        np.testing.assert_array_equal(
            pf.float().numpy() if dtype == "bfloat16" else pf.numpy(),
            np.asarray(rf.astype(ref["jnp"].float32)) if dtype ==
            "bfloat16" else np.asarray(rf))
    assert int(integrity.leaf_fingerprint(p)) == want   # flip copied


def test_region_and_tree_fingerprints_match_reference(ref, monkeypatch):
    """A paged int8-pool-shaped tree (int8 payloads, int32 positions, f32
    scales) and a dense one: per-region fingerprints under counts, and the
    salted tree fingerprint, equal the reference's; walking in small
    chunks changes nothing."""
    jnp, integ = ref["jnp"], ref["integrity"]
    rng = np.random.default_rng(2)
    tree = [{"sub0": {
        "k": rng.integers(-128, 128, (2, 5, 4, 2, 3)).astype(np.int8),
        "v": rng.integers(-128, 128, (2, 5, 4, 2, 3)).astype(np.int8),
        "pos": rng.integers(-1, 9, (2, 5, 4)).astype(np.int32),
        "k_scale": rng.random((2, 5, 2)).astype(np.float32),
        "v_scale": rng.random((2, 5, 2)).astype(np.float32)}},
        {"sub0": {"k": rng.normal(size=(1, 5, 4, 2, 3)).astype(np.float32),
                  "pos": rng.integers(-1, 9, (1, 5, 4)).astype(np.int32)}}]
    counts = np.array([4, 2, 0, 3, 1], np.int32)
    rtree = ref["jax"].tree.map(jnp.asarray, tree)
    ptree = [{"sub0": {k: torch.from_numpy(v) for k, v in g["sub0"].items()}}
             for g in tree]
    want = np.asarray(integ.region_fingerprints(rtree, jnp.asarray(counts)))
    assert want[2] == 0
    got = integrity.region_fingerprints(ptree, torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    monkeypatch.setattr(integrity, "CHUNK", 20)
    np.testing.assert_array_equal(
        integrity.region_fingerprints(ptree, torch.from_numpy(counts))
        .numpy(), want.astype(np.int64))
    assert int(integrity.tree_fingerprint(ptree)) == int(
        integ.tree_fingerprint(rtree)) == integrity.host_tree_fingerprint(
            tree) == integ.host_tree_fingerprint(tree)
    # a flip past a region's count never alarms; within it, only it moves
    k = ptree[0]["sub0"]["k"]
    past = int(np.ravel_multi_index((0, 1, 3, 1, 2), k.shape))
    inside = int(np.ravel_multi_index((1, 3, 2, 0, 1), k.shape))
    integrity.flip_bit_(k, past, 5)
    np.testing.assert_array_equal(
        integrity.region_fingerprints(ptree, torch.from_numpy(counts))
        .numpy(), want.astype(np.int64))
    integrity.flip_bit_(k, inside, 7)
    moved = integrity.region_fingerprints(ptree,
                                          torch.from_numpy(counts)).numpy()
    assert [i for i in range(5) if moved[i] != want[i]] == [3]


def test_clear_regions_matches_reference(ref):
    jnp, integ = ref["jnp"], ref["integrity"]
    tree = {"k": np.ones((2, 4, 3), np.int8),
            "pos": np.full((2, 4, 3), 5, np.int32),
            "s": np.ones((2, 4), np.float32)}
    want = integ.clear_regions(ref["jax"].tree.map(jnp.asarray, tree),
                               jnp.asarray([1, 3]))
    got = integrity.clear_regions({k: torch.from_numpy(v.copy())
                                   for k, v in tree.items()},
                                  torch.tensor([1, 3]))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_runtime_params_fingerprint_matches_reference(ref):
    from repro_torch.bridge import params_from_reference
    jax = ref["jax"]
    rrt = ref["runtime"].Runtime.create(
        ref["configs"].get_smoke_config(ARCH).scaled(dtype=ref["jnp"]
                                                     .float32),
        shape_kind="decode", capacity=32)
    pcfg = _cfg()
    prt = PortRuntime.create(pcfg, capacity=32, device="cpu",
                             params=params_from_reference(
                                 jax.tree.map(np.asarray, rrt.params), pcfg))
    before = prt.params_fingerprint
    assert before == rrt.params_fingerprint == prt.params_fingerprint
    leaves = [prt.params["embed"]] if "embed" in prt.params else None
    assert leaves is not None
    prt.params = dict(prt.params, embed=integrity.flip_bit(
        prt.params["embed"], 3, 17))
    assert prt.params_fingerprint != before


# ---------------------------------------------------------------------------
# block pool quarantine, against the reference's pool
# ---------------------------------------------------------------------------


def _pool_trace(pool_cls):
    """One quarantine scenario; returns what it observed."""
    pool = pool_cls(num_blocks=8 + NUM_RESERVED, block_size=4, num_slots=2,
                    max_blocks_per_seq=4)
    out = []
    pool.admit(0, np.arange(8, dtype=np.int32), 2)
    victim = pool.chain(0)[0]
    pool.poison(victim)
    pool.release(0)
    out.append((victim in pool._free, sorted(pool.poisoned)))
    for s, L in ((0, 12), (1, 12)):
        pool.admit(s, np.arange(L, dtype=np.int32) + s, 3)
        out.append(pool.chain(s))
    out.append(pool.scrub_poisoned())
    out.append((pool.poisoned_total, pool.scrubbed_total,
                pool.alloc_gen.tolist(), repr(pool)))
    pool.release(0)
    pool.release(1)
    pool.admit(0, np.arange(8, dtype=np.int32), 2)
    pool.release(0)
    key_victim = next(iter(pool._key_of))
    pool.poison(key_victim)
    pool.admit(1, np.arange(8, dtype=np.int32), 2)
    out.append((key_victim, pool.chain(1), repr(pool)))
    pool.release(1)
    pool.drop_prefix_cache()
    out.append((len(pool._cached), len(pool._key_of), pool.free_blocks))
    return out


def test_pool_quarantine_matches_reference(ref):
    got = _pool_trace(BlockPool)
    assert got == _pool_trace(ref["blockpool"].BlockPool)
    victim = got[0][1][0]
    assert not got[0][0] and victim not in got[1] + got[2]
    assert got[3] == [victim]


# ---------------------------------------------------------------------------
# the engine under faults: the reference engine's streams and events
# ---------------------------------------------------------------------------


PLAN = ("tick=2,kind=raise;tick=4,kind=corrupt,target=kv,seed=5;"
        "tick=6,kind=corrupt,target=collective,seed=2;"
        "tick=7,kind=corrupt,target=params,seed=9;tick=9,kind=raise,times=3")


@pytest.mark.parametrize("kv_layout,kv_dtype", [
    ("dense", "f32"), ("paged", "f32"), ("paged", "int8")])
def test_engine_faults_match_reference(ref, kv_layout, kv_dtype):
    """A transient raise absorbed by retry, a kv flip, a payload flip, a
    params flip and a retry exhaustion that evacuates, scrubbing every
    tick: the port engine's streams, ``ft`` events (flip targets, detected
    regions, replayed and evacuated rids) and counters equal the
    reference engine's, which equal a clean run's."""
    from repro_torch.bridge import params_from_reference
    jax, jnp = ref["jax"], ref["jnp"]
    kv = dict(kv_layout=kv_layout, kv_dtype=kv_dtype)
    rrt = ref["runtime"].Runtime.create(
        ref["configs"].get_smoke_config(ARCH).scaled(dtype=jnp.float32),
        shape_kind="decode", capacity=32, **kv)
    pcfg = _cfg()
    prt = PortRuntime.create(pcfg, capacity=32, device="cpu",
                             params=params_from_reference(
                                 jax.tree.map(np.asarray, rrt.params), pcfg),
                             **kv)
    ekw = dict(block_size=8) if kv_layout == "paged" else {}
    reng = rrt.engine(num_slots=2, scrub_every=1,
                      injector=ref["inject"].FaultInjector.parse(PLAN),
                      retry_backoff_s=0.001, straggler_kw=NO_STRAGGLER,
                      **ekw)
    for r in _stream(pcfg, ref["engine"].Request):
        reng.submit(r)
    reng.run_to_completion()
    peng = _run(plan=PLAN, scrub=1, rt=prt)
    clean = _run(rt=prt)
    assert _tokens(peng) == _tokens(reng) == _tokens(clean)

    def events(eng):
        return [{k: v for k, v in e.items() if k in EVENT_KEYS}
                for e in eng.ft_events]
    assert events(peng) == events(reng)
    kinds = [e["event"] for e in peng.ft_events]
    assert kinds.count("corrupt_inject") == 3 and kinds.count("evacuate") == 1
    assert peng.stats.summary == reng.stats.summary
    assert peng.stats.params_restores == peng.stats.transfer_retries == 1
    if kv_layout == "paged":
        assert peng.pool.poisoned == set()
        # the pool the evacuation rebuilt holds nothing quarantined
        assert peng.pool.scrubbed_total == peng.pool.poisoned_total
    assert peng.stats.kv_quarantined > 0


# ---------------------------------------------------------------------------
# the port engine's recovery paths against a clean port run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
@pytest.mark.parametrize("target,scrub", [
    ("kv", 1), ("params", 2), ("collective", 1)])
def test_corruption_detected_and_replayed(kv_layout, target, scrub):
    base = _tokens(_run(kv_layout=kv_layout))
    eng = _run(kv_layout=kv_layout, scrub=scrub,
               plan=f"tick=3,kind=corrupt,target={target},seed=5")
    s = eng.stats
    assert all(f.fired for f in eng.injector.faults), "fault never applied"
    assert s.corruption_detected >= 1
    detections = [e for e in eng.ft_events if e["event"] == "corruption"]
    assert detections and all(e["detect_latency_ticks"] <= scrub
                              for e in detections)
    assert _tokens(eng) == base
    if target == "kv":
        assert s.kv_quarantined >= 1 and s.streams_replayed >= 1
    if target == "params":
        assert s.params_restores == 1 and s.streams_replayed >= 1
    if target == "collective":
        assert s.transfer_retries == 1 and s.streams_replayed == 0


def test_scheduler_mode_corruption_and_evacuation():
    kw = dict(kv_layout="paged", kv_dtype="int8")
    cfg = _cfg()
    rt = PortRuntime.create(cfg, capacity=32, device="cpu", scheduler=True,
                            sched_kw=dict(token_budget=16, chunk_size=8),
                            **kw)
    base = _tokens(_run(rt=rt))
    eng = _run(rt=rt, scrub=1,
               plan="tick=3,kind=corrupt,target=kv,seed=5;"
                    "tick=5,kind=raise,times=3")
    assert _tokens(eng) == base
    assert eng.stats.corruption_detected >= 1
    assert eng.stats.evacuations == 1


def test_params_corruption_caught_by_health_gate():
    base = _tokens(_run())
    eng = _run(scrub=50, health_every=2,
               plan="tick=3,kind=corrupt,target=params,seed=9")
    assert _tokens(eng) == base
    assert eng.stats.params_restores == 1 and eng.stats.evacuations == 0
    assert any(e["event"] == "health" and any(
        f.get("reason") == "data_corruption" for f in e["failed"])
        for e in eng.ft_events)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_retry_and_evacuation_keep_streams(kv_layout):
    base = _tokens(_run(kv_layout=kv_layout))
    eng = _run(kv_layout=kv_layout, plan="tick=3,kind=raise")
    assert eng.stats.tick_retries == 1 and eng.stats.evacuations == 0
    assert _tokens(eng) == base
    eng = _run(kv_layout=kv_layout, plan="tick=4,kind=raise,times=3")
    assert eng.stats.evacuations == 1 and _tokens(eng) == base
    ev = next(e for e in eng.ft_events if e["event"] == "evacuate")
    assert ev["mesh"] is None and ev["replayed"]
    if kv_layout == "paged":
        assert ev["kv_chains"] and all(ev["kv_chains"].values())
        assert eng.pool.used_blocks == 0


def test_health_gated_evacuation():
    base = _tokens(_run())
    eng = _run(plan="tick=2,kind=fail,device=0,times=1", health_every=2)
    assert eng.stats.health_checks >= 1 and eng.stats.evacuations == 1
    assert _tokens(eng) == base
    ev = next(e for e in eng.ft_events if e["event"] == "health")
    assert ev["failed"][0]["reason"] == HealthReason.INJECTED.value


def test_stall_fault_walks_straggler_ladder():
    """Stalls of a second each against CPU ticks of milliseconds: no load
    on the machine can hide them from the ladder."""
    base = _tokens(_run())
    eng = _run(plan="tick=6,kind=stall,ms=1000,times=2",
               straggler_kw=dict(window=16, warn_ratio=2.5,
                                 remesh_ratio=4.0, abort_ratio=1e9,
                                 sustained=2, min_window=2))
    assert eng.stats.evacuations >= 1
    assert _tokens(eng) == base
    acts = [e["action"] for e in eng.ft_events if e["event"] == "straggler"]
    assert "remesh" in acts


def test_repeated_evacuation_gives_up():
    rt = PortRuntime.create(_cfg(), capacity=32, device="cpu")
    eng = rt.engine(num_slots=2, tick_retries=0, retry_backoff_s=0.0,
                    max_evacuations=2, straggler_kw=NO_STRAGGLER,
                    injector=FaultInjector.parse("tick=1,kind=raise,"
                                                 "times=1000"))
    for r in _stream(_cfg()):
        eng.submit(r)
    with pytest.raises(RuntimeError, match="giving up after 2 evacuations"):
        eng.run_to_completion()


def test_engine_injector_defaults_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FAULT_PLAN", "tick=3,kind=raise")
    assert _run().stats.tick_retries == 0        # injector=None disables
    rt = PortRuntime.create(_cfg(), capacity=32, device="cpu")
    eng = rt.engine(num_slots=2)
    assert eng.injector is not None and eng.injector.faults[0].kind == "raise"
    assert "fault_plan=tick=3,kind=raise" in rt.describe()


def test_scrub_rejects_swa_arch():
    """The reference refuses ``scrub_every`` on a sliding-window arch with
    a ``ValueError``; the port's engine guard, exercised here through the
    capability (tests/test_torch_moe.py builds mixtral-8x7b itself)."""
    rt = PortRuntime.create(_cfg(), capacity=32, device="cpu")
    rt.caps = dataclasses.replace(rt.caps, swa=True)
    with pytest.raises(ValueError, match="sliding-window"):
        rt.engine(num_slots=2, scrub_every=1)


def test_mesh_requests_raise_naming_their_item():
    rt = PortRuntime.create(_cfg(), capacity=32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        rt.reshape(mesh="2x4")
    desc = rt.describe()
    assert "ft        :" in desc and "evac(lose-1)" in desc \
        and "item 12" in desc
    params, tel = rt.params, rt.telemetry()
    back = rt.reshape(capacity=64, kv_layout="paged")
    assert back.capacity == 64 and back.params is params
    assert back.telemetry() is tel
