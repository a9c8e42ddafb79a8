"""The port's checkpoints, engine snapshots and launchers
(``repro_torch.checkpoint``, ``launch.train --ckpt-dir``,
``launch.serve``) against the JAX reference, on the CPU.

Each package reads the other's checkpoints: the same tree written by
either gives the same manifest (paths, file names, shapes, dtypes,
CRC32s) and loads back bit for bit on the other side, bf16 leaves, the
optimizer's step count and a train state's NamedTuple paths included.
``EngineSnapshot`` files cross the same way: a snapshot the reference
engine takes mid-run resumes in a port engine and finishes every stream
as an uninterrupted run does.  The train launcher restarts from its own
checkpoint and reproduces the first run's losses exactly; the serve
launcher runs the fault-tolerance flags end to end.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import serialize
from repro_torch.checkpoint.manager import CheckpointManager, EngineSnapshot
from repro_torch.checkpoint.serialize import (ChecksumError, load_pytree,
                                              save_pytree)
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.launch.train import train_loop
from repro_torch.optim.adamw import OptState
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve.engine import Request
from repro_torch.train.state import TrainState

ARCH = "llama3.2-3b"
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import repro.checkpoint.manager
    import repro.checkpoint.serialize
    import repro.configs
    import repro.optim.adamw
    import repro.runtime
    import repro.serve.engine
    import repro.train.state
    return {"jax": jax, "jnp": jax.numpy,
            "serialize": repro.checkpoint.serialize,
            "manager": repro.checkpoint.manager, "configs": repro.configs,
            "adamw": repro.optim.adamw, "runtime": repro.runtime,
            "engine": repro.serve.engine, "state": repro.train.state}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "c": np.arange(10, dtype=np.int32),
            "d": rng.normal(size=(3, 5)).astype(np.float32),
            "l0": np.ones(3, np.float32), "l1": rng.normal(size=(2, 2))
            .astype(np.float32)}


def _port_tree(seed=0):
    a = _arrays(seed)
    return {"a": torch.from_numpy(a["a"]),
            "b": {"c": torch.from_numpy(a["c"]),
                  "d": torch.from_numpy(a["d"]).to(torch.bfloat16)},
            "lst": [torch.from_numpy(a["l0"]), torch.from_numpy(a["l1"])]}


def _ref_tree(ref, seed=0):
    jnp, a = ref["jnp"], _arrays(seed)
    return {"a": jnp.asarray(a["a"]),
            "b": {"c": jnp.asarray(a["c"]),
                  "d": jnp.asarray(a["d"]).astype(jnp.bfloat16)},
            "lst": [jnp.asarray(a["l0"]), jnp.asarray(a["l1"])]}


def _port_state(seed=0):
    """A bf16 mixed-precision train state: bf16 params, f32 moments and
    master, an int step count."""
    a = _arrays(seed)
    p = {"w": torch.from_numpy(a["a"]).to(torch.bfloat16),
         "norm": [torch.from_numpy(a["l0"])]}
    f32 = {"w": torch.from_numpy(a["a"]), "norm": [torch.from_numpy(a["l0"])]}
    return TrainState(p, OptState(mu=f32, nu={k: v for k, v in f32.items()},
                                  count=7, master=f32))


def _ref_state(ref, seed=0):
    jnp, a = ref["jnp"], _arrays(seed)
    f32 = {"w": jnp.asarray(a["a"]), "norm": [jnp.asarray(a["l0"])]}
    p = {"w": f32["w"].astype(jnp.bfloat16), "norm": [f32["norm"][0]]}
    return ref["state"].TrainState(
        p, ref["adamw"].OptState(mu=f32, nu=f32, count=jnp.int32(7),
                                 master=f32), ())


def _flat_numpy(tree):
    """path -> numpy array (bf16 as f32) of either package's tree."""
    out = {}
    for path, leaf in serialize.flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
                else leaf.numpy()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
        out["/".join(path)] = arr
    return out


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    t = _port_tree()
    save_pytree(str(tmp_path / "ck"), t, step=5)
    back = load_pytree(str(tmp_path / "ck"), t)
    for (pa, a), (pb, b) in zip(serialize.flatten_with_path(t),
                                serialize.flatten_with_path(back)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)
    state = _port_state()
    save_pytree(str(tmp_path / "st"), state, step=1)
    back = load_pytree(str(tmp_path / "st"), state)
    assert isinstance(back, TrainState) and back.opt.count == 7
    assert back.opt.master["w"].dtype == torch.float32
    assert torch.equal(back.params["w"], state.params["w"])


def test_load_rejects_shape_mismatch_and_missing_leaf(tmp_path):
    t = _port_tree()
    save_pytree(str(tmp_path / "ck"), t, step=0)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "ck"), dict(t, a=torch.zeros(4, 16)))
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(str(tmp_path / "ck"), dict(t, z=torch.zeros(1)))


def test_checkpoint_crc_detects_rot_and_old_format_loads(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(4)}
    d = str(tmp_path / "step_000000001")
    save_pytree(d, tree, step=1)
    man = serialize.load_manifest(d)
    assert all("crc32" in m for m in man["leaves"].values())
    path = os.path.join(d, man["leaves"]["w"]["file"])
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0x40
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ChecksumError, match="'w'"):
        load_pytree(d, tree)
    d2 = str(tmp_path / "step_000000002")
    save_pytree(d2, tree, step=2)
    mpath = os.path.join(d2, "MANIFEST.json")
    man = json.load(open(mpath))
    for meta in man["leaves"].values():
        meta.pop("crc32")
    json.dump(man, open(mpath, "w"))
    assert torch.equal(load_pytree(d2, tree)["w"], tree["w"])


@pytest.mark.parametrize("kind", ["tree", "train_state"])
def test_checkpoints_cross_packages(ref, tmp_path, kind):
    """The same values written by each package: identical manifests, and
    each package loads the other's checkpoint bit for bit."""
    rs = ref["serialize"]
    port = _port_tree() if kind == "tree" else _port_state()
    want = _ref_tree(ref) if kind == "tree" else _ref_state(ref)
    pdir, rdir = str(tmp_path / "port"), str(tmp_path / "ref")
    save_pytree(pdir, port, step=3, extra_meta={"who": "x"})
    rs.save_pytree(rdir, want, step=3, extra_meta={"who": "x"})
    assert serialize.load_manifest(pdir) == rs.load_manifest(rdir)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(rdir))
    by_ref = rs.load_pytree(pdir, want)             # reference reads port
    by_port = load_pytree(rdir, port)               # port reads reference
    expect = _flat_numpy(port)
    for got in (_flat_numpy(by_ref), _flat_numpy(by_port)):
        assert got.keys() == expect.keys()
        for k in expect:
            np.testing.assert_array_equal(got[k], expect[k], err_msg=k)
    if kind == "train_state":
        assert by_port.opt.count == 7 and isinstance(by_port.opt.count, int)
        assert by_port.params["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------


def test_manager_rotation_async_and_crash_safety(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), save_every=1, keep=2,
                            async_save=False)
    state = _port_tree()
    for step in range(5):
        state["a"] += 1            # in place, as the port's train step
        mgr.maybe_save(step, state)
    assert mgr.checkpoints() == [3, 4]
    restored, step = mgr.restore_latest(state)
    assert step == 4 and torch.equal(restored["a"], state["a"])
    amgr = CheckpointManager(str(tmp_path / "a"), save_every=2, keep=3)
    t = _port_tree()
    assert amgr.maybe_save(0, t) and not amgr.maybe_save(1, t)
    before = t["a"].clone()
    t["a"] += 5                    # after the save returned: not captured
    amgr.wait()
    back, _ = amgr.restore_latest(t)
    assert torch.equal(back["a"], before)
    os.makedirs(tmp_path / "a" / "step_000000099.tmp")
    os.makedirs(tmp_path / "a" / "step_000000042")
    assert amgr.checkpoints() == [0]
    assert CheckpointManager(str(tmp_path / "e")).restore_latest(t) == \
        (None, -1)


# ---------------------------------------------------------------------------
# engine snapshots
# ---------------------------------------------------------------------------


def _cfg():
    return port_smoke(ARCH).scaled(dtype=torch.float32)


def _stream(cfg, request_cls=Request, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [request_cls(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=int(rng.integers(3, 14)),
                                            dtype=np.int32),
                        max_new_tokens=int(rng.integers(4, 9)))
            for i in range(n)]


def _tokens(eng):
    return {r.rid: list(r.generated) for r in eng.finished}


def test_engine_snapshot_file_format_matches_reference(ref, tmp_path):
    rsnap = ref["manager"].EngineSnapshot
    snap = EngineSnapshot(requests=[{"rid": 1, "prompt": [1, 2, 3],
                                     "generated": [7], "max_new_tokens": 4,
                                     "eos_id": -1, "priority": 0}],
                          stats={"ticks": 3}, meta={"arch": ARCH})
    d = snap.save(str(tmp_path / "port"))
    rd = rsnap(**vars(snap)).save(str(tmp_path / "ref"))
    name = "ENGINE_SNAPSHOT.json"
    assert open(os.path.join(d, name)).read() == \
        open(os.path.join(rd, name)).read()
    assert vars(rsnap.load(d)) == vars(snap)
    assert vars(EngineSnapshot.load(rd)) == vars(snap)
    doc = json.load(open(os.path.join(d, name)))
    doc["payload"] = doc["payload"].replace('"rid":1', '"rid":2')
    json.dump(doc, open(os.path.join(d, name), "w"))
    with pytest.raises(ChecksumError, match="snapshot is corrupt"):
        EngineSnapshot.load(d)
    legacy = str(tmp_path / "legacy")
    os.makedirs(legacy)
    with open(os.path.join(legacy, name), "w") as f:
        json.dump({"requests": [{"rid": 9}], "stats": {}, "meta": {}}, f)
    assert EngineSnapshot.load(legacy).requests[0]["rid"] == 9
    with pytest.raises(FileNotFoundError, match="no engine snapshot"):
        EngineSnapshot.load(str(tmp_path / "nope"))


@pytest.mark.parametrize("kv", [{}, dict(kv_layout="paged")])
def test_engine_snapshot_roundtrip(tmp_path, kv):
    cfg = _cfg()
    rt = PortRuntime.create(cfg, capacity=32, device="cpu", **kv)
    ekw = dict(straggler_kw=NO_STRAGGLER, injector=None,
               **(dict(block_size=8) if kv else {}))
    clean = rt.engine(num_slots=2, **ekw)
    for r in _stream(cfg):
        clean.submit(r)
    clean.run_to_completion()
    eng = rt.engine(num_slots=2, **ekw)
    for r in _stream(cfg):
        eng.submit(r)
    for _ in range(4):
        eng.tick()
    snap = eng.snapshot()
    assert snap.requests and snap.meta["arch"] == cfg.name
    back = EngineSnapshot.load(snap.save(str(tmp_path / "snap")))
    eng2 = rt.engine(num_slots=2, **ekw)
    assert eng2.load_snapshot(back) == len(back.requests)
    eng2.run_to_completion()
    merged = _tokens(eng)
    merged.update(_tokens(eng2))
    assert merged == _tokens(clean) and len(merged) == 5
    busy = rt.engine(num_slots=2, **ekw)
    busy.submit(_stream(cfg)[0])
    with pytest.raises(RuntimeError, match="idle engine"):
        busy.load_snapshot(EngineSnapshot())
    with pytest.raises(ValueError, match="arch"):
        rt.engine(num_slots=2, **ekw).load_snapshot(
            EngineSnapshot(meta={"arch": "other-arch"}))


def test_reference_snapshot_resumes_in_port_engine(ref, tmp_path):
    """A snapshot the reference engine takes mid-run, saved by the
    reference, loads into a port engine (the reference's params carried
    over), which finishes every stream as the uninterrupted reference run
    does."""
    from repro_torch.bridge import params_from_reference
    jax = ref["jax"]
    rrt = ref["runtime"].Runtime.create(
        ref["configs"].get_smoke_config(ARCH).scaled(
            dtype=ref["jnp"].float32), shape_kind="decode", capacity=32)
    pcfg = _cfg()
    prt = PortRuntime.create(pcfg, capacity=32, device="cpu",
                             params=params_from_reference(
                                 jax.tree.map(np.asarray, rrt.params), pcfg))
    RReq = ref["engine"].Request
    clean = rrt.engine(num_slots=2, injector=None, straggler_kw=NO_STRAGGLER)
    for r in _stream(pcfg, RReq):
        clean.submit(r)
    clean.run_to_completion()
    reng = rrt.engine(num_slots=2, injector=None, straggler_kw=NO_STRAGGLER)
    for r in _stream(pcfg, RReq):
        reng.submit(r)
    for _ in range(5):
        reng.tick()
    path = reng.snapshot().save(str(tmp_path / "snap"))
    peng = prt.engine(num_slots=2, injector=None, straggler_kw=NO_STRAGGLER)
    peng.load_snapshot(EngineSnapshot.load(path))
    peng.run_to_completion()
    merged = _tokens(reng)
    merged.update(_tokens(peng))
    assert merged == _tokens(clean)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_restart_reproduces_losses(tmp_path, capsys):
    """Four bf16 steps saving every two, then a restart from the step-2
    checkpoint (the state after step 2; steps count from 0 and save where
    ``step % save_every == 0``, as the reference's loop does): the resumed
    step's loss, and the final state, equal the first run's exactly."""
    kw = dict(steps=4, global_batch=2, seq_len=16, save_every=2,
              param_dtype=torch.bfloat16, device="cpu")
    d = str(tmp_path / "ck")
    cfg = port_smoke("exanode-100m")
    state, first = train_loop(cfg, ckpt_dir=d, **kw)
    assert CheckpointManager(d).checkpoints() == [0, 2, 3]
    import shutil
    shutil.rmtree(os.path.join(d, "step_000000003"))
    state2, second = train_loop(cfg, ckpt_dir=d, **kw)
    assert "restored checkpoint @ step 2" in capsys.readouterr().out
    assert [r["step"] for r in second] == [3]
    assert second[0]["loss"] == first[3]["loss"]
    assert second[0]["grad_norm"] == first[3]["grad_norm"]
    for a, b in zip(_flat_numpy(state).values(),
                    _flat_numpy(state2).values()):
        np.testing.assert_array_equal(a, b)


def test_serve_launcher_fault_flags(tmp_path):
    ev, met, tr = (str(tmp_path / n) for n in
                   ("ev.jsonl", "m.json", "trace.json"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "exanode-100m", "--smoke", "--requests", "4", "--max-new", "5",
           "--slots", "2", "--capacity", "32", "--device", "cpu",
           "--kv-layout", "paged", "--scrub-every", "1", "--health-every",
           "2", "--fault-plan",
           "tick=4,kind=corrupt,target=kv,seed=7;tick=3,kind=raise",
           "--events-out", ev, "--metrics-out", met, "--trace-out", tr]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "finished=4" in r.stdout and "corruption_detected=1" in r.stdout
    kinds = [json.loads(ln)["event"] for ln in open(ev)]
    assert kinds[:1] == ["tick_retry"] and "corruption" in kinds
    assert json.load(open(met))["serve_engine_finished_total"] == 4
    assert any(e["name"] == "tick" for e in
               json.load(open(tr))["traceEvents"])
    for flag, item in (("--mesh=2x4", "item 9"), ("--burn-in", "item 12")):
        r = subprocess.run(cmd[:3] + [flag, "--device", "cpu"], env=env,
                           cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode != 0 and item in r.stderr
