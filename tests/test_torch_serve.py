"""The PyTorch port's serving path against the JAX reference, on the CPU.

The same parameters (the reference's ``init_params`` carried over by
``repro_torch.bridge``) and the same seeded inputs go through both
packages in f32; the port runs the plain PyTorch versions of its kernels
here.  Tolerances are the reference's own: logits <= 1e-3, identical
greedy token streams.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.models.attention import write_kv
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve.engine import Request as PortRequest

ARCHS = ["exanode-100m", "llama3.2-3b"]
LOGITS_TOL = 1e-3

# never-firing straggler thresholds: a slow tick on a loaded machine
# must not evacuate and replay a stream these tests pin
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.models.common
    import repro.runtime
    import repro.serve.engine
    return {"jax": jax, "configs": repro.configs,
            "common": repro.models.common, "runtime": repro.runtime,
            "engine": repro.serve.engine}


def _pair(ref, arch, capacity=32):
    """(reference Runtime, port Runtime) on the f32 smoke config with the
    reference's seeded params on both sides."""
    jnp = ref["jax"].numpy
    rcfg = ref["configs"].get_smoke_config(arch).scaled(dtype=jnp.float32)
    rrt = ref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                        capacity=capacity)
    tree = ref["jax"].tree.map(np.asarray, rrt.params)
    pcfg = port_smoke(arch).scaled(dtype=torch.float32)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(tree, pcfg))
    return rrt, prt


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape, dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_leaf_count_and_shapes(ref, arch):
    rrt, prt = _pair(ref, arch)
    leaves = tree_leaves(prt.params)
    assert len(leaves) == len(ref["jax"].tree.leaves(rrt.params)) == 11
    for a, b in zip(leaves, ref["jax"].tree.leaves(rrt.params)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    L = prt.cfg.num_layers
    wq = prt.params["groups"][0]["sub0"]["attn"]["wq"]
    assert tuple(wq.shape) == (L, prt.cfg.d_model, prt.cfg.num_heads,
                               prt.cfg.head_dim)


def test_bridge_rejects_mismatched_tree(ref):
    rrt, prt = _pair(ref, "exanode-100m")
    tree = ref["jax"].tree.map(np.asarray, rrt.params)
    with pytest.raises(ValueError, match="do not match"):
        params_from_reference(tree, port_smoke("llama3.2-3b").scaled(
            d_model=32, dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(ref, arch):
    rrt, prt = _pair(ref, arch)
    from repro.models.registry import model_forward as ref_forward
    from repro_torch.models.registry import model_forward
    toks = _tokens(prt.cfg, (2, 24), seed=1)
    want, _ = ref_forward(rrt.params, {"tokens": ref["jax"].numpy.asarray(
        toks)}, rrt.cfg)
    got = model_forward(prt.params, torch.from_numpy(toks), prt.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_TOL, rtol=0)


def test_prefill_step_matches_reference(ref):
    """Right-padded batched prefill: next tokens identical, caches (K/V
    and positions, pad entries invalidated) within tolerance."""
    jax, jnp = ref["jax"], ref["jax"].numpy
    rrt, prt = _pair(ref, "exanode-100m", capacity=24)
    lens = np.array([5, 16, 11, 1], np.int32)
    toks = _tokens(prt.cfg, (4, 16), seed=2)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    want_tok, want = jax.jit(rrt.make_prefill_step())(
        rrt.params, {"tokens": jnp.asarray(toks),
                     "lengths": jnp.asarray(lens)})
    got_tok, got = prt.make_prefill_step()(
        prt.params, {"tokens": torch.from_numpy(toks),
                     "lengths": torch.from_numpy(lens)})
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    w, g = want[0]["sub0"], got[0]["sub0"]
    np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
    for name in ("k", "v"):
        assert tuple(g[name].shape) == w[name].shape
        np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]),
                                   atol=1e-5, rtol=1e-5)


def test_decode_logits_match_reference_per_tick(ref):
    jnp = ref["jax"].numpy
    rrt, prt = _pair(ref, "exanode-100m", capacity=16)
    toks = _tokens(prt.cfg, (2, 6), seed=3)
    r_logits, r_caches = rrt.prefill({"tokens": jnp.asarray(toks)},
                                     last_only=True)
    p_logits, p_caches = prt.prefill(torch.from_numpy(toks), last_only=True)
    pos = np.full(2, 6, np.int32)
    for tick in range(5):
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   atol=LOGITS_TOL, rtol=0,
                                   err_msg=f"tick {tick}")
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        r_logits, r_caches = rrt.decode_step(jnp.asarray(nxt), r_caches,
                                             jnp.asarray(pos))
        p_logits = prt.decode_step(torch.from_numpy(nxt), p_caches,
                                   torch.from_numpy(pos))
        pos = pos + 1


def _flip_margin(prt, prompt, stream, j) -> float:
    """Top-2 logit margin of the port's own model at the position where
    ``stream[j]`` was sampled."""
    from repro_torch.models.registry import model_forward
    ctx = np.concatenate([prompt, np.asarray(stream[:j], np.int32)])
    logits = model_forward(prt.params, torch.from_numpy(ctx)[None], prt.cfg)
    top = torch.topk(logits[0, -1, :prt.cfg.vocab_size], 2).values
    return float(top[0] - top[1])


def test_engine_token_streams_match_reference(ref):
    """Mixed prompt lengths (several admission buckets), more requests than
    slots (slot churn) and one request that runs past the capacity: the
    port's engine emits the reference engine's greedy streams."""
    rrt, prt = _pair(ref, "exanode-100m", capacity=32)
    rng = np.random.default_rng(4)
    specs = [(int(rng.integers(2, 20)), int(rng.integers(1, 9)))
             for _ in range(9)] + [(28, 10)]       # 28 + 10 > capacity
    reqs = [(i, _tokens(prt.cfg, n, seed=100 + i), m)
            for i, (n, m) in enumerate(specs)]

    def run(engine, request_cls):
        for i, p, m in reqs:
            engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=m))
        engine.run_to_completion()
        return {r.rid: list(r.generated) for r in engine.finished}

    want = run(rrt.engine(num_slots=3, injector=None,
                          straggler_kw=NO_STRAGGLER),
               ref["engine"].Request)
    port = prt.engine(num_slots=3, straggler_kw=NO_STRAGGLER)
    got = run(port, PortRequest)
    assert port.stats.prefill_calls > 1 and port.stats.finished == len(reqs)
    for i, p, m in reqs:
        assert len(got[i]) == m
        if got[i] != want[i]:
            j = next(k for k, (a, b) in enumerate(zip(got[i], want[i]))
                     if a != b)
            pytest.fail(f"rid {i}: first divergence at token {j} "
                        f"(port {got[i][j]}, reference {want[i][j]}); port "
                        f"logit margin there "
                        f"{_flip_margin(prt, p, got[i], j):.3g}")


def test_write_past_capacity_is_dropped():
    """The engine keeps advancing positions on slots that run past the
    cache; such writes are dropped (JAX drops an out-of-bounds scatter;
    torch indexing would raise)."""
    B, T, KV, Dh = 3, 4, 2, 8
    k = torch.zeros(B, T, KV, Dh)
    v = torch.zeros(B, T, KV, Dh)
    kv_pos = torch.full((B, T), -1, dtype=torch.int32)
    new = torch.ones(B, KV, Dh)
    widx = torch.tensor([1, T, T + 7], dtype=torch.int32)
    write_kv(k, v, kv_pos, new, 2 * new, widx, widx)
    assert k[0, 1].eq(1).all() and v[0, 1].eq(2).all()
    assert kv_pos.tolist() == [[-1, 1, -1, -1]] + [[-1] * T] * 2
    assert k[1:].eq(0).all() and v[1:].eq(0).all()


def test_engine_slot_past_capacity_finishes():
    prt = PortRuntime.create("exanode-100m", smoke=True, capacity=16,
                             device="cpu")
    eng = prt.engine(num_slots=2)
    eng.submit(PortRequest(rid=0, prompt=_tokens(prt.cfg, 14, seed=5),
                           max_new_tokens=12))
    eng.submit(PortRequest(rid=1, prompt=_tokens(prt.cfg, 3, seed=6),
                           max_new_tokens=4))
    stats = eng.run_to_completion()
    assert stats.finished == 2
    assert sorted(len(r.generated) for r in eng.finished) == [4, 12]


def test_runtime_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortRuntime.create("exanode-100m", smoke=True)


def test_out_of_slice_requests_raise():
    cfg = port_smoke("exanode-100m")
    # GeGLU and scaled embeddings are ported (tests/test_torch_dense.py);
    # a frontend and learned positions are not
    for bad in (cfg.scaled(sliding_window=8),
                cfg.scaled(frontend="vision_stub", frontend_len=4),
                cfg.scaled(attn_logit_softcap=30.0),
                cfg.scaled(pos_emb="learned", max_position_embeddings=64)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PortRuntime.create(bad, device="cpu")
    rt = PortRuntime.create("exanode-100m", smoke=True, device="cpu")
    # the fault layer is ported (tests/test_torch_ft.py); a mesh is not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.reshape(mesh="2x4")
    for kw in ({"health_every": 1}, {"scrub_every": 2}):
        eng = rt.engine(**kw)
        assert (eng.health_every, eng.scrub_every) == (
            kw.get("health_every", 0), kw.get("scrub_every", 0))
    # the chunked-prefill scheduler is ported (tests/test_torch_sched.py)
    assert rt.engine(scheduler=True).sched is not None


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port imports in a fresh interpreter without
    pulling in ``jax`` or any ``repro`` module."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
