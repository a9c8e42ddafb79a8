"""The PyTorch port's chunked-prefill scheduler against the JAX reference, on
the CPU.

* The scheduler's policy (host code): the same sequences of calls on the
  port's ``Scheduler`` and the reference's give the same selections,
  grants, ages and stats (mirroring tests/test_scheduler.py:53-153).
* The int8 pool write with a chunk's [1, C] write blocks (repeats,
  offset-0 clears, trash writes) against the reference's
  ``_quantized_block_write``, bit for bit.
* The chunk append (dense, paged f32 and int8) against the reference's
  ``attention_chunk_append{,_paged}`` at 1e-5, and ``model_chunk_prefill``
  at the reference's logits bound 1e-3; int8 payloads within one code and
  scales at 1e-6 relative (the projections may differ in the last bit).
* The engine on exanode-100m smoke (f32, capacity 64, 2 slots): the
  scheduler's streams equal the port's own monolithic streams (dense,
  paged) and the reference scheduler engine's (dense, paged, int8).  The
  int8 pool is not held to monolithic admission: that quantizes each
  (block, kv head) tile once over all its entries, while the chunk path
  grows the scale entry by entry and requantizes, two roundings of the
  same values.

Parameters come from the reference (``repro_torch.bridge``), inputs from
numpy seeds; JAX is pinned to the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.kernels import ref as port_ref
from repro_torch.models import attention as pattn
from repro_torch.models.registry import model_chunk_prefill, model_forward
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import blockpool as pbp
from repro_torch.serve import kvcache as pkv
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.scheduler import Scheduler as PortScheduler

ARCH = "exanode-100m"
OUT_TOL = 1e-5
LOGITS_TOL = 1e-3
SCALE_RTOL = 1e-6
# a greedy token may differ between the frameworks only where the f32
# top-2 logit margin is below this
FLIP_MARGIN = 1e-4
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)
PAD_POS = pattn.PAD_POS
TRASH = pbp.TRASH_BLOCK


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads for this file: its small shapes gain little from
    more, and the test workers beside it share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.kernels.quant
    import repro.models.attention
    import repro.models.registry
    import repro.runtime
    import repro.serve.blockpool
    import repro.serve.engine
    import repro.serve.kvcache
    import repro.serve.scheduler
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "quant": repro.kernels.quant,
            "attention": repro.models.attention,
            "registry": repro.models.registry, "runtime": repro.runtime,
            "blockpool": repro.serve.blockpool,
            "engine": repro.serve.engine, "kvcache": repro.serve.kvcache,
            "scheduler": repro.serve.scheduler}


def _cfgs(jref):
    rcfg = jref["configs"].get_smoke_config(ARCH).scaled(
        dtype=jref["jnp"].float32)
    return rcfg, port_smoke(ARCH).scaled(dtype=torch.float32)


def _params(jref, rcfg, pcfg):
    """(reference params, port params): the reference's seeded init."""
    rrt = jref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                         capacity=32)
    tree = jref["jax"].tree.map(np.asarray, rrt.params)
    return rrt.params, params_from_reference(tree, pcfg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# -- 1. the scheduler's policy ------------------------------------------------


class _Req:
    """The attributes the scheduler reads from a request."""

    def __init__(self, rid, priority=0):
        self.rid, self.priority = rid, priority


def _fifo(S):
    s = S()
    for i in range(5):
        s.enqueue(_Req(i))
    return [s.select().rid for _ in range(5)], s.select(), s.pending


def _wrr(S):
    s = S(class_weights={0: 3, 1: 1})
    for i in range(40):
        s.enqueue(_Req(i, i % 2))
    return [s.select().priority for _ in range(8)], s._current


def _unknown_class(S):
    s = S(class_weights={0: 2})
    s.enqueue(_Req(0, priority=7))
    return s.weights, s.select().rid


def _aging(S):
    s = S(class_weights={0: 100, 1: 1}, aging_ticks=3)
    s.enqueue(_Req(1, priority=1))
    for _ in range(3):
        s.on_tick()
    for i in range(10):
        s.enqueue(_Req(10 + i))
    first = s.select().rid
    aged = s.stats.aged
    return first, aged, s.select().priority, s.stats.aged


def _requeue_front(S):
    s = S(aging_ticks=4)
    for i in range(4):
        s.enqueue(_Req(i))
    a, b = s.select(), s.select()
    for _ in range(4):
        s.on_tick()
    s.requeue_front([a, b])
    order = [r.rid for r in s.waiting()]
    waited = s._waited(s.waiting()[0])
    return order, waited, s.select().rid, s.stats.aged


def _budget(S):
    s = S(token_budget=16, chunk_size=8)
    grants = [s.chunk_tokens(a, r) for a, r in
              ((0, 100), (0, 5), (12, 100), (16, 100), (99, 100), (0, 100))]
    return grants, vars(s.stats), s.describe()


def _interleave(S):
    """Selections, grants and ages over a run of ticks with arrivals in
    three classes, a requeue and forgotten requests."""
    s = S(token_budget=10, chunk_size=4, class_weights={0: 2, 2: 3},
          aging_ticks=5)
    out = []
    for t in range(30):
        s.on_tick()
        if t % 3 == 0:
            s.enqueue(_Req(100 + t, priority=t % 3 + t % 2))
        if t % 4 == 1 and s.pending:
            r = s.select()
            out.append(("sel", r.rid, s.stats.aged))
            if t % 8 == 1:
                s.requeue_front([r])
            else:
                s.forget(r.rid)
        out.append(("grant", s.chunk_tokens(t % 12, 9 - t % 7)))
    return out, vars(s.stats), s.pending, s.describe()


POLICY = {"fifo": _fifo, "wrr": _wrr, "unknown_class": _unknown_class,
          "aging": _aging, "requeue_front": _requeue_front,
          "budget": _budget, "interleave": _interleave}


@pytest.mark.parametrize("case", sorted(POLICY))
def test_scheduler_policy_matches_reference(jref, case):
    want = POLICY[case](jref["scheduler"].Scheduler)
    assert POLICY[case](PortScheduler) == want


def test_scheduler_policy_values():
    """The reference test's literal expectations, on the port alone."""
    order, _, pending = _fifo(PortScheduler)
    assert order == [0, 1, 2, 3, 4] and pending == 0
    picks, _ = _wrr(PortScheduler)
    assert picks.count(0) == 6 and picks.count(1) == 2
    assert all(not (a == 1 and b == 1) for a, b in zip(picks, picks[1:]))
    assert _aging(PortScheduler)[:3] == (1, 1, 0)
    order, waited, first, aged = _requeue_front(PortScheduler)
    assert order == [0, 1, 2, 3] and waited >= 4 and first == 0 and aged
    grants, stats, _ = _budget(PortScheduler)
    assert grants == [8, 5, 4, 0, 0, 8]
    assert stats["deferred_chunks"] == 2 and stats["shrunk_chunks"] == 1


@pytest.mark.parametrize("kw", [dict(token_budget=0), dict(chunk_size=0),
                                dict(aging_ticks=0),
                                dict(class_weights={0: 0})])
def test_scheduler_rejects_bad_knobs(jref, kw):
    with pytest.raises(ValueError):
        jref["scheduler"].Scheduler(**kw)
    with pytest.raises(ValueError):
        PortScheduler(**kw)


def test_engine_sched_knobs_and_capability():
    cfg = port_smoke(ARCH).scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        rt.engine(num_slots=2, token_budget=64)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu", scheduler=True,
                            sched_kw=dict(chunk_size=64))
    with pytest.raises(ValueError, match="chunk_size"):
        rt.engine(num_slots=2)
    # xLSTM blocks would need a sequential in-chunk scan
    with pytest.raises(ValueError, match="chunked prefill"):
        PortRuntime.create("xlstm-125m", smoke=True, device="cpu",
                           scheduler=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        PortRuntime.create("xlstm-125m", smoke=True,
                           device="cpu").engine(scheduler=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        model_chunk_prefill(None, None, None,
                            port_smoke("xlstm-125m"), positions=None,
                            reset=None, last_index=None)


def test_runtime_describe_scheduler_block(jref):
    rcfg, pcfg = _cfgs(jref)
    kw = dict(capacity=32, scheduler=True, sched_kw=dict(token_budget=64))
    rdesc = jref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                           **kw).describe()
    pdesc = PortRuntime.create(pcfg, device="cpu", **kw).describe()
    for text in (rdesc, pdesc):
        assert "scheduler[token_budget=64]" in text
        assert "chunked_prefill_ok=True" in text
    assert PortRuntime.create(pcfg, device="cpu").caps \
        .supports_chunked_prefill
    assert "scheduler=off" in PortRuntime.create(pcfg,
                                                 device="cpu").describe()


# -- 2. the int8 pool write with a chunk's write blocks -----------------------


def _q8_pool(N, bs, KV, Dh, seed):
    """An int8 pool of recycled storage: random payload and scales."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-127, 128, (N, bs, KV, Dh)).astype(np.int8)
    scale = (rng.random((N, KV)) * 0.05).astype(np.float32)
    return pool, scale


def test_chunk_quantized_block_write_matches_reference(jref):
    """Two [1, 8] chunks into a block-size-4 int8 pool: the first opens at
    a shared column (trash writes) and fills a fresh block from offset 0,
    the second fills the next block partly and pads (trash, offset 0, all
    repeating one block and offset).  Payloads and scales equal the
    reference's bit for bit; the trash block's payload is left out (its
    colliding writes land in no fixed order in either framework)."""
    jnp = jref["jnp"]
    N, bs, KV, Dh, C = 9, 4, 2, 16, 8
    pool, scale = _q8_pool(N, bs, KV, Dh, seed=0)
    chunks = [([TRASH] * 4 + [5] * 4, [0, 1, 2, 3, 0, 1, 2, 3], 1.0),
              ([7] * 5 + [TRASH] * 3, [0, 1, 2, 3, 0, 0, 0, 0], 30.0)]
    r_pool, r_scale = jnp.asarray(pool), jnp.asarray(scale)
    p_pool, p_scale = torch.from_numpy(pool.copy()), \
        torch.from_numpy(scale.copy())
    keep = np.arange(N) != TRASH
    for i, (bids, off, mag) in enumerate(chunks):
        bids = np.array([bids], np.int32)
        off = np.array([off], np.int32)
        new = _rand((1, C, KV, Dh), seed=10 + i, scale=mag)
        r_pool, r_scale = jref["attention"]._quantized_block_write(
            r_pool, r_scale, jnp.asarray(new), jnp.asarray(bids),
            jnp.asarray(off))
        pattn._quantized_block_write(
            p_pool, p_scale, torch.from_numpy(new[0]),
            torch.from_numpy(bids[0]), torch.from_numpy(off[0]))
        np.testing.assert_array_equal(p_pool.numpy()[keep],
                                      np.asarray(r_pool)[keep])
        np.testing.assert_array_equal(p_scale.numpy(), np.asarray(r_scale))


# -- 3. the chunk append and the chunked prefill ------------------------------


def _layer0(tree, key="attn"):
    return {k: v[0] for k, v in tree["groups"][0]["sub0"][key].items()}


def test_attention_chunk_append_matches_reference(jref):
    """Dense: a row continuing at positions 10..17 of a 16-entry cache (the
    last two dropped, one kept write at entry 15) and a recycled row reset
    before its first chunk, five tokens and three pads."""
    jnp = jref["jnp"]
    rcfg, pcfg = _cfgs(jref)
    rparams, pparams = _params(jref, rcfg, pcfg)
    B, T, C = 2, 16, 8
    KV, Dh = pcfg.num_kv_heads, pcfg.head_dim
    x = _rand((B, C, pcfg.d_model), seed=1)
    k, v = _rand((B, T, KV, Dh), 2), _rand((B, T, KV, Dh), 3)
    kvp = np.full((B, T), -1, np.int32)
    kvp[0, :10] = np.arange(10)
    kvp[1] = np.random.default_rng(4).integers(0, 40, T)   # stale junk
    pos = np.array([np.arange(10, 18),
                    [0, 1, 2, 3, 4] + [PAD_POS] * 3], np.int32)
    reset = np.array([False, True])
    y, rk, rv, rp = jref["attention"].attention_chunk_append(
        jnp.asarray(x), _layer0(rparams), rcfg, k_cache=jnp.asarray(k),
        v_cache=jnp.asarray(v), kv_positions=jnp.asarray(kvp),
        positions=jnp.asarray(pos), reset=jnp.asarray(reset))
    tk, tv, tp = (torch.from_numpy(a.copy()) for a in (k, v, kvp))
    got = pattn.attention_chunk_append(
        torch.from_numpy(x), _layer0(pparams), pcfg, k_cache=tk,
        v_cache=tv, kv_positions=tp, positions=torch.from_numpy(pos),
        reset=torch.from_numpy(reset))
    _close(got, y, OUT_TOL, "y")
    _close(tk, rk, OUT_TOL, "k cache")
    _close(tv, rv, OUT_TOL, "v cache")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


def _paged_case(kv_dtype, KV, Dh, N=10, bs=4):
    """Pools of recycled storage (stale positions, payload and, for int8,
    scales); block 2 holds positions 0..3 of a shared prefix."""
    rng = np.random.default_rng(5)
    if kv_dtype == "int8":
        k, ks = _q8_pool(N, bs, KV, Dh, seed=6)
        v, vs = _q8_pool(N, bs, KV, Dh, seed=7)
    else:
        k, v = _rand((N, bs, KV, Dh), 6), _rand((N, bs, KV, Dh), 7)
        ks = vs = None
    pos = rng.integers(20, 60, (N, bs)).astype(np.int32)
    pos[0] = -1
    pos[2] = np.arange(4)
    return k, v, ks, vs, pos


# the chain [2 (shared), 6, 4]; chunk 1: positions 0..7 (the shared column
# writes the trash block), chunk 2: positions 8..10 and five pads
PAGED_TABLE = np.array([[2, 6, 4, 0, 0]], np.int32)
PAGED_CHUNKS = [(np.arange(8), [TRASH] * 4 + [6] * 4),
                (np.array([8, 9, 10] + [PAD_POS] * 5), [4] * 3 + [TRASH] * 5)]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_attention_chunk_append_paged_matches_reference(jref, kv_dtype):
    jnp = jref["jnp"]
    rcfg, pcfg = _cfgs(jref)
    rparams, pparams = _params(jref, rcfg, pcfg)
    KV, Dh = pcfg.num_kv_heads, pcfg.head_dim
    k, v, ks, vs, pos = _paged_case(kv_dtype, KV, Dh)
    names = ("k", "v", "ks", "vs", "pos")
    rs = {n: jnp.asarray(a) for n, a in zip(names, (k, v, ks, vs, pos))
          if a is not None}
    ps = {n: torch.from_numpy(a.copy()) for n, a in
          zip(names, (k, v, ks, vs, pos)) if a is not None}
    keep = np.arange(k.shape[0]) != TRASH
    for i, (cpos, bids) in enumerate(PAGED_CHUNKS):
        x = _rand((1, 8, pcfg.d_model), seed=20 + i)
        cpos = np.asarray(cpos, np.int32)[None]
        bids = np.asarray(bids, np.int32)[None]
        out = jref["attention"].attention_chunk_append_paged(
            jnp.asarray(x), _layer0(rparams), rcfg, k_pool=rs["k"],
            v_pool=rs["v"], pos_pool=rs["pos"],
            block_table=jnp.asarray(PAGED_TABLE), write_bids=jnp.asarray(bids),
            positions=jnp.asarray(cpos), k_scale_pool=rs.get("ks"),
            v_scale_pool=rs.get("vs"))
        rs.update(zip(("k", "v", "pos", "ks", "vs"), out[1:]))
        got = pattn.attention_chunk_append_paged(
            torch.from_numpy(x), _layer0(pparams), pcfg, k_pool=ps["k"],
            v_pool=ps["v"], pos_pool=ps["pos"],
            block_table=torch.from_numpy(PAGED_TABLE),
            write_bids=torch.from_numpy(bids),
            positions=torch.from_numpy(cpos), k_scale_pool=ps.get("ks"),
            v_scale_pool=ps.get("vs"))
        _close(got, out[0], OUT_TOL, f"chunk {i} y")
        np.testing.assert_array_equal(ps["pos"].numpy()[keep],
                                      np.asarray(rs["pos"])[keep])
        for n in ("k", "v"):
            g, w = ps[n].numpy()[keep], np.asarray(rs[n])[keep]
            if kv_dtype == "int8":
                step = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert step.max() <= 1, f"chunk {i} {n}: {step.max()} codes"
                np.testing.assert_allclose(ps[n + "s"].numpy(),
                                           np.asarray(rs[n + "s"]),
                                           rtol=SCALE_RTOL, atol=0)
            else:
                _close(g, w, OUT_TOL, f"chunk {i} {n} pool")


def _chunks(prompt, C):
    """(tokens [1,C], positions [1,C], last index [1]) per chunk."""
    out = []
    for s in range(0, len(prompt), C):
        n = min(C, len(prompt) - s)
        tok = np.zeros((1, C), np.int32)
        pos = np.full((1, C), PAD_POS, np.int32)
        tok[0, :n] = prompt[s:s + n]
        pos[0, :n] = np.arange(s, s + n)
        out.append((tok, pos, np.array([n - 1], np.int32), s))
    return out


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_model_chunk_prefill_matches_reference(jref, layout):
    """A 21-token prompt in three chunks of 8 (the last padded) through
    every layer: each chunk's last-token logits within 1e-3 of the
    reference's, and the port's final logits within 1e-3 of its own
    full-context forward.

    Over the int8 pool the reference is evaluated op by op
    (``jax.disable_jit``): its compiled layer scan disagrees with its own
    op-by-op evaluation by 3.1e-3 in these logits at two layers (1.4e-6 at
    one), while the op-by-op form and the port agree to 1e-6, caches
    equal bit for bit (ROADMAP queue 3)."""
    jnp = jref["jnp"]
    rcfg, pcfg = _cfgs(jref)
    rparams, pparams = _params(jref, rcfg, pcfg)
    prompt = np.random.default_rng(8).integers(
        1, 200, 21).astype(np.int32)
    cap, bs = 32, 4
    if layout == "dense":
        rc = jref["kvcache"].init_cache(rcfg, 1, cap)
        pc = pkv.init_cache(pcfg, 1, cap)
        paged = None
    else:
        kv = "int8" if layout == "int8" else "f32"
        rc = jref["blockpool"].init_paged_cache(rcfg, 12, bs, kv_dtype=kv)
        pc = pbp.init_paged_cache(pcfg, 12, bs, kv)
        table = np.zeros((1, cap // bs), np.int32)
        table[0, :6] = [3, 7, 2, 9, 5, 11]
    for tok, pos, last, start in _chunks(prompt, 8):
        if layout != "dense":
            cols = np.where(pos[0] < PAD_POS, pos[0] // bs, -1)
            bids = np.where(cols >= 0, table[0, np.maximum(cols, 0)],
                            TRASH)[None].astype(np.int32)
            paged = (table, bids)
        rkw = dict(positions=jnp.asarray(pos),
                   reset=jnp.asarray([start == 0]),
                   last_index=jnp.asarray(last))
        pkw = dict(positions=torch.from_numpy(pos),
                   reset=torch.tensor([start == 0]),
                   last_index=torch.from_numpy(last))
        if paged is not None:
            rkw["paged"] = {"block_table": jnp.asarray(paged[0]),
                            "write_bids": jnp.asarray(paged[1])}
            pkw["paged"] = {"block_table": torch.from_numpy(paged[0]),
                            "write_bids": torch.from_numpy(paged[1])}
        with contextlib.ExitStack() as stack:
            if layout == "int8":
                stack.enter_context(jref["jax"].disable_jit())
            want, rc = jref["registry"].model_chunk_prefill(
                rparams, jnp.asarray(tok), rc, rcfg, **rkw)
        got = model_chunk_prefill(pparams, torch.from_numpy(tok), pc, pcfg,
                                  **pkw)
        _close(got, want, LOGITS_TOL, f"chunk at {start}")
    if layout != "int8":
        full = model_forward(pparams, torch.from_numpy(prompt)[None], pcfg)
        _close(got[0, 0], full[0, -1], LOGITS_TOL, "vs full forward")


# -- 4. the engine -------------------------------------------------------------

_LENS = (5, 8, 21, 24, 13)
SCHED_KW = dict(token_budget=8, chunk_size=8)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
           "int8": dict(kv_layout="paged", kv_dtype="int8")}


def _reqs(cls, lens=_LENS, max_new=5):
    out = []
    for i, n in enumerate(lens):
        rng = np.random.default_rng(i)
        out.append(cls(rid=i, prompt=rng.integers(1, 200, size=n,
                                                   dtype=np.int32),
                       max_new_tokens=max_new, priority=i % 2))
    return out


def _serve_port(pcfg, params, layout, reqs, sched_kw=None, **ekw):
    rt = PortRuntime.create(pcfg, capacity=64, device="cpu", params=params,
                            scheduler=sched_kw is not None,
                            sched_kw=sched_kw, **LAYOUTS[layout])
    if layout != "dense":
        ekw.setdefault("block_size", 8)
    eng = rt.engine(num_slots=2, straggler_kw=NO_STRAGGLER, **ekw)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert len(eng.finished) == len(reqs), "stream dropped"
    return eng


def _streams(eng):
    return {r.rid: list(r.generated) for r in eng.finished}


def _margin(pcfg, params, prompt, stream, j) -> float:
    """Top-2 f32 logit margin of the port's full-context forward where
    ``stream[j]`` was sampled."""
    ctx = np.concatenate([prompt, np.asarray(stream[:j], np.int32)])
    logits = model_forward(params, torch.from_numpy(ctx)[None], pcfg)
    top = torch.topk(logits[0, -1, :pcfg.vocab_size], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_scheduler_engine_matches_reference(jref, layout):
    """Streams of the port's scheduler engine against the reference's
    scheduler engine, and (dense, paged) against the port's monolithic
    engine; no monolithic prefill runs, chunk ticks do, the pool drains."""
    rcfg, pcfg = _cfgs(jref)
    _, params = _params(jref, rcfg, pcfg)
    rrt = jref["runtime"].Runtime.create(
        rcfg, shape_kind="decode", capacity=64, scheduler=True,
        sched_kw=SCHED_KW, **LAYOUTS[layout])
    rkw = dict(block_size=8) if layout != "dense" else {}
    ref_eng = rrt.engine(num_slots=2, injector=None,
                         straggler_kw=NO_STRAGGLER, **rkw)
    for r in _reqs(jref["engine"].Request):
        ref_eng.submit(r)
    ref_eng.run_to_completion()
    want = _streams(ref_eng)
    eng = _serve_port(pcfg, params, layout, _reqs(PortRequest),
                      sched_kw=SCHED_KW)
    got = _streams(eng)
    assert eng.stats.prefill_calls == 0 and eng.stats.chunk_ticks > 0
    assert eng.stats.chunk_ticks == ref_eng.stats.chunk_ticks
    if eng.paged:
        assert eng.pool.used_blocks == 0
    for r in _reqs(PortRequest):
        if got[r.rid] != want[r.rid]:
            j = next(k for k, (a, b) in enumerate(zip(got[r.rid],
                                                      want[r.rid])) if a != b)
            m = _margin(pcfg, params, r.prompt, got[r.rid], j)
            assert m < FLIP_MARGIN, (
                f"rid {r.rid}: first divergence at token {j} (port "
                f"{got[r.rid][j]}, reference {want[r.rid][j]}); f32 logit "
                f"margin {m:.3g}")
    if layout != "int8":
        mono = _streams(_serve_port(pcfg, params, layout, _reqs(PortRequest)))
        assert got == mono


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_scheduler_engine_edges_match_reference(jref, layout):
    """A prompt longer than the capacity (dense; a paged table cannot hold
    one) or ending near it, a request done at its final chunk
    (max_new_tokens=1) and a stream that runs past the capacity: the
    dropped and junked writes leave the reference's streams."""
    rcfg, pcfg = _cfgs(jref)
    _, params = _params(jref, rcfg, pcfg)
    lens = (70 if layout == "dense" else 60, 9, 3, 40)

    def reqs(cls):
        return [cls(rid=i, prompt=np.random.default_rng(50 + i).integers(
                    1, 200, size=n, dtype=np.int32), max_new_tokens=m,
                    priority=i % 2)
                for i, (n, m) in enumerate(zip(lens, (6, 1, 4, 30)))]

    rrt = jref["runtime"].Runtime.create(
        rcfg, shape_kind="decode", capacity=64, scheduler=True,
        sched_kw=SCHED_KW, **LAYOUTS[layout])
    ref_eng = rrt.engine(num_slots=2, injector=None,
                         straggler_kw=NO_STRAGGLER,
                         **(dict(block_size=8) if layout == "paged" else {}))
    for r in reqs(jref["engine"].Request):
        ref_eng.submit(r)
    ref_eng.run_to_completion()
    eng = _serve_port(pcfg, params, layout, reqs(PortRequest),
                      sched_kw=SCHED_KW)
    got = _streams(eng)
    assert got == _streams(ref_eng)
    assert {i: len(t) for i, t in got.items()} == {0: 6, 1: 1, 2: 4, 3: 30}


def test_scheduler_budget_one_still_completes(jref):
    """Budget 1 leaves no chunk room while a slot decodes: chunks wait
    until decoding drains, and the streams are the monolithic ones."""
    rcfg, pcfg = _cfgs(jref)
    _, params = _params(jref, rcfg, pcfg)
    base = _streams(_serve_port(pcfg, params, "dense", _reqs(PortRequest)))
    eng = _serve_port(pcfg, params, "dense", _reqs(PortRequest),
                      sched_kw=dict(token_budget=1, chunk_size=4))
    assert _streams(eng) == base
    assert eng.sched.stats.deferred_chunks > 0


def test_scheduler_paged_prefix_reuse(jref):
    """Chunked admission goes through ``pool.admit``: a two-block shared
    prefix is found in the prefix cache, and the pool drains."""
    rcfg, pcfg = _cfgs(jref)
    _, params = _params(jref, rcfg, pcfg)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 200, size=16, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 200, size=2 + i,
                                                    dtype=np.int32)])
               for i in range(3)]

    def reqs():
        return [PortRequest(rid=i, prompt=p.astype(np.int32),
                            max_new_tokens=4) for i, p in enumerate(prompts)]

    base = _streams(_serve_port(pcfg, params, "paged", reqs()))
    eng = _serve_port(pcfg, params, "paged", reqs(),
                      sched_kw=dict(chunk_size=8))
    assert _streams(eng) == base
    assert eng.pool.prefix_hits >= 2
    assert eng.pool.used_blocks == 0


def test_chunk_rows_write_through_views():
    """The dense mixed step writes the chunk slot's row in place and leaves
    every other slot's row as it was."""
    cfg = port_smoke(ARCH).scaled(dtype=torch.float32)
    caches = pkv.init_cache(cfg, 3, 16)
    before = [t.clone() for t in (caches[0]["sub0"]["k"],
                                  caches[0]["sub0"]["pos"])]
    rows = pkv.slot_rows(caches, 1)
    rows[0]["sub0"]["pos"][:, 0, 3] = 7
    rows[0]["sub0"]["k"][:, 0, 3] = 1.0
    assert int(caches[0]["sub0"]["pos"][0, 1, 3]) == 7
    changed = (caches[0]["sub0"]["k"] != before[0]).any(dim=(2, 3, 4))
    assert changed[:, 1].all() and not changed[:, 0].any() \
        and not changed[:, 2].any()


def test_plain_int8_ops_cast_and_keep_f32():
    """The chunk path's gather rounds to the activation dtype once; the q8
    decode oracle's stays in f32."""
    pool, scale = (torch.from_numpy(a) for a in _q8_pool(6, 4, 2, 8, 9))
    table = torch.tensor([[2, 4, 0]], dtype=torch.int32)
    f32 = port_ref.dequantize_gather(pool, scale, table)
    got = port_ref.ref_dequantize_gather(pool, scale, table, torch.bfloat16)
    assert f32.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
