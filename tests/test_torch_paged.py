"""The PyTorch port's paged and int8-paged KV serving path against the JAX
reference, on the CPU.

The plain paged versions are held against the reference's Pallas kernels
(interpret mode, as tests/test_paged.py runs them) and its jnp oracles;
the host allocator, the device-side pool updates, the per-tick paged
decode logits and the engines' token streams against the reference's own;
and, inside the port, the paged engine against the dense one bit for bit.
Parameters come from the reference (``repro_torch.bridge``), inputs from a
numpy seed.  Tolerances are the reference's: kernels 1e-5 f32 / 2e-2 bf16
(tests/test_paged.py), logits 1e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import ref
from repro_torch.models import attention as port_attention
from repro_torch.models.registry import (model_decode_step,
                                         model_paged_decode_step,
                                         model_prefill)
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import blockpool as pbp
from repro_torch.serve import kvcache
from repro_torch.serve.engine import Request as PortRequest

ARCHS = ["exanode-100m", "llama3.2-3b"]
HEADS = [(8, 2), (6, 1), (4, 4)]
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LOGITS_TOL = 1e-3
# Two sides whose logits agree within LOGITS_TOL can only pick different
# greedy tokens where the top-2 margin is at most twice that.
FLIP_MARGIN = 2 * LOGITS_TOL
# The reference engine's straggler monitor may evacuate and replay the
# streams after a slow tick on a loaded machine; parity runs switch it off.
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)


@pytest.fixture(scope="module")
def jref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.kernels.paged_attention
    import repro.kernels.ref
    import repro.models.attention
    import repro.models.registry
    import repro.runtime
    import repro.serve.blockpool
    import repro.serve.engine
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "kernel": repro.kernels.paged_attention,
            "oracle": repro.kernels.ref, "attention": repro.models.attention,
            "registry": repro.models.registry, "runtime": repro.runtime,
            "blockpool": repro.serve.blockpool, "engine": repro.serve.engine}


def _pair(jref, arch, capacity=32, **kv):
    """(reference Runtime, port Runtime) on the f32 smoke config with the
    reference's seeded params on both sides."""
    jnp = jref["jnp"]
    rcfg = jref["configs"].get_smoke_config(arch).scaled(dtype=jnp.float32)
    rrt = jref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                         capacity=capacity, **kv)
    tree = jref["jax"].tree.map(np.asarray, rrt.params)
    pcfg = port_smoke(arch).scaled(dtype=torch.float32)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(tree, pcfg), **kv)
    return rrt, prt


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape, dtype=np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# -- kernel inputs: chains with NULL tails, a shared block, stale entries ----

BS, D, M, N = 4, 16, 5, 16
# row -> (chain length, position of the query); row 3 shares row 2's first
# two blocks; row 2 attends to less than its chain holds
CHAINS = [(9, 8), (4, 3), (14, 12), (11, 10)]


def _paged_inputs(H, KV, seed):
    """q [B,H,D], pools [N,BS,KV,D], pos_pool, table [B,M], pos [B] as
    numpy.  Blocks come off a shuffled free list (physical order arbitrary);
    every non-reserved block starts as recycled storage holding stale
    positions above every query's position, and a chain's tail block keeps
    them past its last entry; columns past a chain are NULL."""
    rng = np.random.default_rng(seed)
    B = len(CHAINS)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((N, BS, KV, D)).astype(np.float32)
    kp[:2] = vp[:2] = 0.0                      # NULL and TRASH never written
    pos_pool = np.full((N, BS), -1, np.int32)
    pos_pool[2:] = rng.integers(40, 60, (N - 2, BS))
    table = np.zeros((B, M), np.int32)
    free = list(rng.permutation(np.arange(pbp.NUM_RESERVED, N)))
    for b, (L, _) in enumerate(CHAINS):
        for j in range(-(-L // BS)):
            if b == 3 and j < 2:
                table[b, j] = table[2, j]       # shared prefix block
                continue
            bid = table[b, j] = free.pop()
            for o in range(BS):
                if j * BS + o < L:
                    pos_pool[bid, o] = j * BS + o
    pos = np.array([p for _, p in CHAINS], np.int32)
    return q, kp, vp, pos_pool, table, pos


def _walked(fn, args, table):
    """``fn`` row by row over the columns the kernel walks: up to the first
    NULL column after column 0."""
    rows = []
    for b in range(table.shape[0]):
        nulls = [j for j in range(1, table.shape[1])
                 if table[b, j] == pbp.NULL_BLOCK]
        n = nulls[0] if nulls else table.shape[1]
        q, pos, tbl = args[0][b:b + 1], args[-1][b:b + 1], args[-2][b:b + 1]
        rows.append(fn(q, *args[1:-2], tbl[:, :n].contiguous(), pos))
    return torch.cat(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", HEADS)
def test_paged_plain_matches_pallas(jref, H, KV, dtype):
    jnp = jref["jnp"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, kp, vp, pos_pool, table, pos = _paged_inputs(H, KV, seed=H + KV)
    want = jref["kernel"].paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pos_pool), jnp.asarray(table), jnp.asarray(pos),
        interpret=True)
    args = [torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(pos_pool),
            torch.from_numpy(table), torch.from_numpy(pos)]
    got = ref.ref_paged_decode_attention(*args)
    assert got.dtype == dtype and got.shape == (len(CHAINS), H, D)
    tol = KERNEL_TOL[dtype]
    _close(got.float(), np.asarray(want, np.float32), tol, "vs Pallas")
    oracle = jref["oracle"].ref_paged_decode_attention(
        jnp.asarray(q, jdt), jnp.repeat(jnp.asarray(kp, jdt), H // KV, 2),
        jnp.repeat(jnp.asarray(vp, jdt), H // KV, 2), jnp.asarray(pos_pool),
        jnp.asarray(table), jnp.asarray(pos))
    _close(got.float(), np.asarray(oracle, np.float32), tol, "vs oracle")
    # the kernel's walk (stop at the first NULL column) computes the same
    walked = _walked(ref.ref_paged_decode_attention, args, table)
    _close(walked.float(), got.float(), tol, "walk to the first NULL")


def _q8_inputs(H, KV, seed):
    q, _, _, pos_pool, table, pos = _paged_inputs(H, KV, seed)
    rng = np.random.default_rng(seed + 100)
    kq, vq = (rng.integers(-127, 128, (N, BS, KV, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.05, (N, KV)).astype(np.float32)
              for _ in range(2))
    for a in (kq, vq, ks, vs):
        a[:2] = 0                               # NULL and TRASH
    return q, kq, vq, ks, vs, pos_pool, table, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", HEADS)
def test_paged_q8_plain_matches_pallas(jref, H, KV, dtype):
    jnp = jref["jnp"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, kq, vq, ks, vs, pos_pool, table, pos = _q8_inputs(H, KV, seed=H * KV)
    want = jref["kernel"].paged_decode_attention_q8(
        jnp.asarray(q, jdt), *(jnp.asarray(a) for a in (
            kq, vq, ks, vs, pos_pool, table, pos)), interpret=True)
    args = [torch.from_numpy(q).to(dtype)] + [torch.from_numpy(a) for a in (
        kq, vq, ks, vs, pos_pool, table, pos)]
    got = ref.ref_paged_decode_attention_q8(*args)
    assert got.dtype == dtype
    tol = KERNEL_TOL[dtype]
    _close(got.float(), np.asarray(want, np.float32), tol, "vs Pallas")
    G = H // KV
    oracle = jref["oracle"].ref_paged_decode_attention_q8(
        jnp.asarray(q, jdt), jnp.repeat(jnp.asarray(kq), G, 2),
        jnp.repeat(jnp.asarray(vq), G, 2), jnp.repeat(jnp.asarray(ks), G, 1),
        jnp.repeat(jnp.asarray(vs), G, 1), jnp.asarray(pos_pool),
        jnp.asarray(table), jnp.asarray(pos))
    _close(got.float(), np.asarray(oracle, np.float32), tol, "vs oracle")
    walked = _walked(ref.ref_paged_decode_attention_q8, args, table)
    _close(walked.float(), got.float(), tol, "walk to the first NULL")


def test_paged_kernel_wrappers_refuse_cpu_tensors():
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a) for a in _paged_inputs(4, 2, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    scale = torch.zeros(N, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_decode_attention_q8(q, kp.to(torch.int8),
                                            vp.to(torch.int8), scale, scale,
                                            pos_pool, table, pos)


# -- host allocator ----------------------------------------------------------


def _pool_state(pool):
    return {"table": pool.table.tolist(), "refcount": pool.refcount.tolist(),
            "seq_blocks": pool.seq_blocks.tolist(),
            "next_pos": pool.next_pos.tolist(),
            "reserved": pool.reserved.tolist(), "free": list(pool._free),
            "prefix_hits": pool.prefix_hits, "cow_copies": pool.cow_copies,
            "high_water": pool.high_water,
            "available": pool.available_blocks}


def test_blockpool_matches_reference_allocator(jref):
    """One scripted sequence through both allocators, compared after every
    step: shared-prefix admission, release, re-admission after eviction,
    fork and copy-on-write, writes past ``max_entries``, and exhaustion
    with rollback."""
    RefPool = jref["blockpool"].BlockPool
    kw = dict(num_blocks=10, block_size=2, num_slots=3, max_blocks_per_seq=4,
              max_entries=7)
    pools = {"port": pbp.BlockPool(**kw), "ref": RefPool(**kw)}
    a = np.array([1, 2, 3, 4, 5], np.int32)
    script = [
        ("admit", 0, a, 3, 4),
        ("admit", 1, np.array([1, 2, 3, 4, 9], np.int32), 3, None),
        ("plan", 0, True), ("plan", 0, True), ("plan", 1, True),
        ("plan", 2, False),
        ("release", 0), ("release", 1),
        ("admit", 2, a[:4], 2, None),            # cached-free blocks
        ("admit", 1, np.array([7, 8, 9], np.int32), 2, 3),
        ("fork", 1, 0),
        ("plan", 0, True),                       # shared tail: COW
        ("plan", 1, True), ("plan", 1, True), ("plan", 1, True),
        ("plan", 1, True), ("plan", 1, True),    # p >= max_entries: trash
        ("release", 0),
        ("admit", 0, np.arange(20, 28, dtype=np.int32), 4, None),
        ("admit", 0, np.arange(30, 38, dtype=np.int32), 4, None),  # exhausts
    ]
    for step in script:
        out = {}
        for side, pool in pools.items():
            op, *args = step
            try:
                if op == "admit":
                    slot, prompt, nb, reserve = args
                    out[side] = pool.admit(slot, prompt, nb,
                                           reserve_blocks=reserve).tolist()
                elif op == "plan":
                    bid, copies = pool.write_plan(*args)
                    out[side] = (int(bid), [tuple(map(int, c))
                                            for c in copies])
                else:
                    out[side] = getattr(pool, op)(*args)
            except RuntimeError as e:
                out[side] = type(e).__name__
        assert out["port"] == out["ref"], step
        assert _pool_state(pools["port"]) == _pool_state(pools["ref"]), step
    assert out["port"] == "PoolExhausted"
    assert pools["port"].cow_copies == 1 and pools["port"].prefix_hits == 4


# -- device-side pool updates -----------------------------------------------

CAP, PBS = 20, 8     # capacity not a multiple of the block size


def _part(cfg, seed, Bp=2):
    """A capacity-padded prefill part: [L,Bp,CAP,KV,Dh] payload, pos -1
    past each row's length."""
    rng = np.random.default_rng(seed)
    L = cfg.num_layers
    shape = (L, Bp, CAP, cfg.num_kv_heads, cfg.head_dim)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([CAP, 13][:Bp])
    t = np.arange(CAP)
    pos = np.broadcast_to(np.where(t[None] < lens[:, None], t[None], -1),
                          (L, Bp, CAP)).astype(np.int32)
    return [{"sub0": {"k": k, "v": v, "pos": pos}}]


def _to_ref(jref, tree):
    return jref["jax"].tree.map(jref["jnp"].asarray, tree)


def _to_port(tree):
    return [{n: {leaf: torch.from_numpy(np.array(a)) for leaf, a in sub.items()}
             for n, sub in g.items()} for g in tree]


def _assert_trees_equal(got, want):
    for gg, wg in zip(got, want):
        for name in wg:
            assert set(gg[name]) == set(wg[name])
            for leaf, w in wg[name].items():
                np.testing.assert_array_equal(gg[name][leaf].numpy(),
                                              np.asarray(w), err_msg=leaf)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_paged_splice_matches_reference(jref, kv_dtype):
    """Splice a capacity-20 part into a block-size-8 pool (nb = 3 columns,
    the last one padded): every leaf bit for bit, untouched blocks
    included."""
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    rcfg = jref["configs"].get_smoke_config("exanode-100m").scaled(
        dtype=jref["jnp"].float32)
    part = _part(cfg, seed=0)
    dst = np.array([[5, 2, 7], [3, pbp.TRASH_BLOCK, 6]], np.int32)
    want = jref["blockpool"].paged_splice(
        jref["blockpool"].init_paged_cache(rcfg, 9, PBS, kv_dtype=kv_dtype),
        _to_ref(jref, part), jref["jnp"].asarray(dst))
    got = pbp.paged_splice(pbp.init_paged_cache(cfg, 9, PBS, kv_dtype),
                           _to_port(part), torch.from_numpy(dst))
    _assert_trees_equal(got, want)
    assert pbp.cache_kv_dtype(got) == kv_dtype


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_copy_blocks_matches_reference(jref, kv_dtype):
    """Copy-on-write duplication over every layer and leaf, the scale
    pools included."""
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    rcfg = jref["configs"].get_smoke_config("exanode-100m").scaled(
        dtype=jref["jnp"].float32)
    part, dst = _part(cfg, seed=4), np.array([[5, 2, 7], [3, 4, 6]])
    caches = {
        "ref": jref["blockpool"].paged_splice(
            jref["blockpool"].init_paged_cache(rcfg, 9, PBS,
                                               kv_dtype=kv_dtype),
            _to_ref(jref, part), jref["jnp"].asarray(dst, np.int32)),
        "port": pbp.paged_splice(pbp.init_paged_cache(cfg, 9, PBS, kv_dtype),
                                 _to_port(part), torch.from_numpy(dst))}
    src, to = np.array([5, 6], np.int32), np.array([8, 5], np.int32)
    want = jref["blockpool"].copy_blocks(caches["ref"],
                                         jref["jnp"].asarray(src),
                                         jref["jnp"].asarray(to))
    got = pbp.copy_blocks(caches["port"], torch.from_numpy(src),
                          torch.from_numpy(to))
    _assert_trees_equal(got, want)


def test_quantize_paged_part_matches_reference(jref):
    part = _part(port_smoke("exanode-100m"), seed=1)
    for nb in (2, 3):             # truncated and zero-padded tails
        want = jref["blockpool"].quantize_paged_part(_to_ref(jref, part),
                                                     PBS, nb)
        got = pbp.quantize_paged_part(_to_port(part), PBS, nb)
        _assert_trees_equal(got, want)
        assert got[0]["sub0"]["k_scale"].shape == (2, 2, nb, 2)


def test_quantized_block_write_matches_reference(jref):
    """Three ticks of int8 entry writes into a spliced pool: a fresh block
    at offset 0 (stale scale and payload reset), writes within the block's
    scale, writes that grow it (the block requantized) and trash writes.
    Payloads and scales equal the reference's bit for bit in every block,
    the untouched ones included."""
    jnp = jref["jnp"]
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    rcfg = jref["configs"].get_smoke_config("exanode-100m").scaled(
        dtype=jnp.float32)
    part, dst = _part(cfg, seed=2), np.array([[5, 2, 7], [3, 4, 6]])
    rp = jref["blockpool"].paged_splice(
        jref["blockpool"].init_paged_cache(rcfg, 9, PBS, kv_dtype="int8"),
        _to_ref(jref, part), jnp.asarray(dst, jnp.int32))[0]["sub0"]
    pp = pbp.paged_splice(pbp.init_paged_cache(cfg, 9, PBS, "int8"),
                          _to_port(part), torch.from_numpy(dst))[0]["sub0"]
    rng = np.random.default_rng(3)
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    # (write block, offset, magnitude) per row; block 8 is recycled storage
    # (stale payload and scale from the splice of block 7's twin below)
    ticks = [[(7, 4, 1.0), (8, 0, 0.5), (1, 3, 9.0), (6, 5, 30.0)],
             [(7, 5, 40.0), (8, 1, 0.1), (1, 0, 1.0), (6, 6, 0.01)],
             [(2, 0, 2.0), (8, 2, 80.0), (1, 4, 1.0), (3, 7, 5.0)]]
    pp["k"][0, 8] = pp["k"][0, 7]
    pp["k_scale"][0, 8] = pp["k_scale"][0, 7]
    rk, rks = rp["k"][0].at[8].set(rp["k"][0, 7]), \
        rp["k_scale"][0].at[8].set(rp["k_scale"][0, 7])
    pk, pks = pp["k"][0], pp["k_scale"][0]
    for plan in ticks:
        bids = np.array([b for b, _, _ in plan], np.int32)
        off = np.array([o for _, o, _ in plan], np.int32)
        new = np.stack([rng.standard_normal((KV, Dh)) * m
                        for _, _, m in plan]).astype(np.float32)
        rk, rks = jref["attention"]._quantized_block_write(
            rk, rks, jnp.asarray(new), jnp.asarray(bids), jnp.asarray(off))
        port_attention._quantized_block_write(
            pk, pks, torch.from_numpy(new), torch.from_numpy(bids),
            torch.from_numpy(off))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(pks.numpy(), np.asarray(rks))


def test_offset0_write_clears_a_recycled_blocks_stale_positions():
    """A recycled block whose old positions lie below the new token's must
    not let them pass the mask: the offset-0 write clears the block's
    position row, so attention equals attention over a clean block."""
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    params = PortRuntime.create(cfg, device="cpu").params["groups"][0]
    p = {k: v[0] for k, v in params["sub0"]["attn"].items()}
    bs, Nb = 4, 6
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 1, cfg.d_model))
                         .astype(np.float32))
    outs, rows = [], []
    for stale in (True, False):
        sub = {k: v[0] for k, v in pbp.init_paged_cache(
            cfg, Nb, bs)[0]["sub0"].items()}
        g = torch.Generator().manual_seed(0)
        sub["k"].copy_(torch.randn(sub["k"].shape, generator=g))
        sub["v"].copy_(torch.randn(sub["v"].shape, generator=g))
        sub["pos"][2] = torch.arange(bs)      # positions 0..3 of a chain
        sub["pos"][3] = torch.arange(bs, 2 * bs)
        if stale:                             # block 4 held positions 0..3
            sub["pos"][4] = torch.arange(bs)
        table = torch.tensor([[2, 3, 4, 0]], dtype=torch.int32)
        outs.append(port_attention.attention_decode_paged(
            x, p, cfg, k_pool=sub["k"], v_pool=sub["v"],
            pos_pool=sub["pos"], block_table=table,
            write_bids=torch.tensor([4], dtype=torch.int32),
            pos=torch.tensor([2 * bs], dtype=torch.int32)))
        rows.append(sub["pos"][4].tolist())
    assert rows[0] == rows[1] == [2 * bs, -1, -1, -1]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# -- per-tick paged decode logits --------------------------------------------


def _paged_setup(cfg, prompts, kv_dtype, capacity=32, bs=4):
    """A port BlockPool holding ``prompts`` (shared full blocks shared),
    their splice plan and tables."""
    M = -(-capacity // bs)
    pool = pbp.BlockPool(len(prompts) * M + 2, bs, len(prompts), M,
                         max_entries=capacity)
    nb = -(-prompts.shape[1] // bs)
    dst = np.stack([pool.admit(b, p, nb) for b, p in enumerate(prompts)])
    return pool, dst


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_logits_match_reference_per_tick(jref, arch, kv_dtype):
    jnp = jref["jnp"]
    rrt, prt = _pair(jref, arch)
    toks = _tokens(prt.cfg, (2, 11), seed=5)
    toks[1, :8] = toks[0, :8]                    # two shared prompt blocks
    pool, dst = _paged_setup(prt.cfg, toks, kv_dtype)
    assert pool.prefix_hits == 2
    r_logits, r_part = jref["registry"].model_prefill(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg, 32,
        last_only=True)
    p_logits, p_part = model_prefill(prt.params, torch.from_numpy(toks),
                                     prt.cfg, 32, last_only=True)
    rbp = jref["blockpool"]
    r_caches = rbp.paged_splice(
        rbp.init_paged_cache(rrt.cfg, pool.num_blocks, pool.block_size,
                             kv_dtype=kv_dtype), r_part, jnp.asarray(dst))
    p_caches = pbp.paged_splice(
        pbp.init_paged_cache(prt.cfg, pool.num_blocks, pool.block_size,
                             kv_dtype), p_part, torch.from_numpy(dst))
    pos = np.full(2, 11, np.int32)
    for tick in range(6):
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   atol=LOGITS_TOL, rtol=0,
                                   err_msg=f"tick {tick}")
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        bids = np.array([pool.write_plan(b, True)[0] for b in range(2)],
                        np.int32)
        table = pool.table.copy()
        r_logits, r_caches = jref["registry"].model_paged_decode_step(
            rrt.params, jnp.asarray(nxt), r_caches, rrt.cfg,
            pos=jnp.asarray(pos), block_table=jnp.asarray(table),
            write_bids=jnp.asarray(bids))
        p_logits = model_paged_decode_step(
            prt.params, torch.from_numpy(nxt), p_caches, prt.cfg,
            pos=torch.from_numpy(pos), block_table=torch.from_numpy(table),
            write_bids=torch.from_numpy(bids))
        pos = pos + 1


def test_paged_decode_logits_equal_dense_bitwise():
    """Inside the port, the plain paged path gathers the chain and runs the
    same dense plain version: a pool holding the dense cache's entries
    gives the dense logits bit for bit, tick after tick."""
    cfg = port_smoke("llama3.2-3b").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu")
    toks = _tokens(cfg, (2, 9), seed=6)
    pool, dst = _paged_setup(cfg, toks, "f32", bs=8)
    _, part = model_prefill(rt.params, torch.from_numpy(toks), cfg, 32)
    dense = kvcache.init_cache(cfg, 2, 32)
    kvcache.splice_slots(dense, part, [0, 1])
    paged = pbp.paged_splice(pbp.init_paged_cache(cfg, pool.num_blocks, 8),
                             part, torch.from_numpy(dst))
    tok = torch.from_numpy(_tokens(cfg, (2, 1), seed=7))
    pos = torch.full((2,), 9, dtype=torch.int32)
    for _ in range(10):
        want = model_decode_step(rt.params, tok, dense, cfg, pos=pos)
        bids = torch.tensor([pool.write_plan(b, True)[0] for b in range(2)],
                            dtype=torch.int32)
        got = model_paged_decode_step(rt.params, tok, paged, cfg, pos=pos,
                                      block_table=torch.from_numpy(
                                          pool.table.copy()),
                                      write_bids=bids)
        assert torch.equal(got, want)
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1


# -- engines -----------------------------------------------------------------


def _stream(cfg, n=9, seed=8):
    """Mixed prompt lengths and budgets (slot churn at 3 slots), two
    requests sharing a two-block prefix, one running past capacity."""
    rng = np.random.default_rng(seed)
    shared = _tokens(cfg, 16, seed=seed + 1)
    reqs = []
    for i in range(n):
        p = _tokens(cfg, int(rng.integers(2, 20)), seed=seed + 10 + i)
        if i in (3, 6):
            p = np.concatenate([shared, p[:3]]).astype(np.int32)
        reqs.append((i, p, int(rng.integers(1, 9))))
    reqs.append((n, _tokens(cfg, 28, seed=seed + 99), 10))  # past capacity
    return reqs


def _run(engine, request_cls, reqs):
    for i, p, m in reqs:
        engine.submit(request_cls(rid=i, prompt=p.copy(), max_new_tokens=m))
    engine.run_to_completion()
    return {r.rid: list(r.generated) for r in engine.finished}


def _paged_margin(prt, prompt, stream, j, kv_dtype, bs=8):
    """Top-2 logit margin of the port's own paged path (request alone) at
    the position where ``stream[j]`` was sampled."""
    cfg = prt.cfg
    pool, dst = _paged_setup(cfg, prompt[None], kv_dtype, prt.capacity, bs)
    logits, part = model_prefill(prt.params, torch.from_numpy(prompt)[None],
                                 cfg, prt.capacity, last_only=True)
    caches = pbp.paged_splice(
        pbp.init_paged_cache(cfg, pool.num_blocks, bs, kv_dtype), part,
        torch.from_numpy(dst))
    for t in range(j):
        bid = torch.tensor([pool.write_plan(0, True)[0]], dtype=torch.int32)
        logits = model_paged_decode_step(
            prt.params, torch.tensor([[stream[t]]], dtype=torch.int32),
            caches, cfg, pos=torch.tensor([len(prompt) + t], dtype=torch.int32),
            block_table=torch.from_numpy(pool.table.copy()), write_bids=bid)
    top = torch.topk(logits[0, -1, :cfg.vocab_size], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_paged_engine_streams_match_reference(jref, kv_dtype):
    """The port's paged engine (f32 or int8 pool) emits the reference paged
    engine's greedy streams.  Where a stream diverges, the port's own
    logit margin there must be a near-tie (<= 2x the logits tolerance)."""
    rrt, prt = _pair(jref, "exanode-100m", kv_layout="paged",
                     kv_dtype=kv_dtype)
    reqs = _stream(prt.cfg)
    ref_eng = rrt.engine(num_slots=3, block_size=8, injector=None,
                         straggler_kw=NO_STRAGGLER)
    want = _run(ref_eng, jref["engine"].Request, reqs)
    port = prt.engine(num_slots=3, block_size=8,
                      straggler_kw=NO_STRAGGLER)
    got = _run(port, PortRequest, reqs)
    assert port.stats.finished == len(reqs) and port.stats.prefill_calls > 1
    assert port.pool.prefix_hits == ref_eng.pool.prefix_hits >= 2
    assert port.pool.used_blocks == 0
    for i, p, m in reqs:
        assert len(got[i]) == m
        if got[i] != want[i]:
            j = next(k for k, (a, b) in enumerate(zip(got[i], want[i]))
                     if a != b)
            margin = _paged_margin(prt, p, got[i], j, kv_dtype)
            assert margin <= FLIP_MARGIN, (
                f"rid {i}: first divergence at token {j} (port {got[i][j]}, "
                f"reference {want[i][j]}); port logit margin {margin:.3g}")


@pytest.mark.parametrize("capacity", [32, 30])
def test_paged_engine_streams_equal_dense(capacity):
    """Inside the port, dense and paged engines give identical streams, also
    where the capacity is not a whole number of blocks (writes past it are
    junked where the dense layout drops them)."""
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    reqs = _stream(cfg, seed=9)
    out = {}
    for layout in ("dense", "paged"):
        rt = PortRuntime.create(cfg, capacity=capacity, device="cpu",
                                kv_layout=layout)
        kw = dict(block_size=8) if layout == "paged" else {}
        out[layout] = _run(rt.engine(num_slots=3, straggler_kw=NO_STRAGGLER,
                                        **kw), PortRequest, reqs)
    assert out["dense"] == out["paged"]


def test_paged_engine_column0_holds_position0():
    """The kernel stops at the first NULL column after column 0; that is
    sound because every live chain's column 0 holds position 0."""
    cfg = port_smoke("exanode-100m").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu",
                            kv_layout="paged")
    eng = rt.engine(num_slots=3, block_size=4)
    for i, p, m in _stream(cfg, seed=10):
        eng.submit(PortRequest(rid=i, prompt=p, max_new_tokens=m))
    checked = 0
    while eng.tick() or eng.queue:
        for s, r in enumerate(eng.slot_req):
            if r is None:
                continue
            bid = int(eng.pool.table[s, 0])
            assert bid >= pbp.NUM_RESERVED
            for gc in eng.caches:
                for sub in gc.values():
                    assert bool((sub["pos"][:, bid, 0] == 0).all())
            checked += 1
    assert checked > 10 and eng.stats.finished == 10


def test_paged_engine_tight_pool_defers_admission():
    """A pool that holds one request's worst case at a time serializes the
    admissions, and decode-time growth never exhausts it."""
    cfg = port_smoke("llama3.2-3b").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu",
                            kv_layout="paged")
    eng = rt.engine(num_slots=2, block_size=4, num_blocks=5)   # 3 usable
    for i in range(2):
        eng.submit(PortRequest(rid=i, prompt=_tokens(cfg, 4, seed=11 + i),
                               max_new_tokens=4))
    stats = eng.run_to_completion()
    assert stats.finished == 2 and stats.prefill_calls == 2
    assert all(len(r.generated) == 4 for r in eng.finished)
    assert eng.pool.used_blocks == 0


def test_paged_engine_rejects_unservable_request():
    cfg = port_smoke("llama3.2-3b").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu",
                            kv_layout="paged")
    eng = rt.engine(num_slots=2, block_size=4, num_blocks=5)
    with pytest.raises(ValueError, match="usable blocks"):
        eng.submit(PortRequest(rid=0, prompt=np.arange(8, dtype=np.int32),
                               max_new_tokens=16))


def test_paged_engine_reuses_blocks_after_eviction():
    """An identical prompt admitted after its twin finished shares the
    evicted (cached-free) int8 blocks: same physical ids, same stream."""
    cfg = port_smoke("llama3.2-3b").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, capacity=32, device="cpu",
                            kv_layout="paged", kv_dtype="int8")
    eng = rt.engine(num_slots=1, block_size=8)
    prompt = np.arange(1, 17, dtype=np.int32)            # 2 full blocks
    eng.submit(PortRequest(rid=0, prompt=prompt, max_new_tokens=3))
    eng.tick()
    first = eng.pool.table[0, :2].copy()
    eng.run_to_completion()
    assert eng.pool.used_blocks == 0
    assert (eng.pool.table == pbp.NULL_BLOCK).all()
    eng.submit(PortRequest(rid=1, prompt=prompt.copy(), max_new_tokens=3))
    eng.tick()
    assert eng.pool.prefix_hits == 2
    assert (eng.pool.table[0, :2] == first).all()
    eng.run_to_completion()
    a, b = eng.finished
    assert a.generated == b.generated


# -- Runtime -----------------------------------------------------------------


def test_runtime_and_engine_reject_bad_kv_layouts():
    cfg = port_smoke("exanode-100m")
    for kw, msg in (({"kv_layout": "ring"}, "kv_layout"),
                    ({"kv_dtype": "int4"}, "kv_dtype"),
                    ({"kv_dtype": "int8"}, "requires kv_layout='paged'")):
        with pytest.raises(ValueError, match=msg):
            PortRuntime.create(cfg, device="cpu", **kw)
    rt = PortRuntime.create(cfg, device="cpu")
    for kw, msg in (({"kv_layout": "ring"}, "kv_layout"),
                    ({"kv_dtype": "int8"}, "requires kv_layout='paged'"),
                    ({"block_size": 8}, "kv_layout='paged'")):
        with pytest.raises(ValueError, match=msg):
            rt.engine(**kw)
    paged = PortRuntime.create(cfg, device="cpu", kv_layout="paged")
    assert paged.engine(kv_dtype="int8").kv_dtype == "int8"


def test_paged_runtime_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortRuntime.create("exanode-100m", smoke=True, kv_layout="paged")


@pytest.mark.parametrize("kv_layout,kv_dtype",
                         [("dense", "f32"), ("paged", "f32"),
                          ("paged", "int8")])
def test_kv_bytes_per_stream_and_describe(jref, kv_layout, kv_dtype):
    for arch in ARCHS:
        for capacity, bs in ((32, 16), (30, 8), (2048, 16)):
            rrt = jref["runtime"].Runtime.create(
                arch, smoke=True, shape_kind="decode", capacity=capacity,
                kv_layout=kv_layout, kv_dtype=kv_dtype)
            prt = PortRuntime.create(arch, smoke=True, capacity=capacity,
                                     device="cpu", kv_layout=kv_layout,
                                     kv_dtype=kv_dtype)
            assert prt.kv_bytes_per_stream(block_size=bs) == \
                rrt.kv_bytes_per_stream(block_size=bs)
    text = prt.describe()
    assert f"kv_layout={kv_layout} kv_dtype={kv_dtype}" in text
    assert f"kv_bytes/stream={prt.kv_bytes_per_stream():,}" in text
