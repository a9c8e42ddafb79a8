"""The port's kernels: each plain PyTorch version against the reference's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
jnp oracle, and, on a CUDA machine, each Hopper kernel against its plain
version.  Inputs are made from a numpy seed; tolerances are the
reference's (tests/test_kernels.py, tests/test_paged.py): flash 2e-5 f32 /
2e-2 bf16, decode 2e-5, paged decode 1e-5, FFN 1e-5 f32 / 3e-2 bf16; the
plain paged versions are held against the reference in
tests/test_torch_paged.py.

The backward versions are held in f32 at 1e-5 against ``jax.vjp`` of the
reference's Pallas ops (interpret mode) and against ``torch.autograd`` of
the plain forwards.  On the card the backward kernels are held against
them at the reference's grad tolerances in f32 (tests/test_kernels.py:
115-180: flash 2e-4, FFN 1e-4) and at its forward tolerances in bf16
(flash 2e-2, FFN 3e-2: both sides accumulate in f32 and round the grads
to bf16 once, so they differ by about one bf16 step; the bf16 FFN
forward and dx kernels also round their [N, F] intermediate to bf16 once
between their two products, about 2.5e-3 relative, under that step).  The
reference set its 1e-4 at <= 256 rows; the weight grads sum over all N
rows, and the f32 rounding of such a sum grows as sqrt(N) (at 4096 rows
the CPU's own f32 product is 1.02x that 1e-4 away from its f64 value), so
the f32 weight grads are held to 1e-4 * max(1, sqrt(N / 256)).

The bf16 tensor-core kernels round more than their plain versions do: the
dW kernel reads dg, du and h rounded to bf16, the flash forward rounds p
to bf16 for P·V, and the flash backward rounds P and dS to bf16 for its
four second products.  Three CPU tests hold that extra rounding, in plain
torch at the kernels' widths, within the unchanged bf16 tolerances (the
backward's also against the Pallas kernels in interpret mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import fused_ffn as ffn_kernel
from repro_torch.kernels import mlstm_scan as ml_kernel
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import quant as qt_kernel
from repro_torch.kernels import ssm_scan as ssm_kernel

TOL = {"flash": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "decode": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "paged": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "ffn": {torch.float32: 1e-5, torch.bfloat16: 3e-2},
       "flash_bwd": {torch.float32: 2e-4, torch.bfloat16: 2e-2},
       "ffn_bwd": {torch.float32: 1e-4, torch.bfloat16: 3e-2}}
PLAIN_BWD_TOL = 1e-5


def _dw_tol(N, dtype):
    """The FFN weight grads' tolerance at N rows (see the docstring)."""
    tol = TOL["ffn_bwd"][dtype]
    return tol * max(1.0, (N / 256) ** 0.5) if dtype == torch.float32 else tol


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jref():
    """The reference kernels and oracles (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    from repro.kernels import decode_attention, flash_attention, fused_ffn
    from repro.kernels import ref as jnp_ref
    return {"jnp": jax.numpy, "flash": flash_attention,
            "decode": decode_attention, "ffn": fused_ffn, "ref": jnp_ref}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the Hopper kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# -- plain versions against the reference (CPU) ------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
def test_flash_plain_matches_pallas(jref, dtype, causal, window):
    jnp = jref["jnp"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v = (_rand((1, 2, 256, 64), seed=i) for i in range(3))
    out_j, lse_j = jref["flash"]._forward(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal, window, 64, 128,
        True)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out, lse = ref.ref_attention(tq, tk, tv, causal=causal, window=window)
    tol = TOL["flash"][dtype]
    _close(out.float(), out_j, tol, "out vs Pallas")
    _close(lse, lse_j, tol, "lse vs Pallas")
    want = jref["ref"].ref_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     causal=causal, window=window)
    _close(out.float(), want, tol, "out vs jnp oracle")


def test_flash_plain_groups_kv_heads(jref):
    """K/V with fewer heads than Q equal the reference's repeated layout."""
    jnp = jref["jnp"]
    q = _rand((2, 6, 40, 16), seed=3)
    k, v = _rand((2, 2, 40, 16), seed=4), _rand((2, 2, 40, 16), seed=5)
    out, _ = ref.ref_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jref["ref"].ref_attention(jnp.asarray(q),
                                     jnp.repeat(jnp.asarray(k), 3, axis=1),
                                     jnp.repeat(jnp.asarray(v), 3, axis=1))
    _close(out, want, TOL["flash"][torch.float32])


@pytest.mark.parametrize("window", [0, 64])
def test_decode_plain_matches_pallas(jref, window):
    jnp = jref["jnp"]
    B, H, KV, T, D = 2, 8, 2, 256, 64
    q, k, v = (_rand((B, H, D), 6), _rand((B, T, KV, D), 7),
               _rand((B, T, KV, D), 8))
    pos = np.array([T // 3, T - 1], np.int32)
    t = np.arange(T, dtype=np.int32)
    kv_pos = np.where(t[None] <= pos[:, None], t[None], -1).astype(np.int32)
    args = (q, k, v, kv_pos, pos)
    want = jref["decode"].decode_attention(
        *(jnp.asarray(a) for a in args), window=window, bk=64,
        interpret=True)
    got = ref.ref_decode_attention(*(torch.from_numpy(a) for a in args),
                                   window=window)
    _close(got, want, TOL["decode"][torch.float32], "vs Pallas")
    oracle = jref["ref"].ref_decode_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), H // KV, axis=2),
        jnp.repeat(jnp.asarray(v), H // KV, axis=2), jnp.asarray(kv_pos),
        jnp.asarray(pos), window=window)
    _close(got, oracle, TOL["decode"][torch.float32], "vs jnp oracle")


def _edge_rows(T: int = 2048):
    """kv_pos [6,T] / pos [6] (numpy int32) for the split kernels' edge
    rows: 1, 64, 1000 and 2048 valid entries from the start; one whose
    only valid entries are the last 100 (the others hold stale positions
    above its pos: a ring that wrapped); an idle row, every kv_pos -1."""
    kv_pos = np.full((6, T), -1, np.int32)
    pos = np.zeros(6, np.int32)
    for b, n in enumerate((1, 64, 1000, T)):
        kv_pos[b, :n] = np.arange(n)
        pos[b] = n - 1
    kv_pos[4] = np.arange(T) + 5000
    kv_pos[4, T - 100:] = np.arange(100)
    pos[4] = 99
    return kv_pos, pos


def _split_rehearsal(q, k, v, kv_pos, pos, *, window, tile, splits,
                     split_len, k_scale=None, v_scale=None, p_bf16=False):
    """csrc/split_decode.cuh's split-and-combine arithmetic in plain torch
    (f32, natural exp where the kernels take exp2 of scores scaled by
    log2(e): the same numbers) over a dense cache: per (row, kv head) each
    split lists the
    tiles holding a valid entry; a split without one gives an empty
    partial (m = -inf, l = 0) unless the row has no valid entry at all,
    when every tile of the split goes in with its scores at -1e30; tiles
    fold into an online softmax (masked -1e30, past the walk -inf); the
    combine rescales by exp(m_s - m) and divides by max(l, 1e-30).

    int8 K/V come with per-entry scales ``k_scale``/``v_scale`` [B,T,KV]:
    K's multiplies the entry's score, V's its p (l sums p).  ``p_bf16``
    rounds as the tensor-core kernel does: l sums p rounded to bf16 and
    P·V takes p·vs rounded to bf16."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = q.float() * D ** -0.5
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        valid &= kv_pos > (pos[:, None] - window)
    out = torch.empty(B, H, D)
    for b in range(B):
        row_any = bool(valid[b].any())
        for h in range(KV):
            parts = []
            for s in range(splits):
                t0 = s * split_len
                n = min(split_len, T - t0)
                if n <= 0:
                    continue
                vs = valid[b, t0:t0 + n]
                n_tiles = -(-n // tile)
                listed = [j for j in range(n_tiles)
                          if vs[j * tile:(j + 1) * tile].any()]
                idle = not listed and not row_any
                if not listed and not idle:
                    parts.append((torch.full((G,), -torch.inf),
                                  torch.zeros(G), None))
                    continue
                m = torch.full((G,), -torch.inf)
                l, acc = torch.zeros(G), torch.zeros(G, D)
                for j in (range(n_tiles) if idle else listed):
                    e = torch.arange(j * tile, (j + 1) * tile)
                    inside = e < n
                    t = t0 + torch.clamp(e, max=n - 1)
                    kk = k[b, t, h].float()
                    vv = torch.where(inside[:, None], v[b, t, h].float(),
                                     torch.zeros(()))
                    sc = qs[b, h * G:(h + 1) * G] @ kk.T
                    if k_scale is not None:
                        sc = sc * k_scale[b, t, h]
                    ok = inside & vs[torch.clamp(e, max=n - 1)] & (not idle)
                    sc = torch.where(ok, sc, torch.tensor(-1e30))
                    sc = torch.where(inside, sc, torch.tensor(-torch.inf))
                    m_new = torch.maximum(m, sc.max(-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    pv = p if v_scale is None else p * v_scale[b, t, h]
                    if p_bf16:
                        p = p.bfloat16().float()
                        pv = pv.bfloat16().float()
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + pv @ vv
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
            num, den = torch.zeros(G, D), torch.zeros(G)
            for pm, pl_, pa in parts:
                if pa is None:
                    continue
                w = torch.exp(pm - mx)
                num += w[:, None] * pa
                den += w * pl_
            den = torch.clamp(den, min=1e-30)
            out[b, h * G:(h + 1) * G] = num / den[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("plan", ["planner", (8, 256), (3, 704)])
@pytest.mark.parametrize("window", [0, 300])
def test_split_decode_rehearsal_matches_reference_and_pallas(jref, plan,
                                                             window):
    """The split kernels' rules (empty splits, skipped tiles, the idle
    row's uniform mean, the combine) give the reference's numbers on the
    edge rows, in f32, before any card runs them."""
    jnp = jref["jnp"]
    B, H, KV, T, D = 6, 8, 2, 2048, 64
    q, k, v = (_rand((B, H, D), 40), _rand((B, T, KV, D), 41),
               _rand((B, T, KV, D), 42))
    kv_pos, pos = _edge_rows(T)
    tile = da_kernel.tile_entries(D, 2)
    splits, split_len = (da_kernel.plan_splits(B * KV, T, tile)
                         if plan == "planner" else plan)
    assert splits * split_len >= T
    args = (q, k, v, kv_pos, pos)
    got = _split_rehearsal(*(torch.from_numpy(a) for a in args),
                           window=window, tile=tile, splits=splits,
                           split_len=split_len)
    want = ref.ref_decode_attention(*(torch.from_numpy(a) for a in args),
                                    window=window)
    _close(got, want, TOL["decode"][torch.float32], "vs plain version")
    pallas = jref["decode"].decode_attention(
        *(jnp.asarray(a) for a in args), window=window, bk=512,
        interpret=True)
    _close(got, pallas, TOL["decode"][torch.float32], "vs Pallas")
    idle = np.asarray(want[5])                 # the uniform mean of V
    _close(idle, np.repeat(v[5].mean(0), H // KV, axis=0),
           TOL["decode"][torch.float32], "idle row")


@pytest.mark.parametrize("G,groups", [(1, 1), (3, 1), (8, 1), (9, 3),
                                      (12, 2), (16, 2), (48, 6), (13, 13)])
def test_head_groups_are_the_fewest_equal_groups_of_at_most_8(G, groups):
    n = da_kernel.head_groups(G)
    assert n == groups and G % n == 0 and G // n <= da_kernel.GROUP_BLOCK
    assert all(G % m or G // m > da_kernel.GROUP_BLOCK for m in range(1, n))


@pytest.mark.parametrize("G", [9, 16, 48])
def test_split_decode_head_groups_rehearsal_matches_reference_and_pallas(
        jref, G):
    """The split kernels past 8 q heads a kv head: head group x of the
    grid computes q heads [x * G / n, (x + 1) * G / n) against kv head
    x / n (n = head_groups(G)), exactly as a launch with n times the kv
    heads, each read by one group, would.  The split arithmetic over that
    view (each group its own splits, counters and combine) gives the
    reference's numbers on the edge rows, at the planner's split count for
    the groups, against the plain version and the Pallas kernel in
    interpret mode, which takes any G."""
    jnp = jref["jnp"]
    B, KV, T, D = 6, 1, 2048, 16
    H = KV * G
    q, k, v = (_rand((B, H, D), 70), _rand((B, T, KV, D), 71),
               _rand((B, T, KV, D), 72))
    kv_pos, pos = _edge_rows(T)
    n = da_kernel.head_groups(G)
    tile = da_kernel.tile_entries(D, 2)
    splits, split_len = da_kernel.plan_splits(B * KV * n, T, tile)
    tq, tk, tv, tkp, tp = (torch.from_numpy(a)
                           for a in (q, k, v, kv_pos, pos))
    got = _split_rehearsal(tq, tk.repeat_interleave(n, dim=2),
                           tv.repeat_interleave(n, dim=2), tkp, tp,
                           window=0, tile=tile, splits=splits,
                           split_len=split_len)
    want = ref.ref_decode_attention(tq, tk, tv, tkp, tp)
    _close(got, want, TOL["decode"][torch.float32], "vs plain version")
    pallas = jref["decode"].decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, kv_pos, pos)), bk=512,
        interpret=True)
    _close(got, pallas, TOL["decode"][torch.float32], "vs Pallas")


@pytest.mark.parametrize("rows,length,tile,unit,want", [
    (16 * 4, 2048, 64, 1, (8, 256)),       # exanode-100m serve, bf16
    (16 * 8, 2048, 64, 1, (8, 256)),       # jamba-v0.1-52b, bf16 D 128
    (16 * 6, 2048, 64, 1, (8, 256)),       # granite-20b's 6 head groups
    (16 * 8, 2048, 16, 1, (8, 256)),       # the same in f32
    (16 * 4, 128 * 16, 64, 16, (8, 256)),  # the paged pool, 128 columns
    (4, 2048, 64, 1, (32, 64)),            # one row: a tile a split
    (1024, 2048, 64, 1, (8, 256)),         # many rows: runs of 256
    (64, 64, 64, 1, (1, 64)),              # a walk of one tile
    (1, 1 << 20, 64, 1, (128, 8192)),      # the longest walk taken
    (3, 300, 32, 1, (10, 32)),
    (64, 100, 64, 48, (2, 96)),            # blocks that do not tile
])
def test_split_plan(rows, length, tile, unit, want):
    splits, split_len = da_kernel.plan_splits(rows, length, tile, unit)
    assert (splits, split_len) == want
    assert split_len % unit == 0 and split_len >= tile
    assert splits * split_len >= length > (splits - 1) * split_len
    assert split_len <= da_kernel.MAX_SPLIT_LEN


def test_split_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="splits"):
        da_kernel.plan_splits(1, (1 << 20) + 1, 64)
    with pytest.raises(ValueError, match="outgrows"):
        da_kernel.plan_splits(4, 20000, 64, 10000)


@pytest.mark.parametrize("D,itemsize,pool,tile,ring", [
    (16, 2, 2, 64, None), (64, 2, 2, 64, None), (128, 2, 2, 64, None),
    (256, 2, 2, 64, None), (16, 4, 4, 128, None), (64, 4, 4, 32, None),
    (128, 4, 4, 16, None), (256, 4, 4, 16, None),
    # int8 pools (#9): bf16 q, 2 stages of [64][D + 16] int8 K and V + 64 K
    # and 64 V f32 scales; f32 q, 3 stages of [tile][D] int8 + scales, at
    # least the 4 warps' f32 acc [8][D]
    (64, 2, 1, 64, 21504), (128, 2, 1, 64, 37888), (256, 2, 1, 64, 70656),
    (64, 4, 1, 32, 13056), (128, 4, 1, 16, 16384), (256, 4, 1, 16, 32768)])
def test_split_tile_matches_the_kernel_layouts(D, itemsize, pool, tile,
                                               ring):
    """csrc MmaLayout::kTile (bf16: 16 entries a warp, 4 warps) and
    SimtLayout::kTile (f32: 4 passes of 4 warps, 32 / (D / 4) rows a pass:
    4 values a lane, at most 32 lanes a row), and each layout's kBytes
    (the ring of stages, for int8 with the entries' scales)."""
    assert da_kernel.tile_entries(D, itemsize) == tile
    if ring is None:
        ring = (4 * tile * (D + 8) * 2 if itemsize == 2
                else 6 * tile * D * 4)
    assert da_kernel.stage_bytes(D, itemsize, pool) == ring


def _paged_chains(M: int = 128, bs: int = 16, N: int = 300, KV: int = 2,
                  D: int = 64, H: int = 8, seed: int = 50):
    """Pools and a table for chains of 1 and M blocks (row 1 sharing row
    0's first block), a 37-block chain and an idle row (table all NULL);
    numpy, f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, bs, KV, D)).astype(np.float32)
              for _ in range(2))
    pos_pool = np.full((N, bs), -1, np.int32)
    table = np.zeros((4, M), np.int32)
    free = list(rng.permutation(np.arange(2, N)))
    lens = (bs - 5, M * bs, 37 * bs - 3, 0)
    for b, L in enumerate(lens):
        for j in range(-(-L // bs)):
            if b == 1 and j == 0:
                table[1, 0] = table[0, 0]
                continue
            bid = table[b, j] = free.pop()
            t = np.arange(j * bs, (j + 1) * bs)
            pos_pool[bid] = np.where(t < L, t, -1)
    pos = np.array([max(L - 1, 0) for L in lens], np.int32)
    return q, kp, vp, pos_pool, table, pos


def test_paged_split_rehearsal_matches_reference():
    """The same rehearsal over a paged walk (the table's columns up to the
    first NULL after column 0, split over whole columns) against the
    plain paged version: chains of 1 and 128 blocks sharing their first
    block, a 37-block chain, an idle row."""
    q, kp, vp, pos_pool, table, pos = (torch.from_numpy(a)
                                       for a in _paged_chains())
    B, M = table.shape
    bs = kp.shape[1]
    tile = da_kernel.tile_entries(q.shape[2], 2)
    splits, split_len = da_kernel.plan_splits(B * kp.shape[2], M * bs, tile,
                                              bs)
    got = torch.empty_like(q)
    for b in range(B):
        nulls = (table[b, 1:] == 0).nonzero()
        cols = 1 + int(nulls[0]) if len(nulls) else M
        flat = table[b, :cols].long()
        k = kp[flat].reshape(1, cols * bs, *kp.shape[2:])
        v = vp[flat].reshape(1, cols * bs, *vp.shape[2:])
        kv_pos = pos_pool[flat].reshape(1, cols * bs)
        got[b:b + 1] = _split_rehearsal(q[b:b + 1], k, v, kv_pos,
                                        pos[b:b + 1], window=0, tile=tile,
                                        splits=splits, split_len=split_len)
    want = ref.ref_paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    _close(got, want, TOL["paged"][torch.float32])


def _quantize_pools(kp, vp):
    """int8 pools and their f32 per-(block, kv head) max-abs / 127 scales
    [N,KV] from f32 pools [N,bs,KV,D] (torch)."""
    out = []
    for x in (kp, vp):
        sc = x.abs().amax(dim=(1, 3)) / 127.0
        out.append((torch.round(x / sc[:, None, :, None]).to(torch.int8), sc))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


@pytest.mark.parametrize("bs", [16, 48])
@pytest.mark.parametrize("p_bf16", [False, True])
def test_paged_q8_split_rehearsal_matches_reference_and_pallas(jref, bs,
                                                               p_bf16):
    """The split rules over int8 pools, with K's scale on the score and
    V's folded into p, on chains of 1 and 128 blocks sharing their first
    block, a 37-block chain and an idle row, at a block size that tiles
    and one (48) whose blocks straddle the kernels' tiles: against the
    plain version and the reference's Pallas kernel (interpret mode) in
    f32; with p and p·vs rounded to bf16 as the tensor-core kernel rounds
    them, against the plain version at the bf16 tolerance.  The idle row
    is the uniform mean of the dequantized V its walk covers (column 0,
    the NULL block)."""
    from repro.kernels.paged_attention import paged_decode_attention_q8
    jnp = jref["jnp"]
    q, kp, vp, pos_pool, table, pos = (torch.from_numpy(a) for a in
                                       _paged_chains(bs=bs, seed=51))
    kq, vq, ks, vs = _quantize_pools(kp, vp)
    B, M = table.shape
    KV, D = kp.shape[2], q.shape[2]
    G = q.shape[1] // KV
    # the tile of the kernel that rounds so: bf16 q on the tensor cores
    tile = da_kernel.tile_entries(D, 2 if p_bf16 else 4)
    splits, split_len = da_kernel.plan_splits(B * KV, M * bs, tile, bs)
    got = torch.empty_like(q)
    for b in range(B):
        nulls = (table[b, 1:] == 0).nonzero()
        cols = 1 + int(nulls[0]) if len(nulls) else M
        flat = table[b, :cols].long()
        k = kq[flat].reshape(1, cols * bs, KV, D)
        v = vq[flat].reshape(1, cols * bs, KV, D)
        k_scale, v_scale = (x[flat].repeat_interleave(bs, 0)[None]
                            for x in (ks, vs))
        kv_pos = pos_pool[flat].reshape(1, cols * bs)
        got[b:b + 1] = _split_rehearsal(
            q[b:b + 1], k, v, kv_pos, pos[b:b + 1], window=0, tile=tile,
            splits=splits, split_len=split_len, k_scale=k_scale,
            v_scale=v_scale, p_bf16=p_bf16)
    args = (q, kq, vq, ks, vs, pos_pool, table, pos)
    want = ref.ref_paged_decode_attention_q8(*args)
    tol = TOL["paged"][torch.bfloat16 if p_bf16 else torch.float32]
    _close(got, want, tol, "vs plain version")
    if not p_bf16:
        pallas = paged_decode_attention_q8(
            *(jnp.asarray(a.numpy()) for a in args), interpret=True)
        _close(got, pallas, tol, "vs Pallas")
    idle = (vq[0].float() * vs[0][None, :, None]).mean(0)     # [KV, D]
    _close(got[3], idle.repeat_interleave(G, 0), tol, "idle row")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_plain_matches_pallas(jref, dtype):
    jnp = jref["jnp"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    N, D, F = 128, 128, 256
    arrs = (_rand((N, D), 9), _rand((D, F), 10, 0.05),
            _rand((D, F), 11, 0.05), _rand((F, D), 12, 0.05))
    want = jref["ffn"]._forward(*(jnp.asarray(a, jdt) for a in arrs),
                                64, 128, True)
    got = ref.ref_swiglu_ffn(*(torch.from_numpy(a).to(dtype) for a in arrs))
    assert got.dtype == dtype
    _close(got.float(), want, TOL["ffn"][dtype], "vs Pallas")
    oracle = jref["ref"].ref_swiglu_ffn(*(jnp.asarray(a, jdt) for a in arrs))
    _close(got.float(), oracle, TOL["ffn"][dtype], "vs jnp oracle")


# -- plain backward versions against the reference (CPU) --------------------


def _torch_grads(fwd, inputs, cot):
    """torch.autograd of a plain forward for the cotangent ``cot``."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fwd(*leaves)
    return torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("S,T,H,Hkv,causal,window", [
    (72, 72, 12, 4, True, 0), (72, 72, 12, 4, True, 24),
    (40, 72, 4, 4, False, 0), (72, 72, 6, 2, True, 0)])
def test_flash_bwd_plain_matches_pallas_vjp(jref, S, T, H, Hkv, causal,
                                            window):
    """ref_attention_bwd == jax.vjp through the Pallas flash kernel (grouped
    K/V repeated as the reference's model does, so dK/dV sum over each
    group) and == torch.autograd of ref_attention; S and T are not
    multiples of the port's 64-row tile."""
    jax = pytest.importorskip("jax")
    jnp = jref["jnp"]
    G = H // Hkv
    q, do = _rand((2, H, S, 16), 40), _rand((2, H, S, 16), 41)
    k, v = _rand((2, Hkv, T, 16), 42), _rand((2, Hkv, T, 16), 43)

    def fwd(q, k, v):
        return jref["flash"].flash_attention(
            q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1),
            causal=causal, window=window, interpret=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.ref_attention(tq, tk, tv, causal=causal, window=window)
    got = ref.ref_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal,
                                window=window)
    auto = _torch_grads(
        lambda a, b, c: ref.ref_attention(a, b, c, causal=causal,
                                          window=window)[0],
        (tq, tk, tv), tdo)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
        assert g.shape == a.shape
        _close(g, w, PLAIN_BWD_TOL, f"{name} vs Pallas vjp")
        _close(g, a, PLAIN_BWD_TOL, f"{name} vs torch.autograd")


def test_ffn_bwd_plain_matches_pallas_vjp(jref):
    """ref_swiglu_ffn_bwd == jax.vjp through the Pallas fused FFN and ==
    torch.autograd of ref_swiglu_ffn, for every operand."""
    jax = pytest.importorskip("jax")
    jnp = jref["jnp"]
    N, D, F = 96, 64, 256
    arrs = (_rand((N, D), 44), _rand((D, F), 45, 0.05),
            _rand((D, F), 46, 0.05), _rand((F, D), 47, 0.05))
    dy = _rand((N, D), 48)
    _, vjp = jax.vjp(lambda *a: jref["ffn"].swiglu_ffn(*a, br=32, bf=64,
                                                       interpret=True),
                     *(jnp.asarray(a) for a in arrs))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a) for a in arrs]
    got = ref.ref_swiglu_ffn_bwd(*ts, torch.from_numpy(dy))
    auto = _torch_grads(ref.ref_swiglu_ffn, ts, torch.from_numpy(dy))
    for name, g, w, a in zip(("dx", "dw_gate", "dw_up", "dw_down"), got,
                             want, auto):
        _close(g, w, PLAIN_BWD_TOL, f"{name} vs Pallas vjp")
        _close(g, a, PLAIN_BWD_TOL, f"{name} vs torch.autograd")


def test_ffn_bwd_dw_plain_matches_pallas_vjp(jref):
    """ref_swiglu_ffn_bwd_dw (three f32 products over dg, du and h from the
    plain grad math, ref_swiglu_ffn_grads) == the weight grads of jax.vjp
    through the Pallas fused FFN, whose dW kernel recomputes them."""
    jax = pytest.importorskip("jax")
    jnp = jref["jnp"]
    N, D, F = 160, 64, 192
    arrs = (_rand((N, D), 49), _rand((D, F), 50, 0.05),
            _rand((D, F), 51, 0.05), _rand((F, D), 52, 0.05))
    dy = _rand((N, D), 53)
    _, vjp = jax.vjp(lambda *a: jref["ffn"].swiglu_ffn(*a, br=32, bf=64,
                                                       interpret=True),
                     *(jnp.asarray(a) for a in arrs))
    want = vjp(jnp.asarray(dy))[1:]
    x, wg, wu, wd = (torch.from_numpy(a) for a in arrs)
    tdy = torch.from_numpy(dy)
    dg, du, h = ref.ref_swiglu_ffn_grads(x, wg, wu, wd, tdy)
    got = ref.ref_swiglu_ffn_bwd_dw(x, tdy, dg, du, h)
    for name, g, w in zip(("dw_gate", "dw_up", "dw_down"), got, want):
        assert g.shape == tuple(w.shape)
        _close(g, w, PLAIN_BWD_TOL, f"{name} vs Pallas vjp")


def _bf16_pair(t):
    hi = t.bfloat16()
    return torch.stack([hi, (t - hi.float()).bfloat16()])


def test_bf16_hidden_grads_keep_dw_within_the_bf16_bounds():
    """The bf16 dW kernel reads dg, du and h as bf16 (hi, lo) pairs, where
    the plain backward keeps them in f32.  At exanode-100m's widths (D 768,
    F 2048; 1024 of the train step's 4096 rows) each summand rounded once
    to bf16 would keep the weight grads within ||err|| / ||want|| <= 1e-2
    (near 2.3e-3) but drift ~2^-9 of their RMS on every entry, past the
    elementwise 3e-2 atol + rtol bound on the small ones; the pairs keep
    both bounds."""
    N, D, F = 1024, 768, 2048
    x, dy = (torch.from_numpy(_rand((N, D), s)).bfloat16() for s in (54, 55))
    wg, wu = (torch.from_numpy(_rand((D, F), s, D ** -0.5)).bfloat16()
              for s in (56, 57))
    wd = torch.from_numpy(_rand((F, D), 58, F ** -0.5)).bfloat16()
    grads = ref.ref_swiglu_ffn_grads(x, wg, wu, wd, dy)
    want = ref.ref_swiglu_ffn_bwd_dw(x.float(), dy, *grads)
    once = ref.ref_swiglu_ffn_bwd_dw(x, dy, *(g.bfloat16() for g in grads))
    pairs = ref.ref_swiglu_ffn_bwd_dw(
        x, dy, *(_bf16_pair(g).float().sum(0) for g in grads))
    tol = TOL["ffn_bwd"][torch.bfloat16]
    outside = 0
    for name, g1, g2, w in zip(("dw_gate", "dw_up", "dw_down"), once, pairs,
                               want):
        assert g1.dtype == g2.dtype == torch.bfloat16
        for g in (g1, g2):
            assert float((g.float() - w).norm() / w.norm()) <= 1e-2, name
        outside += int(((g1.float() - w).abs() > tol + tol * w.abs()).sum())
        _close(g2.float(), w, tol, name)
    assert outside > 0


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_p_keeps_attention_within_the_bf16_bound(D):
    """The tensor-core flash forward rounds p = exp(s - m) to bf16 for
    P·V and divides by l summed from the f32 p.  At the prefill length
    (1024 causal, the exanode and jamba head dims, bf16 q/k/v) that output,
    rounded to bf16, stays within the bf16 flash tolerance (2e-2 atol +
    rtol) of ref_attention, which keeps p in f32."""
    S, H = 1024, 2
    q, k, v = (torch.from_numpy(_rand((1, H, S, D), s)).bfloat16()
               for s in (90, 91, 92))
    want, _ = ref.ref_attention(q, k, v, causal=True)
    s_ = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * D ** -0.5
    s_ = s_.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                        ref.NEG_INF)
    p = torch.exp(s_ - s_.amax(-1, keepdim=True))
    got = (torch.einsum("bhst,bhtd->bhsd", p.bfloat16().float(), v.float())
           / p.sum(-1, keepdim=True)).bfloat16()
    _close(got.float(), want.float(), TOL["flash"][torch.bfloat16])


def _tc_bwd_rehearsal(q, k, v, o, lse, do, *, causal, window):
    """The bf16 tensor-core backward's arithmetic in plain torch: raw
    scores as f32 sums of the bf16 products, p = exp(s·scale − lse) (0
    where masked), δ = rowsum(dO ⊙ O) and dS = p ⊙ (dO·Vᵀ − δ) in f32; P
    and dS rounded to bf16 before their products (dV = Pᵀ·dO, dQ = dS·K,
    dK = dSᵀ·Q, f32 sums), dQ and dK scaled in f32 after them, the group
    summed in f32 and each grad rounded to bf16 once."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, scale = H // Hkv, D ** -0.5
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    p = torch.exp(torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
                  - lse[..., None])
    if causal:
        qp, kp = torch.arange(S)[:, None], torch.arange(T)[None, :]
        seen = (kp <= qp) & ((kp > qp - window) if window else True)
        p = p.masked_fill(~seen, 0.0)
    delta = (dof * o.float()).sum(-1)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dof, vf) - delta[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhst,bhtd->bhsd", dsb, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", dsb, qf) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", pb, dof)
    dk, dv = (t.view(B, Hkv, G, T, D).sum(2) for t in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("S,T,H,Hkv,D,causal,window", [
    (256, 256, 12, 4, 64, True, 0), (128, 128, 24, 8, 128, True, 0),
    (200, 200, 4, 2, 64, True, 0), (256, 256, 4, 1, 64, True, 100),
    (130, 70, 4, 4, 64, False, 0)])
def test_tc_bwd_rehearsal_matches_pallas_vjp_and_plain(jref, S, T, H, Hkv,
                                                       D, causal, window):
    """The tensor-core backward's roundings (P and dS in bf16 for their
    products) keep bf16 grads within the bf16 flash bounds (2e-2 atol +
    rtol, ||err|| / ||want|| <= 1e-2) of jax.vjp through the Pallas flash
    kernel (interpret mode, f32 over the same bf16 values, grouped K/V
    repeated as the reference's model does) and of ref_attention_bwd:
    exanode's 12 / 4 heads of 64, llama3.2-3b's 24 / 8 of 128, a ragged
    S, a window and a non-causal S x T."""
    jax = pytest.importorskip("jax")
    jnp = jref["jnp"]
    G = H // Hkv
    q, do = (torch.from_numpy(_rand((1, H, S, D), s)).bfloat16()
             for s in (93, 94))
    k, v = (torch.from_numpy(_rand((1, Hkv, T, D), s)).bfloat16()
            for s in (95, 96))

    def fwd(q, k, v):
        return jref["flash"].flash_attention(
            q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1),
            causal=causal, window=window, interpret=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(t.float().numpy())
                            for t in (q, k, v)))
    pallas = vjp(jnp.asarray(do.float().numpy()))
    out, lse = ref.ref_attention(q, k, v, causal=causal, window=window)
    got = _tc_bwd_rehearsal(q, k, v, out, lse, do, causal=causal,
                            window=window)
    plain = ref.ref_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window)
    tol = TOL["flash_bwd"][torch.bfloat16]
    for name, g, w_pallas, w_plain in zip(("dq", "dk", "dv"), got, pallas,
                                          plain):
        assert g.shape == w_plain.shape and g.dtype == torch.bfloat16
        for what, w in (("Pallas vjp", np.asarray(w_pallas)),
                        ("ref_attention_bwd", w_plain.float().numpy())):
            _close(g.float(), w, tol, f"{name} vs {what}")
            w = torch.tensor(np.asarray(w, np.float32))
            assert float((g.float() - w).norm() / w.norm()) <= 1e-2, \
                (name, what)


@pytest.mark.parametrize("op", ["flash", "ffn"])
def test_autograd_functions_take_plain_backward_on_cpu(op):
    """With grad, ops.flash_attention / ops.swiglu_ffn go through their
    autograd Functions, whose CPU backward is the plain one; without grad
    they are the plain forward and build no graph."""
    if op == "flash":
        q, k, v = (torch.from_numpy(_rand(sh, 50 + i)) for i, sh in
                   enumerate([(1, 6, 20, 16), (1, 2, 20, 16),
                              (1, 2, 20, 16)]))
        args, cls = (q, k, v), ops.FlashAttention
        call = lambda *a: ops.flash_attention(*a, window=8)[0]  # noqa: E731
    else:
        args = tuple(torch.from_numpy(_rand(sh, 60 + i, 0.1)) for i, sh in
                     enumerate([(12, 16), (16, 32), (16, 32), (32, 16)]))
        cls, call = ops.SwiGLUFFN, ops.swiglu_ffn
    assert call(*args).grad_fn is None
    leaves = [a.clone().requires_grad_() for a in args]
    out = call(*leaves)
    assert type(out.grad_fn).__name__ == f"{cls.__name__}Backward"
    cot = torch.from_numpy(_rand(tuple(out.shape), 70))
    got = torch.autograd.grad(out, leaves, cot)
    if op == "flash":
        o, lse = ref.ref_attention(*args, window=8)
        want = ref.ref_attention_bwd(*args, o, lse, cot, window=8)
    else:
        want = ref.ref_swiglu_ffn_bwd(*args, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- dispatch, checks and the build (CPU) ------------------------------------


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    ops.reset_launch_counts()
    q = torch.from_numpy(_rand((1, 2, 8, 16), 13))
    out, lse = ops.flash_attention(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 2, 8)
    x = torch.from_numpy(_rand((4, 16), 14))
    w = torch.from_numpy(_rand((16, 32), 15))
    assert ops.swiglu_ffn(x, w, w, w.t().contiguous()).shape == (4, 16)
    assert ops.launch_counts() == {"flash_attention": 0, "fused_ffn": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_decode_attention_q8": 0,
                                   "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_dkv": 0,
                                   "fused_ffn_bwd_dx": 0,
                                   "fused_ffn_bwd_dw": 0,
                                   "mlstm_scan": 0,
                                   "mlstm_scan_bwd": 0,
                                   "quantize_int8": 0,
                                   "dequantize_int8": 0,
                                   "quantized_block_write": 0,
                                   "ssm_scan": 0, "ssm_scan_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the
    CPU itself."""
    q = torch.zeros(1, 1, 8, 64)
    x, w = torch.zeros(4, 16), torch.zeros(16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ffn_kernel.swiglu_ffn(x, w, w, w.t().contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 8), q)
    with pytest.raises(ValueError, match="CUDA"):
        ffn_kernel.swiglu_ffn_bwd(x, w, w, w.t().contiguous(), x)
    with pytest.raises(ValueError, match="CUDA"):
        ml_kernel.mlstm_scan(q, q, q, torch.zeros(1, 1, 8),
                             torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        da_kernel.decode_attention(torch.zeros(1, 2, 64),
                                   torch.zeros(1, 8, 1, 64),
                                   torch.zeros(1, 8, 1, 64),
                                   torch.zeros(1, 8, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        qt_kernel.quantize_rows(x)
    with pytest.raises(ValueError, match="CUDA"):
        qt_kernel.dequantize_rows(torch.zeros(4, 16, dtype=torch.int8),
                                  torch.zeros(4))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        qt_kernel.quantized_block_write(
            [torch.zeros(3, 4, 1, 8, dtype=torch.int8)], [torch.zeros(3, 1)],
            [torch.zeros(2, 1, 8)], idx, idx)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_every_cuda_source_is_built():
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    with pytest.raises(KeyError, match="no kernel source"):
        _build.library("flash_attention_fwd")


def test_build_is_keyed_by_sources():
    paths = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert len(set(p.parent for p in paths.values())) == len(paths)
    assert all(_build.lib_path(n) == p for n, p in paths.items())


@pytest.mark.parametrize("N,expect_splits", [(16, True), (4096, False)])
def test_ffn_plan_splits_f_only_when_rows_leave_sms_idle(N, expect_splits):
    br, f_per_split, splits = ffn_kernel.plan(N, 768, 2048, num_sms=132)
    assert br * 768 <= ffn_kernel.SMEM_ROWS_X_D and br >= min(N, 8)
    assert f_per_split % ffn_kernel.BF == 0 and f_per_split * splits >= 2048
    assert (splits > 1) == expect_splits
    if expect_splits:
        assert -(-N // br) * splits <= 132


@pytest.mark.parametrize("N,D,F,splits", [(4096, 768, 2048, 1),
                                           (64, 768, 512, 2), (200, 768, 512, 4),
                                           (300, 3072, 8192, 1)])
def test_ffn_dw_plan_tiles_fit_and_split_rows(N, D, F, splits):
    bf, rows_per_split, n_splits = ffn_kernel.plan_dw(N, D, F, num_sms=132)
    chunk = ffn_kernel.DW_CHUNK_X_BF // bf
    assert 12 * D * bf + 12 * ffn_kernel.DW_CHUNK_X_BF \
        <= ffn_kernel.DW_SMEM_BYTES
    assert rows_per_split % chunk == 0
    assert n_splits == splits and rows_per_split * n_splits >= N
    assert rows_per_split * (n_splits - 1) < N          # no empty split
    assert ffn_kernel.plan_dx(N, D) * D <= ffn_kernel.SMEM_ROWS_X_D


# every config the port registers with a SwiGLU FFN (xlstm-125m has none,
# d_ff 0): the bf16 tensor-core FFN's widths (the MoE configs' experts are
# SwiGLU FFNs of d_ff each, which run as torch.bmm)
SILU_ARCHS = ("exanode-100m", "llama3.2-3b", "jamba-v0.1-52b", "qwen3-4b",
              "qwen3-moe-30b-a3b", "mixtral-8x7b")


def test_silu_archs_are_every_registered_silu_config():
    assert set(SILU_ARCHS) == {a for a in ARCHS
                               if get_config(a).mlp_act == "silu"
                               and get_config(a).d_ff > 0}


def _cover(n: int, tile: int, tiles: int) -> np.ndarray:
    """How often each of n positions is covered by ``tiles`` tiles of
    ``tile`` starting at ``i * tile``, as the kernels map block indices."""
    cov = np.zeros(n, np.int64)
    for i in range(tiles):
        cov[i * tile:(i + 1) * tile] += 1
    return cov


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N", [1, 16, 600, 4096, 16384])
@pytest.mark.parametrize("arch", SILU_ARCHS)
def test_ffn_tc_plan_covers_outputs_once(arch, N, backward):
    """The bf16 route's tiles: both kernels' grids cover every row, every
    F column (first kernel) and every D column (second kernel) once, and
    every 64-deep K tile of the second kernel lies in exactly one split;
    K is split only when the output tiles alone leave SMs idle, and then
    into no more splits than fill them; the scratch is [N, F]."""
    cfg = get_config(arch)
    D, F, sms = cfg.d_model, cfg.d_ff, 132
    assert D % 8 == 0 and F % 8 == 0                # TMA's 16-byte strides
    pl = ffn_kernel.plan_tc(N, D, F, sms, backward=backward)
    rows, f_tiles = pl.grid1
    rows2, d_tiles, splits = pl.grid2
    assert pl.bm in (64, 128) and pl.bn1 in (64, 128) and rows2 == rows
    assert (_cover(N, pl.bm, rows) == 1).all()
    assert (_cover(F, pl.bn1, f_tiles) == 1).all()
    assert (_cover(D, ffn_kernel.TC_BN_DOWN, d_tiles) == 1).all()
    assert pl.k_tiles == -(-F // ffn_kernel.TC_BK) * (2 if backward else 1)
    assert (_cover(pl.k_tiles, pl.k_tiles_per_split, splits) == 1).all()
    tiles = rows * d_tiles
    assert (splits > 1) == (tiles < sms)
    assert tiles * (splits - 1) < sms
    assert pl.splits == splits and pl.scratch == (N, F)


@pytest.mark.parametrize("N", [1, 16, 600, 4096, 16384])
@pytest.mark.parametrize("arch", SILU_ARCHS)
def test_ffn_dw_tc_plan_covers_outputs_once(arch, N):
    """The bf16 dW kernel's tiles: each block's [bm, bn] tile of [D, F]
    holds all three products (dWg and dWu at [d, f], dWd at [f, d]), so the
    grid covers every element of each of the three grads once when its D
    tiles cover every row of D once and its F tiles every column of F
    once; every 64-row K tile lies in exactly one split, none empty; the
    rows are split only when the output tiles alone leave SMs idle, and
    then into no more splits than fill them."""
    cfg = get_config(arch)
    D, F, sms = cfg.d_model, cfg.d_ff, 132
    pl = ffn_kernel.plan_dw_tc(N, D, F, sms)
    d_tiles, f_tiles, splits = pl.grid
    assert pl.bm in (64, 128) and pl.bn == ffn_kernel.TC_BN_GRAD
    cover_d, cover_f = _cover(D, pl.bm, d_tiles), _cover(F, pl.bn, f_tiles)
    for name, rows, cols in (("dw_gate", cover_d, cover_f),
                             ("dw_up", cover_d, cover_f),
                             ("dw_down", cover_f, cover_d)):
        assert (rows == 1).all() and (cols == 1).all(), name
    assert pl.k_tiles == 2 * -(-N // ffn_kernel.TC_BK)   # hi, lo rows
    assert (_cover(pl.k_tiles, pl.k_tiles_per_split, splits) == 1).all()
    assert pl.k_tiles_per_split * (splits - 1) < pl.k_tiles   # none empty
    tiles = d_tiles * f_tiles
    assert (splits > 1) == (tiles < sms)
    assert tiles * (splits - 1) < sms
    assert pl.splits == splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fa_kernel.HEAD_DIMS)
def test_flash_route_takes_tensor_cores_for_bf16_at_64_and_128(dtype, D):
    """bf16 at head dims 64 (exanode-100m) and 128 (llama3.2-3b,
    jamba-v0.1-52b) runs on the tensor cores; f32 and the other head dims
    on the SIMT kernel."""
    want = ("tc" if dtype == torch.bfloat16 and D in (64, 128) else "simt")
    assert fa_kernel.route(dtype, D) == want
    assert set(fa_kernel.TC_HEAD_DIMS) <= set(fa_kernel.HEAD_DIMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fa_kernel.BWD_HEAD_DIMS)
def test_flash_bwd_route_takes_tensor_cores_for_bf16_at_64_and_128(dtype, D):
    """The backward's route matches the forward's: bf16 at head dims 64
    and 128 on the tensor cores, f32 and bf16 at 16, 32 and 256 (gemma-2b)
    on the SIMT kernels; a head dim outside BWD_HEAD_DIMS has no
    backward."""
    want = "tc" if dtype == torch.bfloat16 and D in (64, 128) else "simt"
    assert fa_kernel.route_bwd(dtype, D) == want
    assert fa_kernel.BWD_HEAD_DIMS == fa_kernel.HEAD_DIMS
    assert fa_kernel.route_bwd(dtype, 256) == "simt"
    for bad in (8, 96, 512):
        with pytest.raises(ValueError, match=f"head dim {bad}"):
            fa_kernel.route_bwd(dtype, bad)


def test_flash_route_takes_tensor_cores_on_the_bf16_model_paths():
    """The configs whose attention runs on the card in bf16 (exanode-100m
    serving and training, llama3.2-3b, jamba-v0.1-52b's attention layer,
    qwen3-4b and granite-20b at head dim 128) have head dims the
    tensor-core forward and backward take."""
    for arch in ("exanode-100m", "llama3.2-3b", "jamba-v0.1-52b",
                 "qwen3-4b", "granite-20b"):
        assert fa_kernel.route(torch.bfloat16,
                               get_config(arch).head_dim) == "tc", arch
        assert fa_kernel.route_bwd(torch.bfloat16,
                                   get_config(arch).head_dim) == "tc", arch


# -- Hopper kernels against their plain versions (CUDA only) -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,Hkv,causal,window", [
    (256, 256, 4, True, 0), (200, 200, 2, True, 0), (130, 70, 4, False, 0),
    (256, 256, 1, True, 100)])
def test_flash_kernel_matches_plain(cuda, dtype, S, T, Hkv, causal, window):
    q = torch.from_numpy(_rand((2, 4, S, 64), 20)).to(cuda, dtype)
    k = torch.from_numpy(_rand((2, Hkv, T, 64), 21)).to(cuda, dtype)
    v = torch.from_numpy(_rand((2, Hkv, T, 64), 22)).to(cuda, dtype)
    out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window)
    want, want_lse = ref.ref_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(out.float().cpu(), want.float().cpu(), TOL["flash"][dtype])
    _close(lse.cpu(), want_lse.cpu(), TOL["flash"][torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 50])
def test_decode_kernel_matches_plain(cuda, dtype, window):
    B, H, KV, T, D = 3, 12, 4, 300, 64
    q = torch.from_numpy(_rand((B, H, D), 23)).to(cuda, dtype)
    k = torch.from_numpy(_rand((B, T, KV, D), 24)).to(cuda, dtype)
    v = torch.from_numpy(_rand((B, T, KV, D), 25)).to(cuda, dtype)
    pos = torch.tensor([0, 150, T - 1], dtype=torch.int32, device=cuda)
    t = torch.arange(T, dtype=torch.int32, device=cuda)
    kv_pos = torch.where(t[None] <= pos[:, None], t[None],
                         torch.full_like(t[None], -1)).contiguous()
    got = da_kernel.decode_attention(q, k, v, kv_pos, pos, window=window)
    want = ref.ref_decode_attention(q, k, v, kv_pos, pos, window=window)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["decode"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("H,KV,D", [(12, 4, 64), (32, 8, 128), (24, 8, 128),
                                    (8, 8, 64), (16, 2, 32), (8, 4, 256)])
def test_decode_split_kernel_matches_plain(cuda, dtype, window, H, KV, D):
    """The split kernel on the edge rows at T = 2048: 1, 64, 1000 and
    2048 valid entries, valid entries only in the last split, an idle
    row; exanode-100m's 12 / 4 heads of 64, jamba-v0.1-52b's 32 / 8 and
    llama3.2-3b's 24 / 8 heads of 128, and other groups and head dims."""
    T = 2048
    kv_pos, pos = (torch.from_numpy(a).to(cuda) for a in _edge_rows(T))
    B = pos.shape[0]
    q = torch.from_numpy(_rand((B, H, D), 43)).to(cuda, dtype)
    k = torch.from_numpy(_rand((B, T, KV, D), 44)).to(cuda, dtype)
    v = torch.from_numpy(_rand((B, T, KV, D), 45)).to(cuda, dtype)
    got = da_kernel.decode_attention(q, k, v, kv_pos, pos, window=window)
    want = ref.ref_decode_attention(q, k, v, kv_pos, pos, window=window)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["decode"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(1, 2048), (16, 2048), (3, 100), (2, 20000)])
def test_decode_split_kernel_matches_plain_across_plans(cuda, dtype, B, T):
    """Other split plans: one row (a tile a split), the serve batch, a
    walk shorter than a split's tile, one longer than a split's 8192."""
    H, KV, D = 12, 4, 64
    rng = np.random.default_rng(46)
    lens = rng.integers(1, T + 1, B)
    t = np.arange(T)
    kv_pos = torch.from_numpy(np.where(t[None] < lens[:, None], t[None], -1)
                              .astype(np.int32)).to(cuda)
    pos = torch.from_numpy((lens - 1).astype(np.int32)).to(cuda)
    q = torch.from_numpy(_rand((B, H, D), 47)).to(cuda, dtype)
    k = torch.from_numpy(_rand((B, T, KV, D), 48)).to(cuda, dtype)
    v = torch.from_numpy(_rand((B, T, KV, D), 49)).to(cuda, dtype)
    got = da_kernel.decode_attention(q, k, v, kv_pos, pos)
    want = ref.ref_decode_attention(q, k, v, kv_pos, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["decode"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(8, 2, 64), (12, 4, 64), (24, 8, 128)])
def test_paged_split_kernel_matches_plain_on_long_chains(cuda, dtype, H, KV,
                                                         D):
    """Chains of 1 and 128 blocks sharing their first block, a 37-block
    chain and an idle row (table all NULL), 128 table columns."""
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a).to(cuda)
        for a in _paged_chains(KV=KV, D=D, H=H))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = pa_kernel.paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    want = ref.ref_paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype])


@pytest.mark.cuda
def test_split_kernels_leave_their_arrival_counters_zero(cuda):
    """The last split of each (row, kv head) combines and resets its
    counter, so back-to-back launches of both split kernels reuse one
    zeroed buffer and agree with their plain versions every time."""
    T = 2048
    kv_pos, pos = (torch.from_numpy(a).to(cuda) for a in _edge_rows(T))
    B, H, KV, D = pos.shape[0], 12, 4, 64
    q = torch.from_numpy(_rand((B, H, D), 60)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_rand((B, T, KV, D), 61)).to(cuda, torch.bfloat16)
    v = torch.from_numpy(_rand((B, T, KV, D), 62)).to(cuda, torch.bfloat16)
    pq, kp, vp, pos_pool, table, ppos = (
        torch.from_numpy(a).to(cuda) for a in _paged_chains(KV=KV, D=D, H=H))
    pq, kp, vp = (t.to(torch.bfloat16) for t in (pq, kp, vp))
    want = ref.ref_decode_attention(q, k, v, kv_pos, pos)
    want_p = ref.ref_paged_decode_attention(pq, kp, vp, pos_pool, table, ppos)
    for _ in range(3):
        got = da_kernel.decode_attention(q, k, v, kv_pos, pos)
        got_p = pa_kernel.paged_decode_attention(pq, kp, vp, pos_pool, table,
                                                 ppos)
        torch.cuda.synchronize()
        _close(got.float().cpu(), want.float().cpu(),
               TOL["decode"][torch.bfloat16])
        _close(got_p.float().cpu(), want_p.float().cpu(),
               TOL["paged"][torch.bfloat16])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    counters = da_kernel.arrival_counters(q.device, stream, B * KV)
    assert int(counters.abs().sum()) == 0


def _paged_case(H, KV, D, seed, bs=16, M=6, N=24, B=4):
    """Paged inputs: rows with 1, M-1, M and 2 blocks (NULL tails), row 3
    sharing row 2's first block, tail entries past each row's length
    holding stale positions above every query's; numpy, q/pools f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, bs, KV, D)).astype(np.float32)
              for _ in range(2))
    pos_pool = np.full((N, bs), -1, np.int32)
    pos_pool[2:] = rng.integers(10 * bs, 20 * bs, (N - 2, bs))
    table = np.zeros((B, M), np.int32)
    free = list(rng.permutation(np.arange(2, N)))
    lens = [5, (M - 1) * bs, M * bs - 3, bs + 7]
    for b, L in enumerate(lens):
        for j in range(-(-L // bs)):
            if b == 3 and j == 0:
                table[b, j] = table[2, 0]
                continue
            bid = table[b, j] = free.pop()
            valid = np.arange(j * bs, (j + 1) * bs) < L
            pos_pool[bid, valid] = np.arange(j * bs, (j + 1) * bs)[valid]
    pos = np.array([L - 1 for L in lens], np.int32)
    pos[2] -= 2                        # the chain holds entries past pos
    return q, kp, vp, pos_pool, table, pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(8, 2, 64), (6, 1, 64), (4, 4, 64),
                                    (12, 4, 64), (24, 8, 128)])
def test_paged_kernel_matches_plain(cuda, dtype, H, KV, D):
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a).to(cuda) for a in _paged_case(H, KV, D, 30))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = pa_kernel.paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    want = ref.ref_paged_decode_attention(q, kp, vp, pos_pool, table, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(8, 2, 64), (6, 1, 64), (4, 4, 64),
                                    (12, 4, 64), (24, 8, 128), (16, 2, 128),
                                    (16, 2, 256), (8, 1, 256)])
def test_paged_q8_kernel_matches_plain(cuda, dtype, H, KV, D):
    """Also 8 q heads a kv head at head dims 128 and 256 (gemma-2b's int8
    pool: G * D up to 2048, which the first version refused)."""
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a).to(cuda) for a in _paged_case(H, KV, D, 31))
    q = q.to(dtype)
    kq, vq, ks, vs = _quantize_pools(kp, vp)
    got = pa_kernel.paged_decode_attention_q8(q, kq, vq, ks, vs, pos_pool,
                                              table, pos)
    want = ref.ref_paged_decode_attention_q8(q, kq, vq, ks, vs, pos_pool,
                                             table, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 48])
@pytest.mark.parametrize("H,KV,D", [(8, 2, 64), (12, 4, 64), (24, 8, 128),
                                    (16, 2, 256)])
def test_paged_q8_split_kernel_matches_plain_on_long_chains(cuda, dtype, bs,
                                                            H, KV, D):
    """The int8 split kernel on chains of 1 and 128 blocks sharing their
    first block, a 37-block chain and an idle row (table all NULL), 128
    table columns, at a block size that tiles and one that does not."""
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a).to(cuda)
        for a in _paged_chains(bs=bs, KV=KV, D=D, H=H, seed=52))
    kq, vq, ks, vs = _quantize_pools(kp, vp)
    args = (q.to(dtype), kq, vq, ks, vs, pos_pool, table, pos)
    got = pa_kernel.paged_decode_attention_q8(*args)
    want = ref.ref_paged_decode_attention_q8(*args)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype])


@pytest.mark.cuda
def test_paged_q8_kernel_takes_the_split_limits(cuda):
    """#9 takes #8's limits: any G (G 16 runs as two head groups of 8; the
    first version's G * D <= 1024 and the later G <= 8 are gone) at any
    head dim of HEAD_DIMS; another head dim is refused."""
    q, kp, vp, pos_pool, table, pos = (
        torch.from_numpy(a).to(cuda) for a in _paged_case(16, 1, 256, 32))
    kq, vq, ks, vs = _quantize_pools(kp, vp)
    got = pa_kernel.paged_decode_attention_q8(q, kq, vq, ks, vs, pos_pool,
                                              table, pos)      # G 16
    want = ref.ref_paged_decode_attention_q8(q, kq, vq, ks, vs, pos_pool,
                                             table, pos)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), TOL["paged"][torch.float32])
    with pytest.raises(ValueError, match="D=96"):
        pa_kernel.paged_decode_attention_q8(
            q[..., :96].contiguous(), kq[..., :96].contiguous(),
            vq[..., :96].contiguous(), ks, vs, pos_pool, table, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(16, 1, 128), (48, 1, 128), (32, 2, 64),
                                    (12, 1, 256)])
def test_split_kernels_take_wide_groups(cuda, dtype, H, KV, D):
    """#3, #8 and #9 past 8 q heads a kv head (granite-20b's 48 / 1 heads
    of 128, G 16 and 12, two kv heads of 16 groups) against their plain
    versions: the dense kernel on the edge rows at T = 2048, the paged
    kernels on long chains over f32 / bf16 and int8 pools."""
    T = 2048
    kv_pos, pos = (torch.from_numpy(a).to(cuda) for a in _edge_rows(T))
    B = pos.shape[0]
    q = torch.from_numpy(_rand((B, H, D), 90)).to(cuda, dtype)
    k = torch.from_numpy(_rand((B, T, KV, D), 91)).to(cuda, dtype)
    v = torch.from_numpy(_rand((B, T, KV, D), 92)).to(cuda, dtype)
    got = da_kernel.decode_attention(q, k, v, kv_pos, pos)
    want = ref.ref_decode_attention(q, k, v, kv_pos, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["decode"][dtype],
           "dense")
    pq, kp, vp, pos_pool, table, ppos = (
        torch.from_numpy(a).to(cuda) for a in _paged_chains(KV=KV, D=D, H=H))
    args = (pq.to(dtype), kp.to(dtype), vp.to(dtype), pos_pool, table, ppos)
    got = pa_kernel.paged_decode_attention(*args)
    want = ref.ref_paged_decode_attention(*args)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype],
           "paged")
    kq, vq, ks, vs = _quantize_pools(kp, vp)
    args = (pq.to(dtype), kq, vq, ks, vs, pos_pool, table, ppos)
    got = pa_kernel.paged_decode_attention_q8(*args)
    want = ref.ref_paged_decode_attention_q8(*args)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), TOL["paged"][dtype],
           "int8 paged")
    stream = torch.cuda.current_stream(cuda).cuda_stream
    counters = da_kernel.arrival_counters(q.device, stream, B * H)
    assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_groups_equal_their_groups_launched_alone(cuda, dtype,
                                                       monkeypatch):
    """A G 48 launch is six G <= 8 launches in one: at a fixed split plan
    its output equals, bit for bit, that of six launches each taking 8 of
    the q heads against the same cache (dense, paged and int8 pools), so a
    head group runs exactly the code and roundings a G 8 launch runs."""
    monkeypatch.setattr(da_kernel, "plan_splits",
                        lambda *a, **k: (8, 256))
    T, H, D = 2048, 48, 128
    kv_pos, pos = (torch.from_numpy(a).to(cuda) for a in _edge_rows(T))
    B = pos.shape[0]
    q = torch.from_numpy(_rand((B, H, D), 93)).to(cuda, dtype)
    k = torch.from_numpy(_rand((B, T, 1, D), 94)).to(cuda, dtype)
    v = torch.from_numpy(_rand((B, T, 1, D), 95)).to(cuda, dtype)
    pq, kp, vp, pos_pool, table, ppos = (
        torch.from_numpy(a).to(cuda) for a in _paged_chains(KV=1, D=D, H=H))
    pq, kp, vp = (t.to(dtype) for t in (pq, kp, vp))
    kq, vq, ks, vs = _quantize_pools(kp.float(), vp.float())
    cases = {
        "dense": (lambda x: da_kernel.decode_attention(x, k, v, kv_pos, pos),
                  q),
        "paged": (lambda x: pa_kernel.paged_decode_attention(
            x, kp, vp, pos_pool, table, ppos), pq),
        "int8": (lambda x: pa_kernel.paged_decode_attention_q8(
            x, kq, vq, ks, vs, pos_pool, table, ppos), pq)}
    for name, (fn, x) in cases.items():
        whole = fn(x)
        parts = torch.cat([fn(x[:, g:g + 8].contiguous())
                           for g in range(0, H, 8)], dim=1)
        torch.cuda.synchronize()
        assert torch.equal(whole, parts), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(8, 1), (2, 1), (4, 2)])
@pytest.mark.parametrize("S,T,causal,window", [
    (512, 512, True, 0), (200, 200, True, 0), (256, 256, True, 100),
    (130, 70, False, 0), (100, 150, True, 0)])
def test_flash_bwd_kernels_match_plain_at_head_dim_256(cuda, dtype, H, Hkv,
                                                       S, T, causal, window):
    """#4 and #5 at head dim 256 (gemma-2b's 8 / 1 heads, the model's
    strided views; 32-row tiles) against ``ref_attention_bwd``: causal,
    ragged, windowed, non-causal and T != S."""
    q, k, v, out, lse, do = _flash_bwd_case(cuda, dtype, 2, H, Hkv, S, T,
                                            256, causal, window, seed=86)
    assert fa_kernel.route_bwd(dtype, 256) == "simt"
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    want = ref.ref_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    _check_flash_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,F", [(1, 256, 512), (16, 256, 512),
                                   (300, 256, 512), (600, 256, 512),
                                   (16, 3072, 8192), (300, 3072, 8192),
                                   (16, 4096, 14336), (600, 4096, 14336)])
def test_ffn_kernel_matches_plain(cuda, dtype, N, D, F):
    """Ragged N (bf16: 64- and 128-row tiles, split and unsplit down
    kernel), llama3.2-3b's and jamba-v0.1-52b's widths.  In f32 the
    reference's 1e-5 (set at F 512) is scaled by sqrt(F / 512), as at
    jamba width below."""
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda, dtype) for a in (
        _rand((N, D), 26), _rand((D, F), 27, D ** -0.5),
        _rand((D, F), 28, D ** -0.5), _rand((F, D), 29, F ** -0.5)))
    got = ffn_kernel.swiglu_ffn(x, wg, wu, wd)
    want = ref.ref_swiglu_ffn(x, wg, wu, wd)
    torch.cuda.synchronize()
    tol = TOL["ffn"][dtype] * ((F / 512) ** 0.5 if dtype == torch.float32
                               else 1.0)
    _close(got.float().cpu(), want.float().cpu(), tol)


@pytest.mark.cuda
def test_ffn_tc_route_refuses_what_tma_cannot_load(cuda):
    """bf16 goes to the tensor-core route, whose TMA loads need D and F
    multiples of 8 and 16-byte aligned tensors: it raises otherwise."""
    x = torch.zeros(4, 20, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(20, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8|% 8"):
        ffn_kernel.swiglu_ffn(x, w, w, w.t().contiguous())
    buf = torch.zeros(4 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    x = buf[1:].view(4, 16)                          # 2 bytes off
    w = torch.zeros(16, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ffn_kernel.swiglu_ffn(x, w, w, w.t().contiguous())


def _flash_bwd_case(cuda, dtype, B, H, Hkv, S, T, D, causal, window, seed):
    """Seeded q/k/v/dO in the model's [B,S,H,D] -> [B,H,S,D] views and the
    forward's (out, lse) from the plain version, on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).transpose(1, 2)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=cuda).transpose(1, 2)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=cuda).transpose(1, 2)
    do = torch.randn(B, H, S, D, generator=gen, device=cuda)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    out, lse = ref.ref_attention(q, k, v, causal=causal, window=window)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 4, 64), (12, 4, 64),
                                     (24, 8, 128), (6, 2, 128)])
@pytest.mark.parametrize("S,T,causal,window", [
    (256, 256, True, 0), (200, 200, True, 0), (256, 256, True, 100),
    (130, 70, False, 0), (100, 150, True, 0)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, H, Hkv, D, S, T, causal,
                                       window):
    q, k, v, out, lse, do = _flash_bwd_case(cuda, dtype, 2, H, Hkv, S, T, D,
                                            causal, window, seed=80)
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    want = ref.ref_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    _check_flash_grads(got, want, dtype)


def _check_flash_grads(got, want, dtype):
    """The backward kernels' bounds: TOL["flash_bwd"] atol + rtol, and in
    bf16 ||err|| / ||want|| <= 1e-2 (a zeroed grad passes an absolute bound
    where the grads are small, never this one)."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = g.float().cpu(), w.float().cpu()
        _close(g, w, TOL["flash_bwd"][dtype], name)
        if dtype == torch.bfloat16:
            assert float((g - w).norm() / w.norm()) <= 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain_at_the_train_shape(cuda, dtype):
    """exanode-100m's train step (batch 8 x 512, 12 / 4 heads of 64, the
    model's strided views): 768 dq and 256 dkv blocks, several waves."""
    q, k, v, out, lse, do = _flash_bwd_case(cuda, dtype, 8, 12, 4, 512, 512,
                                            64, True, 0, seed=83)
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do)
    want = ref.ref_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    _check_flash_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_tc_kernels_are_deterministic(cuda, D):
    """Grouped dK/dV are summed inside the dkv block, without atomics: two
    launches give bit-identical dq, dk and dv."""
    q, k, v, out, lse, do = _flash_bwd_case(cuda, torch.bfloat16, 2, 12, 4,
                                            300, 300, D, True, 0, seed=84)
    first = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def _bwd_kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "flash_bwd" in e.key}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_bwd_route_launches_tc_kernels_for_bf16_at_64_and_128(
        cuda, dtype, D):
    """route_bwd sends bf16 at head dims 64 and 128 to the tensor-core
    kernels and f32 (and bf16 at 32 and 256) to the SIMT ones: the
    kernels the profiler sees launched are the route's, and their grads
    match."""
    q, k, v, out, lse, do = _flash_bwd_case(cuda, dtype, 1, 4, 2, 128, 128,
                                            D, True, 0, seed=85)
    tc = fa_kernel.route_bwd(dtype, D) == "tc"
    assert tc == (dtype == torch.bfloat16 and D in (64, 128))
    got = []
    names = _bwd_kernel_names(
        lambda: got.extend(fa_kernel.flash_attention_bwd(q, k, v, out, lse,
                                                         do)))
    want = ("_tc_kernel" if tc else "_kernel<")
    assert len(names) == 2 and all(
        any(f"flash_bwd_{x}{want}" in n for n in names)
        for x in ("dq", "dkv")), names
    _check_flash_grads(got, ref.ref_attention_bwd(q, k, v, out, lse, do),
                       dtype)


@pytest.mark.cuda
def test_flash_bwd_tc_copies_a_dout_tma_cannot_load(cuda):
    """On the tensor-core route a dout whose layout TMA cannot load (a
    misaligned view, a non-contiguous head dim) is copied, not sent to the
    SIMT kernels: the grads match; q/k/v that TMA cannot load raise."""
    q, k, v, out, lse, do = _flash_bwd_case(cuda, torch.bfloat16, 1, 4, 2,
                                            96, 96, 64, True, 0, seed=86)
    want = ref.ref_attention_bwd(q, k, v, out, lse, do)
    buf = torch.empty(do.numel() + 1, device=cuda, dtype=do.dtype)
    shifted = buf[1:].view(do.shape)
    shifted.copy_(do)
    wide = torch.empty(*do.shape[:3], 128, device=cuda, dtype=do.dtype)
    wide[..., ::2] = do
    for dout in (shifted, wide[..., ::2]):
        _check_flash_grads(fa_kernel.flash_attention_bwd(q, k, v, out, lse,
                                                         dout),
                           want, torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.flash_attention_bwd(shifted, k, v, out, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,F", [(1, 256, 512), (16, 256, 512),
                                   (300, 256, 512), (600, 256, 512),
                                   (4096, 768, 2048), (40, 3072, 1024),
                                   (600, 3072, 8192)])
def test_ffn_bwd_kernels_match_plain(cuda, dtype, N, D, F):
    gen = torch.Generator(device=cuda).manual_seed(81)
    x = torch.randn(N, D, generator=gen, device=cuda)
    ws = [torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
          torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
          torch.randn(F, D, generator=gen, device=cuda) * F ** -0.5]
    dy = torch.randn(N, D, generator=gen, device=cuda)
    args = [t.to(dtype) for t in [x] + ws + [dy]]
    got = ffn_kernel.swiglu_ffn_bwd(*args)
    want = ref.ref_swiglu_ffn_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        tol = TOL["ffn_bwd"][dtype] if name == "dx" else _dw_tol(N, dtype)
        _close(g.float().cpu(), w.float().cpu(), tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_launch_backward_kernels(cuda, dtype):
    """On the card the Functions' backward launches the backward kernels:
    one dq and one dkv launch per attention backward; per FFN backward, in
    f32 the dx kernel and the dW kernel with its row-split reduce, in bf16
    the gradient kernel once, the dx kernel and its split-K reduce, and
    the dW kernel on the gradient kernel's scratch."""
    ops.reset_launch_counts()
    q, k, v, _, _, do = _flash_bwd_case(cuda, torch.float32, 1, 6, 2, 96, 96,
                                        64, True, 0, seed=82)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, _ = ops.flash_attention(*leaves)
    torch.autograd.grad(out, leaves, do)
    x = torch.randn(64, 64, device=cuda, dtype=dtype, requires_grad=True)
    w = torch.randn(64, 128, device=cuda, dtype=dtype, requires_grad=True)
    y = ops.swiglu_ffn(x, w, w, w.t().contiguous())
    torch.autograd.grad(y.sum(), [x, w])
    counts = ops.launch_counts()
    # 64 rows leave SMs idle: f32 splits F (kernel + reduce); bf16 splits
    # the down and dx kernels' K (gate/up or gradients, down or dx, reduce)
    split_launches = 2 if dtype == torch.float32 else 3
    assert counts["flash_attention"] == 1
    assert counts["fused_ffn"] == split_launches
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["fused_ffn_bwd_dx"] == (1 if dtype == torch.float32 else 3)
    # 64 rows leave SMs idle: f32 splits the rows in two, bf16 the two
    # 64-row K tiles (the pairs' hi and lo rows): kernel + reduce
    assert counts["fused_ffn_bwd_dw"] == 2


# -- the mLSTM scan (#13) ----------------------------------------------------

# the reference's own shapes (tests/test_kernels.py:53-55), xlstm-125m's
# full width (dh 1536 / 4 = 384, chunk 256), one row of it, a single chunk
MLSTM_SHAPES = [(2, 4, 512, 64, 128), (1, 2, 256, 128, 64),
                (2, 2, 512, 32, 256), (4, 4, 1024, 384, 256),
                (1, 4, 256, 384, 256), (2, 2, 128, 64, 256)]
MLSTM_TOL, MLSTM_REL_TOL = 2e-4, 1e-4


def _mlstm_inputs(B, H, S, dh, seed=0):
    """The reference test's recipe: q, k·dh^-0.5, v, i ~ N(0, 1) and
    f_log = log_sigmoid(N(0, 1) + 2), in [B,H,S,dh] / [B,H,S]."""
    q = _rand((B, H, S, dh), seed + 1)
    k = _rand((B, H, S, dh), seed + 2) * dh ** -0.5
    v = _rand((B, H, S, dh), seed + 3)
    ig = _rand((B, H, S), seed + 4)
    fl = torch.nn.functional.logsigmoid(
        torch.from_numpy(_rand((B, H, S), seed + 5) + 2.0)).numpy()
    return q, k, v, ig, fl


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def test_mlstm_op_dispatches_cpu_tensors_to_plain_version():
    ops.reset_launch_counts()
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(1, 2, 16, 8)]
    y, (C, n, m) = ops.mlstm_scan(*ins, chunk=8)
    want, _ = ref.ref_mlstm_scan(*ins, chunk=8)
    assert torch.equal(y, want) and tuple(C.shape) == (1, 2, 8, 8)
    assert ops.launch_counts()["mlstm_scan"] == 0


def _mlstm_check(got, want, what):
    """y and the carry (C, n, m) of the kernel against the plain version:
    within 2e-4 (atol = rtol) and 1e-4 in ||err|| / ||want||."""
    torch.cuda.synchronize()
    y, (C, n, m) = got
    wy, (wC, wn, wm) = want
    for name, g, w in (("y", y, wy), ("C", C, wC), ("n", n, wn),
                       ("m", m, wm)):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g.cpu(), w.cpu(), MLSTM_TOL, f"{what} {name}")
        assert _rel(g.cpu(), w.cpu()) <= MLSTM_REL_TOL, f"{what} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,dh,chunk", MLSTM_SHAPES)
def test_mlstm_kernel_matches_plain(cuda, B, H, S, dh, chunk):
    ins = [torch.from_numpy(a).to(cuda) for a in _mlstm_inputs(B, H, S, dh)]
    ops.reset_launch_counts()
    got = ops.mlstm_scan(*ins, chunk=chunk)
    assert ops.launch_counts()["mlstm_scan"] == 1
    _mlstm_check(got, ref.ref_mlstm_scan(*ins, chunk=chunk),
                 f"{B}x{H}x{S}x{dh} chunk {chunk}")


@pytest.mark.cuda
def test_mlstm_kernel_continues_from_a_state_and_pads(cuda):
    """A carry handed over from a first call, and pad steps (i = -1e30,
    f_log = 0, zero q/k/v) as ``models.ssm.mlstm`` appends them."""
    ins = [torch.from_numpy(a).to(cuda)
           for a in _mlstm_inputs(2, 4, 512, 96, seed=50)]
    first = ml_kernel.mlstm_scan(*(t[:, :, :256].contiguous() for t in ins),
                                 chunk=128)
    rest = [t[:, :, 256:].contiguous() for t in ins]
    _mlstm_check(ml_kernel.mlstm_scan(*rest, chunk=128, state=first[1]),
                 ref.ref_mlstm_scan(*rest, chunk=128, state=first[1]),
                 "from a state")
    padded = [t.clone() for t in ins]
    for t in padded[:3]:
        t[:, :, 450:] = 0.0
    padded[3][:, :, 450:] = -1e30
    padded[4][:, :, 450:] = 0.0
    _mlstm_check(ml_kernel.mlstm_scan(*padded, chunk=256),
                 ref.ref_mlstm_scan(*padded, chunk=256), "padded tail")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,dh,chunk", [
    (2, 2, 192, 96, 192),    # nc = 1, a chunk of three 64-row q tiles
    (2, 3, 240, 96, 80),     # dh 96: a 64-row C tile and a half; L 80
    (3, 2, 144, 32, 48),     # dh 32 below one C tile; L 48 not a 32-piece
    (1, 1, 100, 32, 20),     # L 20 inside one piece, five chunks
    (2, 2, 1, 64, 256),      # a one-token prompt: L 1
    (1, 3, 3, 32, 256),      # three tokens, one chunk of L 3
    (2, 2, 128, 36, 64),     # dh 36: pieces and n8 tiles cut at 4 floats
    (1, 2, 256, 512, 128),   # dh 512: two y tiles, four C tile columns
    (8, 8, 1024, 64, 64),    # 1024 output blocks: past one wave
    (4, 8, 512, 384, 128)])  # 576 carry blocks, 256 output blocks
def test_mlstm_kernel_matches_plain_at_tile_edges(cuda, B, H, S, dh, chunk):
    """The two kernels' edges: one chunk, dh and chunks that are not
    multiples of the 64 / 128-wide tiles and 32-deep pieces, prompts of 1
    and 3 tokens, and grids past one wave of 132 SMs."""
    ins = [torch.from_numpy(a).to(cuda)
           for a in _mlstm_inputs(B, H, S, dh, seed=60)]
    got = ml_kernel.mlstm_scan(*ins, chunk=chunk)
    _mlstm_check(got, ref.ref_mlstm_scan(*ins, chunk=chunk),
                 f"{B}x{H}x{S}x{dh} chunk {chunk}")


@pytest.mark.cuda
def test_mlstm_kernel_follows_a_carry_dominated_chunk(cuda):
    """A chunk whose own maximum a stays below the entering m (input gates
    -30 after a chunk of +4): the carry's term outweighs the chunk's, and
    the chunk-local stabilizer rescales by e^{A_c - M_L} << 1.  Also from
    a given state whose m is above every a of the first chunk."""
    B, H, S, dh, L = 2, 4, 512, 128, 128
    q, k, v, ig, fl = (torch.from_numpy(a).to(cuda)
                       for a in _mlstm_inputs(B, H, S, dh, seed=70))
    ig = ig.clone()
    ig[:, :, :L] += 4.0
    ig[:, :, L:2 * L] -= 30.0
    _mlstm_check(ml_kernel.mlstm_scan(q, k, v, ig, fl, chunk=L),
                 ref.ref_mlstm_scan(q, k, v, ig, fl, chunk=L),
                 "carry-dominated")
    _, st = ref.ref_mlstm_scan(q, k, v, ig + 12.0, fl, chunk=L)
    _mlstm_check(ml_kernel.mlstm_scan(q, k, v, ig, fl, chunk=L, state=st),
                 ref.ref_mlstm_scan(q, k, v, ig, fl, chunk=L, state=st),
                 "from a high-m state")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,dh,chunk", [(4, 4, 1024, 384, 256),
                                            (3, 2, 144, 32, 48)])
def test_mlstm_kernel_is_deterministic(cuda, B, H, S, dh, chunk):
    """Two launches give the same bits: the carry walk and every sum run
    in a fixed order, with no atomics."""
    ins = [torch.from_numpy(a).to(cuda) for a in _mlstm_inputs(B, H, S, dh)]
    first = ml_kernel.mlstm_scan(*ins, chunk=chunk)
    second = ml_kernel.mlstm_scan(*ins, chunk=chunk)
    torch.cuda.synchronize()
    for a, b in zip((first[0],) + first[1], (second[0],) + second[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mlstm_kernel_names_its_limits(cuda):
    ins = [torch.from_numpy(a).to(cuda) for a in _mlstm_inputs(1, 1, 512, 8)]
    with pytest.raises(ValueError, match="MAX_CHUNK 256"):
        ml_kernel.mlstm_scan(*ins, chunk=512)
    odd = [torch.from_numpy(a).to(cuda) for a in _mlstm_inputs(1, 1, 64, 6)]
    with pytest.raises(ValueError, match="HEAD_DIM_MULTIPLE 4"):
        ml_kernel.mlstm_scan(*odd, chunk=64)


@pytest.mark.cuda
def test_mlstm_kernel_refuses_other_dtypes(cuda):
    ins = [torch.from_numpy(a).to(cuda) for a in _mlstm_inputs(1, 1, 8, 8)]
    with pytest.raises(ValueError, match="f32"):
        ops.mlstm_scan(*(t.detach().to(torch.bfloat16) for t in ins),
                       chunk=8)
    with pytest.raises(ValueError, match="multiple"):
        ops.mlstm_scan(*(t.detach() for t in ins), chunk=3)


# -- the mLSTM scan's backward (#13b) -----------------------------------------

# the train shape (xlstm-125m, batch 8 x 512), four chunks, one chunk, and
# the tiles' edges: dh 96 (a 64-row tile and a half, one 128-column tile
# cut), L 80 (not a 32-piece), dh 36 and L 20 (five chunks), three tokens,
# dh 512 (four 128-column tiles)
MLSTM_BWD_SHAPES = [(8, 4, 512, 384, 256), (4, 4, 1024, 384, 256),
                    (2, 4, 256, 384, 256), (2, 3, 240, 96, 80),
                    (1, 2, 100, 36, 20), (2, 2, 3, 32, 256),
                    (1, 2, 256, 512, 128)]
# Each output of the backward kernels against its plain version in f32:
# every element within MLSTM_BWD_TOL of the output's largest value, and
# ||err|| / ||want|| <= MLSTM_BWD_REL_TOL.  Not atol + rtol per element:
# dk and df_log are sums of large terms that cancel (at dh 384 the plain
# version's own f32 rounding against f64 reaches 0.46x a 1e-3 atol + rtol
# on dk, 0.32x on df_log), while the norms agree to ~3e-6.
MLSTM_BWD_TOL, MLSTM_BWD_REL_TOL = 1e-4, 1e-4


def _mlstm_bwd_close(got, want, what):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), what
    if not want.numel():
        return
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= MLSTM_BWD_TOL * scale, what
    if scale:
        assert _rel(got, want) <= MLSTM_BWD_REL_TOL, what


def _mlstm_bwd_case(cuda, B, H, S, dh, chunk, from_state, seed=80):
    """Inputs on the card, the kernel forward's y and kept tensors, and
    the cotangents (dy and the final carry's dC, dn, dm)."""
    ins = [torch.from_numpy(a).to(cuda)
           for a in _mlstm_inputs(B, H, S, dh, seed=seed)]
    state = None
    if from_state:
        _, state = ml_kernel.mlstm_scan(
            *(torch.from_numpy(a).to(cuda)
              for a in _mlstm_inputs(B, H, S, dh, seed=seed + 10)),
            chunk=chunk)
    y, _, kept = ml_kernel.mlstm_scan(*ins, chunk=chunk, state=state,
                                      keep=True)
    cot = [torch.from_numpy(_rand(shape, seed + 20 + j)).to(cuda)
           for j, shape in enumerate(((B, H, S, dh), (B, H, dh, dh),
                                      (B, H, dh), (B, H)))]
    return ins, state, y, kept, cot


@pytest.mark.cuda
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("B,H,S,dh,chunk", MLSTM_BWD_SHAPES)
def test_mlstm_bwd_kernels_match_plain(cuda, B, H, S, dh, chunk, from_state):
    """Each pass of the backward (the row scalars, the carry walk, the
    keys' and queries' kernels, the gates' pass) and the grads against
    the plain passes fed the same forward tensors."""
    ins, state, y, kept, (dy, dC, dn, dm) = _mlstm_bwd_case(
        cuda, B, H, S, dh, chunk, from_state)
    ops.reset_launch_counts()
    grads, got = ml_kernel.mlstm_scan_bwd(
        *ins, y, kept, dy, chunk=chunk, state=state, dC=dC, dn=dn, dm=dm,
        return_passes=True)
    assert ops.launch_counts()["mlstm_scan_bwd"] == 1
    kw = dict(chunk=chunk, state=state, carries=kept[1:])
    rows = ref.ref_mlstm_bwd_rows(y, kept[0], dy)
    carry = ref.ref_mlstm_bwd_carry(ins[0], *ins[3:], dy, *rows[:2], dC=dC,
                                    dn=dn, **kw)
    chunk_ = ref.ref_mlstm_bwd_chunk(*ins, dy, *rows[:2], *carry[:2], dC=dC,
                                     dn=dn, **kw)
    gates = ref.ref_mlstm_bwd_gates(*ins[3:], *chunk_[3:], rows[2],
                                    carry[4], dm=dm, **kw)
    torch.cuda.synchronize()
    for name, want in (("rows", rows), ("carry", carry), ("chunk", chunk_),
                       ("gates", gates)):
        for j, (g, w) in enumerate(zip(got[name], want)):
            if w is None or (g is None and not from_state):
                continue
            _mlstm_bwd_close(g, w, f"{name}[{j}]")
    want = ref.ref_mlstm_scan_bwd(*ins, y, kept, dy, chunk=chunk,
                                  state=state, dC=dC, dn=dn, dm=dm)
    for j, (g, w) in enumerate(zip(grads, want)):
        assert (g is None) == (w is None)
        if w is not None:
            _mlstm_bwd_close(g, w, f"grad {j}")


@pytest.mark.cuda
def test_mlstm_bwd_kernels_are_deterministic_and_keep_the_forward(cuda):
    """Two backward launches give the same bits (fixed sums, no atomics);
    the forward's keep mode gives y and the final carry bit for bit as
    without it; dy alone (no carry grads) matches the plain version."""
    ins, _, y, kept, (dy, *_) = _mlstm_bwd_case(cuda, 8, 4, 512, 384, 256,
                                                False)
    plain_y, plain_carry = ml_kernel.mlstm_scan(*ins, chunk=256)
    _, carry, _ = ml_kernel.mlstm_scan(*ins, chunk=256, keep=True)
    first = ml_kernel.mlstm_scan_bwd(*ins, y, kept, dy, chunk=256)
    second = ml_kernel.mlstm_scan_bwd(*ins, y, kept, dy, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(plain_y, y)
    for a, b in zip(plain_carry, carry):
        assert torch.equal(a, b)
    for a, b in zip(first[:5], second[:5]):
        assert torch.equal(a, b)
    want = ref.ref_mlstm_scan_bwd(*ins, y, kept, dy, chunk=256)
    for g, w in zip(first[:5], want[:5]):
        _mlstm_bwd_close(g, w, "dy only")


@pytest.mark.cuda
def test_mlstm_bwd_kernels_give_pad_steps_zero_grads(cuda):
    """Pad steps as ``models.ssm.mlstm`` appends them, with zero dy there:
    exactly zero q, k, v and i grads on those steps."""
    ins, _, _, _, (dy, *_) = _mlstm_bwd_case(cuda, 2, 4, 512, 96, 256,
                                             False, seed=90)
    for t in ins[:3]:
        t[:, :, 450:] = 0.0
    ins[3][:, :, 450:] = -1e30
    ins[4][:, :, 450:] = 0.0
    dy[:, :, 450:] = 0.0
    y, _, kept = ml_kernel.mlstm_scan(*ins, chunk=256, keep=True)
    grads = ml_kernel.mlstm_scan_bwd(*ins, y, kept, dy, chunk=256)
    torch.cuda.synchronize()
    for g in grads[:4]:
        assert bool(torch.isfinite(g).all())
        assert not bool(g[:, :, 450:].any())
    want = ref.ref_mlstm_scan_bwd(*ins, y, kept, dy, chunk=256)
    for g, w in zip(grads[:5], want[:5]):
        _mlstm_bwd_close(g, w, "padded")


@pytest.mark.cuda
def test_mlstm_scan_autograd_runs_the_backward_kernels(cuda):
    """``ops.mlstm_scan`` on inputs that need a gradient: the forward and
    backward kernels launch once each, and the grads (the state's too)
    match the plain backward."""
    ins, state, _, _, (dy, dC, dn, dm) = _mlstm_bwd_case(
        cuda, 2, 4, 512, 384, 256, True, seed=100)
    xs = [t.clone().requires_grad_() for t in ins + list(state)]
    ops.reset_launch_counts()
    y, carry = ops.mlstm_scan(*xs[:5], chunk=256, state=tuple(xs[5:]))
    got = torch.autograd.grad((y, *carry), xs, (dy, dC, dn, dm))
    counts = ops.launch_counts()
    assert counts["mlstm_scan"] == 1 and counts["mlstm_scan_bwd"] == 1
    yk, _, kept = ml_kernel.mlstm_scan(*ins, chunk=256, state=state,
                                       keep=True)
    want = ref.ref_mlstm_scan_bwd(*ins, yk, kept, dy, chunk=256, state=state,
                                  dC=dC, dn=dn, dm=dm)
    for j, (g, w) in enumerate(zip(got, want)):
        _mlstm_bwd_close(g, w, f"grad {j}")


def test_mlstm_grad_on_cpu_runs_the_plain_backward():
    """On the CPU ``ops.mlstm_scan`` with a gradient goes through
    ``MLSTMScan`` to ``ref_mlstm_scan_bwd``: no kernel launch, and the
    grads equal torch.autograd's through the plain forward to f32
    rounding."""
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(1, 2, 48, 8)]
    xs = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    y, _ = ops.mlstm_scan(*xs, chunk=16)
    assert y.grad_fn is not None and "MLSTMScan" in type(y.grad_fn).__name__
    dy = torch.from_numpy(_rand(tuple(y.shape), 5))
    got = torch.autograd.grad(y, xs, dy)
    assert ops.launch_counts()["mlstm_scan_bwd"] == 0
    ys = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(ref.ref_mlstm_scan(*ys, chunk=16)[0], ys, dy)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        ml_kernel.mlstm_scan_bwd(*ins, y.detach(), (None,) * 4, dy, chunk=16)


# -- int8 quantization (#10, #11) and the int8 pool write --------------------


def _quant_rows(nb, seed):
    """[nb, 256] rows of mixed magnitudes, one all-zero row, one row of
    exact .5 quotients (round half to even) and one with a subnormal-free
    tiny max."""
    x = _rand((nb, 256), seed) * np.logspace(-3, 2, nb, dtype=np.float32)[
        :, None]
    x[1] = 0.0
    x[2] = np.arange(256, dtype=np.float32) - 127.5      # scale 1.0039..
    x[3, :] = 0.0
    x[3, 7] = 1e-30
    return x


@pytest.mark.parametrize("nb", [64, 256])
def test_quant_plain_matches_pallas(jref, nb):
    """The plain #10 and #11 against the reference's Pallas kernels in
    interpret mode.  The port's scale is max / 127 in IEEE f32 division
    (checked against numpy); XLA compiles the kernel's ``/ 127.0`` on the
    CPU as a product with the rounded reciprocal, which lands one ulp away
    on some rows (6 of 64 at nb 64), so the reference's scales are held to
    one ulp, and its payload bit for bit on every row whose scale agrees
    (within one code on the others).  Dequantization is a single product:
    bit for bit on the reference's own payload and scales."""
    from repro.kernels import quant as jquant
    jnp = jref["jnp"]
    x = _quant_rows(nb, seed=40 + nb)
    q_j, s_j = (np.array(a) for a in
                jquant.quantize_int8(jnp.asarray(x), interpret=True))
    q, s = ops.quantize_int8(torch.from_numpy(x))
    q, s = q.numpy(), s.numpy()
    np.testing.assert_array_equal(
        s, np.abs(x).max(axis=1).astype(np.float32) / np.float32(127))
    np.testing.assert_array_max_ulp(s, s_j, maxulp=1)
    same = s == s_j
    assert same.mean() > 0.8
    np.testing.assert_array_equal(q[same], q_j[same])
    assert np.abs(q.astype(np.int32) - q_j.astype(np.int32)).max() <= 1
    d_j = jquant.dequantize_int8(jnp.asarray(q_j), jnp.asarray(s_j),
                                 interpret=True)
    np.testing.assert_array_equal(
        ops.dequantize_int8(torch.from_numpy(q_j),
                            torch.from_numpy(s_j)).numpy(), np.asarray(d_j))


def test_quant_kv_tiles_plain_equals_rows():
    """The splice's tile form is the row form over each (block column, kv
    head) tile, the entries past T taken as zeros."""
    x = torch.from_numpy(_rand((2, 3, 20, 4, 8), 44))
    q, s = ops.quantize_kv_tiles(x, 8, 3)
    assert q.shape == (2, 3, 24, 4, 8) and s.shape == (2, 3, 3, 4)
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 4))
    tiles = pad.reshape(2, 3, 3, 8, 4, 8).permute(0, 1, 2, 4, 3, 5)
    q2, s2 = ops.quantize_int8(tiles.reshape(-1, 64))
    assert torch.equal(s.reshape(-1), s2)
    assert torch.equal(q.reshape(2, 3, 3, 8, 4, 8).permute(0, 1, 2, 4, 3, 5)
                       .reshape(-1, 64), q2)
    assert not q[:, :, 20:].any()


def test_quantize_kv_tiles_of_two_leaves_equals_two_calls():
    """``ops.quantize_kv_tiles`` over K and V at once (the admission
    splice's one call a layer) gives each leaf's one-leaf result exactly,
    in f32 and bf16."""
    k, v = (torch.from_numpy(_rand((2, 3, 20, 4, 8), s)) for s in (46, 47))
    for dtype in (torch.float32, torch.bfloat16):
        pair = ops.quantize_kv_tiles((k.to(dtype), v.to(dtype)), 8, 3)
        assert isinstance(pair, tuple) and len(pair) == 2
        for (q, s), leaf in zip(pair, (k, v)):
            q1, s1 = ops.quantize_kv_tiles(leaf.to(dtype), 8, 3)
            assert q.shape == (2, 3, 24, 4, 8) and s.shape == (2, 3, 3, 4)
            assert torch.equal(q, q1) and torch.equal(s, s1)


def test_dequantize_gather_of_two_leaves_equals_two_calls():
    """``ops.dequantize_gather`` over K and V at once (the int8 chunk
    append's one call a layer) gives each leaf's one-leaf gather exactly,
    in f32 and bf16."""
    rng = np.random.default_rng(45)
    pools = [torch.from_numpy(rng.integers(-127, 128, (40, 8, 2, 16))
                              .astype(np.int8)) for _ in range(2)]
    scales = [torch.from_numpy((rng.random((40, 2)) * 0.05)
                               .astype(np.float32)) for _ in range(2)]
    table = torch.from_numpy(rng.integers(2, 40, (3, 5)).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.dequantize_gather(pools, scales, table, dtype)
        assert isinstance(got, tuple) and len(got) == 2
        for g, p, sc in zip(got, pools, scales):
            one = ops.dequantize_gather(p, sc, table, dtype)
            assert g.dtype == dtype and g.shape == (3, 40, 2, 16)
            assert torch.equal(g, one)


def _write_case(kind, seed, N=64, bs=16, KV=4, Dh=64):
    """int8 pools (recycled storage: random payload and scales) and a write
    plan: ``decode`` is 16 one-token rows (active slots on distinct blocks,
    two at offset 0, six inactive rows on the trash block, colliding);
    ``chunk`` is a 32-token chunk from position 124 (four trash writes of
    a shared column, the rest filling the tail of one block, a whole block
    and the head of a third, four pads on the trash block at offset 0)."""
    rng = np.random.default_rng(seed)
    pools = [rng.integers(-127, 128, (N, bs, KV, Dh)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((N, KV)) * 0.05).astype(np.float32)
              for _ in range(2)]
    if kind == "decode":
        bids = [5, 9, 13, 17, 21, 25, 29, 33, 37, 41] + [1] * 6
        off = [0, 3, 15, 7, 0, 1, 2, 9, 11, 14] + [0, 5, 5, 0, 8, 5]
        mags = [0.1, 30.0, 1.0, 3.0, 0.5, 80.0, 1.0, 0.01, 2.0, 5.0] + [1] * 6
    else:
        pos = np.arange(124, 152)
        bids = [1] * 4 + [int(c) for c in 40 + pos[4:] // bs] + [1] * 4
        off = [int(p) % bs for p in pos] + [0] * 4
        mags = [1.0] * 4 + list(np.linspace(0.2, 40.0, 24)) + [1.0] * 4
    new = [(rng.standard_normal((len(bids), KV, Dh))
            * np.asarray(mags)[:, None, None]).astype(np.float32)
           for _ in range(2)]
    return pools, scales, new, np.asarray(bids, np.int32), \
        np.asarray(off, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_match_plain(cuda, nb, dtype):
    x = torch.from_numpy(_quant_rows(nb, 50)).to(cuda, dtype)
    q, s = qt_kernel.quantize_rows(x)
    qw, sw = ref.ref_quantize_rows(x)
    assert torch.equal(q, qw) and torch.equal(s, sw)
    d = qt_kernel.dequantize_rows(q, s)
    assert torch.equal(d, ref.ref_dequantize_rows(q, s))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("T,nb", [(40, 3), (64, 4), (2048, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_tiles_kernel_matches_plain(cuda, T, nb, dtype):
    """The admission splice's tiles read in place: a short tail (T = 40 <
    3 x 16 entries), an exact fit and a 16 x 1024 bucket of a 2048 cache."""
    B = 16 if T == 2048 else 3
    x = torch.randn(2, B, T, 4, 64, device=cuda).to(dtype)
    q, s = qt_kernel.quantize_rows(x, block_size=16, nb=nb)
    qw, sw = ref.ref_quantize_kv_tiles(x, 16, nb)
    assert torch.equal(q, qw) and torch.equal(s, sw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_gather_kernel_matches_plain(cuda, dtype):
    """#11's block-table gather at the chunk append's shape: one row of
    128 blocks of 16 over a 2050-block pool, NULL tail columns."""
    gen = torch.Generator(device=cuda).manual_seed(60)
    pool = torch.randint(-127, 128, (2050, 16, 4, 64), generator=gen,
                         device=cuda, dtype=torch.int8)
    scale = torch.rand(2050, 4, generator=gen, device=cuda) * 0.05
    table = torch.zeros(1, 128, dtype=torch.int32, device=cuda)
    table[0, :100] = torch.randperm(2048, generator=gen,
                                    device=cuda)[:100] + 2
    got = qt_kernel.dequantize_rows(pool, scale, table, dtype)
    assert got.shape == (1, 2048, 4, 64) and got.dtype == dtype
    assert torch.equal(got, ref.ref_dequantize_gather(pool, scale, table,
                                                      dtype))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_gather_kernel_takes_k_and_v_in_one_launch(cuda, dtype):
    """#11 over K and V pools at once: one launch, two contiguous views of
    one buffer, each bit for bit the plain gather of its leaf."""
    gen = torch.Generator(device=cuda).manual_seed(61)
    pools = [torch.randint(-127, 128, (2050, 16, 4, 64), generator=gen,
                           device=cuda, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(2050, 4, generator=gen, device=cuda) * 0.05
              for _ in range(2)]
    table = torch.zeros(3, 128, dtype=torch.int32, device=cuda)
    table[:, :90] = (torch.randperm(2048, generator=gen, device=cuda)[:270]
                     + 2).reshape(3, 90)
    before = qt_kernel.launches_dequant
    got = qt_kernel.dequantize_rows(pools, scales, table, dtype)
    assert qt_kernel.launches_dequant == before + 1
    for g, p, sc in zip(got, pools, scales):
        assert g.shape == (3, 2048, 4, 64) and g.is_contiguous()
        assert torch.equal(g, ref.ref_dequantize_gather(p, sc, table, dtype))
    assert got[1].data_ptr() == got[0].data_ptr() + got[0].nbytes
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_block_write_kernel_matches_plain(cuda, kind, dtype):
    """The fused write (K and V in one launch) against the plain write,
    three times in a row on the same pools: every payload and scale bit
    for bit, but the trash block's payload, whose colliding writes land in
    no fixed order in the plain version's scatter."""
    pools, scales, new, bids, off = _write_case(kind, seed=70)
    dev = lambda a: torch.from_numpy(a).to(cuda)        # noqa: E731
    kp, ks = [dev(p) for p in pools], [dev(s) for s in scales]
    wp, ws = [t.clone() for t in kp], [t.clone() for t in ks]
    keep = torch.arange(kp[0].shape[0], device=cuda) != 1
    for step in range(3):
        news = [(dev(x) * (1 + step)).to(dtype) for x in new]
        qt_kernel.quantized_block_write(kp, ks, news, dev(bids), dev(off))
        for p, s, x in zip(wp, ws, news):
            ref.ref_quantized_block_write(p, s, x, dev(bids), dev(off))
        torch.cuda.synchronize()
        for i in range(2):
            assert torch.equal(kp[i][keep], wp[i][keep]), (step, i)
            assert torch.equal(ks[i], ws[i]), (step, i)


@pytest.mark.cuda
def test_quant_kernels_refuse_bad_inputs(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        qt_kernel.quantize_rows(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        qt_kernel.quantize_rows(torch.zeros(4, 12, device=cuda))
    q = torch.zeros(4, 16, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 q"):
        qt_kernel.dequantize_rows(q.float(), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="n % 16"):
        qt_kernel.dequantize_rows(q[:, :12].contiguous(),
                                  torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="one or two leaves"):
        qt_kernel.dequantize_rows([q] * 3, [torch.zeros(4, device=cuda)] * 3)
    idx = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        qt_kernel.quantized_block_write(
            [torch.zeros(3, 4, 1, 8, dtype=torch.int8, device=cuda)],
            [torch.zeros(3, 1, device=cuda)],
            [torch.zeros(2, 1, 8, device=cuda)], idx, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,nb", [(40, 3), (64, 4)])
def test_quantize_tiles_kernel_takes_rows_of_4096(cuda, T, nb, dtype):
    """gemma-2b's pool rows, bs 16 x Dh 256 = 4096 values (four warps a
    row), with a ragged tail (T = 40 < 3 x 16) and an exact fit."""
    x = torch.randn(1, 2, T, 2, 256, device=cuda).to(dtype)
    q, s = qt_kernel.quantize_rows(x, block_size=16, nb=nb)
    qw, sw = ref.ref_quantize_kv_tiles(x, 16, nb)
    assert torch.equal(q, qw) and torch.equal(s, sw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,nb", [(100, 2), (128, 2)])
def test_quantize_tiles_kernel_takes_rows_past_8192(cuda, T, nb, dtype):
    """Rows of bs 64 x Dh 256 = 16384 values, past what eight warps hold
    in registers (a block a row, read twice), ragged (T = 100 < 2 x 64)
    and exact, K and V in one launch; and [3, 16392] matrix rows."""
    k, v = (torch.randn(1, 2, T, 2, 256, device=cuda).to(dtype)
            for _ in range(2))
    for (q, s), leaf in zip(qt_kernel.quantize_rows((k, v), block_size=64,
                                                     nb=nb), (k, v)):
        qw, sw = ref.ref_quantize_kv_tiles(leaf, 64, nb)
        assert torch.equal(q, qw) and torch.equal(s, sw)
    x = torch.randn(3, 16392, device=cuda).to(dtype)
    q, s = qt_kernel.quantize_rows(x)
    qw, sw = ref.ref_quantize_rows(x)
    assert torch.equal(q, qw) and torch.equal(s, sw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernel_keeps_a_subnormal_scale(cuda, dtype):
    """A row whose max is subnormal: its scale max / 127 is kept (no
    flush to zero), and the max quantizes to +-127."""
    x = torch.zeros(4, 256, device=cuda)
    x[0, 9], x[1, 100], x[2, 3] = 1e-39, -3e-39, 1e-40
    x[3] = torch.linspace(-1, 1, 256, device=cuda)
    x = x.to(dtype)
    q, s = qt_kernel.quantize_rows(x)
    qw, sw = ref.ref_quantize_rows(x)
    assert torch.equal(q, qw) and torch.equal(s, sw)
    assert (s[:3] > 0).all() and (s[:3] < torch.finfo(torch.float32).tiny
                                  ).all()
    assert q[0, 9] == 127 and q[1, 100] == -127 and q[2, 3] == 127
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_tiles_kernel_takes_k_and_v_in_one_launch(cuda, dtype):
    """The splice's K and V in one launch: each leaf's (q, scale) equal
    to its own call, as contiguous views of one buffer."""
    k, v = (torch.randn(2, 3, 40, 4, 64, device=cuda).to(dtype)
            for _ in range(2))
    before = qt_kernel.launches_quant
    pair = qt_kernel.quantize_rows((k, v), block_size=16, nb=3)
    assert qt_kernel.launches_quant == before + 1
    for (q, s), leaf in zip(pair, (k, v)):
        q1, s1 = qt_kernel.quantize_rows(leaf, block_size=16, nb=3)
        assert q.is_contiguous() and torch.equal(q, q1)
        assert torch.equal(s, s1)
    assert pair[1][0].data_ptr() == pair[0][0].data_ptr() + pair[0][0].nbytes
    torch.cuda.synchronize()


# -- the Mamba selective scan (#12) and jamba's FFN width ---------------------

# the reference test's two shapes (tests/test_kernels.py:73-74),
# jamba-v0.1-52b's full width (Di 8192, N 16) over a ragged S, and Di not a
# multiple of the kernel's 64-channel block at N 64 (eight lanes a channel)
SSM_SHAPES = [(2, 512, 256, 16), (1, 256, 512, 8), (1, 300, 8192, 16),
              (2, 77, 200, 64)]
SSM_TOL = 5e-5


def _ssm_inputs(B, S, Di, N, seed=0):
    """dt = softplus(N(0,1)), B/C/x ~ N(0,1), A = -exp(N(0,1)) (the
    reference test's recipe)."""
    dt = np.log1p(np.exp(_rand((B, S, Di), seed + 1)))
    return (dt, _rand((B, S, N), seed + 2), _rand((B, S, N), seed + 3),
            _rand((B, S, Di), seed + 4), -np.exp(_rand((Di, N), seed + 5)))


def test_ffn_plan_takes_four_rows_at_jamba_width():
    """d_model 4096 is past eight f32 rows of shared memory: the forward
    takes 4-row blocks (at prefill and at decode), and so does the f32 dx
    kernel of the backward (jamba-v0.1-52b's f32 train step); its dW
    kernel takes 4-wide F tiles there."""
    for N in (16384, 16):
        br, _, _ = ffn_kernel.plan(N, 4096, 14336, num_sms=132)
        assert br == 4 and br * 4096 <= ffn_kernel.SMEM_ROWS_X_D
    for N in (1200, 16):
        assert ffn_kernel.plan_dx(N, 4096) == 4
    assert ffn_kernel.plan_dx(1200, 3072) == 8
    assert ffn_kernel.plan_dw(1200, 4096, 14336, num_sms=132)[0] == 4
    assert 4096 <= ffn_kernel.BWD_MAX_D == ffn_kernel.MAX_D


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N", SSM_SHAPES)
def test_ssm_kernel_matches_plain(cuda, B, S, Di, N, dtype):
    """y and the final h within 5e-5; x, B and C in ``dtype`` (both sides
    read the same values into f32), dt and A in f32."""
    dt, Bs, Cs, x, A = (torch.from_numpy(a).to(cuda)
                        for a in _ssm_inputs(B, S, Di, N))
    Bs, Cs, x = (t.to(dtype) for t in (Bs, Cs, x))
    ops.reset_launch_counts()
    y, h = ops.ssm_chunk_scan(dt, Bs, Cs, x, A)
    assert ops.launch_counts()["ssm_scan"] == 1
    wy, wh = ref.ref_ssm_scan(dt, Bs, Cs, x, A)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32
    _close(y.cpu(), wy.cpu(), SSM_TOL, "y")
    _close(h.cpu(), wh.cpu(), SSM_TOL, "h")


@pytest.mark.cuda
def test_ssm_kernel_continues_from_a_state_and_pads(cuda):
    """A start state handed over from a first call, and pad steps with
    dt = 0 (as ``models.ssm.mamba`` pads) that leave h as it is."""
    dt, Bs, Cs, x, A = (torch.from_numpy(a).to(cuda)
                        for a in _ssm_inputs(2, 256, 1024, 16, seed=60))
    _, h1 = ssm_kernel.ssm_scan(*(t[:, :100].contiguous()
                                  for t in (dt, Bs, Cs, x)), A)
    rest = [t[:, 100:].contiguous() for t in (dt, Bs, Cs, x)]
    got = ssm_kernel.ssm_scan(*rest, A, h0=h1)
    want = ref.ref_ssm_scan(*rest, A, h1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g.cpu(), w.cpu(), SSM_TOL, "from a state")
    padded = dt.clone()
    padded[:, 200:] = 0.0
    _, h_pad = ssm_kernel.ssm_scan(padded, Bs, Cs, x, A)
    _, h_cut = ssm_kernel.ssm_scan(*(t[:, :200].contiguous()
                                     for t in (dt, Bs, Cs, x)), A)
    torch.cuda.synchronize()
    _close(h_pad.cpu(), h_cut.cpu(), 0.0, "pad steps")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N", [(4, 256, 1024, 16), (2, 77, 200, 64),
                                      (1, 50, 64, 5)])
def test_ssm_kernel_launches_are_bit_identical(cuda, B, S, Di, N):
    """No atomics, one fixed order of y's sums: two launches on the same
    inputs (with a start state) agree bit for bit."""
    dt, Bs, Cs, x, A = (torch.from_numpy(a).to(cuda)
                        for a in _ssm_inputs(B, S, Di, N, seed=70))
    h0 = torch.from_numpy(_rand((B, Di, N), 71)).to(cuda)
    Bs, Cs, x = (t.to(torch.bfloat16) for t in (Bs, Cs, x))
    y1, h1 = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, h0=h0)
    y2, h2 = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_ssm_kernel_refuses_bad_inputs(cuda):
    dt, Bs, Cs, x, A = (torch.from_numpy(a).to(cuda)
                        for a in _ssm_inputs(1, 8, 16, 4))
    with pytest.raises(ValueError, match="one dtype"):
        ssm_kernel.ssm_scan(dt, Bs.to(torch.bfloat16), Cs, x, A)
    with pytest.raises(ValueError, match="f32"):
        ssm_kernel.ssm_scan(dt.to(torch.bfloat16), Bs, Cs, x, A)
    with pytest.raises(ValueError, match="N 80"):
        ssm_kernel.ssm_scan(dt, *(torch.zeros(1, 8, 80, device=cuda)
                                  for _ in range(2)), x,
                            torch.zeros(16, 80, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        ssm_kernel.ssm_scan(*(torch.from_numpy(a).to(cuda)
                              for a in _ssm_inputs(1, 8, 20, 4)))
    with pytest.raises(ValueError, match="not differentiable"):
        ssm_kernel.ssm_scan(dt.requires_grad_(), Bs, Cs, x, A)
    wide = torch.zeros(1, 8, 20, device=cuda)          # N 20: past 16
    rows = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="N 20"):
        ssm_kernel.ssm_scan_bwd(rows, wide, wide, rows,
                                torch.zeros(16, 20, device=cuda), None,
                                torch.zeros(1, 1, 16, 20, device=cuda), rows,
                                chunk=8)


# #12b: (B, S, Di, N, chunk): jamba's full width over a ragged S; Di not a
# multiple of the block's 64 channels at N 8; N 5 (lanes past N idle); a
# chunk that is not a multiple of the 16-step segment; one chunk
SSM_BWD_SHAPES = [(2, 512, 256, 16, 256), (1, 300, 8192, 16, 256),
                  (2, 77, 200, 8, 32), (1, 50, 64, 5, 16),
                  (1, 100, 96, 16, 40), (2, 64, 128, 16, 64)]
# #12b against its plain version, each output: every element within
# SSM_BWD_TOL x max |want| and ||err|| / ||want|| within it; the outputs
# rounded to bf16 (dx, dB, dC with bf16 activations) within a bf16 step
SSM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _ssm_bwd_case(cuda, B, S, Di, N, chunk, dtype, from_state, seed):
    """Inputs on the card, the forward kernel's kept states and (y, h),
    dy (and dh from a state) ~ N(0, 1)."""
    dt, Bs, Cs, x, A = (torch.from_numpy(a).to(cuda)
                        for a in _ssm_inputs(B, S, Di, N, seed=seed))
    Bs, Cs, x = (t.to(dtype) for t in (Bs, Cs, x))
    h0 = (torch.from_numpy(_rand((B, Di, N), seed + 6)).to(cuda)
          if from_state else None)
    y, h, states = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, h0, chunk=chunk,
                                       keep=True)
    dy = torch.from_numpy(_rand((B, S, Di), seed + 7)).to(cuda)
    dh = (torch.from_numpy(_rand((B, Di, N), seed + 8)).to(cuda)
          if from_state else None)
    return (dt, Bs, Cs, x, A, h0), states, dy, dh


def _check_ssm_bwd(got, want, what):
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got, want):
        if w is None:
            assert g is None, name
            continue
        tol = SSM_BWD_TOL[w.dtype]
        g, w = g.float().cpu(), w.float().cpu()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        rel = float((g - w).norm()) / max(float(w.norm()), 1e-30)
        assert bool(g.isfinite().all()), f"{what} {name}"
        assert err <= tol * scale and rel <= tol, \
            f"{what} {name}: max err {err:.3g} (max |want| {scale:.3g}), " \
            f"rel {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,chunk", SSM_BWD_SHAPES)
def test_ssm_keep_variant_keeps_the_serving_bits(cuda, B, S, Di, N, chunk,
                                                 dtype):
    """#12 with ``keep``: y and h bit for bit the serving launch's (the
    flag off), and the state kept at chunk k bit for bit the final h of a
    launch over the first k chunks (chunk 0's: the start state)."""
    ins, states, _, _ = _ssm_bwd_case(cuda, B, S, Di, N, chunk, dtype,
                                      True, seed=80)
    dt, Bs, Cs, x, A, h0 = ins
    y0, h0_ = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, h0)
    y1, h1, kept = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, h0, chunk=chunk,
                                       keep=True)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(h0_, h1)
    assert torch.equal(kept, states)
    assert kept.shape == (B, -(-S // chunk), Di, N)
    assert torch.equal(kept[:, 0], h0)
    for k in range(1, kept.shape[1]):
        _, hk = ssm_kernel.ssm_scan(*(t[:, :k * chunk].contiguous()
                                      for t in (dt, Bs, Cs, x)), A, h0)
        torch.cuda.synchronize()
        assert torch.equal(kept[:, k], hk), k


@pytest.mark.cuda
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,chunk", SSM_BWD_SHAPES)
def test_ssm_bwd_kernel_matches_plain(cuda, B, S, Di, N, chunk, dtype,
                                      from_state):
    """#12b's six grads against ``ref_ssm_scan_bwd`` on the same kept
    states, from zero and from a state with the final state's gradient;
    one ``ssm_scan_bwd`` launch counted."""
    ins, states, dy, dh = _ssm_bwd_case(cuda, B, S, Di, N, chunk, dtype,
                                        from_state, seed=90)
    ops.reset_launch_counts()
    got = ssm_kernel.ssm_scan_bwd(*ins, states, dy, dh=dh, chunk=chunk)
    assert ops.launch_counts()["ssm_scan_bwd"] == 1
    want = ref.ref_ssm_scan_bwd(*ins, states, dy, dh=dh, chunk=chunk)
    torch.cuda.synchronize()
    assert got[1].dtype == got[2].dtype == got[3].dtype == dtype
    _check_ssm_bwd(got, want, f"{dtype} from_state={from_state}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_bwd_kernel_pad_steps(cuda, dtype):
    """Pad steps as ``models.ssm.mamba`` appends them (dt = 0, zero dy
    there): zero dx, dB and dC on them, and every other grad as the
    launch over the cut sequence gives it."""
    B, S, Di, N, chunk, cut = 2, 768, 512, 16, 256, 600
    ins, _, dy, _ = _ssm_bwd_case(cuda, B, S, Di, N, chunk, dtype, False,
                                  seed=100)
    dt, Bs, Cs, x, A, _ = ins
    dt[:, cut:] = 0.0
    dy[:, cut:] = 0.0
    _, _, states = ssm_kernel.ssm_scan(dt, Bs, Cs, x, A, chunk=chunk,
                                       keep=True)
    pad = ssm_kernel.ssm_scan_bwd(dt, Bs, Cs, x, A, None, states, dy,
                                  chunk=chunk)
    short = [t[:, :cut].contiguous() for t in (dt, Bs, Cs, x)]
    _, _, st_cut = ssm_kernel.ssm_scan(*short, A, chunk=chunk, keep=True)
    cut_g = ssm_kernel.ssm_scan_bwd(*short, A, None, st_cut,
                                    dy[:, :cut].contiguous(), chunk=chunk)
    torch.cuda.synchronize()
    for g in pad[1:4]:
        assert not bool(g[:, cut:].any())
    for name, g, w in zip(("ddt", "dx", "dB", "dC"), pad[:4], cut_g[:4]):
        _close(g[:, :cut].float().cpu(), w.float().cpu(), 1e-6, name)
    _close(pad[4].cpu(), cut_g[4].cpu(), 1e-6, "dA")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N,chunk", [(8, 512, 8192, 16, 256),
                                            (2, 77, 200, 8, 32)])
def test_ssm_bwd_kernel_launches_are_bit_identical(cuda, B, S, Di, N, chunk):
    """No atomics; the partials are summed in one fixed order: two
    launches on the same inputs agree bit for bit."""
    ins, states, dy, dh = _ssm_bwd_case(cuda, B, S, Di, N, chunk,
                                        torch.bfloat16, True, seed=110)
    g1 = ssm_kernel.ssm_scan_bwd(*ins, states, dy, dh=dh, chunk=chunk)
    g2 = ssm_kernel.ssm_scan_bwd(*ins, states, dy, dh=dh, chunk=chunk)
    torch.cuda.synchronize()
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssm_chunk_scan_trains_through_both_kernels(cuda):
    """``ops.ssm_chunk_scan`` on inputs that need a gradient: #12 (keep)
    forward, #12b backward, one launch each; the grads those of the plain
    path through ``SSMChunkScan`` on the CPU."""
    ins, _, dy, dh = _ssm_bwd_case(cuda, 2, 300, 256, 16, 128,
                                   torch.float32, True, seed=120)
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [t.detach().to(dev).requires_grad_() for t in ins]
        ops.reset_launch_counts()
        y, h = ops.ssm_chunk_scan(*ts[:5], h0=ts[5], chunk=128)
        ((y * dy.to(dev)).sum() + (h * dh.to(dev)).sum()).backward()
        counts = ops.launch_counts()
        assert (counts["ssm_scan"], counts["ssm_scan_bwd"]) == (
            (1, 1) if dev == "cuda" else (0, 0))
        grads[dev] = [t.grad.cpu() for t in ts]
    for name, g, w in zip(("dt", "B", "C", "x", "A", "h0"), grads["cuda"],
                          grads["cpu"]):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [16, 40])
def test_ffn_kernel_matches_plain_at_jamba_width(cuda, dtype, N):
    """d_model 4096 (4-row blocks), d_ff 14336: a decode tick's 16 rows
    (F split) and 40 ragged rows.  In f32 the reference's 1e-5 (set at
    F 512) is scaled by sqrt(F / 512): the rounding of the F-term f32 sums
    of kernel and plain version grows as sqrt(F), as ``_dw_tol`` scales
    the weight grads' bound with the rows."""
    D, F = 4096, 14336
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda, dtype) for a in (
        _rand((N, D), 80), _rand((D, F), 81, D ** -0.5),
        _rand((D, F), 82, D ** -0.5), _rand((F, D), 83, F ** -0.5)))
    got = ffn_kernel.swiglu_ffn(x, wg, wu, wd)
    want = ref.ref_swiglu_ffn(x, wg, wu, wd)
    torch.cuda.synchronize()
    tol = TOL["ffn"][dtype] * ((F / 512) ** 0.5 if dtype == torch.float32
                               else 1.0)
    _close(got.float().cpu(), want.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 600])
def test_ffn_bwd_dx_kernel_matches_plain_at_jamba_width(cuda, N):
    """dx at d_model 4096, d_ff 14336 in bf16 (the tensor-core route takes
    any width) and in f32 (the SIMT dx kernel's 4-row blocks: its rows and
    accumulator live in shared memory; the f32 tolerance scaled by
    sqrt(F / 512), as the forward's at this width: the F-term sums'
    rounding grows as sqrt(F))."""
    D, F = 4096, 14336
    gen = torch.Generator(device=cuda).manual_seed(84)
    args = [torch.randn(N, D, generator=gen, device=cuda),
            torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
            torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
            torch.randn(F, D, generator=gen, device=cuda) * F ** -0.5,
            torch.randn(N, D, generator=gen, device=cuda)]
    got = ffn_kernel.swiglu_ffn_bwd_dx(*args)
    want = ref.ref_swiglu_ffn_bwd(*args)[0]
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(),
           TOL["ffn_bwd"][torch.float32] * (F / 512) ** 0.5, "dx f32")
    args = [t.to(torch.bfloat16) for t in args]
    got = ffn_kernel.swiglu_ffn_bwd_dx(*args)
    want = ref.ref_swiglu_ffn_bwd(*args)[0]
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(),
           TOL["ffn_bwd"][torch.bfloat16], "dx")


# -- the tensor-core dW (#7) and flash forward (#1) ---------------------------


def _ffn_bwd_args(cuda, N, D, F, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [t.to(torch.bfloat16) for t in (
        torch.randn(N, D, generator=gen, device=cuda),
        torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
        torch.randn(D, F, generator=gen, device=cuda) * D ** -0.5,
        torch.randn(F, D, generator=gen, device=cuda) * F ** -0.5,
        torch.randn(N, D, generator=gen, device=cuda))]


@pytest.mark.cuda
@pytest.mark.parametrize("D,F", [(256, 512), (768, 2048), (3072, 8192)])
@pytest.mark.parametrize("N", [1, 16, 600, 4096])
def test_ffn_bwd_dw_tc_kernel_matches_plain(cuda, N, D, F):
    """The bf16 dW kernel against its plain version (three f32 products)
    over the same dg, du and h pairs from the gradient kernel: ragged N
    (split and unsplit rows), exanode-100m's and llama3.2-3b's widths;
    dWd comes out transposed from its [D, F] tile.  The gradient kernel's
    pairs are held against the plain grad math too: hi within one bf16
    step, hi + lo within 1e-4 (both sides sum D-term f32 products in their
    own orders)."""
    x, wg, wu, wd, dy = _ffn_bwd_args(cuda, N, D, F, 85)
    pairs = ffn_kernel.swiglu_ffn_bwd_grads(x, wg, wu, wd, dy)
    got = ffn_kernel.swiglu_ffn_bwd_dw_tc(x, dy, *pairs)
    sums = [t.float().sum(0) for t in pairs]
    want = ref.ref_swiglu_ffn_bwd_dw(x, dy, *sums)
    plain = ref.ref_swiglu_ffn_grads(x, wg, wu, wd, dy)
    torch.cuda.synchronize()
    for name, t, g, w in zip(("dg", "du", "h"), pairs, sums, plain):
        _close(t[0].float().cpu(), w.cpu(), 2 ** -8, name + " hi")
        _close(g.cpu(), w.cpu(), 1e-4, name + " hi + lo")
    for name, g, w in zip(("dw_gate", "dw_up", "dw_down"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g.float().cpu(), w.float().cpu(),
               TOL["ffn_bwd"][torch.bfloat16], name)
        assert float((g.float() - w.float()).norm()) <= \
            1e-2 * float(w.float().norm()), name


@pytest.mark.cuda
def test_ffn_bwd_dw_tc_refuses_what_tma_cannot_load(cuda):
    """The dW kernel takes bf16, contiguous, 16-byte aligned [N, D] and
    [N, F] tensors with D and F multiples of 8, and raises otherwise."""
    x, wg, wu, wd, dy = _ffn_bwd_args(cuda, 64, 256, 512, 86)
    dg, du, h = ffn_kernel.swiglu_ffn_bwd_grads(x, wg, wu, wd, dy)
    with pytest.raises(ValueError, match="contiguous"):
        ffn_kernel.swiglu_ffn_bwd_dw_tc(x, dy, dg.transpose(1, 2)
                                        .contiguous().transpose(1, 2), du, h)
    buf = torch.zeros(2 * 64 * 512 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ffn_kernel.swiglu_ffn_bwd_dw_tc(x, dy, buf[1:].view(2, 64, 512), du,
                                        h)
    with pytest.raises(ValueError, match=r"\[2,N,F\]"):
        ffn_kernel.swiglu_ffn_bwd_dw_tc(x, dy, dg[0], du, h)
    with pytest.raises(ValueError, match="bf16"):
        ffn_kernel.swiglu_ffn_bwd_dw_tc(x.float(), dy, dg, du, h)
    x20 = torch.zeros(64, 20, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="% 8"):
        ffn_kernel.swiglu_ffn_bwd_dw_tc(x20, x20, dg, du, h)


# (S, T, H, Hkv, causal, window, q strided as the model's [B,S,H,D] view)
FLASH_TC_CASES = [(1024, 1024, 12, 4, True, 0, True),
                  (1000, 1000, 8, 2, True, 256, True),
                  (1000, 1000, 4, 4, False, 0, False),
                  (130, 70, 6, 2, False, 0, True),
                  (200, 200, 4, 1, True, 0, False),
                  (300, 300, 6, 2, True, 100, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T,H,Hkv,causal,window,strided", FLASH_TC_CASES)
def test_flash_tc_kernel_matches_plain(cuda, D, S, T, H, Hkv, causal, window,
                                       strided):
    """The bf16 tensor-core forward against ref_attention: causal,
    non-causal and windowed, ragged S and T, GQA groups 1 to 4, q/k/v as
    the model's strided views or contiguous; out in q's layout."""
    gen = torch.Generator(device=cuda).manual_seed(87)

    def make(heads, rows):
        if strided:
            t = torch.randn(2, rows, heads, D, generator=gen, device=cuda)
            return t.to(torch.bfloat16).transpose(1, 2)
        return torch.randn(2, heads, rows, D, generator=gen,
                           device=cuda).to(torch.bfloat16)

    q, k, v = make(H, S), make(Hkv, T), make(Hkv, T)
    assert fa_kernel.route(q.dtype, D) == "tc"
    out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window)
    want, want_lse = ref.ref_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.stride() == q.stride() or not q.is_contiguous()
    _close(out.float().cpu(), want.float().cpu(), TOL["flash"][torch.bfloat16])
    _close(lse.cpu(), want_lse.cpu(), TOL["flash"][torch.float32])


@pytest.mark.cuda
def test_flash_tc_route_refuses_what_tma_cannot_load(cuda):
    """The tensor-core forward's TMA loads need strides that are multiples
    of 8 elements and 16-byte aligned tensors: another layout raises (it is
    never copied, and never sent to the SIMT kernel)."""
    q = torch.zeros(1, 2, 64, 68, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_kernel.flash_attention(q[..., :64], q[..., :64], q[..., :64])
    buf = torch.zeros(2 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.flash_attention(q, q, q)
    fa_kernel.flash_attention(q.float(), q.float(), q.float())   # SIMT: fine
