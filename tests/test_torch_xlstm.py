"""The PyTorch port's xLSTM serving path against the JAX reference, on the
CPU, at xlstm-125m's smoke size (4 layers of mlstm, mlstm, mlstm, slstm;
d_model 64, 4 heads, chunk 8).

The same parameters (the reference's ``init_params(specs, PRNGKey(0))``
carried over by ``repro_torch.bridge``) and the same seeded inputs go
through both packages in f32; the port runs the plain PyTorch version of
the mLSTM kernel (``ref_mlstm_scan``) here.  Tolerances: the plain scan
within the reference kernel test's 2e-4 of the Pallas kernel (interpret
mode) and of the sequential oracle; block outputs within 1e-4; logits
within 1e-3 and the loss within 1e-4 (the reference's); every state leaf
within 1e-5 in ||err|| / ||want||; identical greedy streams.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.kernels import ref
from repro_torch.models import ssm
from repro_torch.models.common import LayerGroup
from repro_torch.models.common import ModelConfig as PortConfig
from repro_torch.models.registry import (check_supported, check_trainable,
                                         model_decode_step,
                                         model_forward, model_loss,
                                         model_prefill)
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import kvcache
from repro_torch.serve.engine import Request as PortRequest
from test_torch_kernels import (MLSTM_REL_TOL, MLSTM_SHAPES, MLSTM_TOL,
                                _close, _mlstm_inputs, _rel)

ARCH = "xlstm-125m"
LOGITS_TOL, LOSS_TOL, BLOCK_TOL, STATE_REL_TOL = 1e-3, 1e-4, 1e-4, 1e-5

# never-firing straggler thresholds: a slow tick on a loaded machine
# must not evacuate and replay a stream these tests pin
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)


@pytest.fixture(scope="module")
def jref():
    """The reference modules, pinned to the CPU (skips where JAX is
    absent)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.models.common
    import repro.models.registry
    import repro.models.ssm
    import repro.runtime
    import repro.serve.engine
    import repro.serve.kvcache
    from repro.kernels import mlstm_scan
    from repro.kernels import ref as jnp_ref
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "common": repro.models.common, "registry": repro.models.registry,
            "ssm": repro.models.ssm, "runtime": repro.runtime,
            "engine": repro.serve.engine, "kvcache": repro.serve.kvcache,
            "pallas": mlstm_scan, "ref": jnp_ref}


def _np(tree):
    import jax
    return jax.tree.map(lambda a: np.array(a), tree)


def _pair(jref, capacity=32):
    """(reference Runtime, port Runtime) on the f32 smoke config with the
    reference's seeded params on both sides."""
    jnp = jref["jnp"]
    rcfg = jref["configs"].get_smoke_config(ARCH).scaled(dtype=jnp.float32)
    rrt = jref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                         capacity=capacity)
    pcfg = port_smoke(ARCH).scaled(dtype=torch.float32)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(_np(rrt.params),
                                                          pcfg))
    return rrt, prt


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape, dtype=np.int32)


def _state_close(got, want, what):
    """Every leaf within STATE_REL_TOL in ||err|| / ||want|| (m, which
    may hold -inf, exactly where it is infinite)."""
    got, want = got.double(), torch.from_numpy(np.array(want)).double()
    assert got.shape == want.shape, what
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), what
    assert torch.equal(got[~fin], want[~fin]), what
    assert _rel(got[fin], want[fin]) <= STATE_REL_TOL, what


# -- 1. the plain scan against the reference ---------------------------------


@pytest.mark.parametrize("B,H,S,dh,chunk", MLSTM_SHAPES[:3])
def test_mlstm_plain_matches_pallas_and_oracle(jref, B, H, S, dh, chunk):
    """``ref_mlstm_scan`` against the Pallas kernel (interpret mode) and
    the sequential oracle ``ref_mlstm_chunk`` (the reference's and the
    port's) at the reference's 2e-4; its carry against the oracle's at
    1e-5 relative (m at 1e-5 absolute)."""
    jnp = jref["jnp"]
    ins = _mlstm_inputs(B, H, S, dh)
    want = np.asarray(jref["pallas"].mlstm_scan(
        *(jnp.asarray(a) for a in ins), chunk=chunk))
    y, (C, n, m) = ref.ref_mlstm_scan(*(torch.from_numpy(a) for a in ins),
                                      chunk=chunk)
    _close(y, want, MLSTM_TOL, "vs Pallas")
    tr = lambda a: np.ascontiguousarray(a.swapaxes(1, 2))    # noqa: E731
    zero = (np.zeros((B, H, dh, dh), np.float32),
            np.zeros((B, H, dh), np.float32),
            np.full((B, H), -np.inf, np.float32))
    y_seq, (C_s, n_s, m_s) = jref["ref"].ref_mlstm_chunk(
        *(jnp.asarray(tr(a)) for a in ins), *(jnp.asarray(a) for a in zero))
    _close(y, tr(np.asarray(y_seq)), MLSTM_TOL, "vs the sequential oracle")
    py, _ = ref.ref_mlstm_chunk(*(torch.from_numpy(tr(a)) for a in ins),
                                *(torch.from_numpy(a) for a in zero))
    _close(py, np.asarray(y_seq), MLSTM_TOL, "port oracle vs reference's")
    _state_close(C, C_s, "C")
    _state_close(n, n_s, "n")
    _close(m, np.asarray(m_s), 1e-5)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 8)])
def test_mlstm_plain_carry_matches_ssm_scan(jref, S, chunk):
    """The plain scan's final carry against the carry of the reference's
    ``ssm.mlstm`` chunk loop (``_mlstm_chunk`` scanned from the zero
    state), and the scan continued from a given state against one call
    over the whole sequence."""
    jax, jnp = jref["jax"], jref["jnp"]
    B, H, dh = 2, 2, 16
    ins = _mlstm_inputs(B, H, S, dh, seed=40)
    nc = S // chunk

    def split(a):
        a = jnp.asarray(a).swapaxes(1, 2)                 # [B,S,H,...]
        return a.reshape((B, nc, chunk) + a.shape[2:]).swapaxes(0, 1)

    def body(c, xs):
        y, c = jref["ssm"]._mlstm_chunk(*xs, *c)
        return c, y

    carry0 = (jnp.zeros((B, H, dh, dh)), jnp.zeros((B, H, dh)),
              jnp.full((B, H), -jnp.inf))
    (C_w, n_w, m_w), _ = jax.lax.scan(body, carry0,
                                      tuple(split(a) for a in ins))
    ts = [torch.from_numpy(a) for a in ins]
    y, (C, n, m) = ref.ref_mlstm_scan(*ts, chunk=chunk)
    _state_close(C, C_w, "C")
    _state_close(n, n_w, "n")
    _close(m, np.asarray(m_w), 1e-5)
    half = S // 2
    y1, st = ref.ref_mlstm_scan(*(t[:, :, :half] for t in ts), chunk=chunk)
    y2, st2 = ref.ref_mlstm_scan(*(t[:, :, half:] for t in ts), chunk=chunk,
                                 state=st)
    _close(torch.cat([y1, y2], 2), y, 1e-5)
    for a, b in zip(st2, (C, n, m)):
        _close(a, b, 1e-5)


def _tf32_split(x):
    """x = hi + lo as ``csrc/mlstm_scan.cu`` splits an f32 operand: hi
    rounded to the nearest tf32 (10 mantissa bits, ties away from zero),
    lo = x - hi (exact) truncated to tf32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)
    return hi, lo


def _mm3(a, b):
    """a @ b in 3xTF32, as the kernels' products: lo·hi + hi·lo + hi·hi,
    each product of tf32 operands exact in f32, summed in f32."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _rehearse_mlstm(q, k, v, ig, fl, chunk, state=None):
    """The arithmetic of the Hopper kernel in plain torch, f32: the carry
    walk folds each chunk's own state, built under the chunk's own
    stabilizer A_c = max_s a_s, into the carry with e^{A_c - M_L}; the
    output of every chunk is then built from its entry carry alone; every
    product in 3xTF32, q·n and Δn as plain f32 sums.  Returns (y, (C, n,
    m)) and, per chunk, (A_c, the entering m)."""
    B, H, S, dh = q.shape
    L = min(chunk, S)
    if state is None:
        C, n = q.new_zeros(B, H, dh, dh), q.new_zeros(B, H, dh)
        m = q.new_full((B, H), float("-inf"))
    else:
        C, n, m = (t.clone() for t in state)
    entry, stats = [], []
    for c0 in range(0, S, L):          # mlstm_carry_kernel
        entry.append((C, n, m))
        kc, vc = k[:, :, c0:c0 + L], v[:, :, c0:c0 + L]
        g = torch.cumsum(fl[:, :, c0:c0 + L], -1)
        a = ig[:, :, c0:c0 + L] - g
        A = a.max(-1).values
        stats.append((A, m))
        w = torch.exp(a - A[..., None])
        dC = _mm3((vc * w[..., None]).transpose(-1, -2), kc)
        dn = (w[..., None] * kc).sum(-2)
        M = torch.maximum(m, A)
        up, decay = torch.exp(A - M), torch.exp(m - M)
        C = up[..., None, None] * dC + decay[..., None, None] * C
        n = up[..., None] * dn + decay[..., None] * n
        m = g[..., -1] + M
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    ys = []
    for i, c0 in enumerate(range(0, S, L)):   # mlstm_out_kernel
        Cp, np_, mp = entry[i]
        qc, kc, vc = (t[:, :, c0:c0 + L] for t in (q, k, v))
        g = torch.cumsum(fl[:, :, c0:c0 + L], -1)
        a = ig[:, :, c0:c0 + L] - g
        M = torch.maximum(torch.cummax(a, -1).values, mp[..., None])
        P = torch.where(causal, _mm3(qc, kc.transpose(-1, -2))
                        * torch.exp(a[..., None, :] - M[..., :, None]), 0.0)
        inter = torch.exp(mp[..., None] - M)
        num = inter[..., None] * _mm3(qc, Cp.transpose(-1, -2)) + _mm3(P, vc)
        den = P.sum(-1) + inter * (qc @ np_[..., None])[..., 0]
        ys.append(num / den.abs().clamp(min=1.0)[..., None])
    return torch.cat(ys, 2), (C, n, m), stats


def _rehearsal_case(name):
    """(inputs [B,H,S,dh] / [B,H,S] as numpy, chunk, the half of S a state
    is built from or 0) for each case of the rehearsal."""
    if name.startswith("shape"):
        B, H, S, dh, chunk = MLSTM_SHAPES[int(name[-1])]
        return _mlstm_inputs(B, H, S, dh), chunk, 0
    if name == "one chunk":
        return _mlstm_inputs(2, 2, 128, 64, seed=20), 256, 0
    if name == "padded tail":
        ins = [a.copy() for a in _mlstm_inputs(2, 2, 384, 32, seed=21)]
        for a in ins[:3]:
            a[:, :, 300:] = 0.0
        ins[3][:, :, 300:] = -1e30
        ins[4][:, :, 300:] = 0.0
        return ins, 128, 0
    if name == "from a state":
        return _mlstm_inputs(2, 2, 512, 64, seed=22), 128, 256
    assert name == "carry-dominated"
    ins = [a.copy() for a in _mlstm_inputs(2, 2, 384, 32, seed=23)]
    ins[3][:, :, :128] += 4.0
    ins[3][:, :, 128:256] -= 30.0
    return ins, 128, 0


@pytest.mark.parametrize("name", ["shape 0", "shape 1", "shape 2",
                                  "one chunk", "padded tail", "from a state",
                                  "carry-dominated"])
def test_mlstm_kernel_rehearsal_matches_pallas_and_oracle(jref, name):
    """The Hopper kernel's arithmetic (``_rehearse_mlstm``: the chunk-local
    stabilizer and 3xTF32 products) against the Pallas kernel (interpret
    mode; y only, it keeps no carry), the reference's sequential oracle
    ``ref_mlstm_chunk`` (y, C, n, m) and the plain ``ref_mlstm_scan``, each
    within the kernel gates: 2e-4 (atol = rtol) and 1e-4 in
    ||err|| / ||want||."""
    jnp = jref["jnp"]
    ins, chunk, half = _rehearsal_case(name)
    B, H, S, dh = ins[0].shape
    tr = lambda a: np.ascontiguousarray(a.swapaxes(1, 2))    # noqa: E731
    state = (np.zeros((B, H, dh, dh), np.float32),
             np.zeros((B, H, dh), np.float32),
             np.full((B, H), -np.inf, np.float32))
    if half:    # the carry after the first half, from the oracle
        _, state = jref["ref"].ref_mlstm_chunk(
            *(jnp.asarray(tr(a[:, :, :half])) for a in ins),
            *(jnp.asarray(a) for a in state))
        state = tuple(np.array(a) for a in state)
        ins = [np.ascontiguousarray(a[:, :, half:]) for a in ins]
    ts = [torch.from_numpy(a) for a in ins]
    st = tuple(torch.from_numpy(a) for a in state) if half else None
    y, (C, n, m), stats = _rehearse_mlstm(*ts, chunk=chunk, state=st)
    wy, (wC, wn, wm) = jref["ref"].ref_mlstm_chunk(
        *(jnp.asarray(tr(a)) for a in ins), *(jnp.asarray(a) for a in state))
    wants = {"oracle": (tr(np.asarray(wy)), np.asarray(wC), np.asarray(wn),
                        np.asarray(wm))}
    py, pc = ref.ref_mlstm_scan(*ts, chunk=chunk, state=st)
    wants["plain"] = tuple(t.numpy() for t in (py,) + pc)
    if not half:
        wants["pallas"] = (np.asarray(jref["pallas"].mlstm_scan(
            *(jnp.asarray(a) for a in ins), chunk=chunk)),)
    for who, want in wants.items():
        for what, g, w in zip("yCnm", (y, C, n, m), want):
            w = torch.from_numpy(np.array(w))
            _close(g, w, MLSTM_TOL, f"{name}: {what} vs {who}")
            assert _rel(g, w) <= MLSTM_REL_TOL, f"{name}: {what} vs {who}"
    if name == "carry-dominated":   # chunk 1's own maximum is below its m
        A, m_in = stats[1]
        assert bool((A < m_in - 5.0).all()), (A, m_in)
    if name == "one chunk":
        assert len(stats) == 1


def test_mlstm_f32_rounding_at_full_width_is_bounded():
    """xlstm-125m's mLSTM at full width (4 heads of dh 384) over a
    600-token prompt, padded to 768 as ``models.ssm.mlstm`` pads it
    (chunk 256; pad steps i = -1e30, f_log = 0, zero q/k/v): the chunked
    plain scan and the sequential oracle, each in f32, against the
    sequential oracle in f64.  The f32 rounding of the scan alone: y within
    4e-6 of ||y|| (the chunked form measured 1.25e-6, max abs 5.4e-5 at
    |y| <= 12.2; the sequential 2.7e-7), the carry within 1e-6."""
    B, H, S, dh, L = 1, 4, 600, 384, 256
    pad = (-S) % L
    q, k, v, ig, fl = (torch.from_numpy(a)
                       for a in _mlstm_inputs(B, H, S, dh))
    F = torch.nn.functional
    q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    ig, fl = F.pad(ig, (0, pad), value=ssm.PAD_GATE), F.pad(fl, (0, pad))
    tr = lambda t: t.transpose(1, 2).contiguous()            # noqa: E731

    def oracle(dt):
        zero = (torch.zeros(B, H, dh, dh, dtype=dt),
                torch.zeros(B, H, dh, dtype=dt),
                torch.full((B, H), float("-inf"), dtype=dt))
        y, st = ref.ref_mlstm_chunk(*(tr(t.to(dt)) for t in (q, k, v)),
                                    tr(ig.to(dt)[..., None])[..., 0],
                                    tr(fl.to(dt)[..., None])[..., 0], *zero)
        return tr(y), st

    want_y, (wC, wn, wm) = oracle(torch.float64)
    got = {"chunked": ref.ref_mlstm_scan(q, k, v, ig, fl, chunk=L),
           "sequential": oracle(torch.float32)}
    for name, (y, (C, n, m)) in got.items():
        y_tol = 4e-6 if name == "chunked" else 1e-6
        assert _rel(y[:, :, :S], want_y[:, :, :S]) <= y_tol, name
        _close(y[:, :, :S], want_y[:, :, :S], MLSTM_TOL, name)
        assert _rel(C, wC) <= 1e-6 and _rel(n, wn) <= 1e-6, name
        assert float((m.double() - wm).abs().max()) <= 1e-5, name


# -- 2. blocks against the reference -----------------------------------------


def _block_case(jref, kind, S, seed):
    """(reference cfg, port cfg, reference params, port params, x) for one
    ``kind`` block at the f32 smoke widths."""
    jax, jnp = jref["jax"], jref["jnp"]
    rcfg = jref["configs"].get_smoke_config(ARCH).scaled(dtype=jnp.float32)
    pcfg = port_smoke(ARCH).scaled(dtype=torch.float32)
    specs = getattr(jref["ssm"], f"{kind}_specs")(rcfg, rcfg.xlstm)
    rp = jref["common"].init_params(specs, jax.random.PRNGKey(seed))
    pp = params_from_reference(_np(rp))
    x = np.random.default_rng(seed).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, rp, pp, x


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [16, 13])
def test_block_and_decode_match_reference(jref, kind, S):
    """The port's mixer over S tokens (a multiple of the chunk, and with a
    ragged tail the mLSTM pads) and then three decode steps from its state,
    against ``repro.models.ssm``'s: outputs within 1e-4, every state leaf
    within 1e-5 in ||err|| / ||want||."""
    jnp = jref["jnp"]
    rcfg, pcfg, rp, pp, x = _block_case(jref, kind, S, seed=3)
    rfn = getattr(jref["ssm"], kind)
    rdec = getattr(jref["ssm"], f"{kind}_decode")
    pfn, pdec = getattr(ssm, kind), getattr(ssm, f"{kind}_decode")
    want, wst = rfn(jnp.asarray(x), rp, rcfg, rcfg.xlstm)
    got, gst = pfn(torch.from_numpy(x), pp, pcfg, pcfg.xlstm)
    _close(got, np.asarray(want), BLOCK_TOL, f"{kind} S={S}")
    for i, (g, w) in enumerate(zip(gst, wst)):
        _state_close(g, w, f"{kind} S={S} state {i}")
    steps = np.random.default_rng(4).standard_normal(
        (3, 2, 1, rcfg.d_model)).astype(np.float32)
    for t, xt in enumerate(steps):
        want, wst = rdec(jnp.asarray(xt), rp, rcfg, rcfg.xlstm, wst)
        got, gst = pdec(torch.from_numpy(xt), pp, pcfg, pcfg.xlstm, gst)
        _close(got, np.asarray(want), BLOCK_TOL, f"{kind} decode {t}")
        for i, (g, w) in enumerate(zip(gst, wst)):
            _state_close(g, w, f"{kind} decode {t} state {i}")


def test_mlstm_from_a_state_matches_reference(jref):
    """``mlstm(state=...)`` (the reference's optional carry) continues the
    scan from (C, n, m); the conv starts from zeros in both."""
    jnp = jref["jnp"]
    rcfg, pcfg, rp, pp, x = _block_case(jref, "mlstm", 24, seed=5)
    _, wst = jref["ssm"].mlstm(jnp.asarray(x[:, :8]), rp, rcfg, rcfg.xlstm)
    _, gst = ssm.mlstm(torch.from_numpy(x[:, :8]), pp, pcfg, pcfg.xlstm)
    want, wst = jref["ssm"].mlstm(jnp.asarray(x[:, 8:]), rp, rcfg,
                                  rcfg.xlstm, state=wst)
    got, gst = ssm.mlstm(torch.from_numpy(x[:, 8:]), pp, pcfg, pcfg.xlstm,
                         state=gst)
    _close(got, np.asarray(want), BLOCK_TOL)
    for i, (g, w) in enumerate(zip(gst, wst)):
        _state_close(g, w, f"state {i}")


# -- 3. the model against the reference --------------------------------------


def test_bridge_converts_the_xlstm_tree(jref):
    """groups[0]["sub0".."sub3"], stacked over the pattern's repeats, pass
    the port's shape check leaf for leaf."""
    rrt, prt = _pair(jref)
    g = prt.params["groups"][0]
    assert sorted(g) == ["sub0", "sub1", "sub2", "sub3"]
    assert tuple(g["sub0"]["mixer"]["wq"].shape) == (1, 128, 4, 32)
    assert tuple(g["sub3"]["mixer"]["r_rec"].shape) == (1, 4, 4, 16, 16)
    assert prt.num_params == jref["common"].count_params(rrt.specs)


def test_forward_logits_and_loss_match_reference(jref):
    rrt, prt = _pair(jref)
    jnp = jref["jnp"]
    toks = _tokens(prt.cfg, (2, 21), seed=1)          # 3 chunks, ragged
    want, _ = jref["registry"].model_forward(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg)
    got = model_forward(prt.params, torch.from_numpy(toks), prt.cfg)
    _close(got, np.asarray(want), LOGITS_TOL)
    labels = _tokens(prt.cfg, (2, 21), seed=2)
    labels[0, :3] = -1
    wl, _ = jref["registry"].model_loss(
        rrt.params, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)}, rrt.cfg)
    with torch.no_grad():
        gl, metrics = model_loss(prt.params,
                                 {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)},
                                 prt.cfg)
    assert abs(float(gl) - float(wl)) <= LOSS_TOL
    assert float(metrics["moe_aux"]) == 0.0


def test_prefill_caches_and_decode_ticks_match_reference(jref):
    """Prefill over a ragged length, every cache leaf (C, n, m, conv; c,
    n, m, h) against the reference's, then seven decode ticks' logits."""
    rrt, prt = _pair(jref, capacity=16)
    jnp = jref["jnp"]
    toks = _tokens(prt.cfg, (2, 11), seed=3)
    r_logits, r_caches = jref["registry"].model_prefill(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg, 16,
        last_only=True)
    p_logits, p_caches = model_prefill(prt.params, torch.from_numpy(toks),
                                       prt.cfg, 16, last_only=True)
    leaves = 0
    for gi, (gw, gg) in enumerate(zip(r_caches, p_caches)):
        assert sorted(gw) == sorted(gg)
        for sub in gw:
            assert sorted(gw[sub]) == sorted(gg[sub])
            for name in gw[sub]:
                _state_close(gg[sub][name], gw[sub][name],
                             f"group {gi} {sub} {name}")
                leaves += 1
    assert leaves == 16
    pos = np.full(2, 11, np.int32)
    for tick in range(7):
        _close(p_logits, np.asarray(r_logits), LOGITS_TOL, f"tick {tick}")
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        r_logits, r_caches = jref["registry"].model_decode_step(
            rrt.params, jnp.asarray(nxt), r_caches, rrt.cfg,
            pos=jnp.asarray(pos))
        p_logits = model_decode_step(prt.params, torch.from_numpy(nxt),
                                     p_caches, prt.cfg,
                                     pos=torch.from_numpy(pos))
        pos = pos + 1


def test_padded_prefill_states_follow_the_reference(jref):
    """Right-padded batched prefill (the engine's power-of-two buckets):
    the reference masks pad entries of attention caches only
    (``kvcache.mask_prefill_pos``), so recurrent states absorb the pad
    tokens.  The port keeps that: its padded states equal the
    reference's, and the padded row's differ from a prefill of the prompt
    alone, while the unpadded row's do not."""
    jax, jnp = jref["jax"], jref["jnp"]
    rrt, prt = _pair(jref, capacity=16)
    toks = _tokens(prt.cfg, (2, 8), seed=6)
    lens = np.array([5, 8], np.int32)
    toks[0, 5:] = 0
    want_tok, want = jax.jit(rrt.make_prefill_step())(
        rrt.params, {"tokens": jnp.asarray(toks),
                     "lengths": jnp.asarray(lens)})
    got_tok, got = prt.make_prefill_step()(
        prt.params, {"tokens": torch.from_numpy(toks),
                     "lengths": torch.from_numpy(lens)})
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    for sub in want[0]:
        for name in want[0][sub]:
            _state_close(got[0][sub][name], want[0][sub][name],
                         f"{sub} {name}")
    for row, n in enumerate(lens):
        _, alone = model_prefill(prt.params,
                                 torch.from_numpy(toks[row:row + 1, :n]),
                                 prt.cfg, 16, last_only=True)
        rel = _rel(got[0]["sub0"]["C"][:, row], alone[0]["sub0"]["C"][:, 0])
        assert (rel > 1e-2) if n < 8 else (rel <= STATE_REL_TOL), (n, rel)


# -- 4. engine streams --------------------------------------------------------


def test_engine_token_streams_match_reference(jref):
    """Prompt lengths that are and are not powers of two (buckets 8, 16
    and 32: one to four chunks of 8, pad rows absorbed into the states as
    in the reference), one longer than the capacity (admitted at its exact
    length, 37: a ragged tail inside the mLSTM scan), more requests than
    slots: the port's engine emits the reference engine's greedy
    streams."""
    rrt, prt = _pair(jref, capacity=32)
    lens = [5, 8, 16, 11, 21, 32, 3, 13, 37, 24]
    reqs = [(i, _tokens(prt.cfg, n, seed=200 + i), 6)
            for i, n in enumerate(lens)]

    def run(engine, request_cls):
        for i, p, m in reqs:
            engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=m))
        engine.run_to_completion()
        return {r.rid: list(r.generated) for r in engine.finished}

    want = run(rrt.engine(num_slots=3, injector=None,
                          straggler_kw=NO_STRAGGLER),
               jref["engine"].Request)
    port = prt.engine(num_slots=3, straggler_kw=NO_STRAGGLER)
    got = run(port, PortRequest)
    assert port.stats.prefill_calls > 1 and port.stats.finished == len(reqs)
    for i, p, m in reqs:
        assert len(got[i]) == m
        if got[i] != want[i]:
            j = next(k for k, (a, b) in enumerate(zip(got[i], want[i]))
                     if a != b)
            ctx = np.concatenate([p, np.asarray(got[i][:j], np.int32)])
            logits = model_forward(prt.params, torch.from_numpy(ctx)[None],
                                   prt.cfg)[0, -1, :prt.cfg.vocab_size]
            top = torch.topk(logits, 2).values
            pytest.fail(f"rid {i}: first divergence at token {j} (port "
                        f"{got[i][j]}, reference {want[i][j]}); top-2 logit "
                        f"margin of a full forward there "
                        f"{float(top[0] - top[1]):.3g}")


def test_state_bytes_match_reference_cache(jref):
    """The engine counts the recurrent states as its decode-state bytes:
    the reference's ``abstract_cache`` sizes, at smoke size through the
    engine and at full width per stream (16 slots: 343,869,696 B)."""
    rrt, prt = _pair(jref, capacity=32)
    abstract = jref["kvcache"].abstract_cache

    def ref_bytes(cfg, slots, cap):
        import jax
        return sum(a.size * a.dtype.itemsize
                   for a in jax.tree.leaves(abstract(cfg, slots, cap)))

    eng = prt.engine(num_slots=3)
    assert eng.kv_cache_bytes() == ref_bytes(rrt.cfg, 3, 32)
    assert eng.kv_cache_f32_equiv_bytes() == eng.kv_cache_bytes()
    full = jref["configs"].get_config(ARCH)
    per = kvcache.state_bytes_per_stream(PortRuntime.create(
        ARCH, device="cpu").cfg)
    assert per * 16 == ref_bytes(full, 16, 2048) == 343_869_696


# -- 5. the runtime surface ---------------------------------------------------


def test_runtime_describe_names_family_and_kernel():
    rt = PortRuntime.create(ARCH, smoke=True, device="cpu")
    text = rt.describe()
    assert rt.caps.subquadratic and not rt.caps.supports_paged_decode
    assert "subquadratic" in rt.caps.summary
    assert ("  family    : ssm (recurrent: mlstm x3, slstm x1; state "
            "bytes/stream=56,368)") in text
    assert "  kernels   : mlstm_scan (mLSTM prefill" in text
    assert not PortRuntime.create("exanode-100m", smoke=True,
                                  device="cpu").caps.subquadratic


def test_runtime_rejects_paged_for_xlstm(jref):
    with pytest.raises(ValueError, match="does not support the paged KV"):
        jref["runtime"].Runtime.create(ARCH, smoke=True, kv_layout="paged")
    with pytest.raises(ValueError, match="does not support the paged KV"):
        PortRuntime.create(ARCH, smoke=True, device="cpu",
                           kv_layout="paged")


def test_runtime_still_rejects_train_for_jamba():
    """xlstm-125m trains (tests/test_torch_xlstm_train.py), and so do MoE
    stacks (tests/test_torch_moe.py) and, since the Mamba scan's backward
    (#12b), the hybrid: its train shape is no longer refused and names
    ``ssm_scan_bwd`` (tests/test_torch_jamba_train.py).  What the port
    still refuses is an arch it has not ported: whisper-tiny, the next
    slice, is no registry name of the port's yet."""
    rt = PortRuntime.create("jamba-v0.1-52b", smoke=True, device="cpu",
                            shape_kind="train")
    assert "kernels: ssm_scan + ssm_scan_bwd" in rt.describe()
    with pytest.raises(KeyError, match="whisper-tiny"):
        PortRuntime.create("whisper-tiny", smoke=True, device="cpu",
                           shape_kind="train")


def _port_config(rcfg) -> PortConfig:
    """A reference ``ModelConfig`` carried field for field into the
    port's (sub-configs kept as the reference's objects)."""
    import jax.numpy as jnp
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)
          if f.name in {g.name for g in dataclasses.fields(PortConfig)}}
    kw["groups"] = tuple(LayerGroup(tuple(g.pattern), g.repeats)
                         for g in rcfg.groups)
    kw["dtype"] = dtypes[rcfg.dtype]
    kw["param_dtype"] = dtypes[rcfg.param_dtype]
    kw["xlstm"] = None
    return PortConfig(**kw)


@pytest.mark.parametrize("arch,what", [("jamba-v0.1-52b", "Mamba"),
                                       ("mixtral-8x7b", "mixture of experts")])
def test_check_supported_still_rejects_jamba_and_mixtral(jref, arch, what):
    """What the port still refuses of these archs: nothing.  Both,
    carried over field for field from the reference's configs, pass
    ``check_supported`` and ``check_trainable``: jamba since the Mamba
    scan's backward (tests/test_torch_jamba_train.py), mixtral since its
    ring buffer and MoE training (tests/test_torch_moe.py).  The next
    slice's arch, whisper-tiny (an encoder-decoder), is still refused,
    naming ROADMAP, and neither block family (``what``) is named
    there."""
    cfg = _port_config(jref["configs"].get_config(arch))
    check_supported(cfg)
    check_trainable(cfg)
    with pytest.raises(NotImplementedError, match="encoder-decoder.*ROADMAP"
                       ) as err:
        check_supported(_port_config(
            jref["configs"].get_config("whisper-tiny")))
    assert what not in str(err.value)
