"""The PyTorch port's Jamba serving path against the JAX reference, on the
CPU, at jamba-v0.1-52b's smoke size (one 8-layer period of mamba,
mamba_moe, mamba, mamba_moe, attn, mamba_moe, mamba, mamba_moe; d_model
64, 4 experts top-2, d_state 8, chunk 8).

The same parameters (the reference's ``init_params(specs, PRNGKey(0))``
carried over by ``repro_torch.bridge``) and the same seeded inputs go
through both packages in f32; the port runs the plain PyTorch version of
the selective-scan kernel (``ref_ssm_scan``) here.  Tolerances: the plain
scan within the reference kernel test's 5e-5 of the Pallas kernel
(interpret mode); the Mamba mixer, its state and its decode steps within
1e-5; the MoE FFN's y within 1e-5 and its aux loss within 1e-6, with the
dispatch (slots, kept pairs, order) exactly equal; logits within 1e-3 and
the loss within 1e-4 (the reference's); identical greedy streams.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.configs.jamba_v0_1_52b import one_period
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_kernel
from repro_torch.models import moe, ssm
from repro_torch.models.common import MoEConfig, init_params
from repro_torch.models.registry import (check_trainable, model_decode_step,
                                         model_forward, model_loss,
                                         model_prefill, model_specs)
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import kvcache
from repro_torch.serve.engine import Request as PortRequest

ARCH = "jamba-v0.1-52b"
SCAN_TOL, MIXER_TOL, AUX_TOL = 5e-5, 1e-5, 1e-6
LOGITS_TOL, LOSS_TOL = 1e-3, 1e-4
# tests/test_kernels.py:73-74: (B, S, Di, N, chunk, dblk)
SCAN_SHAPES = [(2, 512, 256, 16, 128, 128), (1, 256, 512, 8, 256, 256)]

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
    import repro.models.moe
    import repro.models.registry
    import repro.models.ssm
    import repro.runtime
    import repro.serve.engine
    import repro.serve.kvcache
    from repro.kernels import ops as jops
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "common": repro.models.common, "moe": repro.models.moe,
            "registry": repro.models.registry, "ssm": repro.models.ssm,
            "runtime": repro.runtime, "engine": repro.serve.engine,
            "kvcache": repro.serve.kvcache, "ops": jops}


def _np(tree):
    import jax
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _configs(jref):
    """The f32 smoke config of both packages."""
    rcfg = jref["configs"].get_smoke_config(ARCH).scaled(
        dtype=jref["jnp"].float32)
    return rcfg, port_smoke(ARCH).scaled(dtype=torch.float32)


def _pair(jref, capacity=32):
    """(reference Runtime, port Runtime) on the f32 smoke config with the
    reference's seeded params on both sides."""
    rcfg, pcfg = _configs(jref)
    rrt = jref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                         capacity=capacity)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(_np(rrt.params),
                                                          pcfg))
    return rrt, prt


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape, dtype=np.int32)


# -- 1. the plain scan against the reference's kernel ------------------------


def _scan_inputs(B, S, Di, N, seed=0):
    """The reference test's recipe: dt = softplus(N(0,1)), B/C/x ~ N(0,1),
    A = -exp(N(0,1))."""
    dt = np.log1p(np.exp(_rand((B, S, Di), seed + 1)))
    return (dt, _rand((B, S, N), seed + 2), _rand((B, S, N), seed + 3),
            _rand((B, S, Di), seed + 4), -np.exp(_rand((Di, N), seed + 5)))


@pytest.mark.parametrize("B,S,Di,N,chunk,dblk", SCAN_SHAPES)
def test_scan_plain_matches_pallas(jref, B, S, Di, N, chunk, dblk):
    """``ops.ssm_chunk_scan`` on CPU tensors (the plain ``ref_ssm_scan``)
    against the reference's Pallas kernel in interpret mode: y and the
    final h within 5e-5; then continued from a state against one call
    over the whole sequence."""
    jnp = jref["jnp"]
    ins = _scan_inputs(B, S, Di, N)
    wy, wh = jref["ops"].ssm_chunk_scan(*(jnp.asarray(a) for a in ins),
                                        chunk=chunk, dblk=dblk)
    ts = [torch.from_numpy(a) for a in ins]
    ops.reset_launch_counts()
    y, h = ops.ssm_chunk_scan(*ts)
    assert ops.launch_counts()["ssm_scan"] == 0
    assert y.dtype == h.dtype == torch.float32
    _close(y, np.asarray(wy), SCAN_TOL, "y")
    _close(h, np.asarray(wh), SCAN_TOL, "h")
    half = S // 2
    y1, h1 = ops.ssm_chunk_scan(*(t[:, :half] for t in ts[:4]), ts[4])
    y2, h2 = ops.ssm_chunk_scan(*(t[:, half:] for t in ts[:4]), ts[4],
                                h0=h1)
    _close(torch.cat([y1, y2], 1), y, 1e-5, "from a state")
    _close(h2, h, 1e-5, "final state from a state")


def test_scan_refuses_grads_and_cpu_tensors_in_the_kernel():
    """No autograd through the plain version (Mamba training is not
    ported), and the kernel's wrapper takes CUDA tensors only."""
    ts = [torch.from_numpy(a) for a in _scan_inputs(1, 8, 16, 4)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.ssm_chunk_scan(ts[0].requires_grad_(), *ts[1:])
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel.ssm_scan(*(t.detach() for t in ts))


def _rehearse_ssm(dt, B_ssm, C_ssm, x, A, h0=None, tile=32, states=8):
    """The Hopper kernel's arithmetic (``csrc/ssm_scan.cu``) in plain
    torch on the CPU: N padded to NMAX (8, 16, 32 or 64) with A = B = C = 0;
    S padded with zero steps to a multiple of the staging tile (the
    kernel's zero-filled rows); a2 = A·log2 e in f32, a = 2^(dt·a2) (the
    f32 argument, the power in f64 rounded once: a stand-in for
    ex2.approx, within its 2 ulp; results below 2^-126 flushed to zero);
    b = (dt·x)·B_t in f32; h = fma(a, h, b) and each lane's share of y an
    FMA chain over its 8 states (both emulated in f64 and rounded once);
    the lanes' shares summed by the reduce-scatter's tree, lanes k and
    k + L/2 first.  Returns (y [B,S,Di], h [B,Di,N]) in f32."""
    f32, f64 = torch.float32, torch.float64
    Bt, S, Di = dt.shape
    N = A.shape[-1]
    nmax = next(m for m in (8, 16, 32, 64) if N <= m)
    lanes = nmax // states
    pad_n = (0, nmax - N)
    Sp = -(-S // tile) * tile
    pad_s = (0, 0, 0, Sp - S)
    dt, x = (F.pad(t.to(f32), pad_s) for t in (dt, x))
    Bs, Cs = (F.pad(F.pad(t.to(f32), pad_n), pad_s) for t in (B_ssm, C_ssm))
    a2 = F.pad(A.to(f32), pad_n) * torch.tensor(1.4426950408889634, dtype=f32)
    h = (torch.zeros(Bt, Di, nmax, dtype=f32) if h0 is None
         else F.pad(h0.to(f32), pad_n))

    def fma(a, b, c):
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)

    ys = []
    for t in range(Sp):
        d = dt[:, t, :, None]
        a = torch.exp2((d * a2).to(f64)).to(f32)
        a = torch.where(a < 2.0 ** -126, torch.zeros_like(a), a)
        b = (dt[:, t] * x[:, t])[..., None] * Bs[:, t, None, :]
        h = fma(a, h, b)
        ch = Cs[:, t, None, :].expand_as(h)
        part = []
        for g in range(lanes):
            acc = torch.zeros(Bt, Di, dtype=f32)
            for p in range(g * states, (g + 1) * states):
                acc = fma(ch[..., p], h[..., p], acc)
            part.append(acc)
        while len(part) > 1:
            m = len(part) // 2
            part = [part[k] + part[k + m] for k in range(m)]
        ys.append(part[0])
    return torch.stack(ys, dim=1)[:, :S], h[..., :N]


# (B, S, Di, N, chunk, dblk): N 8, 16, 64 and 5 (padded within a lane),
# S not a multiple of the kernel's 32-step tile
REHEARSAL_SHAPES = [(1, 72, 64, 8, 24, 64), (2, 100, 128, 16, 50, 128),
                    (1, 40, 32, 64, 40, 32), (1, 48, 16, 5, 48, 16)]


@pytest.mark.parametrize("B,S,Di,N,chunk,dblk", REHEARSAL_SHAPES)
def test_ssm_kernel_rehearsal_matches_pallas_and_plain(jref, B, S, Di, N,
                                                       chunk, dblk):
    """The kernel's arithmetic (``_rehearse_ssm``) against the reference's
    Pallas ``_ssm_kernel`` (interpret mode) and the plain ``ref_ssm_scan``:
    y and h within 5e-5; from a start state against the plain version;
    and dt = 0 pad steps leave h exactly as the cut sequence has it."""
    jnp = jref["jnp"]
    ins = _scan_inputs(B, S, Di, N, seed=20 + N)
    ts = [torch.from_numpy(a) for a in ins]
    y, h = _rehearse_ssm(*ts)
    wy, wh = jref["ops"].ssm_chunk_scan(*(jnp.asarray(a) for a in ins),
                                        chunk=chunk, dblk=dblk)
    _close(y, np.asarray(wy), SCAN_TOL, "y against Pallas")
    _close(h, np.asarray(wh), SCAN_TOL, "h against Pallas")
    py, ph = ref.ref_ssm_scan(*ts)
    _close(y, py, SCAN_TOL, "y against plain")
    _close(h, ph, SCAN_TOL, "h against plain")
    h0 = torch.from_numpy(_rand((B, Di, N), 30 + N, 0.5))
    y0, hh0 = _rehearse_ssm(*ts, h0=h0)
    py0, ph0 = ref.ref_ssm_scan(*ts, h0)
    _close(y0, py0, SCAN_TOL, "y from a state")
    _close(hh0, ph0, SCAN_TOL, "h from a state")
    cut = S - 7
    padded = ts[0].clone()
    padded[:, cut:] = 0.0
    _, h_pad = _rehearse_ssm(padded, *ts[1:])
    _, h_cut = _rehearse_ssm(*(t[:, :cut] for t in ts[:4]), ts[4])
    assert torch.equal(h_pad, h_cut)


# -- 2. the Mamba mixer and the MoE FFN against the reference ----------------


def _mamba_case(jref, seed):
    jax = jref["jax"]
    rcfg, pcfg = _configs(jref)
    rp = jref["common"].init_params(jref["ssm"].mamba_specs(rcfg, rcfg.ssm),
                                    jax.random.PRNGKey(seed))
    return rcfg, pcfg, rp, params_from_reference(_np(rp))


@pytest.mark.parametrize("S", [16, 13])
def test_mamba_and_decode_match_reference(jref, S):
    """The mixer over S tokens (a multiple of the chunk, and a ragged
    tail the mixer pads with dt = 0), its (h, conv) state, then four
    decode steps from that state, against ``repro.models.ssm``: all within
    1e-5."""
    jnp = jref["jnp"]
    rcfg, pcfg, rp, pp = _mamba_case(jref, seed=3)
    x = _rand((2, S, rcfg.d_model), 4)
    want, (wh, wbuf) = jref["ssm"].mamba(jnp.asarray(x), rp, rcfg, rcfg.ssm,
                                         return_state=True)
    got, (gh, gbuf) = ssm.mamba(torch.from_numpy(x), pp, pcfg, pcfg.ssm,
                                return_state=True)
    _close(got, np.asarray(want), MIXER_TOL, f"out S={S}")
    _close(gh, np.asarray(wh), MIXER_TOL, "h")
    _close(gbuf, np.asarray(wbuf), MIXER_TOL, "conv")
    for t in range(4):
        xt = _rand((2, 1, rcfg.d_model), 10 + t)
        want, wh, wbuf = jref["ssm"].mamba_decode(jnp.asarray(xt), rp, rcfg,
                                                  rcfg.ssm, wh, wbuf)
        got, gh, gbuf = ssm.mamba_decode(torch.from_numpy(xt), pp, pcfg,
                                         pcfg.ssm, gh, gbuf)
        _close(got, np.asarray(want), MIXER_TOL, f"decode {t}")
        _close(gh, np.asarray(wh), MIXER_TOL, f"decode {t} h")
        _close(gbuf, np.asarray(wbuf), MIXER_TOL, f"decode {t} conv")


def test_mamba_from_a_state_matches_reference(jref):
    jnp = jref["jnp"]
    rcfg, pcfg, rp, pp = _mamba_case(jref, seed=5)
    x = _rand((2, 8, rcfg.d_model), 6)
    h0 = _rand((2, 2 * rcfg.d_model, rcfg.ssm.d_state), 7, 0.5)
    want = jref["ssm"].mamba(jnp.asarray(x), rp, rcfg, rcfg.ssm,
                             h0=jnp.asarray(h0))
    got = ssm.mamba(torch.from_numpy(x), pp, pcfg, pcfg.ssm,
                    h0=torch.from_numpy(h0))
    _close(got, np.asarray(want), MIXER_TOL)
    assert ssm.mamba_init_state(pcfg, pcfg.ssm, 3)[1].shape == (3, 3, 128)


def _moe_case(jref, seed, skew: bool):
    """Reference MoE params and tokens [2, 8, D]; ``skew`` makes expert 0
    every token's first choice (16 pairs for a capacity of 12: 4 drop)."""
    jax = jref["jax"]
    rcfg, pcfg = _configs(jref)
    rp = _np(jref["common"].init_params(
        jref["moe"].moe_specs(rcfg, rcfg.moe), jax.random.PRNGKey(seed)))
    x = _rand((2, 8, rcfg.d_model), seed + 1)
    if skew:
        x += 1.0
        rp["router"][:, 0] = 1.0
    return rcfg, pcfg, rp, params_from_reference(rp), x


@pytest.mark.parametrize("skew", [False, True])
def test_moe_ffn_matches_reference(jref, skew):
    """``moe_ffn`` (one device) against the reference's: the dispatch's
    slots, kept pairs and order exactly, y within 1e-5 and the aux loss
    within 1e-6; with ``skew`` the capacity drops tokens."""
    jnp = jref["jnp"]
    rcfg, pcfg, rp, pp, x = _moe_case(jref, 20, skew)
    T, E = 16, rcfg.moe.num_experts
    C = moe._capacity(T, pcfg.moe)
    assert C == jref["moe"]._capacity(T, rcfg.moe) == 12
    x2 = x.reshape(T, -1)
    w_w, e_w, _ = jref["moe"]._route(jnp.asarray(x2), jnp.asarray(
        rp["router"]), rcfg.moe)
    w_g, e_g, _ = moe._route(torch.from_numpy(x2), pp["router"], pcfg.moe)
    np.testing.assert_array_equal(e_g.numpy(), np.asarray(e_w))
    _close(w_g, np.asarray(w_w), MIXER_TOL)
    want_d = jref["moe"]._dispatch(jnp.asarray(x2), e_w, C, E)
    got_d = moe._dispatch(torch.from_numpy(x2), e_g, C, E)
    _close(got_d[0], np.asarray(want_d[0]), 0.0, "xg")
    for name, g, w in zip(("slot", "pair_token", "keep", "order"),
                          got_d[1:], want_d[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    if skew:        # expert 0 is every token's first choice: 16 pairs
        assert int((e_g[:, 0] == 0).sum()) == T and int((~got_d[3]).sum()) >= 4
    want, waux = jref["moe"].moe_ffn(jnp.asarray(x), rp, rcfg, rcfg.moe)
    got, gaux = moe.moe_ffn(torch.from_numpy(x), pp, pcfg, pcfg.moe)
    _close(got, np.asarray(want), MIXER_TOL, "y")
    assert abs(float(gaux) - float(waux)) <= AUX_TOL


def test_route_breaks_ties_toward_the_lower_expert(jref):
    """Equal router probabilities (a zero router) pick experts 0 and 1 in
    both packages (``jax.lax.top_k``'s order), and the sharded rules
    raise naming ROADMAP."""
    jnp = jref["jnp"]
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16)
    x = _rand((5, 4), 30)
    _, e_w, _ = jref["moe"]._route(jnp.asarray(x), jnp.zeros((4, 8)), cfg)
    _, e_g, _ = moe._route(torch.from_numpy(x), torch.zeros(4, 8), cfg)
    np.testing.assert_array_equal(e_g.numpy(), np.asarray(e_w))
    assert e_g.tolist() == [[0, 1]] * 5
    _, pcfg = _configs(jref)
    with pytest.raises(NotImplementedError, match="item 9"):
        moe.moe_ffn(torch.zeros(1, 2, 64), {}, pcfg, pcfg.moe, regime="ep")


# -- 3. the model against the reference --------------------------------------


def test_bridge_converts_the_jamba_tree(jref):
    """The period's eight sub-layers pass the port's shape check leaf for
    leaf; the router stays f32."""
    rrt, prt = _pair(jref)
    g = prt.params["groups"][0]
    assert sorted(g) == [f"sub{j}" for j in range(8)]
    assert tuple(g["sub0"]["mixer"]["A_log"].shape) == (1, 128, 8)
    assert tuple(g["sub1"]["ffn"]["wi_gate"].shape) == (1, 4, 64, 128)
    assert tuple(g["sub1"]["ffn"]["wo"].shape) == (1, 4, 128, 64)
    assert g["sub1"]["ffn"]["router"].dtype == torch.float32
    assert "attn" in g["sub4"] and "ffn" in g["sub0"]
    assert prt.num_params == jref["common"].count_params(rrt.specs)


@pytest.mark.parametrize("S", [16, 21])
def test_forward_logits_and_loss_match_reference(jref, S):
    """Logits within 1e-3 and the loss, its MoE aux included, within
    1e-4, at a multiple of the chunk and with a ragged tail."""
    rrt, prt = _pair(jref)
    jnp = jref["jnp"]
    toks = _tokens(prt.cfg, (2, S), seed=1)
    want, _ = jref["registry"].model_forward(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg)
    got = model_forward(prt.params, torch.from_numpy(toks), prt.cfg)
    _close(got, np.asarray(want), LOGITS_TOL)
    labels = _tokens(prt.cfg, (2, S), seed=2)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    wl, wm = jref["registry"].model_loss(
        rrt.params, {k: jnp.asarray(v) for k, v in batch.items()}, rrt.cfg)
    with torch.no_grad():
        gl, gm = model_loss(prt.params,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            prt.cfg)
    assert abs(float(gl) - float(wl)) <= LOSS_TOL
    assert float(gm["moe_aux"]) > 0
    assert abs(float(gm["moe_aux"]) - float(wm["moe_aux"])) <= LOSS_TOL


def test_prefill_caches_and_decode_ticks_match_reference(jref):
    """Prefill of 16 tokens, every cache leaf (the attention layer's k, v,
    pos; each Mamba layer's h, conv) against the reference's, then five
    decode ticks' logits."""
    rrt, prt = _pair(jref, capacity=32)
    jnp = jref["jnp"]
    toks = _tokens(prt.cfg, (2, 16), seed=3)
    r_logits, r_caches = jref["registry"].model_prefill(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg, 32,
        last_only=True)
    p_logits, p_caches = model_prefill(prt.params, torch.from_numpy(toks),
                                       prt.cfg, 32, last_only=True)
    leaves = 0
    for sub, gw in r_caches[0].items():
        assert sorted(gw) == sorted(p_caches[0][sub])
        for name, w in gw.items():
            _close(p_caches[0][sub][name], np.asarray(w), MIXER_TOL,
                   f"{sub} {name}")
            leaves += 1
    assert leaves == 7 * 2 + 3
    pos = np.full(2, 16, np.int32)
    for tick in range(5):
        _close(p_logits, np.asarray(r_logits), LOGITS_TOL, f"tick {tick}")
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        r_logits, r_caches = jref["registry"].model_decode_step(
            rrt.params, jnp.asarray(nxt), r_caches, rrt.cfg,
            pos=jnp.asarray(pos))
        p_logits = model_decode_step(prt.params, torch.from_numpy(nxt),
                                     p_caches, prt.cfg,
                                     pos=torch.from_numpy(pos))
        pos = pos + 1


# -- 4. engine streams and the runtime surface --------------------------------


def test_engine_token_streams_match_reference(jref):
    """Mixed prompt lengths (buckets 4, 8, 16 and 32: pad rows absorbed
    into the Mamba states as in the reference), more requests than
    slots: the port's dense monolithic engine emits the reference
    engine's greedy streams."""
    rrt, prt = _pair(jref, capacity=32)
    lens = [5, 8, 16, 3, 11, 24]
    reqs = [(i, _tokens(prt.cfg, n, seed=300 + i), 5)
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
    assert {i: len(s) for i, s in got.items()} == {i: 5 for i in got}
    assert got == want


def test_state_bytes_match_reference_cache(jref):
    """The engine's decode-state bytes are the reference's
    ``abstract_cache`` sizes at smoke size; at full width one period's
    seven Mamba layers hold 4,014,080 B a stream (h f32, conv bf16)."""
    import jax
    rrt, prt = _pair(jref, capacity=32)
    eng = prt.engine(num_slots=3)
    want = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(
        jref["kvcache"].abstract_cache(rrt.cfg, 3, 32)))
    # the reference counts the attention positions too
    pos = 3 * 32 * 4
    assert eng.kv_cache_bytes() == want - pos
    assert kvcache.state_bytes_per_stream(one_period()) == 4_014_080


def test_runtime_refuses_paged_int8_scheduler_and_training(jref):
    """The reference's ValueErrors for the paged layout, the int8 pool
    and the scheduler on a hybrid stack, and NotImplementedError naming
    ROADMAP for training."""
    for kw, msg in (({"kv_layout": "paged"}, "paged KV"),
                    ({"kv_layout": "paged", "kv_dtype": "int8"}, "paged KV"),
                    ({"kv_dtype": "int8"}, "requires kv_layout='paged'"),
                    ({"scheduler": True}, "chunked prefill")):
        with pytest.raises(ValueError, match=msg):
            jref["runtime"].Runtime.create(ARCH, smoke=True, **kw)
        with pytest.raises(ValueError, match=msg):
            PortRuntime.create(ARCH, smoke=True, device="cpu", **kw)
    rt = PortRuntime.create(ARCH, smoke=True, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        rt.engine(scheduler=True)
    with pytest.raises(NotImplementedError, match="Mamba.*ROADMAP"):
        PortRuntime.create(ARCH, smoke=True, device="cpu",
                           shape_kind="train")
    with pytest.raises(NotImplementedError, match="mixture of experts"):
        check_trainable(rt.cfg)
    text = rt.describe()
    assert ("  family    : hybrid (recurrent: mamba x3, mamba_moe x4; state "
            "bytes/stream=34,048)") in text
    assert "  kernels   : ssm_scan (Mamba prefill) flash_attention" in text
    assert rt.caps.subquadratic and not rt.caps.supports_paged_decode


def test_init_params_draw_on_device_keeps_the_cpu_draw_unchanged():
    """``init_params(..., draw_on_device=True)`` draws where the params
    live; the default CPU draw is what it was (init laws arange_log and
    const included)."""
    specs = model_specs(port_smoke(ARCH))
    params = init_params(specs, seed=4)
    on = init_params(specs, seed=4, draw_on_device=True)
    mixer = params["groups"][0]["sub0"]["mixer"]
    assert torch.equal(mixer["A_log"][0, 5],
                       torch.arange(1, 9, dtype=torch.float32).log())
    assert bool((mixer["dt_b"] == -4.0).all())
    assert torch.equal(params["embed"], on["embed"])