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
from test_torch_kernels import (MLSTM_SHAPES, MLSTM_TOL, _close,
                                _mlstm_inputs, _rel)

ARCH = "xlstm-125m"
LOGITS_TOL, LOSS_TOL, BLOCK_TOL, STATE_REL_TOL = 1e-3, 1e-4, 1e-4, 1e-5


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

    want = run(rrt.engine(num_slots=3, injector=None),
               jref["engine"].Request)
    port = prt.engine(num_slots=3)
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


def test_runtime_rejects_paged_and_train_for_xlstm(jref):
    with pytest.raises(ValueError, match="does not support the paged KV"):
        jref["runtime"].Runtime.create(ARCH, smoke=True, kv_layout="paged")
    with pytest.raises(ValueError, match="does not support the paged KV"):
        PortRuntime.create(ARCH, smoke=True, device="cpu",
                           kv_layout="paged")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PortRuntime.create(ARCH, smoke=True, device="cpu",
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
    """What the port still refuses of these archs: training their Mamba
    or MoE blocks (``check_trainable``), with the message naming ROADMAP.
    Serving jamba is ported (tests/test_torch_jamba.py), so
    ``check_supported`` admits it; mixtral stays refused there for its
    sliding-window ring buffer."""
    cfg = _port_config(jref["configs"].get_config(arch))
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP"):
        check_trainable(cfg)
    if arch == "mixtral-8x7b":
        with pytest.raises(NotImplementedError,
                           match="sliding-window.*ROADMAP"):
            check_supported(cfg)
    else:
        check_supported(cfg)
