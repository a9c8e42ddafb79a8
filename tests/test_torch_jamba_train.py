"""The PyTorch port's Jamba training path against the JAX reference, on
the CPU.

The Mamba selective scan's backward is written by hand in the port
(``ref_ssm_scan_bwd``, the plain version of kernel #12b,
``ssm_scan_bwd``): it is held against ``jax.vjp`` of the reference's scan
oracle ``repro.kernels.ref.ref_mamba_chunk_scan`` (its gates a = exp(dt·A)
and b = dt·x·B built in jnp, so the vjp reaches dt, x, B, C and A) within
1e-5 in f32 (dA, a sum over batch and time: both sides within 1e-5 of
its f64 value), from a zero state and from a given one, with the final
state's gradient non-zero, at S not a multiple of the chunk; and against
``torch.autograd`` through the plain forward ``ref_ssm_scan`` within 1e-10
in f64.  The port's Mamba mixer (x, every leaf, h0, with the final state
and the conv tail differentiated) is held against ``jax.vjp`` of the
reference's ``repro.models.ssm.mamba`` within 1e-5; the jamba smoke
period's loss and every grad leaf against ``jax.value_and_grad`` of the
reference's ``model_loss`` within 1e-4, and three AdamW steps against the
reference's train step from the same state (losses within 1e-4, the
params after them within the reference's 1e-3).  Tolerances are atol + rtol.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import opt_state_from_reference, params_from_reference
from repro_torch.configs.jamba_v0_1_52b import TRAIN_CUT, train_cut
from repro_torch.data import pipeline as port_data
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as port_launch
from repro_torch.models import ssm
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import check_trainable
from repro_torch.optim import schedules as port_schedules
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.train import steps as port_steps
from repro_torch.train.state import TrainState
from test_torch_train import (GRAD_TOL, _batch, _cfgs, _np_tree,
                              _port_loss_and_grads,
                              _ref_loss_and_grads, _ref_params, _ref_state)
from test_torch_train import ref as ref_modules  # noqa: F401  (fixture)

ARCH = "jamba-v0.1-52b"
VJP_TOL = 1e-5       # the plain backward and the mixer against jax.vjp, f32
F64_TOL = 1e-10      # against torch.autograd through the plain forward, f64
MODEL_TOL = 1e-4     # loss, grads and the trajectory against the reference

# (B, S, Di, N, chunk): S not a multiple of the chunk (a ragged last
# chunk), one chunk, and several
SCAN_SHAPES = [(2, 13, 16, 8, 8), (1, 40, 24, 16, 16), (2, 33, 16, 12, 32),
               (1, 50, 20, 8, 12)]


@pytest.fixture(scope="module")
def jx():
    """JAX and the reference's scan oracle and mixer, pinned to the CPU
    (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.kernels.ref
    import repro.models.common
    import repro.models.ssm
    return {"jax": jax, "jnp": jax.numpy, "ref": repro.kernels.ref,
            "ssm": repro.models.ssm, "configs": repro.configs,
            "common": repro.models.common}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol, err_msg=msg)


def _scan_inputs(B, S, Di, N, seed):
    """dt = softplus(N(0,1)), x/B/C ~ N(0,1), A = -exp(N(0,1)) (the
    reference kernel test's recipe), a start state and the cotangents dy,
    dh ~ N(0,1).  All numpy f32."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    ins = (np.log1p(np.exp(n(B, S, Di))), n(B, S, N), n(B, S, N),
           n(B, S, Di), -np.exp(n(Di, N)))
    return ins, n(B, Di, N), (n(B, S, Di), n(B, Di, N))


def _jax_vjp(jx, ins, h0, cot):
    """jax.vjp of the reference's scan oracle over dt, B, C, x, A (and
    h0): the gates built in jnp; a start state enters as a first step with
    a = 0 and b = h0 whose y is dropped (the oracle starts from zero)."""
    jnp = jx["jnp"]

    def f(dt, Bm, Cm, x, A, *h):
        a = jnp.exp(dt[..., None] * A)
        b = (dt * x)[..., None] * Bm[:, :, None, :]
        if h:
            a = jnp.concatenate([jnp.zeros_like(a[:, :1]), a], axis=1)
            b = jnp.concatenate([h[0][:, None], b], axis=1)
            Cm = jnp.concatenate([jnp.zeros_like(Cm[:, :1]), Cm], axis=1)
        y, hf = jx["ref"].ref_mamba_chunk_scan(a, b, Cm)
        return (y[:, 1:] if h else y), hf

    args = [jnp.asarray(a) for a in ins] + ([] if h0 is None
                                            else [jnp.asarray(h0)])
    _, vjp = jx["jax"].vjp(f, *args)
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]


def _port_bwd(ins, h0, cot, chunk, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype) for a in ins]
    h0 = None if h0 is None else torch.from_numpy(h0).to(dtype)
    _, _, states = ref.ref_ssm_scan(*ts, h0, chunk=chunk, keep=True)
    dy, dh = (torch.from_numpy(c).to(dtype) for c in cot)
    return ref.ref_ssm_scan_bwd(*ts, h0, states, dy, dh=dh, chunk=chunk)


NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0")


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("B,S,Di,N,chunk", SCAN_SHAPES)
def test_plain_backward_matches_jax_vjp(jx, B, S, Di, N, chunk, from_state):
    """ddt, dx, dB, dC (and dh0) of the plain backward in f32, rebuilding
    the states chunk by chunk from the kept starts, against jax.vjp of the
    reference's oracle in f32 within 1e-5.  dA sums B·S terms, and there
    both f32 sides are held within 1e-5 of the f64 value (the plain
    backward in f64, itself held to torch.autograd's f64 grads below):
    they sit up to 0.42 (the port) and 0.80 (the reference) of that bound
    from it, so up to 1.22 of it from each other."""
    ins, h0, cot = _scan_inputs(B, S, Di, N, seed=S + Di)
    h0 = h0 if from_state else None
    want = dict(zip(("ddt", "dB", "dC", "dx", "dA", "dh0"),
                    _jax_vjp(jx, ins, h0, cot)))
    got = dict(zip(NAMES, _port_bwd(ins, h0, cot, chunk)))
    assert (got["dh0"] is None) == (h0 is None)
    for name in want:
        if name != "dA":
            _close(got[name], want[name], VJP_TOL, name)
    exact = _port_bwd(ins, h0, cot, chunk, torch.float64)[4]
    _close(got["dA"], exact, VJP_TOL, "dA (port f32 against f64)")
    _close(want["dA"], exact, VJP_TOL, "dA (reference f32 against f64)")


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("B,S,Di,N,chunk", SCAN_SHAPES)
def test_plain_backward_matches_autograd_f64(B, S, Di, N, chunk,
                                             from_state):
    """The plain backward against torch.autograd through the plain
    forward, both in f64, within 1e-10."""
    ins, h0, cot = _scan_inputs(B, S, Di, N, seed=S * Di)
    f64 = torch.float64
    ts = [torch.from_numpy(a).to(f64).requires_grad_() for a in ins]
    h = (torch.from_numpy(h0).to(f64).requires_grad_() if from_state
         else None)
    y, hf = ref.ref_ssm_scan(*ts, h)
    dy, dh = (torch.from_numpy(c).to(f64) for c in cot)
    wants = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(),
                                ts + ([h] if from_state else []))
    got = _port_bwd(ins, h0 if from_state else None, cot, chunk, f64)
    ddt, dx, dB, dC, dA, dh0 = got
    for name, g, w in zip(("ddt", "dB", "dC", "dx", "dA", "dh0"),
                          (ddt, dB, dC, dx, dA, dh0), wants):
        assert g.dtype == f64
        _close(g, w, F64_TOL, name)


def test_pad_steps_get_zero_grads():
    """Pad steps as ``models.ssm.mamba`` appends them (dt = 0, dy = 0
    there): zero dx, dB and dC on them, and every other grad equal to the
    cut sequence's (a = 1 passes the adjoint through unchanged)."""
    ins, _, (dy, _) = _scan_inputs(2, 24, 16, 8, seed=7)
    cut = 19
    ts = [torch.from_numpy(a) for a in ins]
    ts[0][:, cut:] = 0.0
    dy = torch.from_numpy(dy)
    dy[:, cut:] = 0.0
    _, _, st = ref.ref_ssm_scan(*ts, chunk=8, keep=True)
    pad = ref.ref_ssm_scan_bwd(*ts, None, st, dy, chunk=8)
    short = [t[:, :cut] for t in ts[:4]] + [ts[4]]
    _, _, st_cut = ref.ref_ssm_scan(*short, chunk=8, keep=True)
    cut_g = ref.ref_ssm_scan_bwd(*short, None, st_cut, dy[:, :cut], chunk=8)
    for g in pad[1:4]:
        assert not bool(g[:, cut:].any())
    for name, g, w in zip(NAMES, pad[:4], cut_g[:4]):
        _close(g[:, :cut], w, 1e-6, name)
    _close(pad[4], cut_g[4], 1e-6, "dA")


def test_ssm_chunk_scan_differentiates_through_the_function():
    """``ops.ssm_chunk_scan`` on inputs that need a gradient runs
    ``SSMChunkScan`` (the plain versions here, no launch counted); its
    grads are the plain backward's; without a gradient it returns the
    serving path's (y, h) exactly."""
    ins, h0, (dy, dh) = _scan_inputs(2, 20, 16, 8, seed=9)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins + (h0,)]
    ops.reset_launch_counts()
    y, h = ops.ssm_chunk_scan(*ts[:5], h0=ts[5], chunk=8)
    assert type(y.grad_fn).__name__ == "SSMChunkScanBackward"
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()
     ).backward()
    assert ops.launch_counts()["ssm_scan_bwd"] == 0
    want = _port_bwd(ins, h0, (dy, dh), 8)
    for t, w in zip(ts, (want[0], want[2], want[3], want[1], want[4],
                         want[5])):
        _close(t.grad, w, 1e-6)
    with torch.no_grad():
        y2, h2 = ops.ssm_chunk_scan(*ts[:5], h0=ts[5])
    assert torch.equal(y2, y.detach()) and torch.equal(h2, h.detach())


# -- the mixer ----------------------------------------------------------------


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("S", [16, 13])
def test_mamba_mixer_grads_match_jax_vjp(jx, S, from_state):
    """x, every mixer leaf and h0 against jax.vjp of the reference's
    ``mamba`` (smoke widths: d_model 64, Di 128, N 8, chunk 8; S 13 is
    padded with dt = 0 steps), with the output, the final state and the
    conv tail all differentiated, within 1e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    rcfg = jx["configs"].get_smoke_config(ARCH).scaled(dtype=jnp.float32)
    pcfg = _port_cfg()
    rp = jx["common"].init_params(jx["ssm"].mamba_specs(rcfg, rcfg.ssm),
                                  jax.random.PRNGKey(S))
    rng = np.random.default_rng(S + from_state)
    D, Di, N = rcfg.d_model, 2 * rcfg.d_model, rcfg.ssm.d_state
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    h0 = (rng.standard_normal((2, Di, N)) * 0.5).astype(np.float32)
    cot = (rng.standard_normal((2, S, D)).astype(np.float32),
           rng.standard_normal((2, Di, N)).astype(np.float32),
           rng.standard_normal((2, 3, Di)).astype(np.float32))

    def f(x, p, *h):
        out, (hf, buf) = jx["ssm"].mamba(x, p, rcfg, rcfg.ssm,
                                         h0=h[0] if h else None,
                                         return_state=True)
        return out, hf, buf

    args = [jnp.asarray(x), rp] + ([jnp.asarray(h0)] if from_state else [])
    _, vjp = jax.vjp(f, *args)
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    pp = {k: v.requires_grad_() for k, v in
          params_from_reference(_np_tree(jx, rp)).items()}
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(h0).requires_grad_() if from_state else None
    out, (hf, buf) = ssm.mamba(xt, pp, pcfg, pcfg.ssm, h0=ht,
                               return_state=True)
    sum((t * torch.from_numpy(c)).sum()
        for t, c in zip((out, hf, buf), cot)).backward()
    _close(xt.grad, want[0], VJP_TOL, "x")
    for k in sorted(pp):
        _close(pp[k].grad, want[1][k], VJP_TOL, k)
    if from_state:
        _close(ht.grad, want[2], VJP_TOL, "h0")


def _port_cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(ARCH).scaled(dtype=torch.float32)


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("S", [24, 21])
def test_loss_and_grads_match_reference(ref_modules, S):
    """The jamba smoke period (mamba, mamba_moe, mamba, mamba_moe, attn,
    mamba_moe, mamba, mamba_moe) at 2 x S tokens: loss, CE and every grad
    leaf against the reference's value_and_grad(model_loss) within 1e-4
    (S 21: a ragged last chunk of 8, padded)."""
    rcfg, pcfg = _cfgs(ref_modules, ARCH)
    rparams = _ref_params(ref_modules, rcfg)
    batch = _batch(rcfg.vocab_size, S=S)
    loss_r, metrics_r, grads_r = _ref_loss_and_grads(ref_modules, rcfg,
                                                     rparams, batch, 0)
    params = params_from_reference(_np_tree(ref_modules, rparams), pcfg)
    loss, metrics, grads = _port_loss_and_grads(pcfg, params, batch, 0)
    _close(loss, loss_r, MODEL_TOL, "loss")
    _close(metrics["ce"], metrics_r["ce"], MODEL_TOL, "ce")
    _close(metrics["moe_aux"], metrics_r["moe_aux"], MODEL_TOL, "moe_aux")
    assert float(metrics["moe_aux"]) > 0
    jax = ref_modules["jax"]
    flat_r = jax.tree_util.tree_flatten_with_path(grads_r)[0]
    got = tree_leaves(grads)
    assert len(got) == len(flat_r)
    for g, (path, want) in zip(got, flat_r):
        assert tuple(g.shape) == want.shape
        _close(g, want, MODEL_TOL, jax.tree_util.keystr(path))
    mixer = [g for g, (path, _) in zip(got, flat_r)
             if "A_log" in jax.tree_util.keystr(path)]
    assert mixer and all(float(g.abs().max()) > 0 for g in mixer)


def test_train_trajectory_matches_reference(ref_modules):
    """Three cosine-scheduled AdamW steps on the jamba smoke config from
    the reference's initial params and optimizer state (bridged): the loss
    and lr of every step within 1e-4, and the params after the last within
    the reference's grad tolerance, 1e-3, as the other trajectory tests
    hold them: AdamW's normalized step turns an f32 difference in a
    near-zero grad into a step of up to lr (3e-3) either way (one MoE
    expert weight of 32,768 ends 2.3e-4 apart)."""
    jax, jnp = ref_modules["jax"], ref_modules["jnp"]
    rcfg, pcfg = _cfgs(ref_modules, ARCH)
    plan = ref_modules["topology"].make_plan(rcfg, {})
    specs = ref_modules["registry"].model_specs(rcfg)
    kw = dict(peak=3e-3, warmup=1, total=3)
    rstep = jax.jit(ref_modules["steps"].make_train_step(
        rcfg, plan, specs, None,
        schedule=ref_modules["schedules"].make_schedule("cosine", **kw)))
    pstep = port_steps.make_train_step(
        pcfg, schedule=port_schedules.make_schedule("cosine", **kw))
    rstate = _ref_state(ref_modules, rcfg, plan)
    state = TrainState(
        params_from_reference(_np_tree(ref_modules, rstate.params), pcfg),
        opt_state_from_reference(_np_tree(ref_modules, rstate.opt), pcfg))
    dkw = dict(vocab_size=rcfg.vocab_size, seq_len=24, global_batch=4,
               branch=4)
    for i in range(3):
        batch = port_data.synthetic_batch(port_data.DataConfig(**dkw), i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = pstep(state, port_data.to_device(batch, "cpu"))
        _close(m["loss"], rm["loss"], MODEL_TOL, f"loss at step {i}")
        _close(m["lr"], rm["lr"], MODEL_TOL, f"lr at step {i}")
    assert state.opt.count == 3
    for a, b in zip(tree_leaves(state.params), jax.tree.leaves(rstate.params)):
        _close(a, b, GRAD_TOL, "params after 3 steps")


# -- the entry points ---------------------------------------------------------


def test_runtime_and_launcher_train_jamba_on_cpu(capsys):
    """create(shape_kind="train") -> init_train_state -> train_step, and
    the launcher, for the jamba smoke period through the plain versions:
    finite losses; the describe line names the scan's backward."""
    rt = PortRuntime.create(ARCH, smoke=True, shape_kind="train",
                            seq_len=24, device="cpu")
    check_trainable(rt.cfg)
    assert "kernels: ssm_scan + ssm_scan_bwd (torch.autograd.Function; " \
        "plain)" in rt.describe()
    state = rt.init_train_state()
    batch = {k: torch.from_numpy(v) for k, v in _batch(rt.cfg.vocab_size)
             .items()}
    loss0, _ = rt.loss(batch, params=state.params)
    state, m = rt.train_step(state, batch)
    assert state.opt.count == 1 and float(m["loss"]) == float(loss0)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    port_launch.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "16", "--device", "cpu",
                      "--log-every", "1"])
    out = capsys.readouterr().out
    assert "ssm_scan + ssm_scan_bwd" in out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_train_cut_is_the_period_mamba_and_attn_layers(ref_modules):
    """``train_cut()``: the full-width model cut to (mamba, attn), every
    width the published one; its parameter count is the reference's
    ``count_params`` of the same cut (1,036,464,128)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import model_specs
    rc = ref_modules["configs"].get_config(ARCH)
    rcut = rc.scaled(num_layers=2, groups=(type(rc.groups[0])(TRAIN_CUT,
                                                               1),))
    want = ref_modules["common"].count_params(
        ref_modules["registry"].model_specs(rcut))
    cfg, full = train_cut(), get_config(ARCH)
    assert want == 1_036_464_128
    assert sum(int(np.prod(s.shape))
               for s in tree_leaves(model_specs(cfg))) == want
    for k in ("d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "ssm", "moe"):
        assert getattr(cfg, k) == getattr(full, k)
    assert [k for g in cfg.groups for k in g.pattern] == ["mamba", "attn"]
    check_trainable(cfg)
