"""The PyTorch port's xLSTM training path against the JAX reference, on
the CPU.

The mLSTM scan's backward is written by hand in the port
(``ref_mlstm_scan_bwd``, the plain version of the kernels
``mlstm_scan_bwd``): it is held against ``jax.vjp`` of the reference's jnp
chunk scan (``repro.models.ssm._mlstm_chunk`` under ``lax.scan``, as
``ssm.mlstm`` runs it) within 1e-4 (atol + rtol) in f32, and against
``torch.autograd`` through the plain forward ``ref_mlstm_scan`` within
1e-10 in f64, in both regimes of the denominator's clamp, from a zero and
from a given state, with the final carry's grads non-zero.  The model's
loss and every grad leaf are held against ``jax.value_and_grad`` of the
reference's ``model_loss`` at the reference's own bounds (loss 1e-4,
grads 1e-3, as tests/test_torch_train.py), at xlstm-125m's smoke size and
at a full-width one-period cut (4 layers of 768, mLSTM dh 384, B 1, S
512: two chunks of 256); ten train steps follow the reference's losses
(1e-4) and end within 1e-3 of its params.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import opt_state_from_reference, params_from_reference
from repro_torch.configs import get_config as port_config
from repro_torch.data import pipeline as port_data
from repro_torch.kernels import ref
from repro_torch.launch import train as port_launch
from repro_torch.models.common import LayerGroup, tree_leaves
from repro_torch.optim import schedules as port_schedules
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.train import steps as port_steps
from repro_torch.train.state import TrainState
from test_torch_train import (GRAD_TOL, LOSS_TOL, OPT_TOL, _batch, _cfgs,
                              _close, _np_tree, _port_loss_and_grads,
                              _ref_loss_and_grads, _ref_params, _ref_state)
from test_torch_train import ref as ref_modules  # noqa: F401  (fixture)

ARCH = "xlstm-125m"
VJP_TOL = 1e-4       # the plain backward against jax.vjp, f32
F64_TOL = 1e-10      # against torch.autograd through the plain forward, f64

# (B, H, S, dh, chunk): one chunk, and two, three and four chunks
SCAN_SHAPES = [(2, 2, 32, 16, 32), (1, 3, 64, 16, 32), (2, 1, 48, 8, 16),
               (1, 2, 96, 32, 24)]
# q scaled so that |d_t| <= 1 (the clamp holds: y = num) on every row, or
# so that |d_t| > 1 on most rows (y = num / |d|; 0.77-0.88 of them here).
# Not further: at q x 10 the grads reach ~3e3, and the reference's own f32
# vjp is then up to 1.8x the 1e-4 bound away from the f64 values (the
# port's plain backward up to 1.7x), at q x 3 both within 0.34x of it.
Q_SCALES = {"clamped": 0.01, "unclamped": 3.0}


@pytest.fixture(scope="module")
def jx():
    """JAX and the reference's chunk math, pinned to the CPU (skips where
    JAX is absent)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import repro.models.ssm
    return {"jax": jax, "jnp": jax.numpy, "ssm": repro.models.ssm}


def _scan_inputs(B, H, S, dh, q_scale, seed):
    """q·q_scale, k·dh^-0.5, v, i ~ N(0, 1), f_log = log_sigmoid(N(0, 1)
    + 2) in [B,H,S,dh] / [B,H,S]; a state (C, n, m) from a scan of other
    inputs; the cotangents dy, dC, dn, dm.  All numpy f32."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    q, k, v = n(B, H, S, dh) * q_scale, n(B, H, S, dh) * dh ** -0.5, \
        n(B, H, S, dh)
    ig, fl = n(B, H, S), n(B, H, S) + 2.0
    fl = torch.nn.functional.logsigmoid(torch.from_numpy(fl)).numpy()
    _, st = ref.ref_mlstm_scan(*(torch.from_numpy(a) for a in (
        n(B, H, S, dh), n(B, H, S, dh) * dh ** -0.5, n(B, H, S, dh),
        n(B, H, S), np.zeros((B, H, S), np.float32) - 0.1)), chunk=S)
    cot = (n(B, H, S, dh), n(B, H, dh, dh), n(B, H, dh), n(B, H))
    return (q, k, v, ig, fl), tuple(t.numpy() for t in st), cot


def _jax_vjp(jx, ins, state, cot, chunk):
    """jax.vjp of the reference's chunk scan (``_mlstm_chunk`` under
    ``lax.scan``) in the port's layout: the grads of q, k, v, i, f_log and,
    with a ``state``, of (C, n, m)."""
    jax, jnp = jx["jax"], jx["jnp"]
    B, H, S, dh = ins[0].shape
    L = min(chunk, S)
    nc = S // L

    def scan(q, k, v, ig, fl, C0, n0, m0):
        split = lambda t: t.reshape((B, nc, L) + t.shape[2:]) \
            .swapaxes(0, 1)                                   # noqa: E731
        seq = lambda t: jnp.moveaxis(t, 1, 2)                 # noqa: E731

        def body(carry, inp):
            y, carry = jx["ssm"]._mlstm_chunk(*inp, *carry)
            return carry, y
        (C, n, m), ys = jax.lax.scan(
            body, (C0, n0, m0),
            tuple(split(seq(t)) for t in (q, k, v, ig, fl)))
        y = ys.swapaxes(0, 1).reshape(B, S, H, dh)
        return jnp.moveaxis(y, 1, 2), C, n, m

    xs = tuple(jnp.asarray(a) for a in ins)
    if state is None:
        zero = (jnp.zeros((B, H, dh, dh)), jnp.zeros((B, H, dh)),
                jnp.full((B, H), -jnp.inf))
        _, vjp = jax.vjp(lambda *a: scan(*a, *zero), *xs)
    else:
        _, vjp = jax.vjp(scan, *xs, *(jnp.asarray(a) for a in state))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]


def _port_bwd(ins, state, cot, chunk):
    """``ref_mlstm_scan_bwd`` from the plain forward's kept tensors."""
    ts = [torch.from_numpy(a) for a in ins]
    st = None if state is None else tuple(torch.from_numpy(a) for a in state)
    y, _, kept = ref.ref_mlstm_scan(*ts, chunk=chunk, state=st, keep=True)
    dy, dC, dn, dm = (torch.from_numpy(c) for c in cot)
    grads = ref.ref_mlstm_scan_bwd(*ts, y, kept, dy, chunk=chunk, state=st,
                                   dC=dC, dn=dn, dm=dm)
    return [g for g in grads if g is not None], kept[0]


NAMES = ("dq", "dk", "dv", "di", "df_log", "dC", "dn", "dm")


@pytest.mark.parametrize("regime", sorted(Q_SCALES))
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("B,H,S,dh,chunk", SCAN_SHAPES)
def test_plain_backward_matches_jax_vjp(jx, B, H, S, dh, chunk, from_state,
                                        regime):
    """``ref_mlstm_scan_bwd`` against ``jax.vjp`` of the reference's chunk
    scan within 1e-4, every grad (the state's too, from a given state);
    the regime is checked on the forward's denominators."""
    ins, state, cot = _scan_inputs(B, H, S, dh, Q_SCALES[regime],
                                   seed=B * 100 + S + dh)
    state = state if from_state else None
    got, d = _port_bwd(ins, state, cot, chunk)
    share = float((d.abs() > 1.0).float().mean())
    assert share == 0.0 if regime == "clamped" else share > 0.5, share
    want = _jax_vjp(jx, ins, state, cot, chunk)
    assert len(got) == len(want) == (8 if from_state else 5)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        _close(g, w, VJP_TOL, name)


@pytest.mark.parametrize("regime", sorted(Q_SCALES))
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("B,H,S,dh,chunk", SCAN_SHAPES)
def test_plain_backward_matches_autograd_f64(B, H, S, dh, chunk, from_state,
                                             regime):
    """The same backward in f64 against ``torch.autograd`` through
    ``ref_mlstm_scan`` within 1e-10."""
    ins, state, cot = _scan_inputs(B, H, S, dh, Q_SCALES[regime],
                                   seed=B * 100 + S + dh + 1)
    ins = [a.astype(np.float64) for a in ins]
    cot = [a.astype(np.float64) for a in cot]
    state = [a.astype(np.float64) for a in state] if from_state else None
    got, _ = _port_bwd(ins, state, cot, chunk)
    xs = [torch.from_numpy(a).requires_grad_() for a in
          ins + (state if from_state else [])]
    y, carry = ref.ref_mlstm_scan(*xs[:5], chunk=chunk,
                                  state=tuple(xs[5:]) if from_state else None)
    want = torch.autograd.grad((y, *carry), xs,
                               [torch.from_numpy(c) for c in cot])
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F64_TOL,
                                   rtol=F64_TOL, err_msg=name)


def test_padded_steps_get_zero_grads():
    """Pad steps as ``models.ssm.mlstm`` appends them (i = -1e30, f_log =
    0, zero q/k/v) with a zero dy there: their q, k, v and i grads are
    exactly zero, and no grad is NaN (the first chunk's m = -inf)."""
    ins, _, cot = _scan_inputs(2, 2, 64, 16, 1.0, seed=7)
    ins = [a.copy() for a in ins]
    for a in ins[:3]:
        a[:, :, 50:] = 0.0
    ins[3][:, :, 50:] = -1e30
    ins[4][:, :, 50:] = 0.0
    cot = (cot[0].copy(),)
    cot[0][:, :, 50:] = 0.0
    ts = [torch.from_numpy(a) for a in ins]
    y, _, kept = ref.ref_mlstm_scan(*ts, chunk=32, keep=True)
    grads = ref.ref_mlstm_scan_bwd(*ts, y, kept, torch.from_numpy(cot[0]),
                                   chunk=32)
    for name, g in zip(NAMES, grads[:5]):
        assert bool(torch.isfinite(g).all()), name
    for name, g in zip(NAMES, grads[:4]):
        assert not bool(g[:, :, 50:].any()), name


def _chunk_with_masked_exponent(jax):
    """The reference's ``_mlstm_chunk`` (``repro/models/ssm.py:234``) with
    one change: the causal mask is applied to the exponent a_s - M_t
    before ``exp``, not to the product after it.  The forward's values are
    the same (both put 0 above the diagonal); its ``jax.grad`` is the
    reference's where the exponent stays below f32's exp overflow, and
    finite where it does not."""
    jnp = jax.numpy

    def chunk(q, k, v, i_gate, f_log, C0, n0, m0):
        B, L, H, dh = q.shape
        g = jnp.cumsum(f_log, axis=1)
        a = i_gate - g
        M = jnp.maximum(jax.lax.cummax(a, axis=1), m0[:, None])
        scores = jnp.einsum("blhd,bshd->bhls", q, k)
        causal = jnp.tril(jnp.ones((L, L), bool))
        w = jnp.exp(jnp.where(causal, a.transpose(0, 2, 1)[:, :, None, :]
                              - M.transpose(0, 2, 1)[..., None], -jnp.inf))
        scores = jnp.where(causal, scores * w, 0.0)
        y_num = jnp.einsum("bhls,bshd->blhd", scores, v)
        inter = jnp.exp(m0[:, None] - M)
        y_num = y_num + inter[..., None] * jnp.einsum("blhd,bhvd->blhv", q,
                                                      C0)
        d_t = jnp.sum(scores, axis=-1).transpose(0, 2, 1) \
            + inter * jnp.einsum("blhd,bhd->blh", q, n0)
        y = y_num / jnp.maximum(jnp.abs(d_t), 1.0)[..., None]
        M_L, g_L = M[:, -1], g[:, -1]
        wc = jnp.exp(a - M_L[:, None])
        C1 = jnp.einsum("blh,blhv,blhk->bhvk", wc, v, k) \
            + jnp.exp(m0 - M_L)[..., None, None] * C0
        n1 = jnp.einsum("blh,blhk->bhk", wc, k) \
            + jnp.exp(m0 - M_L)[..., None] * n0
        return y, (C1, n1, g_L + M_L)
    return chunk


def test_plain_backward_is_finite_where_the_reference_vjp_overflows(
        jx, monkeypatch):
    """Forget gates near 0 (f_log ~ -3) over a chunk of 64: above the
    diagonal a_s - M_t reaches ~190, past f32's exp overflow.  The
    reference's ``jax.vjp`` of its chunk then multiplies a masked 0 by exp's
    inf and returns NaN; the port's backward is finite there and within
    1e-4 of the vjp of the same chunk with the mask applied before
    ``exp`` (``_chunk_with_masked_exponent``)."""
    B, H, S, dh, L = 1, 2, 128, 16, 64
    ins, _, cot = _scan_inputs(B, H, S, dh, 1.0, seed=21)
    ins = list(ins)
    ins[4] = ins[4] - 3.0
    plain = _jax_vjp(jx, ins, None, cot, L)
    assert not all(np.isfinite(g).all() for g in plain)
    got, _ = _port_bwd(ins, None, cot, L)
    monkeypatch.setattr(jx["ssm"], "_mlstm_chunk",
                        _chunk_with_masked_exponent(jx["jax"]))
    want = _jax_vjp(jx, ins, None, cot, L)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g, w, VJP_TOL, name)


# -- the model ----------------------------------------------------------------


def _full_width_cut(ref_modules):
    """xlstm-125m at full width cut to one period (mlstm x3, slstm), f32,
    on both sides."""
    jnp = ref_modules["jnp"]
    period = ("mlstm", "mlstm", "mlstm", "slstm")
    rgroup = type(ref_modules["configs"].get_config(ARCH).groups[0])
    rcfg = ref_modules["configs"].get_config(ARCH).scaled(
        num_layers=4, groups=(rgroup(period, 1),), dtype=jnp.float32)
    pcfg = port_config(ARCH).scaled(
        num_layers=4, groups=(LayerGroup(period, 1),), dtype=torch.float32)
    return rcfg, pcfg


@pytest.mark.parametrize("size", ["smoke", "full_width_period"])
def test_loss_and_grads_match_reference(ref_modules, size, monkeypatch):
    """lm_loss and every grad leaf against the reference's
    value_and_grad(model_loss): the smoke config at 2 x 24 tokens (three
    chunks of 8), and the full-width period at 1 x 512 (two mLSTM chunks
    of 256, two sLSTM remat chunks).

    At chunk 256 the reference's own grads are NaN in every mLSTM layer
    but the last one's out projections: its masked exponent overflows
    (``test_plain_backward_is_finite_where_the_reference_vjp_overflows``).
    There the port is held to the reference with the mask taken before
    ``exp`` (``_chunk_with_masked_exponent``): the same loss, finite
    grads."""
    if size == "smoke":
        rcfg, pcfg = _cfgs(ref_modules, ARCH)
        batch = _batch(rcfg.vocab_size)
    else:
        rcfg, pcfg = _full_width_cut(ref_modules)
        batch = _batch(rcfg.vocab_size, B=1, S=512, seed=11)
        import repro.models.ssm as rssm
        monkeypatch.setattr(rssm, "_mlstm_chunk",
                            _chunk_with_masked_exponent(ref_modules["jax"]))
    rparams = _ref_params(ref_modules, rcfg)
    loss_r, metrics_r, grads_r = _ref_loss_and_grads(ref_modules, rcfg,
                                                     rparams, batch, 0)
    params = params_from_reference(_np_tree(ref_modules, rparams), pcfg)
    del rparams
    loss, metrics, grads = _port_loss_and_grads(pcfg, params, batch, 0)
    _close(loss, loss_r, LOSS_TOL, "loss")
    _close(metrics["ce"], metrics_r["ce"], LOSS_TOL, "ce")
    jax = ref_modules["jax"]
    flat_r = jax.tree_util.tree_flatten_with_path(grads_r)[0]
    got = tree_leaves(grads)
    assert len(got) == len(flat_r)
    for g, (path, want) in zip(got, flat_r):
        assert tuple(g.shape) == want.shape
        _close(g, want, GRAD_TOL, jax.tree_util.keystr(path))


def test_train_trajectory_matches_reference(ref_modules):
    """Ten cosine-scheduled steps on the xlstm-125m smoke config from the
    reference's initial state: the loss of every step within 1e-4, and the
    final params within the grad tolerance.

    But for the mLSTM input gates' biases (``b_if[:H]``): a constant added
    to every i_t of a head moves a and the stabilizer M together and
    leaves y as it is, so their grad is 0 up to f32 rounding on both sides
    (checked here on the port's first step), and AdamW's normalized update
    then follows the rounding's sign: both sides walk by up to ~lr a step,
    each its own way.  They are held to that walk's bound instead."""
    jax, jnp = ref_modules["jax"], ref_modules["jnp"]
    rcfg, pcfg = _cfgs(ref_modules, ARCH)
    plan = ref_modules["topology"].make_plan(rcfg, {})
    specs = ref_modules["registry"].model_specs(rcfg)
    kw = dict(peak=3e-3, warmup=2, total=10)
    rstep = jax.jit(ref_modules["steps"].make_train_step(
        rcfg, plan, specs, None,
        schedule=ref_modules["schedules"].make_schedule("cosine", **kw)))
    pstep = port_steps.make_train_step(
        pcfg, schedule=port_schedules.make_schedule("cosine", **kw))
    rstate = _ref_state(ref_modules, rcfg, plan)
    state = TrainState(
        params_from_reference(_np_tree(ref_modules, rstate.params), pcfg),
        opt_state_from_reference(_np_tree(ref_modules, rstate.opt), pcfg))
    dkw = dict(vocab_size=rcfg.vocab_size, seq_len=32, global_batch=4,
               branch=4)
    H = pcfg.num_heads
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rstate.params)[0]]
    first = port_data.to_device(
        port_data.synthetic_batch(port_data.DataConfig(**dkw), 0), "cpu")
    _, _, grads = port_steps.value_and_grad(state.params, first, pcfg)
    for path, g in zip(paths, tree_leaves(grads)):
        if path.endswith("['b_if']"):
            assert float(g[..., :H].abs().max()) <= 1e-6, path
            assert float(g[..., H:].abs().max()) > 1e-4, path
    init = [t.clone() for t in tree_leaves(state.params)]
    for i in range(10):
        batch = port_data.synthetic_batch(port_data.DataConfig(**dkw), i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = pstep(state, port_data.to_device(batch, "cpu"))
        _close(m["loss"], rm["loss"], LOSS_TOL, f"loss at step {i}")
        _close(m["lr"], rm["lr"], OPT_TOL, f"lr at step {i}")
    assert state.opt.count == 10
    for path, a, b, a0 in zip(paths, tree_leaves(state.params),
                              jax.tree.leaves(rstate.params), init):
        b = np.asarray(b)
        if path.endswith("['b_if']"):
            walk = 10 * kw["peak"]
            assert float((a[..., :H] - a0[..., :H]).abs().max()) <= walk
            assert float(np.abs(b[..., :H] - a0[..., :H].numpy()).max()) \
                <= walk
            a, b = a[..., H:], b[..., H:]
        _close(a, b, GRAD_TOL, f"{path} after 10 steps")


# -- the entry points ---------------------------------------------------------


def test_runtime_trains_xlstm_on_cpu(capsys):
    """create(shape_kind="train") -> init_train_state -> train_step and
    the launcher, for xlstm-125m through the plain versions; the describe
    line names the mLSTM backward."""
    rt = PortRuntime.create(ARCH, smoke=True, shape_kind="train",
                            seq_len=24, device="cpu")
    text = rt.describe()
    assert ("train     : seq_len=24 ce_chunk=0 remat=minimal "
            "param_dtype=torch.float32 kernels: mlstm_scan + mlstm_scan_bwd"
            ) in text
    state = rt.init_train_state()
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(rt.cfg.vocab_size).items()}
    loss0, _ = rt.loss(batch, params=state.params)
    state, m = rt.train_step(state, batch)
    assert state.opt.count == 1 and float(m["loss"]) == float(loss0)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    port_launch.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "16", "--device", "cpu",
                      "--log-every", "1"])
    out = capsys.readouterr().out
    assert "kernels: mlstm_scan + mlstm_scan_bwd" in out
    assert "step     2 loss=" in out and "gnorm=" in out


def test_slstm_remat_chunks_change_memory_not_numbers(monkeypatch):
    """The sLSTM under chunked remat (chunks of 8 over 24 steps, three
    checkpointed chunks) gives the same loss, bit for bit, and the same
    grads to 1e-6, as one plain loop (a chunk of 5 does not divide 24: the
    plain loop).  The grads of the weights every step reads add up chunk
    by chunk, in another order than step by step."""
    from repro_torch.models import ssm
    cfg = port_config(ARCH)
    pcfg = cfg.scaled(num_layers=1, d_model=64, num_heads=4, head_dim=16,
                      vocab_size=256, groups=(LayerGroup(("slstm",), 1),),
                      dtype=torch.float32)
    rt = PortRuntime.create(pcfg, shape_kind="train", seq_len=24,
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(256).items()}
    outs = {}
    for chunk in (8, 5):
        monkeypatch.setattr(ssm, "SLSTM_REMAT_CHUNK", chunk)
        outs[chunk] = port_steps.value_and_grad(rt.params, batch, pcfg)
    (l8, _, g8), (l5, _, g5) = outs[8], outs[5]
    assert torch.equal(l8, l5)
    for a, b in zip(tree_leaves(g8), tree_leaves(g5)):
        _close(a, b, 1e-6, "grads")
