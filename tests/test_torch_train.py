"""The PyTorch port's training path against the JAX reference, on the CPU.

The same parameters (the reference's ``init_params`` carried over by
``repro_torch.bridge``) and the same seeded batches go through both
packages in f32; the port runs the plain forward and backward versions of
its kernels here, through the same ``torch.autograd.Function``s the card
uses.  Tolerances are the reference's own (tests/test_train_fastpath.py):
loss <= 1e-4 and grads <= 1e-3 (atol + rtol); the optimizer and schedule
to 1e-6; the data bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import opt_state_from_reference, params_from_reference
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.data import pipeline as port_data
from repro_torch.launch import train as port_launch
from repro_torch.models import registry as port_registry
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import schedules as port_schedules
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.train import steps as port_steps
from repro_torch.train.state import TrainState

ARCHS = ["exanode-100m", "llama3.2-3b"]
LOSS_TOL, GRAD_TOL, OPT_TOL = 1e-4, 1e-3, 1e-6


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.core.topology
    import repro.data.pipeline
    import repro.models.common
    import repro.models.registry
    import repro.models.sharding
    import repro.optim.adamw
    import repro.optim.schedules
    import repro.train.state
    import repro.train.steps
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "topology": repro.core.topology, "data": repro.data.pipeline,
            "common": repro.models.common, "registry": repro.models.registry,
            "sharding": repro.models.sharding, "adamw": repro.optim.adamw,
            "schedules": repro.optim.schedules, "state": repro.train.state,
            "steps": repro.train.steps}


def _cfgs(ref, arch):
    jnp = ref["jnp"]
    return (ref["configs"].get_smoke_config(arch).scaled(dtype=jnp.float32),
            port_smoke(arch).scaled(dtype=torch.float32))


def _ref_params(ref, rcfg, seed=0):
    specs = ref["registry"].model_specs(rcfg)
    return ref["common"].init_params(specs, ref["jax"].random.PRNGKey(seed))


def _np_tree(ref, tree):
    return ref["jax"].tree.map(np.asarray, tree)


def _batch(vocab, B=2, S=24, seed=3):
    """Seeded tokens and labels, with a few labels ignored (-1)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "labels": labels}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _ref_loss_and_grads(ref, rcfg, params, batch, ce_chunk):
    jax, jnp = ref["jax"], ref["jnp"]
    rules = {"ce_chunk": ce_chunk} if ce_chunk else {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with ref["sharding"].activation_sharding(rules):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: ref["registry"].model_loss(p, jb, rcfg),
            has_aux=True)(params)
    return loss, metrics, grads


def _port_loss_and_grads(pcfg, params, batch, ce_chunk):
    loss, metrics, grads = port_steps.value_and_grad(
        params, _port_batch(batch), pcfg, ce_chunk=ce_chunk)
    return loss, metrics, grads


# -- model loss and grads -----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_loss_and_grads_match_reference(ref, arch, ce_chunk):
    """lm_loss and every grad leaf against the reference's
    value_and_grad(model_loss), on the full-logits branch and on the
    chunked lm_head + CE branch (24 tokens in chunks of 8)."""
    rcfg, pcfg = _cfgs(ref, arch)
    rparams = _ref_params(ref, rcfg)
    batch = _batch(rcfg.vocab_size)
    loss_r, metrics_r, grads_r = _ref_loss_and_grads(ref, rcfg, rparams,
                                                     batch, ce_chunk)
    params = params_from_reference(_np_tree(ref, rparams), pcfg)
    loss, metrics, grads = _port_loss_and_grads(pcfg, params, batch,
                                                ce_chunk)
    _close(loss, loss_r, LOSS_TOL, "loss")
    _close(metrics["ce"], metrics_r["ce"], LOSS_TOL, "ce")
    assert float(metrics["moe_aux"]) == 0.0 == float(metrics_r["moe_aux"])
    flat_r = ref["jax"].tree_util.tree_flatten_with_path(grads_r)[0]
    got = tree_leaves(grads)
    assert len(got) == len(flat_r)
    for g, (path, want) in zip(got, flat_r):
        assert tuple(g.shape) == want.shape
        _close(g, want, GRAD_TOL, ref["jax"].tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS + ["xlstm-125m"])
def test_remat_policies_give_identical_numbers(ref, arch):
    """none / minimal / full change what is saved, never the numbers (on
    xlstm-125m also through the mLSTM backward and the sLSTM's own
    chunked remat)."""
    rcfg, pcfg = _cfgs(ref, arch)
    params = params_from_reference(_np_tree(ref, _ref_params(ref, rcfg)),
                                   pcfg)
    batch = _batch(rcfg.vocab_size)
    outs = {pol: _port_loss_and_grads(pcfg.scaled(remat_policy=pol), params,
                                      batch, 0)
            for pol in ("none", "minimal", "full")}
    loss0, _, grads0 = outs["none"]
    for pol, (loss, _, grads) in outs.items():
        assert torch.equal(loss, loss0), pol
        for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
            assert torch.equal(a, b), pol


# -- optimizer, schedules, data ---------------------------------------------


@pytest.mark.parametrize("param_dtype,grad_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(ref, param_dtype, grad_dtype):
    """From the same carried-across state (two reference steps in, so the
    moments and count are not trivial), one more update with the same
    grads gives the reference's params, moments, master and grad norm.

    f32 grads (the f32 model, and the microbatch accumulator's dtype with
    bf16 params) are held to 1e-6.  bf16 grads are scaled by the clip
    factor and by (1 - b1) in bf16, where one rounding step of a grad is
    ~4e-3 of it, and the two frameworks' f32 norms differ in the last
    bits: the reference's own jit and eager updates then differ by one
    bf16 step on ~0.4 % of the params.  So with bf16 grads the f32 state
    is held to 1e-5 and the bf16 params to 1e-5 plus one bf16 step (rtol
    2**-7)."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg, pcfg = _cfgs(ref, "exanode-100m")
    rparams = jax.tree.map(lambda p: p.astype(getattr(jnp, param_dtype)),
                           _ref_params(ref, rcfg))
    ropt = ref["adamw"].adamw_init(rparams)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape) * 0.3, getattr(jnp, grad_dtype)),
        rparams) for _ in range(3)]
    rcfg_opt = ref["adamw"].AdamWConfig()
    for g in grads[:2]:
        rparams, ropt, _ = ref["adamw"].adamw_update(g, ropt, rparams, 1e-3,
                                                     cfg=rcfg_opt)
    tdt = getattr(torch, param_dtype)
    params = params_from_reference(_np_tree(ref, rparams), pcfg)
    opt = opt_state_from_reference(_np_tree(ref, ropt), pcfg)
    assert opt.count == 2 and all(p.dtype == tdt for p in tree_leaves(params))
    assert (opt.master == ()) == (param_dtype == "float32")
    pgrads = params_from_reference(_np_tree(ref, grads[2]), pcfg)
    rparams, ropt, rm = ref["adamw"].adamw_update(grads[2], ropt, rparams,
                                                  1e-3, cfg=rcfg_opt)
    params, opt, m = port_adamw.adamw_update(pgrads, opt, params, 1e-3)
    assert opt.count == int(ropt.count) == 3
    exact = grad_dtype == "float32"
    state_tol = OPT_TOL if exact else 1e-5
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=OPT_TOL if exact else 1e-5)
    trees = [("mu", opt.mu, ropt.mu), ("nu", opt.nu, ropt.nu)]
    if param_dtype == "bfloat16":
        trees.append(("master", opt.master, ropt.master))
    for name, got, want in trees:
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32
            _close(a, np.asarray(b, np.float32), state_tol, name)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(rparams)):
        assert a.dtype == tdt
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b, np.float32), atol=state_tol,
            rtol=OPT_TOL if exact else 2 ** -7, err_msg="params")
    if param_dtype == "bfloat16":
        for p, f in zip(tree_leaves(params), tree_leaves(opt.master)):
            assert torch.equal(p, f.to(torch.bfloat16))


def test_schedules_match_reference(ref):
    rs, ps = ref["schedules"], port_schedules
    jnp = ref["jnp"]
    for kind in ("cosine", "linear", "constant"):
        r = rs.make_schedule(kind, peak=3e-4, warmup=5, total=40)
        p = ps.make_schedule(kind, peak=3e-4, warmup=5, total=40)
        for step in range(0, 45, 3):
            want = float(r(jnp.asarray(step, jnp.int32)))
            assert isinstance(p(step), float)
            assert abs(p(step) - want) <= OPT_TOL * 3e-4, (kind, step)
    with pytest.raises(ValueError, match="unknown schedule"):
        ps.make_schedule("step")


@pytest.mark.parametrize("vocab,seq,batch,step,hosts", [
    (256, 64, 8, 0, 1), (32000, 512, 8, 7, 1), (1000, 33, 6, 3, 3)])
def test_synthetic_batch_equals_reference_bitwise(ref, vocab, seq, batch,
                                                  step, hosts):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch)
    for host in range(hosts):
        want = ref["data"].synthetic_batch(ref["data"].DataConfig(**kw), step,
                                           host_id=host, num_hosts=hosts)
        got = port_data.synthetic_batch(port_data.DataConfig(**kw), step,
                                        host_id=host, num_hosts=hosts)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    it = port_data.make_batch_iterator(port_data.DataConfig(**kw),
                                       start_step=step)
    assert np.array_equal(next(it)["tokens"], port_data.synthetic_batch(
        port_data.DataConfig(**kw), step)["tokens"])
    dev = port_data.to_device(got, "cpu")
    assert dev["tokens"].dtype == torch.int32


# -- the train step -----------------------------------------------------------


def _ref_state(ref, rcfg, plan):
    specs = ref["registry"].model_specs(rcfg)
    return ref["state"].init_train_state(specs, ref["jax"].random.PRNGKey(0),
                                         plan)


def test_train_trajectory_matches_reference(ref):
    """Ten cosine-scheduled steps on the exanode-100m smoke config from the
    reference's initial state: the loss of every step within 1e-4, and the
    final params within the grad tolerance."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg, pcfg = _cfgs(ref, "exanode-100m")
    plan = ref["topology"].make_plan(rcfg, {})
    specs = ref["registry"].model_specs(rcfg)
    kw = dict(peak=3e-3, warmup=2, total=10)
    rstep = jax.jit(ref["steps"].make_train_step(
        rcfg, plan, specs, None,
        schedule=ref["schedules"].make_schedule("cosine", **kw)))
    pstep = port_steps.make_train_step(
        pcfg, schedule=port_schedules.make_schedule("cosine", **kw))
    rstate = _ref_state(ref, rcfg, plan)
    state = TrainState(params_from_reference(_np_tree(ref, rstate.params),
                                             pcfg),
                       opt_state_from_reference(_np_tree(ref, rstate.opt),
                                                pcfg))
    dkw = dict(vocab_size=rcfg.vocab_size, seq_len=64, global_batch=8,
               branch=4)
    for i in range(10):
        batch = port_data.synthetic_batch(port_data.DataConfig(**dkw), i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = pstep(state, port_data.to_device(batch, "cpu"))
        _close(m["loss"], rm["loss"], LOSS_TOL, f"loss at step {i}")
        _close(m["lr"], rm["lr"], OPT_TOL, f"lr at step {i}")
    assert state.opt.count == 10
    for a, b in zip(tree_leaves(state.params), jax.tree.leaves(rstate.params)):
        _close(a, b, GRAD_TOL, "params after 10 steps")


def test_microbatches_equal_one_batch():
    """k = 4 microbatches accumulate k = 1's grads and loss in f32 (the
    reference's test_microbatch_grad_accumulation_equivalence, on the
    port): a missing 1/k, a dropped block or a wrong row split would be
    off by far more than the f32 summation order's 1e-6."""
    cfg = port_smoke("llama3.2-3b").scaled(dtype=torch.float32)
    rt = PortRuntime.create(cfg, shape_kind="train", seq_len=32,
                            device="cpu")
    dcfg = port_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=8)
    batch = port_data.to_device(port_data.synthetic_batch(dcfg, 0), "cpu")
    assert bool((batch["labels"] >= 0).all())     # equal counts per block
    outs = {k: port_steps._grads_and_loss(rt.params, batch, cfg, k)
            for k in (1, 4)}
    _close(outs[4][1], outs[1][1], 1e-6, "loss")
    for a, b in zip(tree_leaves(outs[4][0]), tree_leaves(outs[1][0])):
        assert a.dtype == torch.float32
        _close(a, b, 1e-6, "grads")
    state, m = rt.make_train_step(microbatches=4)(rt.init_train_state(),
                                                  batch)
    assert state.opt.count == 1
    _close(m["loss"], outs[1][1], 1e-6, "step loss")


def test_runtime_train_surface_on_cpu(capsys):
    """create(shape_kind="train") -> init_train_state -> train_step, the
    describe line, the loss, the ce_chunk decision, and the launcher."""
    rt = PortRuntime.create("exanode-100m", smoke=True, shape_kind="train",
                            seq_len=24, device="cpu")
    assert rt.ce_chunk == 0 and rt.capacity == 24
    assert "train     : seq_len=24 ce_chunk=0 remat=minimal" in rt.describe()
    state = rt.init_train_state()
    batch = _port_batch(_batch(rt.cfg.vocab_size))
    loss0, _ = rt.loss(batch, params=state.params)
    state, m = rt.train_step(state, batch)
    assert state.opt.count == 1 and float(m["loss"]) == float(loss0)
    assert float(m["lr"]) == pytest.approx(3e-4)
    long = PortRuntime.create("exanode-100m", smoke=True, shape_kind="train",
                              seq_len=1024, device="cpu")
    assert long.ce_chunk == 512
    _, hist = port_launch.train_loop(port_smoke("exanode-100m"), steps=3,
                                     global_batch=2, seq_len=16,
                                     device="cpu", log_every=1)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in hist)
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "gnorm=" in out and "step_ms=" in out


def test_train_entry_points_default_to_the_card():
    """Without device="cpu" the train path asks for CUDA (and raises where
    there is none)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PortRuntime.create("exanode-100m", shape_kind="train", seq_len=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.main(["--smoke", "--steps", "1"])


def test_train_errors():
    cfg = port_smoke("exanode-100m")
    with pytest.raises(ValueError, match="pod axis"):
        PortRuntime.create(cfg, shape_kind="train", device="cpu",
                           grad_sync="hierarchical_int8")
    with pytest.raises(ValueError, match="unknown grad_sync"):
        PortRuntime.create(cfg, shape_kind="train", device="cpu",
                           grad_sync="ring")
    for sync in ("flat", "hierarchical"):
        PortRuntime.create(cfg, shape_kind="train", device="cpu",
                           grad_sync=sync)
    with pytest.raises(ValueError, match="unknown shape_kind"):
        PortRuntime.create(cfg, shape_kind="pretrain", device="cpu")
    rt = PortRuntime.create(cfg.scaled(remat_policy="everything"),
                            shape_kind="train", seq_len=8, device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        rt.train_step(rt.init_train_state(), _port_batch(_batch(256, S=8)))
    step = port_steps.make_train_step(cfg, microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(PortRuntime.create(cfg, device="cpu").init_train_state(),
             _port_batch(_batch(256, B=4, S=8)))
    assert port_registry.capabilities(cfg).supports_flash_train
