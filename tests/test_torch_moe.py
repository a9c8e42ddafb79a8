"""The MoE family in the port (qwen3-moe-30b-a3b; mixtral-8x7b with its
sliding-window ring buffer) against the JAX reference, on the CPU.

The smoke configs of both archs, and mixtral's at a window of 8 (as the
reference's own tests scale it, tests/test_serve_fastpath.py:35), run
through both packages in f32 from the same parameters (the reference's
``init_params(specs, PRNGKey(0))`` carried over by ``repro_torch.bridge``)
and the same numpy-seeded inputs; the port runs the plain PyTorch
versions of its kernels here.  Tolerances are the reference's own
(tests/test_train_fastpath.py, tests/test_partition.py): logits 1e-3,
loss and grads 1e-4 (atol + rtol); caches 1e-5; the ring's positions,
the streams and the fixed-order combine exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import opt_state_from_reference, params_from_reference
from repro_torch.configs import ARCHS, get_arch_config
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.launch import train as port_launch
from repro_torch.models import moe as port_moe
from repro_torch.models import registry as port_registry
from repro_torch.models.common import MoEConfig, tree_leaves
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import blockpool as pbp
from repro_torch.serve import kvcache as port_kvcache
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.train import steps as port_steps
from repro_torch.train.state import TrainState

MOE = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
# name -> (registered arch, overrides of its smoke config)
VARIANTS = {
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "mixtral-8x7b": ("mixtral-8x7b", {}),
    # mixtral at the window the reference's ring-buffer tests use
    "mixtral-w8": ("mixtral-8x7b", dict(sliding_window=8)),
}
LOGITS_TOL, TRAIN_TOL, CACHE_TOL = 1e-3, 1e-4, 1e-5
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
           "int8": dict(kv_layout="paged", kv_dtype="int8")}


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.core.topology
    import repro.models.common
    import repro.models.moe
    import repro.models.registry
    import repro.models.sharding
    import repro.optim.adamw
    import repro.runtime
    import repro.serve.blockpool
    import repro.serve.engine
    import repro.train.state
    import repro.train.steps
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "topology": repro.core.topology, "common": repro.models.common,
            "moe": repro.models.moe, "registry": repro.models.registry,
            "sharding": repro.models.sharding, "adamw": repro.optim.adamw,
            "runtime": repro.runtime, "blockpool": repro.serve.blockpool,
            "engine": repro.serve.engine, "state": repro.train.state,
            "steps": repro.train.steps}


def _cfgs(ref, name, dtype="float32"):
    """(reference config, port config) of a variant in ``dtype``."""
    arch, kw = VARIANTS[name]
    rcfg = ref["configs"].get_smoke_config(arch).scaled(
        dtype=getattr(ref["jnp"], dtype), **kw)
    pcfg = port_smoke(arch).scaled(dtype=getattr(torch, dtype), **kw)
    return rcfg, pcfg


def _np(ref, tree):
    return ref["jax"].tree.map(np.asarray, tree)


def _pair(ref, name, capacity=32, **kv):
    """(reference Runtime, port Runtime) of a variant in f32, the
    reference's seeded params on both sides."""
    rcfg, pcfg = _cfgs(ref, name)
    rrt = ref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                        capacity=capacity, **kv)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(
                                 _np(ref, rrt.params), pcfg), **kv)
    return rrt, prt


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape, dtype=np.int32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _batch(vocab, B=2, S=24, seed=3):
    """Seeded tokens and labels, a few labels ignored (-1)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "labels": labels}


# -- configs, capabilities, the runtime surface ------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_configs_match_the_reference(ref, arch):
    """The published and smoke configs carry the reference's values field
    for field (dtypes aside), the MoE fields included; ``cut(n)`` keeps
    every width, head, expert, top-k, window and the vocab."""
    for get, want in ((port_config, ref["configs"].get_config),
                      (port_smoke, ref["configs"].get_smoke_config)):
        got, w = get(arch), want(arch)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "rope_theta", "qk_norm", "mlp_act", "tie_embeddings",
                  "scale_embeddings", "sliding_window", "norm_eps",
                  "subquadratic", "attn_logit_softcap", "logit_softcap",
                  "padded_vocab"):
            assert getattr(got, f) == getattr(w, f), (arch, f)
        for f in ("num_experts", "top_k", "d_ff_expert", "capacity_factor",
                  "aux_loss_weight"):
            assert getattr(got.moe, f) == getattr(w.moe, f), (arch, f)
        assert [(g.pattern, g.repeats) for g in got.groups] == \
            [(g.pattern, g.repeats) for g in w.groups]
    full, cut = port_config(arch), get_arch_config(arch, layers=3)
    assert cut.num_layers == 3 and cut.groups[0].repeats == 3
    for f in ("d_model", "num_heads", "num_kv_heads", "head_dim",
              "vocab_size", "sliding_window", "moe", "qk_norm"):
        assert getattr(cut, f) == getattr(full, f), f


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_capabilities_match_the_reference(ref, arch):
    """Every registered config's flags equal the reference's
    ``Capabilities``: the qwen3-moe stack pages and quantizes (every block
    ``startswith("attn")``), mixtral's window keeps the dense ring buffer.
    ``supports_flash_train`` is the port's kernel limit (head dims of the
    flash backward); it equals the reference's for every config with
    attention blocks (xlstm-125m has none)."""
    rcfg = ref["configs"].get_config(arch)
    want = ref["registry"].resolve(rcfg).capabilities(rcfg)
    got = port_registry.capabilities(port_config(arch))
    for f in ("swa", "subquadratic", "supports_fused_ffn",
              "supports_flash_decode", "supports_paged_decode",
              "supports_quantized_kv", "supports_chunked_prefill"):
        assert getattr(got, f) == getattr(want, f), f
    if port_registry.needs_flash_train(port_config(arch)):
        assert got.supports_flash_train == want.supports_flash_train
    else:
        assert port_config(arch).head_dim not in fa_kernel.BWD_HEAD_DIMS
    assert len(ARCHS) == 9


def test_runtime_accepts_and_refuses_as_the_reference(ref):
    """qwen3-moe: dense, paged, int8, the scheduler and training.
    mixtral: dense ring KV and training; its paged layout, int8 pool,
    scheduler and ``scrub_every`` raise the reference's ``ValueError``s;
    Jamba, whose MoE FFN trains as these do, trains too since the Mamba
    scan's backward (#12b)."""
    for kw in ({}, LAYOUTS["paged"], LAYOUTS["int8"], {"scheduler": True},
               {"shape_kind": "train"}):
        PortRuntime.create("qwen3-moe-30b-a3b", smoke=True, device="cpu",
                           **kw)
    PortRuntime.create("mixtral-8x7b", smoke=True, device="cpu",
                       shape_kind="train")
    for kw, msg in ((LAYOUTS["paged"], "paged KV"),
                    (LAYOUTS["int8"], "paged KV"),
                    ({"scheduler": True}, "chunked prefill")):
        with pytest.raises(ValueError, match=msg):
            ref["runtime"].Runtime.create("mixtral-8x7b", smoke=True, **kw)
        with pytest.raises(ValueError, match=msg):
            PortRuntime.create("mixtral-8x7b", smoke=True, device="cpu",
                               **kw)
    rrt = ref["runtime"].Runtime.create("mixtral-8x7b", smoke=True)
    prt = PortRuntime.create("mixtral-8x7b", smoke=True, device="cpu")
    for rt, kw in ((rrt, dict(injector=None)), (prt, {})):
        with pytest.raises(ValueError, match="sliding-window"):
            rt.engine(num_slots=2, scrub_every=1, **kw)
    jamba = PortRuntime.create("jamba-v0.1-52b", smoke=True, device="cpu",
                               shape_kind="train")
    assert "ssm_scan + ssm_scan_bwd" in jamba.describe()
    text = prt.describe()
    assert "window 16" in text and "torch.bmm experts" in text
    assert "fused_ffn" not in text.split("train")[0]


@pytest.mark.parametrize("arch", MOE)
def test_entry_points_serve_and_train_on_cpu(arch):
    """``Runtime.create`` serves each config (qwen3-moe over every layout,
    monolithic and scheduled; mixtral over its ring) and trains it, all
    with ``device="cpu"``; the launchers take ``--layers``."""
    cfg = port_smoke(arch)
    prompts = [_tokens(cfg, n, seed=20 + n) for n in (3, 9, 21, 6)]
    ways = [({}, False)]
    if arch == "qwen3-moe-30b-a3b":
        ways += [(kv, s) for kv in LAYOUTS.values() for s in (False, True)
                 if kv or s]
    for kv, sched in ways:
        rt = PortRuntime.create(arch, smoke=True, device="cpu", capacity=32,
                                scheduler=sched,
                                sched_kw=dict(token_budget=8, chunk_size=8)
                                if sched else None, **kv)
        eng = rt.engine(num_slots=2, **(dict(block_size=8) if kv else {}))
        for i, p in enumerate(prompts):
            eng.submit(PortRequest(rid=i, prompt=p, max_new_tokens=12))
        stats = eng.run_to_completion()
        assert stats.finished == len(prompts), (kv, sched)
        assert all(len(r.generated) == 12 for r in eng.finished)
        if kv:
            assert eng.pool.used_blocks == 0
        if sched:
            assert stats.prefill_calls == 0 and stats.chunk_ticks > 0
    _, hist = port_launch.train_loop(cfg, steps=2, global_batch=2,
                                     seq_len=16, device="cpu", log_every=1)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(ValueError, match="no depth cut"):
        get_arch_config("exanode-100m", layers=2)


# -- the MoE FFN: a fixed-order combine, gradients ---------------------------


def _route_case(ref, T, E, k, D, seed, dtype=torch.float32):
    """Seeded tokens routed top-``k`` of ``E`` experts through the
    reference's ``_route`` / ``_dispatch``, and expert outputs ``yg``:
    (port dispatch tensors, reference dispatch arrays, weights)."""
    jnp = ref["jnp"]
    cfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=16)
    x = _rand((T, D), seed)
    w = _rand((D, E), seed + 1)
    C = port_moe._capacity(T, cfg)
    weights, top_e, _ = port_moe._route(torch.from_numpy(x),
                                        torch.from_numpy(w), cfg)
    _, slot, ptok, keep, order = port_moe._dispatch(torch.from_numpy(x),
                                                    top_e, C, E)
    yg = torch.from_numpy(_rand((E * C, D), seed + 2)).to(dtype)
    return cfg, C, x, w, top_e, weights, (yg, slot, ptok, keep, order)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_sums_in_the_reference_order_at_top8(ref, dtype):
    """At top-8 a token's eight terms depend on their order ((a + b) + c
    is not (a + c) + b): the port's combine adds them left to right in
    the stable expert order, bit for bit the reference's ``.at[].add`` on
    the CPU, and the same when the router hands the pairs over in another
    order (each token's top-k columns permuted).  A reversed order gives
    other bits, so the order is what is pinned."""
    jnp = ref["jnp"]
    tdt = getattr(torch, dtype)
    T, E, k, D = 40, 32, 8, 24
    cfg, C, x, w, top_e, weights, args = _route_case(ref, T, E, k, D, 40,
                                                     tdt)
    yg, slot, ptok, keep, order = args
    got = port_moe._combine(yg, slot, ptok, keep, weights, order, T)
    want = ref["moe"]._combine(
        jnp.asarray(yg.float().numpy(), getattr(jnp, dtype)),
        jnp.asarray(slot.numpy()), jnp.asarray(ptok.numpy()),
        jnp.asarray(keep.numpy()), jnp.asarray(weights.numpy()),
        jnp.asarray(order.numpy()), T)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # the same routes, each token's k columns in another order
    perm = torch.from_numpy(np.stack([np.random.default_rng(t).permutation(k)
                                      for t in range(T)]))
    top_p, w_p = top_e.gather(1, perm), weights.gather(1, perm)
    _, slot2, ptok2, keep2, order2 = port_moe._dispatch(
        torch.from_numpy(x), top_p, C, E)
    assert not torch.equal(order2, order)
    again = port_moe._combine(yg, slot2, ptok2, keep2, w_p, order2, T)
    assert torch.equal(again, got)
    # the terms summed in the reverse order differ somewhere
    pair_w = weights.reshape(-1)[order]
    terms = torch.cat([yg, yg.new_zeros(1, D)])[slot] * \
        (pair_w * keep).to(tdt)[:, None]
    per = terms[torch.argsort(ptok, stable=True)].view(T, k, D)
    rev = yg.new_zeros(T, D)
    for r in reversed(range(k)):
        rev = rev + per[:, r]
    fwd = yg.new_zeros(T, D)
    for r in range(k):
        fwd = fwd + per[:, r]
    assert torch.equal(fwd, got) and not torch.equal(rev, got)


def test_combine_keeps_top2_bits():
    """At top-2 (Jamba's routing) the fixed order gives exactly what the
    scatter-add gave: 0 + a + b either way."""
    T, E, k, D = 33, 16, 2, 24
    cfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=16)
    x = torch.from_numpy(_rand((T, D), 50))
    weights, top_e, _ = port_moe._route(
        x, torch.from_numpy(_rand((D, E), 51)), cfg)
    C = port_moe._capacity(T, cfg)
    _, slot, ptok, keep, order = port_moe._dispatch(x, top_e, C, E)
    for dtype in (torch.float32, torch.bfloat16):
        yg = torch.from_numpy(_rand((E * C, D), 52)).to(dtype)
        got = port_moe._combine(yg, slot, ptok, keep, weights, order, T)
        pair_w = weights.reshape(-1)[order]
        contrib = torch.cat([yg, yg.new_zeros(1, D)])[slot] * \
            (pair_w * keep).to(dtype)[:, None]
        want = yg.new_zeros(T, D).index_add_(0, ptok, contrib)
        assert torch.equal(got, want), dtype


@pytest.mark.parametrize("skew", [False, True])
def test_moe_ffn_grads_match_reference(ref, skew):
    """Gradients of the MoE FFN at top-8 (qwen3-moe's routing) through the
    router's sorted top-k values, the dispatch's gather, the experts and
    the combine, against ``jax.grad`` of the reference's ``moe_ffn``;
    with ``skew`` the capacity drops pairs.  The loss is a fixed random
    projection of y plus the aux loss."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg = ref["configs"].get_smoke_config("qwen3-moe-30b-a3b").scaled(
        dtype=jnp.float32, moe=ref["common"].MoEConfig(
            num_experts=16, top_k=8, d_ff_expert=32))
    pcfg = port_smoke("qwen3-moe-30b-a3b").scaled(
        dtype=torch.float32, moe=MoEConfig(num_experts=16, top_k=8,
                                           d_ff_expert=32))
    rp = {k: np.array(v) for k, v in ref["common"].init_params(
        ref["moe"].moe_specs(rcfg, rcfg.moe), jax.random.PRNGKey(7)).items()}
    x = _rand((2, 12, rcfg.d_model), 8)
    if skew:
        x += 1.0
        rp["router"][:, :4] += 0.5
    proj = _rand((2, 12, rcfg.d_model), 9)

    def ref_loss(p, x):
        y, aux = ref["moe"].moe_ffn(x, p, rcfg, rcfg.moe)
        return jnp.sum(y * jnp.asarray(proj)) + aux

    with ref["sharding"].activation_sharding({}):
        want_l, (want_gp, want_gx) = jax.value_and_grad(
            ref_loss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in
                                       rp.items()}, jnp.asarray(x))
    pp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in rp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = port_moe.moe_ffn(tx, pp, pcfg, pcfg.moe)
    loss = (y * torch.from_numpy(proj)).sum() + aux
    loss.backward()
    _close(float(loss.detach()), float(want_l), TRAIN_TOL, "loss")
    _close(tx.grad, want_gx, TRAIN_TOL, "dx")
    for name in rp:
        _close(pp[name].grad, want_gp[name], TRAIN_TOL, name)
    if skew:
        C = port_moe._capacity(24, pcfg.moe)
        _, e, _ = port_moe._route(torch.from_numpy(x.reshape(24, -1)),
                                  pp["router"].detach(), pcfg.moe)
        assert int(torch.bincount(e.reshape(-1)).max()) > C    # drops


# -- the models against the reference ----------------------------------------


def test_bridge_carries_the_moe_params_and_adamw_state(ref):
    """qwen3-moe's ``attn_moe`` leaves (router f32, experts stacked by
    layer) and an AdamW state with bf16 params (moments and the f32
    master) go across leaf by leaf."""
    jax = ref["jax"]
    rrt, prt = _pair(ref, "qwen3-moe-30b-a3b")
    ffn = prt.params["groups"][0]["sub0"]["ffn"]
    assert tuple(ffn["router"].shape) == (2, 64, 8)
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["wi_gate"].shape) == (2, 8, 64, 64)
    assert tuple(ffn["wo"].shape) == (2, 8, 64, 64)
    assert prt.num_params == ref["common"].count_params(rrt.specs)
    rparams = jax.tree.map(lambda p: p.astype(ref["jnp"].bfloat16)
                           if p.dtype == ref["jnp"].float32 and p.ndim > 1
                           and p.shape[-1] != 8 else p, rrt.params)
    ropt = ref["adamw"].adamw_init(rparams)
    opt = opt_state_from_reference(_np(ref, ropt), prt.cfg)
    assert len(tree_leaves(opt.master)) == len(jax.tree.leaves(rparams))
    for a, b in zip(tree_leaves(opt.master), jax.tree.leaves(ropt.master)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_logits_match_reference(ref, name):
    """Logits at every position of a 24-token sequence (past both of
    mixtral's smoke windows: the window masks), within 1e-3."""
    rrt, prt = _pair(ref, name)
    toks = _tokens(prt.cfg, (2, 24), seed=1)
    want, _ = ref["registry"].model_forward(
        rrt.params, {"tokens": ref["jnp"].asarray(toks)}, rrt.cfg)
    got = port_registry.model_forward(prt.params, torch.from_numpy(toks),
                                      prt.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("name", VARIANTS)
def test_loss_and_grads_match_reference(ref, name):
    """The loss (its MoE aux included) and every grad leaf against the
    reference's ``value_and_grad(model_loss)``, within 1e-4."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg, pcfg = _cfgs(ref, name)
    rparams = ref["common"].init_params(ref["registry"].model_specs(rcfg),
                                        jax.random.PRNGKey(0))
    params = params_from_reference(_np(ref, rparams), pcfg)
    batch = _batch(rcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with ref["sharding"].activation_sharding({}):
        (loss_r, m_r), grads_r = jax.value_and_grad(
            lambda p: ref["registry"].model_loss(p, jb, rcfg),
            has_aux=True)(rparams)
    loss, m, grads = port_steps.value_and_grad(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    assert float(m["moe_aux"]) > 0
    _close(float(m["moe_aux"]), float(m_r["moe_aux"]), TRAIN_TOL, "aux")
    _close(float(loss), float(loss_r), TRAIN_TOL, "loss")
    got, want = tree_leaves(grads), jax.tree.leaves(grads_r)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TRAIN_TOL, f"grad leaf {i} {tuple(g.shape)}")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "mixtral-w8"])
def test_train_steps_match_reference(ref, name):
    """Three AdamW steps from the reference's initial state under its
    cosine schedule: each step's loss within 1e-4 and the updated params
    within the grad tolerance."""
    jax, jnp = ref["jax"], ref["jnp"]
    from repro.optim.schedules import make_schedule as ref_schedule
    from repro_torch.optim.schedules import make_schedule
    rcfg, pcfg = _cfgs(ref, name)
    plan = ref["topology"].make_plan(rcfg, {})
    specs = ref["registry"].model_specs(rcfg)
    kw = dict(peak=3e-3, warmup=1, total=3)
    rstep = jax.jit(ref["steps"].make_train_step(
        rcfg, plan, specs, None, schedule=ref_schedule("cosine", **kw)))
    pstep = port_steps.make_train_step(
        pcfg, schedule=make_schedule("cosine", **kw))
    rstate = ref["state"].init_train_state(specs, jax.random.PRNGKey(0),
                                           plan)
    state = TrainState(params_from_reference(_np(ref, rstate.params), pcfg),
                       opt_state_from_reference(_np(ref, rstate.opt), pcfg))
    for i in range(3):
        batch = _batch(rcfg.vocab_size, S=20, seed=60 + i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = pstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        _close(m["loss"], rm["loss"], TRAIN_TOL, f"loss at step {i}")
    assert state.opt.count == 3
    for a, b in zip(tree_leaves(state.params),
                    jax.tree.leaves(rstate.params)):
        _close(a, b, 1e-3, "params after 3 steps")


@pytest.mark.parametrize("S,capacity", [(21, 32), (11, 6), (8, 8),
                                        (19, 12)])
def test_pad_prefill_cache_rolls_the_ring_as_the_reference(ref, S,
                                                          capacity):
    """mixtral at window 8: a prefill of S tokens into a ring of T =
    min(8, capacity) entries.  Past the window the prefill keeps the last
    8 entries, then the last T, rolled right by ``p0 % T`` (p0 the first
    kept position, not a multiple of T at (21, 32), (11, 6) and (19, 12))
    so that each sits at slot ``pos % T``: every leaf (k, v, pos) of every
    layer equal to the reference's."""
    rrt, prt = _pair(ref, "mixtral-w8", capacity=capacity)
    toks = _tokens(prt.cfg, (2, S), seed=11)
    _, r_caches = ref["registry"].model_prefill(
        rrt.params, {"tokens": ref["jnp"].asarray(toks)}, rrt.cfg,
        capacity, last_only=True)
    _, p_caches = port_registry.model_prefill(
        prt.params, torch.from_numpy(toks), prt.cfg, capacity,
        last_only=True)
    T = port_kvcache.attn_cache_len(prt.cfg, capacity)
    for name in ("k", "v", "pos"):
        got, want = p_caches[0]["sub0"][name], r_caches[0]["sub0"][name]
        assert tuple(got.shape[:3]) == (2, 2, T) == want.shape[:3], name
        if name == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, CACHE_TOL, name)
    pos = p_caches[0]["sub0"]["pos"]
    live = pos >= 0
    assert torch.equal((pos % T)[live],
                       torch.arange(T).expand_as(pos)[live])
    if S > T:
        assert int(live.sum()) == 2 * 2 * T
        assert int(pos.max()) == S - 1 and int(pos[live].min()) == S - T


def test_decode_after_a_wrap_matches_reference(ref):
    """mixtral at window 8, capacity 12 (a ring of 8): a 13-token prefill
    (p0 5, rolled by 5), then ten decode ticks whose writes wrap the ring
    again: logits within 1e-3 at every tick and the ring's positions equal
    to the reference's."""
    rrt, prt = _pair(ref, "mixtral-w8", capacity=12)
    jnp = ref["jnp"]
    toks = _tokens(prt.cfg, (2, 13), seed=12)
    r_logits, r_caches = ref["registry"].model_prefill(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg, 12,
        last_only=True)
    p_logits, p_caches = port_registry.model_prefill(
        prt.params, torch.from_numpy(toks), prt.cfg, 12, last_only=True)
    pos = np.full(2, 13, np.int32)
    for tick in range(11):
        _close(p_logits, np.asarray(r_logits), LOGITS_TOL, f"tick {tick}")
        np.testing.assert_array_equal(
            p_caches[0]["sub0"]["pos"].numpy(),
            np.asarray(r_caches[0]["sub0"]["pos"]))
        if tick == 10:
            break
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        r_logits, r_caches = ref["registry"].model_decode_step(
            rrt.params, jnp.asarray(nxt), r_caches, rrt.cfg,
            pos=jnp.asarray(pos))
        p_logits = port_registry.model_decode_step(
            prt.params, torch.from_numpy(nxt), p_caches, prt.cfg,
            pos=torch.from_numpy(pos))
        pos = pos + 1
    # ten ticks wrote positions 13..22: the ring holds the last 8
    assert int(p_caches[0]["sub0"]["pos"].min()) == 22 - 8 + 1


def _decode_sides(ref, rrt, prt, toks, layout, capacity=32, bs=4):
    """Prefill ``toks`` on both sides into ``layout``'s caches: (reference
    logits, step, port logits, step); each step maps (next tokens,
    positions) to the next logits."""
    jnp = ref["jnp"]
    if layout == "dense":
        r_logits, r_caches = rrt.prefill({"tokens": jnp.asarray(toks)},
                                         last_only=True)
        p_logits, p_caches = prt.prefill(torch.from_numpy(toks),
                                         last_only=True)
        r_box = [r_caches]

        def r_step(nxt, pos):
            logits, r_box[0] = rrt.decode_step(jnp.asarray(nxt), r_box[0],
                                               jnp.asarray(pos))
            return logits

        def p_step(nxt, pos):
            return prt.decode_step(torch.from_numpy(nxt), p_caches,
                                   torch.from_numpy(pos))
        return r_logits, r_step, p_logits, p_step
    kv_dtype = "int8" if layout == "int8" else "f32"
    B, S = toks.shape
    M = -(-capacity // bs)
    pool = pbp.BlockPool(B * M + 2, bs, B, M, max_entries=capacity)
    dst = np.stack([pool.admit(b, p, -(-S // bs))
                    for b, p in enumerate(toks)])
    r_logits, r_part = ref["registry"].model_prefill(
        rrt.params, {"tokens": jnp.asarray(toks)}, rrt.cfg, capacity,
        last_only=True)
    p_logits, p_part = port_registry.model_prefill(
        prt.params, torch.from_numpy(toks), prt.cfg, capacity,
        last_only=True)
    rbp = ref["blockpool"]
    r_box = [rbp.paged_splice(
        rbp.init_paged_cache(rrt.cfg, pool.num_blocks, bs,
                             kv_dtype=kv_dtype), r_part, jnp.asarray(dst))]
    p_caches = pbp.paged_splice(
        pbp.init_paged_cache(prt.cfg, pool.num_blocks, bs, kv_dtype),
        p_part, torch.from_numpy(dst))
    plan = {}

    def r_step(nxt, pos):
        plan["bids"] = np.array([pool.write_plan(b, True)[0]
                                 for b in range(B)], np.int32)
        plan["table"] = pool.table.copy()
        logits, r_box[0] = ref["registry"].model_paged_decode_step(
            rrt.params, jnp.asarray(nxt), r_box[0], rrt.cfg,
            pos=jnp.asarray(pos), block_table=jnp.asarray(plan["table"]),
            write_bids=jnp.asarray(plan["bids"]))
        return logits

    def p_step(nxt, pos):            # the write plan r_step just made
        return port_registry.model_paged_decode_step(
            prt.params, torch.from_numpy(nxt), p_caches, prt.cfg,
            pos=torch.from_numpy(pos),
            block_table=torch.from_numpy(plan["table"]),
            write_bids=torch.from_numpy(plan["bids"]))
    return r_logits, r_step, p_logits, p_step


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_qwen3_moe_decode_ticks_match_reference(ref, layout):
    """qwen3-moe: a prefill, then four decode ticks over dense, paged and
    int8-paged KV (two prompts sharing two pool blocks), logits within
    1e-3 of the reference's own decode at every tick."""
    rrt, prt = _pair(ref, "qwen3-moe-30b-a3b")
    toks = _tokens(prt.cfg, (2, 11), seed=5)
    toks[1, :8] = toks[0, :8]
    r_logits, r_step, p_logits, p_step = _decode_sides(ref, rrt, prt, toks,
                                                       layout)
    pos = np.full(2, 11, np.int32)
    for tick in range(5):
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   atol=LOGITS_TOL, rtol=0,
                                   err_msg=f"{layout} tick {tick}")
        if tick == 4:
            break
        nxt = np.asarray(r_logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        r_logits = r_step(nxt, pos)
        p_logits = p_step(nxt, pos)
        pos = pos + 1


def test_qwen3_moe_chunked_prefill_matches_reference(ref):
    """``model_chunk_prefill`` of a 19-token prompt in chunks of 8 (the
    last padded) into a dense cache row: each chunk's last logits within
    1e-3 of the reference's, the cache's positions equal."""
    from repro_torch.models.attention import PAD_POS
    rrt, prt = _pair(ref, "qwen3-moe-30b-a3b")
    jnp = ref["jnp"]
    from repro.serve.kvcache import init_cache as ref_init_cache
    r_caches = ref_init_cache(rrt.cfg, 1, 32)
    p_caches = port_kvcache.init_cache(prt.cfg, 1, 32)
    prompt = _tokens(prt.cfg, 19, seed=13)
    for start in range(0, 19, 8):
        n = min(8, 19 - start)
        tok = np.zeros((1, 8), np.int32)
        tok[0, :n] = prompt[start:start + n]
        pos = np.full((1, 8), PAD_POS, np.int32)
        pos[0, :n] = np.arange(start, start + n)
        reset = np.array([start == 0])
        last = np.array([n - 1], np.int32)
        want, r_caches = ref["registry"].model_chunk_prefill(
            rrt.params, jnp.asarray(tok), r_caches, rrt.cfg,
            positions=jnp.asarray(pos), reset=jnp.asarray(reset),
            last_index=jnp.asarray(last))
        got = port_registry.model_chunk_prefill(
            prt.params, torch.from_numpy(tok), p_caches, prt.cfg,
            positions=torch.from_numpy(pos), reset=torch.from_numpy(reset),
            last_index=torch.from_numpy(last))
        _close(got, np.asarray(want), LOGITS_TOL, f"chunk at {start}")
    np.testing.assert_array_equal(p_caches[0]["sub0"]["pos"].numpy(),
                                  np.asarray(r_caches[0]["sub0"]["pos"]))


def _run_engine(engine, request_cls, reqs):
    for i, p, m in reqs:
        engine.submit(request_cls(rid=i, prompt=p.copy(), max_new_tokens=m))
    engine.run_to_completion()
    return {r.rid: list(r.generated) for r in engine.finished}


# runs of the reference engine a differing stream is held against
REF_ENGINE_TRIES = 3


def _assert_reference_engine_streams(ref, rrt, got, reqs, **ekw):
    """The port's streams ``got`` equal the reference engine's on the same
    requests.  Where they differ, the reference engine runs again (up to
    REF_ENGINE_TRIES runs in all) and one run must equal them: on a loaded
    machine the reference engine's stream can leave its own model's
    greedy path (ROADMAP section 3; its own
    ``test_quant_kv.py::test_quantized_engine_token_parity
    [qwen3-moe-30b-a3b]`` fails so), while the port's streams are the same
    in every run."""
    runs = []
    for _ in range(REF_ENGINE_TRIES):
        want = _run_engine(rrt.engine(num_slots=3, injector=None,
                                      straggler_kw=NO_STRAGGLER, **ekw),
                           ref["engine"].Request, reqs)
        if got == want:
            return
        runs.append({i: (g, want[i]) for i, g in got.items()
                     if g != want.get(i)})
    raise AssertionError(f"the port's streams differ from each of "
                         f"{REF_ENGINE_TRIES} reference engine runs; (port, "
                         f"reference) where they differ: {runs}")


@pytest.mark.parametrize("layout,sched", [
    ("dense", False), ("paged", False), ("int8", False), ("dense", True),
    ("paged", True), ("int8", True)])
def test_qwen3_moe_engine_streams_match_reference(ref, layout, sched):
    """Mixed prompt lengths, more requests than slots, one request past
    the capacity (dense) or near it: the port's engine, monolithic or
    scheduled, emits the reference engine's greedy streams under the same
    admission (MoE capacity is a function of each call's tokens, so each
    layout is held to the reference's same layout).  The straggler is off
    on both sides; a differing reference run is repeated
    (``_assert_reference_engine_streams``)."""
    sched_kw = dict(token_budget=8, chunk_size=8) if sched else None
    kv = dict(LAYOUTS[layout], scheduler=sched, sched_kw=sched_kw)
    rrt, prt = _pair(ref, "qwen3-moe-30b-a3b", **kv)
    rng = np.random.default_rng(4)
    specs = [(int(rng.integers(2, 20)), int(rng.integers(1, 9)))
             for _ in range(6)]
    specs.append((28, 10) if layout == "dense" else (20, 10))
    reqs = [(i, _tokens(prt.cfg, n, seed=100 + i), m)
            for i, (n, m) in enumerate(specs)]
    ekw = dict(block_size=8) if layout != "dense" else {}
    eng = prt.engine(num_slots=3, straggler_kw=NO_STRAGGLER, **ekw)
    got = _run_engine(eng, PortRequest, reqs)
    assert eng.stats.finished == len(reqs)
    assert (eng.stats.prefill_calls == 0) == sched
    if layout != "dense":
        assert eng.pool.used_blocks == 0
    _assert_reference_engine_streams(ref, rrt, got, reqs, **ekw)


def test_mixtral_engine_streams_past_the_window_match_reference(ref):
    """mixtral at window 8, capacity 32 (a ring of 8): prompts and
    generations past the window (exact-length admission buckets, the ring
    rolled at admission and wrapped by decode), more requests than slots:
    the port's engine emits the reference engine's streams."""
    rrt, prt = _pair(ref, "mixtral-w8")
    lens = [(5, 12), (13, 6), (21, 9), (3, 14), (9, 4), (13, 11)]
    reqs = [(i, _tokens(prt.cfg, n, seed=200 + i), m)
            for i, (n, m) in enumerate(lens)]
    eng = prt.engine(num_slots=3, straggler_kw=NO_STRAGGLER)
    got = _run_engine(eng, PortRequest, reqs)
    assert eng.stats.finished == len(reqs)
    assert {i: len(s) for i, s in got.items()} == {i: m for i, (_, m) in
                                                   enumerate(lens)}
    _assert_reference_engine_streams(ref, rrt, got, reqs)
    T = eng.caches[0]["sub0"]["pos"].shape[2]
    assert T == 8
