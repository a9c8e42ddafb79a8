"""The dense family in the port (qwen3-4b, gemma-2b, granite-20b) against
the JAX reference, on the CPU.

The three configs' smoke versions and two narrow variants that reach the
shapes this family brings to the kernels (a gemma-like one at head dim
256 and a granite-like one at 48 q heads a kv head) run through both
packages in f32 from the same parameters (the reference's
``init_params(specs, PRNGKey(0))`` carried over by ``repro_torch.bridge``)
and the same numpy-seeded inputs; the port runs the plain PyTorch
versions of its kernels here.  Tolerances are the reference's own
(tests/test_train_fastpath.py, tests/test_partition.py): logits 1e-3,
loss and grads 1e-4 (atol + rtol), kernels 2e-5 (decode) / 1e-5 (paged)
in f32; token streams equal, or diverging only at a near-tie (the
ROADMAP's rule: a top-2 logit margin of at most twice the logits
tolerance).  The reference's Pallas decode kernels run in interpret mode
at G 48, as its own tests run them.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ref as port_ref
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm
from repro_torch.models import mlp as port_mlp
from repro_torch.models import registry as port_registry
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import Runtime as PortRuntime
from repro_torch.serve import blockpool as pbp
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.train import steps as port_steps

DENSE = ("qwen3-4b", "gemma-2b", "granite-20b")
# name -> (registered arch, overrides of its smoke config)
VARIANTS = {
    "qwen3-4b": ("qwen3-4b", {}),
    "gemma-2b": ("gemma-2b", {}),
    "granite-20b": ("granite-20b", {}),
    # gemma-like at gemma-2b's head dim, 256 (2 / 1 heads)
    "gemma-d256": ("gemma-2b", dict(d_model=512, num_heads=2,
                                    num_kv_heads=1, head_dim=256,
                                    d_ff=256)),
    # granite-like at granite-20b's 48 q heads a kv head
    "granite-g48": ("granite-20b", dict(num_heads=48, num_kv_heads=1,
                                        head_dim=16)),
}
LOGITS_TOL, TRAIN_TOL = 1e-3, 1e-4
DECODE_TOL, PAGED_TOL = 2e-5, 1e-5
FLIP_MARGIN = 2 * LOGITS_TOL
NO_STRAGGLER = dict(warn_ratio=1e9, remesh_ratio=1e9, abort_ratio=1e9)


@pytest.fixture(scope="module")
def ref():
    """The reference modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    # the reference runs on the CPU in full f32, also where JAX could reach
    # a GPU (whose default f32 matmuls use TF32)
    jax.config.update("jax_platforms", "cpu")
    import repro.configs
    import repro.kernels.decode_attention
    import repro.kernels.flash_attention
    import repro.kernels.paged_attention
    import repro.models.common
    import repro.models.layers
    import repro.models.lm
    import repro.models.mlp
    import repro.models.registry
    import repro.models.sharding
    import repro.runtime
    import repro.serve.blockpool
    import repro.serve.engine
    return {"jax": jax, "jnp": jax.numpy, "configs": repro.configs,
            "decode": repro.kernels.decode_attention,
            "flash": repro.kernels.flash_attention,
            "paged": repro.kernels.paged_attention,
            "common": repro.models.common, "layers": repro.models.layers,
            "lm": repro.models.lm, "mlp": repro.models.mlp,
            "registry": repro.models.registry,
            "sharding": repro.models.sharding, "runtime": repro.runtime,
            "blockpool": repro.serve.blockpool, "engine": repro.serve.engine}


def _cfgs(ref, name, dtype="float32"):
    """(reference config, port config) of a variant in ``dtype``."""
    arch, kw = VARIANTS[name]
    rcfg = ref["configs"].get_smoke_config(arch).scaled(
        dtype=getattr(ref["jnp"], dtype), **kw)
    pcfg = port_smoke(arch).scaled(dtype=getattr(torch, dtype), **kw)
    return rcfg, pcfg


def _pair(ref, name, capacity=32, **kv):
    """(reference Runtime, port Runtime) of a variant in f32, the
    reference's seeded params on both sides."""
    rcfg, pcfg = _cfgs(ref, name)
    rrt = ref["runtime"].Runtime.create(rcfg, shape_kind="decode",
                                        capacity=capacity, **kv)
    tree = ref["jax"].tree.map(np.asarray, rrt.params)
    prt = PortRuntime.create(pcfg, capacity=capacity, device="cpu",
                             params=params_from_reference(tree, pcfg), **kv)
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


# -- configs, registry and routes --------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_the_reference(ref, arch):
    """The published and smoke configs carry the reference's values, field
    for field (dtypes aside)."""
    for get, want in ((port_config, ref["configs"].get_config),
                      (port_smoke, ref["configs"].get_smoke_config)):
        got, w = get(arch), want(arch)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "rope_theta", "qk_norm", "mlp_act", "tie_embeddings",
                  "scale_embeddings", "sliding_window", "norm_eps",
                  "attn_logit_softcap", "logit_softcap", "padded_vocab"):
            assert getattr(got, f) == getattr(w, f), (arch, f)
        assert [(g.pattern, g.repeats) for g in got.groups] == \
            [(g.pattern, g.repeats) for g in w.groups]


def test_routes_of_the_dense_family():
    """qwen3-4b's FFN runs #2 and its attention the tensor cores; gemma-2b
    and granite-20b keep GeGLU in plain PyTorch; gemma's head dim 256
    runs the SIMT flash kernels both ways; granite's G 48 decodes in six
    head groups of 8; all three train through the flash kernels."""
    want = {"qwen3-4b": (True, "tc", "tc", 4, 1),
            "gemma-2b": (False, "simt", "simt", 8, 1),
            "granite-20b": (False, "tc", "tc", 48, 6)}
    for arch, (fused, fwd, bwd, G, groups) in want.items():
        cfg = port_config(arch)
        caps = port_registry.capabilities(cfg)
        assert caps.supports_fused_ffn is fused
        assert caps.supports_flash_train
        assert fa_kernel.route(torch.bfloat16, cfg.head_dim) == fwd
        assert fa_kernel.route_bwd(torch.bfloat16, cfg.head_dim) == bwd
        assert cfg.num_heads // cfg.num_kv_heads == G
        assert da_kernel.head_groups(G) == groups
    assert port_config("granite-20b").head_dim == 128      # 6144 / 48
    from repro_torch.configs.granite_20b import cut
    assert cut().num_layers == 8 and cut().d_model == 6144


@pytest.mark.parametrize("arch", DENSE)
def test_runtime_serves_and_trains_on_cpu(arch):
    """``Runtime.create`` serves each config over dense, paged and int8 KV,
    monolithic and through the chunked-prefill scheduler, and trains it,
    all with ``device="cpu"``; ``describe()`` names the routes."""
    cfg = port_smoke(arch)
    prompts = [_tokens(cfg, n, seed=20 + n) for n in (3, 9, 17, 6)]
    for kv in ({}, dict(kv_layout="paged"),
               dict(kv_layout="paged", kv_dtype="int8")):
        for sched in (False, True):
            rt = PortRuntime.create(arch, smoke=True, device="cpu",
                                    capacity=32, scheduler=sched,
                                    sched_kw=dict(token_budget=8,
                                                  chunk_size=8)
                                    if sched else None, **kv)
            eng = rt.engine(num_slots=2, **(dict(block_size=8) if kv
                                             else {}))
            for i, p in enumerate(prompts):
                eng.submit(PortRequest(rid=i, prompt=p, max_new_tokens=5))
            stats = eng.run_to_completion()
            assert stats.finished == len(prompts), (kv, sched)
            assert all(len(r.generated) == 5 for r in eng.finished)
            if kv:
                assert eng.pool.used_blocks == 0
            if sched:
                assert stats.prefill_calls == 0 and stats.chunk_ticks > 0
    text = rt.describe()
    assert "routes    : ffn=" in text
    assert ("fused_ffn (#2" in text) == (cfg.mlp_act == "silu")
    rt = PortRuntime.create(arch, smoke=True, device="cpu",
                            shape_kind="train", seq_len=16)
    state = rt.init_train_state()
    batch = {"tokens": torch.from_numpy(_tokens(cfg, (2, 16), seed=1)),
             "labels": torch.from_numpy(_tokens(cfg, (2, 16), seed=2))}
    state, metrics = rt.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


# -- the modules this family adds --------------------------------------------


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches_reference(ref, name):
    x = _rand((4, 33), 3, 4.0)
    got = port_layers.act_fn(name)(torch.from_numpy(x))
    want = ref["layers"].act_fn(name)(ref["jnp"].asarray(x))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_geglu_mlp_matches_reference(ref, dtype, tol):
    """The GeGLU path (``mlp_act="gelu"``, three plain products, the tanh
    gelu) against ``repro.models.mlp.mlp``, weights cast to the activation
    dtype before each product on both sides; bf16 at the reference's FFN
    bf16 tolerance."""
    jnp = ref["jnp"]
    rcfg, pcfg = _cfgs(ref, "granite-20b", dtype)
    D, F = pcfg.d_model, pcfg.d_ff
    w = {"wi_gate": _rand((D, F), 4, D ** -0.5),
         "wi_up": _rand((D, F), 5, D ** -0.5),
         "wo": _rand((F, D), 6, F ** -0.5)}
    x = _rand((2, 7, D), 7)
    want = ref["mlp"].mlp(jnp.asarray(x, rcfg.dtype),
                          {k: jnp.asarray(v) for k, v in w.items()}, rcfg)
    got = port_mlp.mlp(torch.from_numpy(x).to(pcfg.dtype),
                       {k: torch.from_numpy(v) for k, v in w.items()}, pcfg)
    assert got.dtype == pcfg.dtype and got.shape == x.shape
    _close(got.float(), np.asarray(want, np.float32), tol)


def test_scaled_embedding_rounds_its_multiplier_to_the_activation_dtype(ref):
    """gemma-2b's embedding scale in bf16: sqrt(2048) = 45.2548... taken in
    f32 and cast to bf16 (45.25) before the product, as the reference
    does; the port's rows equal the reference's bit for bit."""
    jnp = ref["jnp"]
    rcfg = ref["configs"].get_config("gemma-2b").scaled(vocab_size=256)
    pcfg = port_config("gemma-2b").scaled(vocab_size=256)
    assert pcfg.dtype == torch.bfloat16 and pcfg.scale_embeddings
    table = _rand((pcfg.padded_vocab, pcfg.d_model), 8)
    toks = _tokens(pcfg, (2, 5), seed=9)
    got = port_lm._embed({"embed": torch.from_numpy(table)},
                         torch.from_numpy(toks), pcfg)
    want = ref["lm"]._embed({"embed": jnp.asarray(table)},
                            jnp.asarray(toks), rcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    rows = torch.from_numpy(table[toks]).bfloat16()
    assert torch.equal(got, rows * torch.tensor(45.25, dtype=torch.bfloat16))
    assert not torch.equal(got, (rows.float() * 2048 ** 0.5).bfloat16())


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_backward_at_head_dim_256_matches_pallas_vjp(ref,
                                                                 causal):
    """``ref_attention_bwd`` at head dim 256, 8 q heads on 1 kv head (as
    gemma-2b), against ``jax.vjp`` through the reference's Pallas flash
    kernel in interpret mode (K/V repeated over the group, as the
    reference's model does), at a small S that is no multiple of the
    kernels' tiles."""
    jax, jnp = ref["jax"], ref["jnp"]
    B, H, S, D = 1, 8, 40, 256
    q, do = _rand((B, H, S, D), 10), _rand((B, H, S, D), 11)
    k, v = _rand((B, 1, S, D), 12), _rand((B, 1, S, D), 13)

    def fwd(q, k, v):
        return ref["flash"].flash_attention(
            q, jnp.repeat(k, H, axis=1), jnp.repeat(v, H, axis=1),
            causal=causal, interpret=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = port_ref.ref_attention(tq, tk, tv, causal=causal)
    got = port_ref.ref_attention_bwd(tq, tk, tv, out, lse, tdo,
                                     causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("G", [16, 48])
def test_plain_decode_at_wide_groups_matches_pallas(ref, G):
    """The plain decode versions at G 16 and 48 q heads a kv head (#3 over
    a dense cache, #8 over f32 pools, #9 over int8 pools with per-block
    scales) against the reference's Pallas decode kernels in interpret
    mode, which take any G."""
    jnp = ref["jnp"]
    B, T, KV, D, bs = 2, 64, 1, 16, 8
    H = KV * G
    q = _rand((B, H, D), 14)
    k, v = _rand((B, T, KV, D), 15), _rand((B, T, KV, D), 16)
    pos = np.array([T // 3, T - 1], np.int32)
    t = np.arange(T, dtype=np.int32)
    kv_pos = np.where(t[None] <= pos[:, None], t[None], -1).astype(np.int32)
    args = (q, k, v, kv_pos, pos)
    want = ref["decode"].decode_attention(*(jnp.asarray(a) for a in args),
                                          bk=16, interpret=True)
    got = port_ref.ref_decode_attention(*(torch.from_numpy(a)
                                          for a in args))
    _close(got, want, DECODE_TOL, "dense")
    # the same entries in pool blocks, in reversed block order
    M = T // bs
    N = B * M + 2
    table = np.stack([np.arange(2 + b * M, 2 + (b + 1) * M)[::-1]
                      for b in range(B)]).astype(np.int32)
    kp, vp = (np.zeros((N, bs, KV, D), np.float32) for _ in range(2))
    pos_pool = np.full((N, bs), -1, np.int32)
    for b in range(B):
        for j in range(M):
            kp[table[b, j]] = k[b, j * bs:(j + 1) * bs]
            vp[table[b, j]] = v[b, j * bs:(j + 1) * bs]
            pos_pool[table[b, j]] = kv_pos[b, j * bs:(j + 1) * bs]
    pargs = (q, kp, vp, pos_pool, table, pos)
    want = ref["paged"].paged_decode_attention(
        *(jnp.asarray(a) for a in pargs), interpret=True)
    got = port_ref.ref_paged_decode_attention(*(torch.from_numpy(a)
                                                for a in pargs))
    _close(got, want, PAGED_TOL, "paged")
    rng = np.random.default_rng(17)
    kq, vq = (rng.integers(-127, 128, (N, bs, KV, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.05, (N, KV)).astype(np.float32)
              for _ in range(2))
    qargs = (q, kq, vq, ks, vs, pos_pool, table, pos)
    want = ref["paged"].paged_decode_attention_q8(
        *(jnp.asarray(a) for a in qargs), interpret=True)
    got = port_ref.ref_paged_decode_attention_q8(*(torch.from_numpy(a)
                                                   for a in qargs))
    _close(got, want, PAGED_TOL, "int8 paged")


# -- the models against the reference ----------------------------------------


@pytest.mark.parametrize("name", VARIANTS)
def test_bridge_carries_the_reference_params(ref, name):
    rrt, prt = _pair(ref, name)
    leaves = tree_leaves(prt.params)
    want = ref["jax"].tree.leaves(rrt.params)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert tuple(a.shape) == b.shape


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_logits_match_reference(ref, name):
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
    """One train step's loss and every grad leaf against the reference's
    ``value_and_grad(model_loss)`` from the same params and batch."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg, pcfg = _cfgs(ref, name)
    rparams = ref["common"].init_params(ref["registry"].model_specs(rcfg),
                                        jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, rcfg.vocab_size, (2, 24), dtype=np.int32)
    labels[:, -3:] = -1
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (2, 24),
                                    dtype=np.int32), "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with ref["sharding"].activation_sharding({}):
        (loss_r, _), grads_r = jax.value_and_grad(
            lambda p: ref["registry"].model_loss(p, jb, rcfg),
            has_aux=True)(rparams)
    loss, _, grads = port_steps.value_and_grad(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    _close(float(loss), float(loss_r), TRAIN_TOL, "loss")
    got, want = tree_leaves(grads), jax.tree.leaves(grads_r)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TRAIN_TOL, f"grad leaf {i} {tuple(g.shape)}")


def _decode_sides(ref, rrt, prt, toks, layout, capacity=32, bs=4):
    """Prefill ``toks`` on both sides into ``layout``'s caches: (reference
    logits, caches, step), (port logits, caches, step); each step maps
    (next tokens, positions) to the next logits, caches in step."""
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
@pytest.mark.parametrize("name", VARIANTS)
def test_decode_ticks_match_reference(ref, name, layout):
    """A prefill, then four decode ticks over dense, paged and int8-paged
    KV (two prompts sharing two pool blocks), logits within 1e-3 of the
    reference's own decode at every tick."""
    rrt, prt = _pair(ref, name)
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


def _hold_to_reference_model(ref, rrt, prt, prompt, got, want, bs=8):
    """Where the port's stream leaves the reference engine's, hold it to
    the reference's model instead: teacher-force the port's tokens through
    both packages' own single-request paths (``_decode_sides``; the
    engine's pool layout) and require every port token from the first
    divergence on to be the reference model's greedy token there, or a
    near-tie (top-2 margin <= ``FLIP_MARGIN``) on the port's own path.
    The reference engine's stream is not the oracle past a divergence: it
    can itself leave its model's greedy path when the machine is loaded
    (ROADMAP section 3)."""
    j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    layout = ("dense" if prt.kv_layout == "dense" else
              "int8" if prt.kv_dtype == "int8" else "paged")
    V = prt.cfg.vocab_size
    r_logits, r_step, p_logits, p_step = _decode_sides(
        ref, rrt, prt, prompt[None], layout, capacity=prt.capacity, bs=bs)
    pos = np.array([len(prompt)], np.int32)
    for k in range(len(got)):
        if k >= j:
            r_top2 = np.sort(np.asarray(r_logits)[0, -1, :V])[-2:]
            r_tok = int(np.asarray(r_logits)[0, -1, :V].argmax())
            if got[k] != r_tok:
                top = torch.topk(p_logits[0, -1, :V], 2).values
                margin = float(top[0] - top[1])
                assert margin <= FLIP_MARGIN, (
                    f"token {k}: port {got[k]}, reference model {r_tok} "
                    f"(reference engine {want[k] if k < len(want) else None},"
                    f" first divergence at {j}); port logit margin "
                    f"{margin:.3g}, reference model margin "
                    f"{float(r_top2[1] - r_top2[0]):.3g}")
        if k == len(got) - 1:
            break
        nxt = np.array([[got[k]]], np.int32)
        r_logits = r_step(nxt, pos)
        p_logits = p_step(nxt, pos)
        pos = pos + 1


@pytest.mark.parametrize("name,kv", [
    ("qwen3-4b", {}), ("gemma-2b", {}), ("granite-20b", {}),
    ("gemma-d256", {}), ("granite-g48", {}),
    ("granite-g48", dict(kv_layout="paged", kv_dtype="int8"))])
def test_engine_streams_match_reference(ref, name, kv):
    """Mixed prompt lengths, more requests than slots and one request past
    the capacity: the port's engine emits the reference engine's greedy
    streams; where one diverges, every port token from there on is the
    reference model's own greedy token or a near-tie on the port's path
    (``_hold_to_reference_model``).  The straggler is off on both
    sides."""
    rrt, prt = _pair(ref, name, **kv)
    rng = np.random.default_rng(4)
    specs = [(int(rng.integers(2, 20)), int(rng.integers(1, 9)))
             for _ in range(6)] + [(28, 10)]       # 28 + 10 > capacity
    reqs = [(i, _tokens(prt.cfg, n, seed=100 + i), m)
            for i, (n, m) in enumerate(specs)]
    engine_kw = dict(block_size=8) if kv else {}

    def run(engine, request_cls):
        for i, p, m in reqs:
            engine.submit(request_cls(rid=i, prompt=p.copy(),
                                      max_new_tokens=m))
        engine.run_to_completion()
        return {r.rid: list(r.generated) for r in engine.finished}

    want = run(rrt.engine(num_slots=3, injector=None,
                          straggler_kw=NO_STRAGGLER, **engine_kw),
               ref["engine"].Request)
    port = prt.engine(num_slots=3, straggler_kw=NO_STRAGGLER, **engine_kw)
    got = run(port, PortRequest)
    assert port.stats.finished == len(reqs)
    for i, p, m in reqs:
        assert len(got[i]) == m
        if got[i] != want[i]:
            _hold_to_reference_model(ref, rrt, prt, p, got[i], want[i])
