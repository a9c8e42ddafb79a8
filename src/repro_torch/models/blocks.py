"""Block assembly over stacked layer parameters (port of
``repro.models.blocks``: the ``attn``, ``attn_moe``, ``mamba``,
``mamba_nof``, ``mamba_moe``, ``mlstm`` and ``slstm`` kinds).

A group's parameters are stacked along a leading "layers" axis, as in the
reference, so a reference parameter tree carries over leaf for leaf.  The
reference's ``jax.lax.scan`` over that axis (``blocks.py:195``) becomes a
Python loop over layer views, each layer walking the group's pattern of
kinds in order (xlstm-125m: mlstm, mlstm, mlstm, slstm; jamba's period:
mamba, mamba_moe, mamba, mamba_moe, attn, mamba_moe, mamba, mamba_moe);
decode caches are stacked the same way and each layer's view is updated
in place (the K/V entry of an attention layer, the whole recurrent state
of a Mamba or xLSTM one).

Block kinds
  attn       RMSNorm, GQA attention; RMSNorm, SwiGLU FFN
  attn_moe   RMSNorm, GQA attention; RMSNorm, MoE FFN (its router loss is
             the block's aux loss)
  mamba      RMSNorm, Mamba mixer; RMSNorm, SwiGLU FFN
  mamba_nof  RMSNorm, Mamba mixer (no FFN)
  mamba_moe  RMSNorm, Mamba mixer; RMSNorm, MoE FFN (its router loss is
             the block's aux loss)
  mlstm      RMSNorm, mLSTM mixer (its FFN is built into the projections)
  slstm      RMSNorm, sLSTM mixer with its gated FFN

Remat (the reference's ``_remat_wrap``, ``blocks.py:159``) wraps each
layer of a differentiated forward in ``torch.utils.checkpoint``:
``"none"`` saves every activation, ``"full"`` recomputes the whole layer
in the backward pass, and ``"minimal"`` saves the outputs of the matrix
products and recomputes the rest, the counterpart of JAX's
``dots_with_no_batch_dims_saveable`` (the kernels' outputs are not
products and are recomputed, as the Pallas calls are).  Remat changes
memory and the number of forward kernel launches, never the numbers.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import ssm
from repro_torch.models.attention import (attention,
                                          attention_chunk_append,
                                          attention_chunk_append_paged,
                                          attention_decode,
                                          attention_decode_paged,
                                          attention_specs)
from repro_torch.models.common import (LayerGroup, ModelConfig, PSpec,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.moe import moe_ffn, moe_specs

ATTN_KINDS = ("attn", "attn_moe")
MAMBA_KINDS = ("mamba", "mamba_nof", "mamba_moe")
# the state leaves of a recurrent block's cache, in the order its mixer
# returns them
STATE_LEAVES = {"mlstm": ("C", "n", "m", "conv"),
                "slstm": ("c", "n", "m", "h"),
                **{k: ("h", "conv") for k in MAMBA_KINDS}}


def block_specs(kind: str, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    if kind in ATTN_KINDS:
        return {"norm1": rmsnorm_spec(D), "attn": attention_specs(cfg),
                "norm2": rmsnorm_spec(D),
                "ffn": (moe_specs(cfg, cfg.moe) if kind == "attn_moe"
                        else mlp_specs(cfg))}
    if kind in MAMBA_KINDS:
        s = {"norm1": rmsnorm_spec(D),
             "mixer": ssm.mamba_specs(cfg, cfg.ssm)}
        if kind != "mamba_nof":
            s["norm2"] = rmsnorm_spec(D)
            s["ffn"] = (moe_specs(cfg, cfg.moe) if kind == "mamba_moe"
                        else mlp_specs(cfg))
        return s
    if kind == "mlstm":
        return {"norm1": rmsnorm_spec(D),
                "mixer": ssm.mlstm_specs(cfg, cfg.xlstm)}
    if kind == "slstm":
        return {"norm1": rmsnorm_spec(D),
                "mixer": ssm.slstm_specs(cfg, cfg.xlstm)}
    raise NotImplementedError(f"block kind {kind!r} is not ported")


def stack_specs(specs, n: int):
    """Add a leading layers axis of length ``n`` to every PSpec leaf."""
    return tree_map(lambda p: PSpec((n,) + p.shape, p.init, p.dtype), specs)


def group_specs(group: LayerGroup, cfg: ModelConfig) -> dict:
    per_layer = {f"sub{j}": block_specs(kind, cfg)
                 for j, kind in enumerate(group.pattern)}
    return stack_specs(per_layer, group.repeats)


def layer(tree, i: int):
    """Layer ``i``'s view of a stacked parameter or cache tree."""
    return tree_map(lambda a: a[i], tree)


def _ffn(kind: str, x: torch.Tensor, p: dict, cfg: ModelConfig):
    """The residual FFN half of a block: (x + FFN(norm2(x)), aux): the
    MoE FFN of an ``attn_moe`` or ``mamba_moe`` block with its router
    loss, else the SwiGLU FFN (``mamba_nof``: none) with aux None."""
    if kind == "mamba_nof":
        return x, None
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if kind.endswith("_moe"):
        f, aux = moe_ffn(h2, p["ffn"], cfg, cfg.moe)
        return x + f, aux
    return x + mlp(h2, p["ffn"], cfg), None


def block_forward(kind: str, x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                  collect_cache: bool = False):
    """One block of ``kind`` over the standard positions 0..S-1.
    Returns (x, aux, cache or None): aux is the block's MoE router loss
    (f32 scalar; None without MoE); the cache is the grouped (k, v)
    [B,S,KV,Dh] of an attention block (``attn``, ``attn_moe``), or the
    final recurrent state of a
    Mamba (h, conv), ``mlstm`` (C, n, m, conv) or ``slstm`` (c, n, m, h)
    block.  Under a sliding window the attention cache keeps only the
    last ``window`` entries of a longer sequence (the reference's trim,
    ``blocks.py:100``): no later query attends past them."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    cache = None
    if kind in MAMBA_KINDS:
        if collect_cache:
            m, st = ssm.mamba(h, p["mixer"], cfg, cfg.ssm, return_state=True)
            cache = dict(zip(STATE_LEAVES[kind], st))
        else:
            m = ssm.mamba(h, p["mixer"], cfg, cfg.ssm)
        x, aux = _ffn(kind, x + m, p, cfg)
        return x, aux, cache
    if kind in STATE_LEAVES:
        mixer = ssm.mlstm if kind == "mlstm" else ssm.slstm
        m, st = mixer(h, p["mixer"], cfg, cfg.xlstm)
        if collect_cache:
            cache = dict(zip(STATE_LEAVES[kind], st))
        return x + m, None, cache
    if collect_cache:
        a, (k, v) = attention(h, p["attn"], cfg, return_kv=True)
        W = cfg.sliding_window
        if W is not None and k.shape[1] > W:
            k, v = k[:, -W:], v[:, -W:]
        cache = {"k": k, "v": v}
    else:
        a = attention(h, p["attn"], cfg)
    x, aux = _ffn(kind, x + a, p, cfg)
    return x, aux, cache


REMAT_POLICIES = ("none", "minimal", "full")
# the matrix products the "minimal" policy saves (aten ops under autograd)
_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default,
                        torch.ops.aten.baddbmm.default})


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, policy: str):
    """``fn`` under the remat ``policy`` (one of ``REMAT_POLICIES``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _save_products))


def unstack(tree, n: int) -> list:
    """The ``n`` layer views of a stacked tree, taken with one ``unbind``
    per leaf (so the backward stacks each leaf's layer grads once)."""
    parts = [a.unbind(0) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(n)]


def run_groups(x: torch.Tensor, group_params: list, cfg: ModelConfig, *,
               collect_cache: bool = False):
    """All layer groups in order.  Returns (x, aux, caches): aux is the sum
    of the MoE blocks' router losses (f32 scalar, 0 without MoE), caches
    per group each sub-layer's prefill cache leaves stacked over the
    layers ((k, v) to [L,B,S,KV,Dh], recurrent states to [L,B,...]; None
    without ``collect_cache``).  ``cfg.remat_policy`` applies to each
    layer when a gradient will be taken (grad enabled and x or a
    parameter requiring it); a prefill that collects caches, or any
    forward without grad, runs bare."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; valid choices: "
                         f"{', '.join(REMAT_POLICIES)}")
    caches = []
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, gp in zip(cfg.groups, group_params):
        differentiated = torch.is_grad_enabled() and not collect_cache and (
            x.requires_grad or any(t.requires_grad for t in tree_leaves(gp)))

        def body(xx, lp, group=group):
            auxes = []
            for j, kind in enumerate(group.pattern):
                xx, aux, _ = block_forward(kind, xx, lp[f"sub{j}"], cfg)
                auxes.append(aux)
            return xx, auxes

        step = _remat_wrap(body, policy) if differentiated else body
        per = [[] for _ in group.pattern]
        for lp in unstack(gp, group.repeats):
            if not collect_cache:
                x, auxes = step(x, lp)
            else:
                auxes = []
                for j, kind in enumerate(group.pattern):
                    x, aux, c = block_forward(kind, x, lp[f"sub{j}"], cfg,
                                              collect_cache=True)
                    auxes.append(aux)
                    per[j].append(c)
            for aux in auxes:
                if aux is not None:
                    total_aux = total_aux + aux
        caches.append({
            f"sub{j}": {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
            for j, cs in enumerate(per)} if collect_cache else None)
    return x, total_aux, caches


def block_decode(kind: str, x: torch.Tensor, p: dict, cfg: ModelConfig,
                 cache: dict, *, pos: torch.Tensor, write_idx: torch.Tensor,
                 paged=None) -> torch.Tensor:
    """One block of ``kind``, one token; ``cache`` (this layer's views of
    the stacked caches) is updated in place: an attention block writes the
    token's K/V entry, a recurrent block copies its new state into every
    leaf.  ``paged`` = {"block_table": [B,M], "write_bids": [B]} switches
    an attention cache to the pooled paged layout (its leaves are then this
    layer's block pools; int8 pools carry ``k_scale``/``v_scale``)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        m, hs, buf = ssm.mamba_decode(h, p["mixer"], cfg, cfg.ssm,
                                      cache["h"], cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(buf)
        return _ffn(kind, x + m, p, cfg)[0]
    if kind in STATE_LEAVES:
        step = ssm.mlstm_decode if kind == "mlstm" else ssm.slstm_decode
        names = STATE_LEAVES[kind]
        m, st = step(h, p["mixer"], cfg, cfg.xlstm,
                     tuple(cache[n] for n in names))
        for n, t in zip(names, st):
            cache[n].copy_(t)
        return x + m
    if paged is not None:
        a = attention_decode_paged(
            h, p["attn"], cfg, k_pool=cache["k"], v_pool=cache["v"],
            pos_pool=cache["pos"], block_table=paged["block_table"],
            write_bids=paged["write_bids"], pos=pos,
            k_scale_pool=cache.get("k_scale"),
            v_scale_pool=cache.get("v_scale"))
    else:
        a = attention_decode(h, p["attn"], cfg, k_cache=cache["k"],
                             v_cache=cache["v"], kv_positions=cache["pos"],
                             pos=pos, write_idx=write_idx)
    return _ffn(kind, x + a, p, cfg)[0]


def run_groups_decode(x: torch.Tensor, group_params: list, caches: list,
                      cfg: ModelConfig, *, pos: torch.Tensor,
                      write_idx: torch.Tensor, paged=None) -> torch.Tensor:
    """One-token step through all groups.  Where the reference threads the
    caches through a scan and returns new ones, the port writes each
    layer's new K/V entry or state into the stacked caches in place.  ``paged``
    (block table + this tick's write plan) applies to every layer: one
    table serves all layers' pools."""
    for group, gp, gc in zip(cfg.groups, group_params, caches):
        for i in range(group.repeats):
            lp, lc = layer(gp, i), layer(gc, i)
            for j, kind in enumerate(group.pattern):
                x = block_decode(kind, x, lp[f"sub{j}"], cfg, lc[f"sub{j}"],
                                 pos=pos, write_idx=write_idx, paged=paged)
    return x


def block_chunk(kind: str, x: torch.Tensor, p: dict, cfg: ModelConfig,
                cache: dict, *, positions: torch.Tensor, reset: torch.Tensor,
                paged=None) -> torch.Tensor:
    """One block, one prompt chunk x [B,C,D] (the reference's
    ``block_chunk``, ``blocks.py:307``); ``cache`` (this layer's views)
    takes the chunk's K/V in place.  Self-attention blocks only, as in the
    reference: a recurrent mixer would need the sequential in-chunk scan
    that the full prefill already is.  ``paged`` = {"block_table": [B,M],
    "write_bids": [B,C]} switches to the pooled layout."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"chunked prefill only supports self-attention "
                         f"blocks; got block kind {kind!r}")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if paged is not None:
        a = attention_chunk_append_paged(
            h, p["attn"], cfg, k_pool=cache["k"], v_pool=cache["v"],
            pos_pool=cache["pos"], block_table=paged["block_table"],
            write_bids=paged["write_bids"], positions=positions,
            k_scale_pool=cache.get("k_scale"),
            v_scale_pool=cache.get("v_scale"))
    else:
        a = attention_chunk_append(
            h, p["attn"], cfg, k_cache=cache["k"], v_cache=cache["v"],
            kv_positions=cache["pos"], positions=positions, reset=reset)
    return _ffn(kind, x + a, p, cfg)[0]


def run_groups_chunk(x: torch.Tensor, group_params: list, caches: list,
                     cfg: ModelConfig, *, positions: torch.Tensor,
                     reset: torch.Tensor, paged=None) -> torch.Tensor:
    """One prompt chunk through all groups, each layer's K/V written into
    the stacked caches in place: the chunk analog of
    :func:`run_groups_decode` (C queries instead of one)."""
    for group, gp, gc in zip(cfg.groups, group_params, caches):
        for i in range(group.repeats):
            lp, lc = layer(gp, i), layer(gc, i)
            for j, kind in enumerate(group.pattern):
                x = block_chunk(kind, x, lp[f"sub{j}"], cfg, lc[f"sub{j}"],
                                positions=positions, reset=reset,
                                paged=paged)
    return x


def kind_cache_key(kind: str) -> str:
    """The cache family of a block kind: "attn" (K/V entries at positions)
    or "ssm" (a recurrent state)."""
    return "attn" if kind.startswith("attn") else "ssm"
