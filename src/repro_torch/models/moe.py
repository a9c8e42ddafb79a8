"""Mixture-of-experts FFN with sort-based token dispatch, on one device
(port of the single-device path of ``repro.models.moe``).

The router picks each token's top-k experts; ``_dispatch`` packs the
(token, expert) pairs into per-expert slots of a fixed capacity (pairs
past it are dropped), the experts run as batched SwiGLU products over
their [C, D] slots, and ``_combine`` adds each token's k weighted expert
outputs back, in a fixed order: its pairs' order in the dispatch's stable
sort by expert, left to right from zero, which is the order the
reference's scatter-add (``.at[].add``) applies them on the CPU.  (An
``index_add_`` would add them with atomics on the card, in no fixed order:
at top-8 a token's sum could change from run to run.)  Routing is exactly
the reference's: the capacity is a function of the call's token count
(pad rows included), ties in the top-k go to the lower expert index, and
the dispatch order is a stable sort by expert.  The expert products are
``torch.bmm``, as the reference leaves them to XLA outside any Pallas
kernel.  Every step is differentiable by autograd (the sorted top-k
values, the dispatch's gather, the combine), as the reference
differentiates its jnp; the router stays f32.

The reference's expert-parallel and tensor-parallel bodies (all-to-all or
psum across a mesh) and its token chunking under sharding rules need a
mesh; they wait for the port's sharding (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MoEConfig, PSpec

_SHARDED = "ROADMAP queue 1, item 9 (sharding)"


def moe_specs(cfg: ModelConfig, moe: MoEConfig) -> dict:
    D, E, Fe = cfg.d_model, moe.num_experts, moe.d_ff_expert
    return {
        "router": PSpec((D, E), init=f"scaled:{D}", dtype=torch.float32),
        "wi_gate": PSpec((E, D, Fe), init=f"scaled:{D}"),
        "wi_up": PSpec((E, D, Fe), init=f"scaled:{D}"),
        "wo": PSpec((E, Fe, D), init=f"scaled:{Fe}"),
    }


def _capacity(tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(4, -(-c // 4) * 4)  # >= 4, a multiple of 4


def _route(x: torch.Tensor, router_w: torch.Tensor, moe: MoEConfig):
    """x [T,D] -> (weights [T,k] f32, experts [T,k] int64, aux scalar
    f32).  The top-k is taken from a stable descending sort, so equal
    probabilities go to the lower expert index, as ``jax.lax.top_k``
    does."""
    logits = x.float() @ router_w.float()                       # [T,E]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = order.values[:, :moe.top_k]
    top_e = order.indices[:, :moe.top_k]
    weights = top_p / top_p.sum(-1, keepdim=True)
    # Switch-style load-balance loss
    E = moe.num_experts
    dispatch_frac = F.one_hot(top_e, E).float().sum(1).mean(0)
    prob_frac = probs.mean(0)
    aux = E * (dispatch_frac * prob_frac).sum() * moe.aux_loss_weight
    return weights, top_e, aux


def _dispatch(x: torch.Tensor, experts: torch.Tensor, capacity: int,
              num_experts: int):
    """Pack tokens into per-expert slots.  x [T,D]; experts [T,k] ->
    (xg [E*C, D], slot [T*k] (E*C = dropped), pair_token sorted [T*k],
    keep [T*k], order [T*k])."""
    T, k = experts.shape
    pair_expert = experts.reshape(-1)
    pair_token = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(pair_expert, stable=True)
    sorted_expert = pair_expert[order]
    counts = torch.bincount(sorted_expert, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts                  # exclusive
    rank = torch.arange(T * k, device=x.device) - starts[sorted_expert]
    keep = rank < capacity
    slot = torch.where(keep, sorted_expert * capacity + rank,
                       num_experts * capacity)
    xg = x.new_zeros(num_experts * capacity + 1, x.shape[-1])
    xg[slot] = x[pair_token[order]]
    return xg[:-1], slot, pair_token[order], keep, order


def _combine(yg: torch.Tensor, slot, pair_token_sorted, keep, weights,
             order, T: int) -> torch.Tensor:
    """Gather the expert outputs back to their tokens, weighted by the
    router, each token's k terms summed in a fixed order.  The sorted
    pairs' contributions are placed at [T, k] by their rank among the
    token's pairs in the sort (a token's pairs have distinct experts, so
    the stable sort by expert ranks them by expert) and added left to
    right onto zero: the order the reference's scatter-add applies them
    in, and the same on every device and every run."""
    k = order.numel() // T
    pair_w = weights.reshape(-1)[order]
    yg_pad = torch.cat([yg, yg.new_zeros(1, yg.shape[-1])])
    contrib = yg_pad[slot] * (pair_w * keep).to(yg.dtype)[:, None]
    # a stable sort by token lists each token's k sorted positions in
    # increasing order: row t of ``per`` holds t's terms by their rank
    by_token = torch.argsort(pair_token_sorted, stable=True)
    per = contrib[by_token].view(T, k, -1)
    y = contrib.new_zeros(T, contrib.shape[-1])
    for r in range(k):
        y = y + per[:, r]
    return y


def _expert_ffn(xg: torch.Tensor, wi_gate, wi_up, wo) -> torch.Tensor:
    """xg [E,C,D] with weights [E,D,F] / [E,F,D] -> [E,C,D]: each
    expert's SwiGLU as batched products in xg's dtype."""
    gate = torch.bmm(xg, wi_gate.to(xg.dtype))
    up = torch.bmm(xg, wi_up.to(xg.dtype))
    return torch.bmm(F.silu(gate) * up, wo.to(xg.dtype))


def _moe_local(x2d: torch.Tensor, params: dict, moe: MoEConfig):
    """Single-device MoE over tokens x2d [T,D] -> (y [T,D], aux)."""
    T = x2d.shape[0]
    E = moe.num_experts
    C = _capacity(T, moe)
    weights, top_e, aux = _route(x2d, params["router"], moe)
    xg, slot, ptok, keep, order = _dispatch(x2d, top_e, C, E)
    yg = _expert_ffn(xg.view(E, C, -1), params["wi_gate"], params["wi_up"],
                     params["wo"])
    return _combine(yg.view(E * C, -1), slot, ptok, keep, weights, order,
                    T), aux


def moe_ffn(x: torch.Tensor, params: dict, cfg: ModelConfig,
            moe: MoEConfig, *, regime=None, moe_chunk: int = 0):
    """x [B,S,D] -> (y [B,S,D] in x's dtype, aux scalar f32): the
    reference's ``moe_ffn`` with no sharding rules installed (one
    device), over all B*S tokens of the call at once.  ``regime`` ("ep" /
    "tp") and ``moe_chunk`` are the reference's sharding rules: its
    expert- and tensor-parallel bodies and token-chunked dispatch run
    across a mesh, which the port does not have yet, so they raise."""
    if regime is not None or moe_chunk:
        raise NotImplementedError(
            f"sharded MoE (regime {regime!r}, moe_chunk {moe_chunk}) is not "
            f"ported yet ({_SHARDED})")
    B, S, D = x.shape
    y, aux = _moe_local(x.reshape(B * S, D), params, moe)
    return y.view(B, S, D).to(x.dtype), aux
