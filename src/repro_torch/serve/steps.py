"""Serve steps: prefill (context -> caches) and decode (one token), over the
dense cache or the paged pool (port of ``repro.serve.steps``, single
device).

The reference jits these with the caches donated; the port runs them
eagerly and updates the decode caches in place.  Kernels are chosen by
device inside the model code (``kernels.ops``): there is no impl knob, and
the contradictions the reference's ``resolve_decode_attn_impl`` rejects
(an int8 pool without the paged layout) are ``Runtime`` and engine checks.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import (model_decode_step,
                                         model_paged_decode_step,
                                         model_prefill)
from repro_torch.serve import kvcache


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits [B,1,V] -> next token [B] int32 (first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *, capacity: int) -> Callable:
    """(params, batch) -> (next_token [B], caches).

    ``capacity`` is the decode-cache length the caches are padded to.
    ``batch["lengths"]`` [B], when present, marks rows as right-padded to a
    common bucket length: the next token comes from each row's true last
    position and pad cache entries are invalidated."""

    def prefill(params, batch):
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        if lengths is None:
            logits, caches = model_prefill(params, tokens, cfg, capacity,
                                           last_only=True)
            return greedy_sample(logits), caches
        lengths = lengths.to(torch.int32)
        logits, caches = model_prefill(params, tokens, cfg, capacity,
                                       last_index=lengths - 1)
        kvcache.mask_prefill_pos(caches, lengths)
        return greedy_sample(logits), caches

    return prefill


def make_decode_step(cfg: ModelConfig, *,
                     advance_pos: bool = False) -> Callable:
    """(params, token [B,1], caches, pos [B]) -> (next [B], caches).

    ``pos`` is the absolute position of the incoming token.  ``caches``
    take the token's K/V (or the new recurrent states) in place and come
    back as the same object.  With
    ``advance_pos`` the step returns ``(next [B,1], caches, pos + 1)``: the
    engine's device-resident hot-loop contract (every slot advances;
    inactive slots' writes are overwritten at re-admission)."""

    def decode(params, token, caches, pos):
        nxt = greedy_sample(model_decode_step(params, token, caches, cfg,
                                              pos=pos))
        if advance_pos:
            return nxt[:, None], caches, pos + 1
        return nxt, caches

    return decode


def make_paged_decode_step(cfg: ModelConfig) -> Callable:
    """(params, token [B,1], caches, pos [B], block_table [B,M], write_bids
    [B]) -> (next [B,1], caches, pos + 1): the paged analog of
    ``make_decode_step(advance_pos=True)``.  ``caches`` are the pooled
    block caches (``serve.blockpool``; int8 pools carry scale leaves),
    ``write_bids`` the engine's write plan for this tick."""

    def decode(params, token, caches, pos, block_table, write_bids):
        logits = model_paged_decode_step(params, token, caches, cfg, pos=pos,
                                         block_table=block_table,
                                         write_bids=write_bids)
        return greedy_sample(logits)[:, None], caches, pos + 1

    return decode
