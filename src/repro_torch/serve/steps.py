"""Serve steps: prefill (context -> caches), decode (one token) and the
scheduler's mixed step (a decode tick plus one prompt chunk), over the
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
from repro_torch.models.registry import (model_chunk_prefill,
                                         model_decode_step,
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


def make_mixed_step(cfg: ModelConfig) -> Callable:
    """(params, token [N,1], caches, pos [N], c_tok [1,C], c_pos [1,C],
    c_slot, c_reset [1] bool, c_last [1]) -> (next [N,1], caches, pos + 1,
    c_next [1]): the scheduler's step over the dense layout.

    Every slot advances as in ``make_decode_step(advance_pos=True)``, then
    one [1,C] prompt chunk is appended into slot ``c_slot``'s (an int) cache
    row, written in place through its views (``kvcache.slot_rows``).  The
    engine parks every non-decoding slot's ``pos`` at
    ``attention.PAD_POS``, so the decode tick's write for the chunk's slot
    is dropped and never clobbers the row being built; ``c_last`` picks
    the chunk's last real token, whose greedy sample ``c_next`` seeds the
    slot's decode on the request's final chunk."""

    def mixed(params, token, caches, pos, c_tok, c_pos, c_slot, c_reset,
              c_last):
        nxt = greedy_sample(model_decode_step(params, token, caches, cfg,
                                              pos=pos))
        c_logits = model_chunk_prefill(
            params, c_tok, kvcache.slot_rows(caches, c_slot), cfg,
            positions=c_pos, reset=c_reset, last_index=c_last)
        return nxt[:, None], caches, pos + 1, greedy_sample(c_logits)

    return mixed


def make_paged_mixed_step(cfg: ModelConfig) -> Callable:
    """(params, token [N,1], caches, pos [N], block_table [N,M], write_bids
    [N], c_tok [1,C], c_pos [1,C], c_table [1,M], c_bids [1,C], c_last [1])
    -> (next [N,1], caches, pos + 1, c_next [1]): the scheduler's step over
    the paged pool (an f32 or int8 pool, as the cache leaves say).

    The chunk writes the pools directly: ``c_table`` is its owner's chain,
    ``c_bids`` each token's destination (the trash block for pads and for
    prefix-shared blocks, written by their first owner).  Decode slots
    write their own blocks, the chunk only its exclusive fresh ones, and
    the chunk slot's decode write goes to the trash block, so the decode
    streams are those of the monolithic engine."""

    def mixed(params, token, caches, pos, block_table, write_bids, c_tok,
              c_pos, c_table, c_bids, c_last):
        logits = model_paged_decode_step(params, token, caches, cfg, pos=pos,
                                         block_table=block_table,
                                         write_bids=write_bids)
        c_logits = model_chunk_prefill(
            params, c_tok, caches, cfg, positions=c_pos,
            reset=torch.zeros(1, dtype=torch.bool, device=c_tok.device),
            last_index=c_last,
            paged={"block_table": c_table, "write_bids": c_bids})
        return (greedy_sample(logits)[:, None], caches, pos + 1,
                greedy_sample(c_logits))

    return mixed
