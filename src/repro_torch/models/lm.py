"""Decoder-only causal language model (port of ``repro.models.lm``: the
forward, the training loss and the one-token decode step).

    lm_specs(cfg)                                  parameter PSpec tree
    lm_forward(params, tokens, cfg, ...)           logits, MoE aux loss
                                                   (+ prefill caches)
    lm_loss(params, batch, cfg, *, ce_chunk=0)     (loss, metrics)
    lm_decode_step(params, token, caches, cfg, ...)  logits; caches in place
                                                   (dense or paged)
    lm_chunk_prefill(params, tokens, caches, cfg, ...)  one prompt chunk
                                                   appended; last logits
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.blocks import (group_specs, run_groups,
                                      run_groups_chunk, run_groups_decode)
from repro_torch.models.common import ModelConfig, PSpec
from repro_torch.models.layers import (chunked_softmax_xent, cross_entropy,
                                       embedding_spec, lm_head, rmsnorm,
                                       rmsnorm_spec)


def lm_specs(cfg: ModelConfig) -> dict:
    s: dict[str, Any] = {
        "embed": embedding_spec(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "groups": [group_specs(g, cfg) for g in cfg.groups],
    }
    if not cfg.tie_embeddings:
        s["unembed"] = PSpec((cfg.padded_vocab, cfg.d_model),
                             init=f"scaled:{cfg.d_model}")
    return s


def _embed(params: dict, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """tokens [B,S] -> rows of the embedding table in the working dtype,
    times sqrt(d_model) with ``cfg.scale_embeddings`` (gemma): the
    multiplier is taken in f32 and cast to the working dtype first, as the
    reference does (in bf16 sqrt(2048) = 45.2548... becomes 45.25)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32,
                             device=x.device).sqrt().to(cfg.dtype)
    return x


def _unembed_table(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
               collect_cache: bool = False, last_only: bool = False,
               last_index: Optional[torch.Tensor] = None):
    """tokens [B,S] -> (logits [B,S,Vp], aux, caches).

    ``aux`` is the summed MoE router loss (f32 scalar, 0 without MoE).
    ``last_only`` projects the final position only ([B,1,Vp]);
    ``last_index`` [B] picks a per-row position instead (right-padded
    batched prefill).  ``caches`` is ``run_groups``' per-group stacked
    prefill caches ((k, v), or the final recurrent states of Mamba and
    xLSTM blocks) with ``collect_cache``, else a list of None."""
    x = _embed(params, tokens, cfg)
    x, aux, caches = run_groups(x, params["groups"], cfg,
                                collect_cache=collect_cache)
    if last_index is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              last_index.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(x, _unembed_table(params, cfg), cfg), aux, caches


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            ce_chunk: int = 0) -> tuple[torch.Tensor, dict]:
    """batch: tokens [B,S], labels [B,S] (-1 = ignore) -> (loss, {"loss",
    "ce", "moe_aux"}), f32 scalars.

    ``ce_chunk > 0`` runs the lm_head and cross-entropy fused over
    sequence chunks (the [B,S,V] logits never materialize), as the
    reference does under its ``ce_chunk`` activation rule (set for train
    plans with ``seq_len > 512``; here the caller passes it).  ``moe_aux``
    is the MoE blocks' summed router loss (0 without MoE), added to the
    loss as the reference adds it.  Remat follows ``cfg.remat_policy``."""
    labels = batch["labels"]
    if ce_chunk:
        x = _embed(params, batch["tokens"], cfg)
        x, aux, _ = run_groups(x, params["groups"], cfg)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        ce = chunked_softmax_xent(x, _unembed_table(params, cfg), labels,
                                  cfg, ce_chunk)
    else:
        logits, aux, _ = lm_forward(params, batch["tokens"], cfg)
        ce = cross_entropy(logits, labels)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": aux}


def lm_decode_step(params: dict, token: torch.Tensor, caches: list,
                   cfg: ModelConfig, *, pos: torch.Tensor,
                   write_idx: torch.Tensor, paged=None) -> torch.Tensor:
    """token [B,1] -> logits [B,1,Vp].  The token's K/V entries (or the
    xLSTM blocks' new states) are written into ``caches`` in place (the
    reference returns new caches).
    ``paged`` = {"block_table", "write_bids"} switches the caches to the
    pooled paged layout (``serve/blockpool.py``)."""
    x = _embed(params, token, cfg)
    x = run_groups_decode(x, params["groups"], caches, cfg, pos=pos,
                          write_idx=write_idx, paged=paged)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(x, _unembed_table(params, cfg), cfg)


def lm_chunk_prefill(params: dict, tokens: torch.Tensor, caches: list,
                     cfg: ModelConfig, *, positions: torch.Tensor,
                     reset: torch.Tensor, last_index: torch.Tensor,
                     paged=None) -> torch.Tensor:
    """tokens [B,C] (one prompt chunk; pads at ``attention.PAD_POS``) ->
    logits [B,1,Vp] of each row's ``last_index`` [B] token (the reference's
    ``lm_chunk_prefill``, ``lm.py:129``).  The chunk's K/V are appended to
    the decode caches in place at the absolute ``positions`` [B,C], every
    query attending with per-query positional masking; ``reset`` [B] bool
    clears a dense row's positions before its first chunk (paged rows are
    cleared through the pool).  ``paged`` as in :func:`lm_decode_step`,
    with write_bids [B,C]."""
    x = _embed(params, tokens, cfg)
    x = run_groups_chunk(x, params["groups"], caches, cfg,
                         positions=positions, reset=reset, paged=paged)
    x = x[torch.arange(x.shape[0], device=x.device),
          last_index.long()][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(x, _unembed_table(params, cfg), cfg)
