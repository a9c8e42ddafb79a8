"""Which configs the port serves and trains, and the decoder-only LM
family's functional surface (port of the parts of
``repro.models.registry`` that the serving and training slices read).

``check_supported`` is the slices' gate: the dense family (SwiGLU or
GeGLU, with or without scaled embeddings: exanode-100m, llama3.2-3b,
qwen3-4b, gemma-2b, granite-20b), the MoE family (qwen3-moe-30b-a3b;
mixtral-8x7b, with its sliding window), xlstm-125m and jamba-v0.1-52b
pass; a config that needs anything outside them raises
``NotImplementedError`` naming the ROADMAP item that will bring it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS
from repro_torch.models import lm
from repro_torch.models.blocks import (ATTN_KINDS, MAMBA_KINDS,
                                      kind_cache_key)
from repro_torch.models.common import ModelConfig
from repro_torch.serve import kvcache

_LATER = "ROADMAP queue 1, item 11 (remaining families)"


PORTED_KINDS = ATTN_KINDS + ("mlstm", "slstm") + MAMBA_KINDS


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the port: dense
    decoder-only ``attn`` stacks with RoPE and a gated FFN (SwiGLU, or
    GeGLU as gemma-2b and granite-20b have it), scaled embeddings or not,
    ``attn_moe`` stacks (qwen3-moe-30b-a3b, mixtral-8x7b), with or
    without a sliding window (a ring-buffer KV cache), xLSTM stacks of
    ``mlstm`` / ``slstm`` blocks (xlstm-125m), and hybrid stacks of
    ``attn`` and Mamba blocks with dense or MoE FFNs (jamba).  Refused:
    both logit softcaps, encoder-decoders, frontends, learned positions
    and block kinds outside ``PORTED_KINDS``."""
    kinds = {k for g in cfg.groups for k in g.pattern}
    unsupported = {
        "attention logit softcap": cfg.attn_logit_softcap is not None,
        "final logit softcap": cfg.logit_softcap is not None,
        "Mamba blocks without an ssm config": cfg.ssm is None and bool(
            kinds & set(MAMBA_KINDS)),
        "MoE blocks without a moe config": cfg.moe is None and bool(
            kinds & {"mamba_moe", "attn_moe"}),
        "xLSTM blocks without an xlstm config": cfg.xlstm is None and bool(
            kinds & {"mlstm", "slstm"}),
        "encoder-decoder": cfg.encoder is not None,
        "frontend embeddings": bool(cfg.frontend),
        "learned positions": cfg.pos_emb != "rope" or not cfg.use_rope,
        f"block kinds {sorted(kinds - set(PORTED_KINDS))}": bool(
            kinds - set(PORTED_KINDS)),
    }
    missing = [what for what, hit in unsupported.items() if hit]
    if missing:
        raise NotImplementedError(
            f"config {cfg.name!r} needs {', '.join(missing)}, which the "
            f"port does not serve yet ({_LATER})")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port serves but does
    not train.  Since the Mamba scan's backward kernel (#12b) there is
    none: every config ``check_supported`` admits trains.  Attention
    stacks train through the flash and FFN backward kernels, MoE FFNs by
    autograd over the router, dispatch, ``torch.bmm`` experts and
    fixed-order combine (the reference differentiates its jnp MoE,
    outside any Pallas kernel), xLSTM stacks through the mLSTM backward
    kernel and autograd over the sLSTM's plain cell, as the reference's
    is jnp, and Mamba blocks through the selective scan's backward
    (``ssm_scan_bwd``) and autograd over the mixer's projections, conv
    and gates, jnp in the reference.  The check stays the one place a
    future block kind without a backward would be refused: every kind in
    ``PORTED_KINDS`` has one now."""
    kinds = {k for g in cfg.groups for k in g.pattern}
    missing = [k for k in sorted(kinds) if k not in PORTED_KINDS]
    if missing:
        raise NotImplementedError(
            f"training {cfg.name!r} needs block kinds {missing}, which the "
            f"port does not train yet (ROADMAP queue 1)")


def needs_flash_train(cfg: ModelConfig) -> bool:
    """Whether training ``cfg`` runs the flash backward kernels: stacks
    with an attention block kind (an xLSTM stack has none, whatever its
    ``head_dim``)."""
    return any(k.startswith("attn") for g in cfg.groups for k in g.pattern)


@dataclass(frozen=True)
class Capabilities:
    """The subset of the reference's flags the slices read: ``swa``
    selects exact-length admission buckets; ``subquadratic`` marks a
    recurrent stack whose decode state is O(1) per stream (the
    reference's flag, set by the config); the kernel flags say which
    Hopper kernels can express the config (``supports_flash_train``: the
    flash forward and backward kernels, which the training path needs on
    the card); ``supports_paged_decode`` / ``supports_quantized_kv`` gate
    the pooled KV layout and its int8 pool; ``supports_chunked_prefill``
    the scheduler's chunk append.  Mamba blocks have no flag: every
    registered Mamba config (d_state 8 and 16) trains through
    ``ssm_scan`` + ``ssm_scan_bwd`` (#12b takes N <= 16 and chunks of at
    most 256), which ``Runtime.describe()`` names on a training Runtime
    of a hybrid stack."""
    swa: bool
    subquadratic: bool
    supports_flash_train: bool
    supports_fused_ffn: bool
    supports_flash_decode: bool
    supports_paged_decode: bool
    supports_quantized_kv: bool
    supports_chunked_prefill: bool

    @property
    def summary(self) -> str:
        return ",".join(n for n in ("swa", "subquadratic",
                                    "supports_flash_train",
                                    "supports_fused_ffn",
                                    "supports_flash_decode",
                                    "supports_paged_decode",
                                    "supports_chunked_prefill",
                                    "supports_quantized_kv")
                        if getattr(self, n)) or "-"


def _self_attention_stack(cfg: ModelConfig) -> bool:
    """Every block a self-attention kind (the reference's structural law:
    ``startswith("attn")`` and not ``attn_cross``), with no window."""
    return cfg.sliding_window is None and all(
        k.startswith("attn") and k != "attn_cross"
        for g in cfg.groups for k in g.pattern)


def capabilities(cfg: ModelConfig) -> Capabilities:
    # Paged KV covers self-attention stacks without a sliding window, MoE
    # FFNs or not (the reference's structural law; a ring buffer stays
    # dense).  The port has no plain gather route on the card, so the
    # paged kernel's own limit (no logit softcap, the reference's
    # ``paged_pallas_supported``) is part of the capability; the int8 pool
    # shares both.  Recurrent (Mamba, xLSTM) states are O(1) per slot:
    # there is nothing to page, so their stacks, hybrid ones included, are
    # not paged.
    paged = _self_attention_stack(cfg) and cfg.attn_logit_softcap is None
    return Capabilities(
        swa=cfg.sliding_window is not None,
        subquadratic=cfg.subquadratic,
        supports_flash_train=(cfg.attn_logit_softcap is None
                              and cfg.head_dim in BWD_HEAD_DIMS),
        supports_fused_ffn=cfg.mlp_act == "silu",
        supports_flash_decode=cfg.attn_logit_softcap is None,
        supports_paged_decode=paged,
        supports_quantized_kv=paged,
        # the reference's structural law: pure self-attention stacks with
        # absolute positions (a ring buffer would need ring-order chunk
        # writes, a recurrent mixer a sequential in-chunk scan)
        supports_chunked_prefill=_self_attention_stack(cfg))


def model_specs(cfg: ModelConfig):
    return lm.lm_specs(cfg)


def model_loss(params, batch: dict, cfg: ModelConfig, *, ce_chunk: int = 0):
    """batch {"tokens", "labels"} [B,S] -> (loss, {"loss", "ce",
    "moe_aux"}) (the reference's ``model_loss`` / ``_lm_loss``);
    ``ce_chunk`` as in ``lm.lm_loss``."""
    return lm.lm_loss(params, batch, cfg, ce_chunk=ce_chunk)


def model_forward(params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens [B,S] -> logits [B,S,Vp]."""
    return lm.lm_forward(params, tokens, cfg)[0]


def _decode_write_index(cfg: ModelConfig, caches: list,
                        pos: torch.Tensor) -> torch.Tensor:
    """Write indices from the first attention layer's cache length; the
    absolute positions where no layer has an attention cache."""
    for g, gc in zip(cfg.groups, caches):
        for j, kind in enumerate(g.pattern):
            if kind_cache_key(kind) == "attn":
                return kvcache.write_index(cfg, pos, gc[f"sub{j}"]["k"]
                                           .shape[2])
    return pos


def model_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
                  capacity: int, *, last_only: bool = False,
                  last_index=None):
    """Full-context forward that also returns decode-ready caches padded
    to ``capacity``: (logits, caches)."""
    logits, _, caches = lm.lm_forward(params, tokens, cfg,
                                      collect_cache=True, last_only=last_only,
                                      last_index=last_index)
    caches = kvcache.pad_prefill_cache(cfg, caches, tokens.shape[1], capacity)
    return logits, caches


def model_decode_step(params, token: torch.Tensor, caches: list,
                      cfg: ModelConfig, *, pos: torch.Tensor) -> torch.Tensor:
    """token [B,1]; pos [B] absolute positions -> logits [B,1,Vp];
    ``caches`` take the token's K/V (or the new recurrent states) in
    place."""
    widx = _decode_write_index(cfg, caches, pos)
    return lm.lm_decode_step(params, token, caches, cfg, pos=pos,
                             write_idx=widx)


def model_paged_decode_step(params, token: torch.Tensor, caches: list,
                            cfg: ModelConfig, *, pos: torch.Tensor,
                            block_table: torch.Tensor,
                            write_bids: torch.Tensor) -> torch.Tensor:
    """Paged-layout decode step: ``caches`` are ``serve.blockpool`` pools,
    ``block_table`` [B,M] int32, ``write_bids`` [B] this tick's write plan
    -> logits [B,1,Vp]; the pools take the token's K/V in place."""
    return lm.lm_decode_step(
        params, token, caches, cfg, pos=pos, write_idx=pos,
        paged={"block_table": block_table, "write_bids": write_bids})


def model_chunk_prefill(params, tokens: torch.Tensor, caches: list,
                        cfg: ModelConfig, *, positions: torch.Tensor,
                        reset: torch.Tensor, last_index: torch.Tensor,
                        paged=None) -> torch.Tensor:
    """Append one [B,C] prompt chunk into decode caches at absolute
    ``positions`` [B,C] (pads at ``models.attention.PAD_POS``) and return
    the logits [B,1,Vp] of each row's ``last_index`` token; the caches
    take the chunk in place.  ``paged`` = {"block_table", "write_bids"}
    ([B,M] / [B,C]) switches to the pooled KV layout.  Raises for a stack
    without ``supports_chunked_prefill``, as the reference does."""
    if not capabilities(cfg).supports_chunked_prefill:
        raise ValueError(
            f"config {cfg.name!r} has no chunked prefill step "
            f"(caps.supports_chunked_prefill is False)")
    return lm.lm_chunk_prefill(params, tokens, caches, cfg,
                               positions=positions, reset=reset,
                               last_index=last_index, paged=paged)
