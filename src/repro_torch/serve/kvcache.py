"""Dense KV caches (port of ``repro.serve.kvcache``, dense layout).

Caches mirror the layer-group structure: one dict per group, every leaf
stacked along a leading layers axis (``k``/``v`` [L,B,T,KV,Dh] in the
working dtype, ``pos`` [L,B,T] int32 with -1 = empty).  Where the
reference returns updated copies, the port updates tensors in place.
Sliding-window ring buffers are not in this slice
(``models.registry.check_supported`` rejects SWA configs).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.common import ModelConfig


def attn_cache_len(cfg: ModelConfig, context_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, context_len)
    return context_len


def write_index(cfg: ModelConfig, pos: torch.Tensor,
                cache_len: int) -> torch.Tensor:
    """Cache entry each new token lands in: its absolute position (the
    ring-buffer slot ``pos % cache_len`` for SWA archs)."""
    if cfg.sliding_window is not None:
        return pos % cache_len
    return pos


def init_cache(cfg: ModelConfig, batch: int, context_len: int,
               device="cpu") -> list:
    """Empty decode caches: zero K/V, every ``pos`` -1."""
    T = attn_cache_len(cfg, context_len)
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    caches = []
    for g in cfg.groups:
        L = g.repeats
        caches.append({f"sub{j}": {
            "k": torch.zeros((L, batch, T, KV, Dh), dtype=cfg.dtype,
                             device=device),
            "v": torch.zeros((L, batch, T, KV, Dh), dtype=cfg.dtype,
                             device=device),
            "pos": torch.full((L, batch, T), -1, dtype=torch.int32,
                              device=device),
        } for j in range(len(g.pattern))})
    return caches


def mask_prefill_pos(caches: list, lengths: torch.Tensor) -> list:
    """In place: invalidate the entries a right-padded batched prefill wrote
    for pad tokens.  ``lengths`` [B] are the true prompt lengths; every
    entry at a position >= its row's length gets ``pos = -1``, so no
    decode step attends to it (K/V payloads stay; masking is positional)."""
    for gc in caches:
        for c in gc.values():
            p = c["pos"]                                   # [L,B,T]
            keep = (p >= 0) & (p < lengths[None, :, None])
            p.masked_fill_(~keep, -1)
    return caches


def splice_slots(full: list, part: list, slots: Sequence[int]) -> list:
    """In place: write admitted rows' prefill caches into their decode
    slots.  ``full`` leaves are [L, num_slots, ...], ``part`` leaves
    [L, B, ...], ``slots`` the B slot ids.  A slot id that repeats (the
    engine pads admission batches by repeating the last request) takes its
    earliest row, as the reference's reverse-order writes do."""
    first: dict[int, int] = {}
    for i, s in enumerate(slots):
        first.setdefault(int(s), i)
    dev = full[0]["sub0"]["pos"].device
    dst = torch.tensor(list(first), dtype=torch.long, device=dev)
    src = torch.tensor(list(first.values()), dtype=torch.long, device=dev)
    for fg, pg in zip(full, part):
        for name, fc in fg.items():
            for leaf, f in fc.items():
                f[:, dst] = pg[name][leaf][:, src].to(f.dtype)
    return full


def pad_prefill_cache(cfg: ModelConfig, caches: list, prefill_len: int,
                      capacity: int) -> list:
    """Prefill (k, v) [L,B,S,KV,Dh] -> decode caches [L,B,T,...] with
    T = capacity: entry i holds position i; entries past S are empty
    (``pos = -1``); when S > T only the last T entries are kept."""
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window ring-buffer caches are not "
                                  "ported (ROADMAP queue 1, item 11)")
    T = attn_cache_len(cfg, capacity)
    out = []
    for gc in caches:
        per = {}
        for name, c in gc.items():
            k, v = c["k"], c["v"]
            L, B, S = k.shape[:3]
            p_start = prefill_len - S
            pos = torch.arange(p_start, prefill_len, dtype=torch.int32,
                               device=k.device).expand(L, B, S)
            if S >= T:
                per[name] = {"k": k[:, :, S - T:].contiguous(),
                             "v": v[:, :, S - T:].contiguous(),
                             "pos": pos[:, :, S - T:].contiguous()}
                continue
            nk = k.new_zeros((L, B, T) + tuple(k.shape[3:]))
            nv = v.new_zeros(nk.shape)
            npos = torch.full((L, B, T), -1, dtype=torch.int32,
                              device=k.device)
            nk[:, :, :S] = k
            nv[:, :, :S] = v
            npos[:, :, :S] = pos
            per[name] = {"k": nk, "v": nv, "pos": npos}
        out.append(per)
    return out
