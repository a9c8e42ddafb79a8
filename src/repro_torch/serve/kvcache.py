"""Dense decode caches (port of ``repro.serve.kvcache``, dense layout):
attention K/V and the Mamba and xLSTM blocks' recurrent states.

Caches mirror the layer-group structure: one dict per group, one dict per
sub-layer, every leaf stacked along a leading layers axis.  An ``attn``
sub-layer holds ``k``/``v`` [L,B,T,KV,Dh] in the working dtype and
``pos`` [L,B,T] int32 with -1 = empty; a Mamba one (``mamba``,
``mamba_nof``, ``mamba_moe``) ``h`` [L,B,Di,N] f32 and ``conv``
[L,B,K-1,Di] in the working dtype; an ``mlstm`` one its state
(``C`` [L,B,H,dh,dh], ``n`` [L,B,H,dh], ``m`` [L,B,H] starting at -inf,
``conv`` [L,B,K-1,Di]) and an ``slstm`` one (``c``, ``n``, ``m``, ``h``
[L,B,H,dh], ``m`` starting at -inf), all f32.  Recurrent states are
independent of the context length.  Where the reference returns updated
copies, the port updates tensors in place.  A sliding-window arch
(mixtral-8x7b) keeps a ring buffer of T = min(window, capacity) entries:
a token at position p sits in entry ``p % T`` (``write_index``), and the
positional mask, not the entry order, says what a query attends.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models import ssm
from repro_torch.models.blocks import MAMBA_KINDS, STATE_LEAVES
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


def _kind_cache(kind: str, cfg: ModelConfig, B: int, T: int,
                device) -> dict:
    """One sub-layer's empty cache (without the layers axis)."""
    if kind in MAMBA_KINDS:
        state = ssm.mamba_init_state(cfg, cfg.ssm, B, cfg.dtype, device)
    elif kind == "mlstm":
        state = ssm.mlstm_init_state(cfg, cfg.xlstm, B, device)
    elif kind == "slstm":
        state = ssm.slstm_init_state(cfg, B, device)
    else:
        KV, Dh = cfg.num_kv_heads, cfg.head_dim
        return {"k": torch.zeros((B, T, KV, Dh), dtype=cfg.dtype,
                                 device=device),
                "v": torch.zeros((B, T, KV, Dh), dtype=cfg.dtype,
                                 device=device),
                "pos": torch.full((B, T), -1, dtype=torch.int32,
                                  device=device)}
    return dict(zip(STATE_LEAVES[kind], state))


def init_cache(cfg: ModelConfig, batch: int, context_len: int,
               device="cpu") -> list:
    """Empty decode caches: zero K/V with every ``pos`` -1, zero recurrent
    states with ``m`` = -inf."""
    T = attn_cache_len(cfg, context_len)
    return [{f"sub{j}": {
        n: t.unsqueeze(0).repeat((g.repeats,) + (1,) * t.ndim)
        for n, t in _kind_cache(kind, cfg, batch, T, device).items()}
        for j, kind in enumerate(g.pattern)} for g in cfg.groups]


def state_bytes_per_stream(cfg: ModelConfig) -> int:
    """Bytes of one stream's recurrent state over every Mamba and xLSTM
    layer (0 for a pure attention stack); independent of the context
    length."""
    return sum(g.repeats * t.numel() * t.element_size()
               for g in cfg.groups for kind in g.pattern
               if kind in STATE_LEAVES
               for t in _kind_cache(kind, cfg, 1, 0, "meta").values())


def mask_prefill_pos(caches: list, lengths: torch.Tensor) -> list:
    """In place: invalidate the entries a right-padded batched prefill wrote
    for pad tokens.  ``lengths`` [B] are the true prompt lengths; every
    entry at a position >= its row's length gets ``pos = -1``, so no
    decode step attends to it (K/V payloads stay; masking is positional).
    Recurrent states have no positions and are left as they are: they have
    absorbed the pad tokens, as the reference's do."""
    for gc in caches:
        for c in gc.values():
            if "pos" not in c:
                continue
            p = c["pos"]                                   # [L,B,T]
            keep = (p >= 0) & (p < lengths[None, :, None])
            p.masked_fill_(~keep, -1)
    return caches


def splice_slots(full: list, part: list, slots: Sequence[int]) -> list:
    """In place: write admitted rows' prefill caches (every leaf: K/V,
    positions, recurrent states) into their decode slots.  ``full`` leaves
    are [L, num_slots, ...], ``part`` leaves
    [L, B, ...], ``slots`` the B slot ids.  A slot id that repeats (the
    engine pads admission batches by repeating the last request) takes its
    earliest row, as the reference's reverse-order writes do."""
    first: dict[int, int] = {}
    for i, s in enumerate(slots):
        first.setdefault(int(s), i)
    dev = next(iter(full[0]["sub0"].values())).device
    dst = torch.tensor(list(first), dtype=torch.long, device=dev)
    src = torch.tensor(list(first.values()), dtype=torch.long, device=dev)
    for fg, pg in zip(full, part):
        for name, fc in fg.items():
            for leaf, f in fc.items():
                f[:, dst] = pg[name][leaf][:, src].to(f.dtype)
    return full


def slot_rows(caches: list, slot: int) -> list:
    """Views of one slot's row in every leaf ([L, 1, ...] of the
    [L, num_slots, ...] caches).  The scheduler's chunk append writes
    through them in place, where the reference slices the row out and
    splices it back (``splice_slots``)."""
    return [{name: {leaf: t.narrow(1, slot, 1) for leaf, t in c.items()}
             for name, c in gc.items()} for gc in caches]


def pad_prefill_cache(cfg: ModelConfig, caches: list, prefill_len: int,
                      capacity: int) -> list:
    """Prefill caches -> decode caches.  Attention (k, v) [L,B,S,KV,Dh],
    whose entries hold positions ``prefill_len - S .. prefill_len - 1``
    (S is already the window under a sliding window whose prefill was
    longer: ``blocks.block_forward`` trims it), go to [L,B,T,...] with T =
    ``attn_cache_len(cfg, capacity)``.  When S < T entry i holds position
    i and the entries past S are empty (``pos = -1``); when S >= T only the
    last T entries are kept, and for a ring buffer they are rolled right by
    ``p0 % T`` (p0 the first kept position), so that each sits at its slot
    ``pos % T`` (the reference's ``kvcache.py:140-190``).  Recurrent
    states pass through as they are."""
    T = attn_cache_len(cfg, capacity)
    out = []
    for g, gc in zip(cfg.groups, caches):
        per = {}
        for j, kind in enumerate(g.pattern):
            name, c = f"sub{j}", gc[f"sub{j}"]
            if kind in STATE_LEAVES:
                per[name] = c
                continue
            k, v = c["k"], c["v"]
            L, B, S = k.shape[:3]
            p_start = prefill_len - S
            pos = torch.arange(p_start, prefill_len, dtype=torch.int32,
                               device=k.device).expand(L, B, S)
            if S >= T:
                kept = [t[:, :, S - T:] for t in (k, v, pos)]
                shift = ((p_start + S - T) % T
                         if cfg.sliding_window is not None else 0)
                per[name] = dict(zip(("k", "v", "pos"), (
                    (torch.roll(t, shift, dims=2) if shift else t)
                    .contiguous() for t in kept)))
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
