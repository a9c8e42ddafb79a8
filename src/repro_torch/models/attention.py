"""Grouped-query attention with RoPE (and qk-norm): the prefill forward,
the one-token decode step against a dense KV cache or a paged KV pool,
and the chunked-prefill append the scheduler interleaves with decode
(port of ``repro.models.attention``).

Prefill runs through ``kernels.ops.flash_attention``, dense decode through
``kernels.ops.decode_attention`` and paged decode through
``kernels.ops.paged_decode_attention`` (``_q8`` for int8 pools): the Hopper
kernels for CUDA tensors, their plain PyTorch versions for CPU tensors.
The flash kernel takes K/V with fewer heads than Q, so the reference's GQA
repeat (``attention.py:207``) is never materialized.  The kernels keep the
softmax ``p`` in f32 before P·V, as the TPU kernels do; the reference's
plain jnp paths cast it to the activation dtype first
(``attention.py:88,309``), which only differs below f32.

int8 pools take their entries through ``kernels.ops.quantized_block_write``
(the int8 pool write kernel on the card).  The decode step dequantizes in
f32 on both devices: the reference's CPU route (``_dequantize_gather``,
``attention.py:406``) casts the dequantized K/V to the activation dtype,
but its Pallas kernel and its oracle (``ref.py:66``) stay in f32, and the
port follows the kernel, so the card and the CPU compute one function (the
two differ only below f32).

The chunk append (``attention_chunk_append{,_paged}``) is plain tensor
code on both devices, as the reference's is jnp with no Pallas kernel;
its int8 form attends over ``kernels.ops.dequantize_gather`` (kernel #11
on the card), which keeps the reference's cast to the activation dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, PSpec
from repro_torch.models.layers import NEG_INF, apply_rope, rmsnorm
from repro_torch.serve.blockpool import TRASH_BLOCK


def attention_specs(cfg: ModelConfig) -> dict:
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": PSpec((D, H, Dh), init=f"scaled:{D}"),
        "wk": PSpec((D, KV, Dh), init=f"scaled:{D}"),
        "wv": PSpec((D, KV, Dh), init=f"scaled:{D}"),
        "wo": PSpec((H, Dh, D), init=f"scaled:{H * Dh}"),
    }
    if cfg.qk_norm:
        p["q_norm"] = PSpec((Dh,), init="ones")
        p["k_norm"] = PSpec((Dh,), init="ones")
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] · w [D,heads,Dh] -> [B,S,heads,Dh] (``bsd,dhk->bshk``)."""
    D, heads, Dh = w.shape
    y = x @ w.to(x.dtype).reshape(D, heads * Dh)
    return y.view(*x.shape[:-1], heads, Dh)


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o [B,S,H,Dh] · w [H,Dh,D] -> [B,S,D] (``bshk,hkd->bsd``)."""
    H, Dh, D = w.shape
    return o.reshape(*o.shape[:-2], H * Dh) @ w.to(o.dtype).reshape(H * Dh, D)


def _qkv(x, params, cfg: ModelConfig, positions):
    """Projections + qk-norm + rope; positions broadcast to [B,S]."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm and "q_norm" in params:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(x: torch.Tensor, params: dict, cfg: ModelConfig, *,
              causal: bool = True, return_kv: bool = False):
    """x [B,S,D] -> [B,S,D] at the standard positions 0..S-1 (the only
    layout a prefill or a forward of this slice uses; the flash kernel's
    causal mask compares row and column indices).  ``return_kv`` also
    returns the grouped (k, v) [B,S,KV,Dh] for prefill caching."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(x, params, cfg, positions)
    window = (cfg.sliding_window or 0) if causal else 0
    out, _ = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)
    y = _out_proj(out.transpose(1, 2), params["wo"])
    return (y, (k, v)) if return_kv else y


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
             kv_positions: torch.Tensor, k_new: torch.Tensor,
             v_new: torch.Tensor, pos: torch.Tensor,
             write_idx: torch.Tensor) -> None:
    """In place: row b's entry ``write_idx[b]`` of the caches takes
    (k_new[b], v_new[b], pos[b]).  A write at ``write_idx >= T`` is dropped,
    as JAX drops an out-of-bounds scatter (the engine keeps advancing the
    positions of slots that run past capacity); the write goes through a
    clamped index and a select, so it needs no device-to-host sync."""
    B, T = kv_positions.shape
    ok = (write_idx >= 0) & (write_idx < T)
    idx = write_idx.clamp(0, T - 1).long()
    b = torch.arange(B, device=idx.device)
    keep = ok[:, None, None]
    k_cache[b, idx] = torch.where(keep, k_new.to(k_cache.dtype),
                                  k_cache[b, idx])
    v_cache[b, idx] = torch.where(keep, v_new.to(v_cache.dtype),
                                  v_cache[b, idx])
    kv_positions[b, idx] = torch.where(ok, pos.to(kv_positions.dtype),
                                       kv_positions[b, idx])


def attention_decode(x: torch.Tensor, params: dict, cfg: ModelConfig, *,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_positions: torch.Tensor, pos: torch.Tensor,
                     write_idx: torch.Tensor) -> torch.Tensor:
    """One-token decode against a dense KV cache.

    x [B,1,D]; caches [B,T,KV,Dh]; kv_positions [B,T] int32 (-1 = empty);
    pos [B] int32 absolute position of the new token; write_idx [B] the
    cache entry it lands in.  The new K/V entry is written into the caches
    in place (where the reference returns updated copies) before attending,
    so the token sees itself.  Returns y [B,1,D]."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(x, params, cfg, pos[:, None])
    write_kv(k_cache, v_cache, kv_positions, k_new[:, 0], v_new[:, 0], pos,
             write_idx)
    out = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                               kv_positions, pos,
                               window=cfg.sliding_window or 0)
    return _out_proj(out.view(B, 1, *out.shape[1:]), params["wo"])


def _quantized_block_write(pool: torch.Tensor, scale_pool: torch.Tensor,
                           new: torch.Tensor, write_bids: torch.Tensor,
                           off: torch.Tensor) -> None:
    """In place: quantize the new K or V entries ``new`` [R,KV,Dh] into the
    int8 ``pool`` [N,bs,KV,Dh] at (``write_bids``, ``off``) [R] against the
    per-(block, kv head) ``scale_pool`` [N,KV] (the reference's
    ``_quantized_block_write``, ``attention.py:378``): the int8 pool write
    kernel on the card, ``ref.ref_quantized_block_write`` on the CPU."""
    ops.quantized_block_write([pool], [scale_pool], [new], write_bids, off)


def attention_decode_paged(x: torch.Tensor, params: dict, cfg: ModelConfig,
                           *, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           pos_pool: torch.Tensor, block_table: torch.Tensor,
                           write_bids: torch.Tensor, pos: torch.Tensor,
                           k_scale_pool=None, v_scale_pool=None
                           ) -> torch.Tensor:
    """One-token decode against a paged KV pool.

    x [B,1,D]; pools [N,bs,KV,Dh] and pos_pool [N,bs] shared by every row;
    block_table [B,M] int32 names each row's blocks in order (NULL block 0
    = unused entry); write_bids [B] the block this token's K/V lands in
    (the engine's write plan: the trash block for inactive rows); pos [B]
    the token's absolute position (write offset ``pos % bs``).  The entry
    is written in place before attending, so the token sees itself.
    ``k_scale_pool``/``v_scale_pool`` f32 [N,KV] mark int8 pools: the entry
    is quantized against its block's scale (:func:`_quantized_block_write`)
    and the q8 kernel dequantizes in its loop.  Returns y [B,1,D]."""
    B = x.shape[0]
    bs = k_pool.shape[1]
    q, k_new, v_new = _qkv(x, params, cfg, pos[:, None])
    off = pos % bs
    bids = write_bids.long()
    # An offset-0 write always lands in a fresh block, recycled storage
    # whose stale positions would pass the mask as phantoms: clear its
    # position row before writing into it.
    pos_pool[bids] = pos_pool[bids].masked_fill((off == 0)[:, None], -1)
    if k_scale_pool is not None:
        ops.quantized_block_write([k_pool, v_pool],
                                  [k_scale_pool, v_scale_pool],
                                  [k_new[:, 0], v_new[:, 0]], write_bids, off)
    else:
        k_pool[bids, off.long()] = k_new[:, 0].to(k_pool.dtype)
        v_pool[bids, off.long()] = v_new[:, 0].to(v_pool.dtype)
    pos_pool[bids, off.long()] = pos.to(pos_pool.dtype)
    qd = q[:, 0].contiguous()
    if k_scale_pool is not None:
        out = ops.paged_decode_attention_q8(qd, k_pool, v_pool, k_scale_pool,
                                            v_scale_pool, pos_pool,
                                            block_table, pos)
    else:
        out = ops.paged_decode_attention(qd, k_pool, v_pool, pos_pool,
                                         block_table, pos)
    return _out_proj(out.view(B, 1, *out.shape[1:]), params["wo"])


# ---------------------------------------------------------------------------
# Chunked-prefill append (C tokens against a KV cache; the scheduler's path)
# ---------------------------------------------------------------------------


PAD_POS = 2 ** 30
"""Pad-token position of a chunk (the reference's sentinel).  A chunk is a
fixed [B, C] window; pad tokens carry this position, so their dense cache
writes fall past the cache and are dropped, their paged writes go to the
trash block (the caller's write_bids), RoPE and softmax at this position
stay finite, and their outputs are never read (``last_index``)."""


def _chunk_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_positions: torch.Tensor, q_pos: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """q [B,S,H,Dh] against grouped caches k/v [B,T,KV,Dh] with per-query
    positional masking (the reference's ``_jnp_decode_attend`` with ``pos``
    [B,S], ``attention.py:276``): query s attends to every entry with
    ``0 <= kv_positions <= q_pos[:, s]``, so causality within a chunk
    follows from the mask once the chunk's entries are written.  Scores
    and softmax in f32, ``p`` cast to the activation dtype before P·V, as
    the reference does.  Returns [B,S,H,Dh]."""
    B, S = q.shape[:2]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, S, KV, H // KV, Dh)
    valid = (kv_positions >= 0)[:, None, :]                    # [B,1,T]
    within = kv_positions[:, None, :] <= q_pos[:, :, None]     # [B,S,T]
    mask = (valid & within)[:, None, None]                     # [B,1,1,S,T]
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * Dh ** -0.5
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, S, H, Dh)


def _scatter_rows(cache: torch.Tensor, positions: torch.Tensor,
                  new: torch.Tensor) -> None:
    """In place: ``cache[b, positions[b, j]] = new[b, j]`` for every entry
    with ``0 <= positions < T``; the others are dropped, as JAX drops an
    out-of-bounds scatter.  Without a device-to-host sync: a dropped entry
    writes entry T - 1 with the value that entry ends with (the chunk's own
    entry at T - 1 when it has one, else the current one), so colliding
    writes agree.  cache [B,T,...]; positions [B,C]; new [B,C,...]."""
    B, T = cache.shape[:2]
    ok = (positions >= 0) & (positions < T)
    last = ok & (positions == T - 1)                           # [B,C]
    b = torch.arange(B, device=cache.device)
    tail = torch.where(last.any(1).view(B, *[1] * (new.ndim - 2)),
                       new[b, last.int().argmax(1)],
                       cache[:, T - 1].to(new.dtype))          # [B,...]
    vals = torch.where(ok.view(*ok.shape, *[1] * (new.ndim - 2)), new,
                       tail[:, None])
    idx = torch.where(ok, positions, T - 1).long()
    cache[b[:, None], idx] = vals.to(cache.dtype)


def attention_chunk_append(x: torch.Tensor, params: dict, cfg: ModelConfig,
                           *, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_positions: torch.Tensor,
                           positions: torch.Tensor,
                           reset: torch.Tensor) -> torch.Tensor:
    """Append a prompt chunk to a dense KV cache and attend (the
    reference's ``attention_chunk_append``, ``attention.py:549``).

    x [B,C,D]; caches [B,T,KV,Dh] and kv_positions [B,T] (views of the
    engine's caches: the chunk is written in place); positions [B,C]
    absolute (``PAD_POS`` on pads, whose writes are dropped); reset [B]
    bool clears a row's positions before its first chunk, so a recycled
    slot's stale entries never pass the mask.  The chunk's K/V are written
    before attending.  Non-SWA only (``supports_chunked_prefill``).
    Returns y [B,C,D]."""
    # the reference's _project_chunk_kv (attention.py:534)
    q, k_new, v_new = _qkv(x, params, cfg, positions)
    kv_positions.masked_fill_(reset[:, None], -1)
    _scatter_rows(k_cache, positions, k_new)
    _scatter_rows(v_cache, positions, v_new)
    _scatter_rows(kv_positions, positions, positions)
    out = _chunk_attend(q, k_cache, v_cache, kv_positions, positions, cfg)
    return _out_proj(out, params["wo"])


def attention_chunk_append_paged(x: torch.Tensor, params: dict,
                                 cfg: ModelConfig, *, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 pos_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 write_bids: torch.Tensor,
                                 positions: torch.Tensor,
                                 k_scale_pool=None,
                                 v_scale_pool=None) -> torch.Tensor:
    """Append a prompt chunk to a paged KV pool and attend (the
    reference's ``attention_chunk_append_paged``, ``attention.py:584``).

    x [B,C,D]; pools [N,bs,KV,Dh] and pos_pool [N,bs]; block_table [B,M]
    the chunk owner's chain; write_bids [B,C] each token's destination
    block: the trash block for pads and for prefix-shared blocks (written
    by their first owner).  Offsets are ``positions % bs``; a token at
    offset 0 of a fresh block first clears the block's position row.
    int8 pools (``k_scale_pool``/``v_scale_pool`` f32 [N,KV]) take the
    chunk through the int8 pool write and attend over the dequantized
    gather (kernel #11 on the card) in the activation dtype, as the
    reference does.  Returns y [B,C,D]."""
    B, C = positions.shape
    bs = k_pool.shape[1]
    M = block_table.shape[1]
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    q, k_new, v_new = _qkv(x, params, cfg, positions)
    off = positions % bs
    bids = write_bids.long()
    clear = torch.where(off == 0, bids, torch.full_like(bids, TRASH_BLOCK))
    pos_pool[clear] = -1
    if k_scale_pool is not None:
        ops.quantized_block_write(
            [k_pool, v_pool], [k_scale_pool, v_scale_pool],
            [k_new.reshape(B * C, KV, Dh), v_new.reshape(B * C, KV, Dh)],
            write_bids.reshape(-1), off.reshape(-1))
        k, v = ops.dequantize_gather((k_pool, v_pool),
                                     (k_scale_pool, v_scale_pool),
                                     block_table, x.dtype)
    else:
        k_pool[bids, off.long()] = k_new.to(k_pool.dtype)
        v_pool[bids, off.long()] = v_new.to(v_pool.dtype)
        flat = block_table.reshape(-1).long()
        k = k_pool[flat].reshape(B, M * bs, KV, Dh)
        v = v_pool[flat].reshape(B, M * bs, KV, Dh)
    pos_pool[bids, off.long()] = positions.to(pos_pool.dtype)
    kvp = pos_pool[block_table.reshape(-1).long()].reshape(B, M * bs)
    out = _chunk_attend(q, k, v, kvp, positions, cfg)
    return _out_proj(out, params["wo"])
