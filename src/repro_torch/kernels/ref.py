"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``).

Each ``ref_*`` computes the same function as its Hopper kernel with plain
tensor ops, in f32, and casts the result to the input dtype.  The kernel
wrappers run these on CPU tensors; ``chip_smoke.py`` and the CUDA tests
hold each kernel against them on the card.  The backward versions
(``ref_attention_bwd``, ``ref_swiglu_ffn_bwd``) are written out as
formulas, not taken from ``torch.autograd``, so that they are an
independent statement of what the backward kernels compute.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, heads: int, axis: int) -> torch.Tensor:
    """Grouped K/V -> one K/V head per q head (q head h reads kv head
    h // (heads // kv_heads), the reference's ``jnp.repeat`` layout)."""
    kv = k.shape[axis]
    if heads % kv:
        raise ValueError(f"{heads} q heads do not group over {kv} kv heads")
    return k.repeat_interleave(heads // kv, dim=axis) if kv != heads else k


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,S,D]; k/v [B,Hkv,T,D] with Hkv dividing H -> (out [B,H,S,D],
    lse [B,H,S] f32).

    Masking compares absolute row/column indices (``kv <= q`` and, with a
    window, ``kv > q - window``); masked scores are -1e30, not -inf, as in
    the reference.  ``lse`` is the log-sum-exp of the scaled scores, the
    residual the flash backward reads."""
    H, S, D = q.shape[1], q.shape[2], q.shape[3]
    T = k.shape[2]
    k = _repeat_kv(k, H, 1).float()
    v = _repeat_kv(v, H, 1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * D ** -0.5
    mask = _attend_mask(S, T, causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, v)
    return out.to(q.dtype), lse


def _attend_mask(S: int, T: int, causal: bool, window: int, device):
    """[S,T] bool, True = attended (None without a causal mask)."""
    if not causal:
        return None
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > (qp - window)
    return mask


def ref_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0):
    """The backward of :func:`ref_attention` from its residuals: q/o/do
    [B,H,S,D], k/v [B,Hkv,T,D], lse [B,H,S] f32 -> (dq, dk, dv) in the
    inputs' dtypes (the reference's ``_backward``,
    ``repro/kernels/flash_attention.py:224``, written out in f32):

        p = exp(s − lse) (0 where masked),  δ = rowsum(dO ⊙ O),
        dS = p ⊙ (dO·Vᵀ − δ),  dQ = dS·K·scale,
        dK = dSᵀ·(Q·scale),  dV = pᵀ·dO,

    with dK/dV of grouped K/V summed over each kv head's H/Hkv q heads."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = D ** -0.5
    qs = q.float() * scale
    kr = _repeat_kv(k, H, 1).float()
    vr = _repeat_kv(v, H, 1).float()
    dof = do.float()
    p = torch.exp(torch.einsum("bhsd,bhtd->bhst", qs, kr) - lse[..., None])
    mask = _attend_mask(S, T, causal, window, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    delta = (dof * o.float()).sum(-1)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dof, vr) - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kr) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qs)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dk = dk.view(B, Hkv, H // Hkv, T, D).sum(2)
    dv = dv.view(B, Hkv, H // Hkv, T, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ref_decode_attention(q, k, v, kv_pos, pos, *, window: int = 0):
    """q [B,H,D]; k/v [B,T,KV,D] (grouped heads, KV divides H);
    kv_pos [B,T] int32 (-1 = empty); pos [B] int32 -> [B,H,D].

    An entry is attended iff ``kv_pos >= 0 and kv_pos <= pos`` (and, with a
    window, ``kv_pos > pos - window``)."""
    B, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} q heads do not group over {KV} kv heads")
    qg = q.float().reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * D ** -0.5
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        valid &= kv_pos > (pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def ref_paged_decode_attention(q, k_pool, v_pool, pos_pool, block_table,
                               pos):
    """q [B,H,D]; k/v pools [N,bs,KV,D]; pos_pool [N,bs] int32 (-1 =
    empty); block_table [B,M] int32; pos [B] int32 -> [B,H,D].

    Gathers each row's M blocks into a contiguous [B, M*bs] cache and runs
    :func:`ref_decode_attention` over it, so a paged cache holding the
    dense cache's entries gives the dense result bit for bit."""
    B, M = block_table.shape
    bs = k_pool.shape[1]
    flat = block_table.reshape(-1).long()
    k = k_pool[flat].reshape(B, M * bs, *k_pool.shape[2:])
    v = v_pool[flat].reshape(B, M * bs, *v_pool.shape[2:])
    kv_pos = pos_pool[flat].reshape(B, M * bs)
    return ref_decode_attention(q, k, v, kv_pos, pos)


def ref_paged_decode_attention_q8(q, k_pool, v_pool, k_scale, v_scale,
                                  pos_pool, block_table, pos):
    """As :func:`ref_paged_decode_attention` over int8 pools with f32
    per-(block, kv head) scales k_scale/v_scale [N,KV]: the gathered blocks
    are dequantized in f32 (int8 x the block's scale) before the dense
    oracle runs."""
    B, M = block_table.shape
    bs = k_pool.shape[1]
    k = dequantize_gather(k_pool, k_scale, block_table)
    v = dequantize_gather(v_pool, v_scale, block_table)
    kv_pos = pos_pool[block_table.reshape(-1).long()].reshape(B, M * bs)
    return ref_decode_attention(q, k, v, kv_pos, pos)


def dequantize_gather(pool, scale, block_table):
    """int8 pool [N,bs,KV,D] with f32 scales [N,KV] -> each row's blocks
    [B, M*bs, KV, D] in f32 (the reference's ``_dequantize_gather``, which
    then casts to the activation dtype; the q8 decode oracle stays in f32,
    as the decode kernel does)."""
    B, M = block_table.shape
    flat = block_table.reshape(-1).long()
    x = pool[flat].float() * scale[flat][:, None, :, None]
    return x.reshape(B, M * pool.shape[1], *pool.shape[2:])


# -- int8 quantization (kernels #10, #11 and the int8 pool's entry write) ----


def _div127(m):
    """``m / 127`` in IEEE f32 division on every device.  (PyTorch's CUDA
    division by a Python scalar multiplies by the rounded reciprocal,
    which lands one ulp off for some values; a tensor divisor divides.)"""
    return m / torch.full_like(m, 127.0)


def ref_quantize_rows(x):
    """x [..., n] -> (q int8 [..., n], scale f32 [...]): max-abs int8 over
    the last axis, ``scale = max|x| / 127`` (0 for an all-zero row, which
    then divides as 1), ``clip(round(x / scale), -127, 127)`` with round
    half to even (``jnp.round``); the reference's ``block_quant``."""
    x = x.float()
    scale = _div127(x.abs().amax(dim=-1))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def ref_quantize_kv_tiles(x, block_size: int, nb: int):
    """Prefill caches x [R,B,T,KV,Dh] -> (q int8 [R,B,nb*bs,KV,Dh], scale
    f32 [R,B,nb,KV]): :func:`ref_quantize_rows` over each (block column,
    kv head) tile [bs, Dh] of the first ``nb * block_size`` entries, the
    entries past T taken as zeros (the int8 pool's admission splice)."""
    x = x.float()[:, :, :nb * block_size]
    short = nb * block_size - x.shape[2]
    if short > 0:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, short))
    R, B, _, KV, Dh = x.shape
    tiles = x.reshape(R, B, nb, block_size, KV, Dh).permute(0, 1, 2, 4, 3, 5)
    q, scale = ref_quantize_rows(tiles.reshape(R, B, nb, KV,
                                               block_size * Dh))
    q = q.reshape(R, B, nb, KV, block_size, Dh).permute(0, 1, 2, 4, 3, 5)
    return q.reshape(R, B, nb * block_size, KV, Dh), scale


def ref_dequantize_rows(q, scale):
    """int8 q [..., n] x f32 scale [...] -> f32 [..., n]: ``q * scale``, the
    reference's ``block_dequant``."""
    return q.float() * scale[..., None]


def ref_dequantize_gather(pool, scale, block_table, dtype):
    """As :func:`dequantize_gather`, rounded once to ``dtype`` afterwards:
    the reference's ``_dequantize_gather`` (``attention.py:406``), which the
    int8 chunk append attends over in the activation dtype."""
    return dequantize_gather(pool, scale, block_table).to(dtype)


def ref_quantized_block_write(pool, scale_pool, new, write_bids, off,
                              trash_block: int = 1) -> None:
    """In place: quantize the new K or V entries ``new`` [R,KV,Dh] into the
    int8 ``pool`` [N,bs,KV,Dh] at (``write_bids``, ``off``) [R] against the
    per-(block, kv head) ``scale_pool`` [N,KV] (max-abs / 127).

    An offset-0 write lands in a fresh (recycled) block, so its stale scale
    is cleared first (rows writing elsewhere clear the trash block instead)
    and its stale payload is zeroed.  A new entry above its block's scale
    grows the scale, and the block's payload is requantized by
    ``round(q * old / new)``.  The reference requantizes the whole pool
    with a ratio that is exactly 1.0 (or 0 over a zero payload) for every
    block it did not clear or write; this touches only the written and
    cleared blocks, with the same result bit for bit.  Rows may repeat a
    block (a chunk's tokens, the trash block): the touched payload is
    gathered before it is scattered back, so each block is requantized
    once.  Rounding is half to even, as ``jnp.round``."""
    new = new.float()
    bids = write_bids.long()
    clear = torch.where(off == 0, bids, torch.full_like(bids, trash_block))
    scale_pool[clear] = 0.0
    touched = torch.cat([bids, clear])
    old = scale_pool[touched]
    need = _div127(new.abs().amax(dim=-1))                # [R, KV]
    scale_pool.scatter_reduce_(0, bids[:, None].expand_as(need), need,
                               "amax")
    grown = scale_pool[touched]
    ones = torch.ones_like(grown)
    ratio = old / torch.where(grown > 0, grown, ones)
    pool[touched] = torch.round(pool[touched].float()
                                * ratio[:, None, :, None]).to(torch.int8)
    dest = grown[:bids.shape[0]]                          # bids' new scales
    safe = torch.where(dest > 0, dest, ones[:bids.shape[0]])
    pool[bids, off.long()] = torch.clamp(torch.round(new / safe[..., None]),
                                         -127, 127).to(torch.int8)


def ref_swiglu_ffn(x, w_gate, w_up, w_down):
    """x [N,D]; w_gate/w_up [D,F]; w_down [F,D] -> [N,D]:
    ``(silu(x·Wg) ⊙ x·Wu)·Wd`` in f32."""
    xf = x.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    return ((torch.nn.functional.silu(g) * u) @ w_down.float()).to(x.dtype)


def ref_swiglu_ffn_grads(x, w_gate, w_up, w_down, dy):
    """The hidden grads of :func:`ref_swiglu_ffn` in f32: x, dy [N,D] ->
    (dg, du, h) [N,F], with g = x·Wg, u = x·Wu, σ = logistic(g) and
    dh = dy·Wdᵀ:

        du = dh·g·σ,  dg = dh·u·(σ + g·σ·(1 − σ)),  h = g·σ·u.

    The bf16 gradient kernel stores these, each rounded once to bf16."""
    xf, dyf = x.float(), dy.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    sg = torch.sigmoid(g)
    silu = g * sg
    dh = dyf @ w_down.float().t()
    return dh * u * (sg + g * sg * (1.0 - sg)), dh * silu, silu * u


def ref_swiglu_ffn_bwd_dw(x, dy, dg, du, h):
    """The weight grads from the hidden grads: x, dy [N,D]; dg, du, h
    [N,F] -> (dw_gate = xᵀ·dg, dw_up = xᵀ·du, dw_down = hᵀ·dy), three f32
    products cast to x's dtype (the bf16 dW kernel's function)."""
    xf, dyf = x.float(), dy.float()
    return ((xf.t() @ dg.float()).to(x.dtype),
            (xf.t() @ du.float()).to(x.dtype),
            (h.float().t() @ dyf).to(x.dtype))


def ref_swiglu_ffn_bwd(x, w_gate, w_up, w_down, dy):
    """The backward of :func:`ref_swiglu_ffn`: x, dy [N,D] -> (dx, dw_gate,
    dw_up, dw_down) in the inputs' dtypes (the reference's ``_backward``,
    ``repro/kernels/fused_ffn.py:159``, written out in f32): with dg, du
    and h from :func:`ref_swiglu_ffn_grads`,

        dx = dg·Wgᵀ + du·Wuᵀ,  dWg = xᵀ·dg,  dWu = xᵀ·du,  dWd = hᵀ·dy."""
    dg, du, h = ref_swiglu_ffn_grads(x, w_gate, w_up, w_down, dy)
    dx = dg @ w_gate.float().t() + du @ w_up.float().t()
    dwg, dwu, dwd = ref_swiglu_ffn_bwd_dw(x.float(), dy, dg, du, h)
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


def ref_mlstm_chunk(q, k, v, i_gate, f_log, C0, n0, m0):
    """Sequential mLSTM (the reference's oracle ``ref_mlstm_chunk``, the
    recurrence of ``models/ssm.py::_mlstm_cell``): q/k/v [B,S,H,dh] (k
    pre-scaled), i_gate/f_log [B,S,H] (f already log-sigmoid), carry
    (C [B,H,dh,dh], n [B,H,dh], m [B,H]) -> (y [B,S,H,dh], (C, n, m)).
    Each step is stabilized by m' = max(f + m, i)."""
    C, n, m = C0, n0, m0
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_gate[:, t], \
            f_log[:, t]
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * torch.einsum(
            "bhv,bhk->bhvk", vt, kt)
        n = f_[..., None] * n + i_[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.einsum("bhk,bhk->bh", n, qt).abs().clamp(min=1.0)
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), (C, n, m)


def _at_least_f32(t):
    """f32 for f32 and narrower floats; f64 stays f64 (the f64 checks)."""
    return t if t.dtype == torch.float64 else t.float()


def _mlstm_entry(state, c: int, carries, like):
    """The carry (C, n, m) entering chunk ``c``: the given ``state`` (or
    zero, m = -inf) for chunk 0, else the forward's kept carry after chunk
    c - 1 (``carries`` = (Cs, ns, ms) [B,H,nc-1,...])."""
    if c > 0:
        return tuple(t[:, :, c - 1] for t in carries)
    if state is not None:
        return tuple(_at_least_f32(t) for t in state[:3])
    B, H, _, dh = like.shape
    return (like.new_zeros(B, H, dh, dh), like.new_zeros(B, H, dh),
            like.new_full((B, H), float("-inf")))


def _mlstm_gates(ic, fc, m0):
    """A chunk's gate statistics from its gates [B,H,L] and entering m
    [B,H]: g = cumsum(f_log), a = i - g, the running max cm of a and its
    arg (the last index on a tie, as ``torch.cummax``), and the row
    stabilizer M = max(cm, m)."""
    g = torch.cumsum(fc, dim=-1)
    a = ic - g
    cm, arg = torch.cummax(a, dim=-1)
    return g, a, cm, arg, torch.maximum(cm, m0[..., None])


def ref_mlstm_scan(q, k, v, i_gate, f_log, *, chunk: int = 256,
                   state=None, keep: bool = False):
    """The chunkwise-parallel mLSTM (``models/ssm.py::_mlstm_chunk``
    scanned over chunks; the function of the Pallas ``_mlstm_kernel``),
    in f32 (f64 inputs stay f64): q/k/v [B,H,S,dh] (k pre-scaled by
    dh^-0.5), i_gate/f_log [B,H,S] (f already log-sigmoid), S a multiple
    of L = min(chunk, S) -> (y [B,H,S,dh], (C [B,H,dh,dh], n [B,H,dh],
    m [B,H])).

    The carry starts at ``state`` = (C, n, m) or at zero (C = 0, n = 0,
    m = -inf).  Per chunk, g = cumsum(f_log), a = i - g and
    M_t = max(m_prev, max_{s<=t} a_s); the causal [L,L] scores q·kᵀ are
    weighted by e^{a_s - M_t}, the carry enters as e^{m_prev - M_t}·q·Cᵀ,
    y = num / max(|den|, 1), and the carry becomes
    C' = Σ_s e^{a_s - M_L} v_s k_sᵀ + e^{m_prev - M_L} C, n' likewise,
    m' = g_L + M_L.

    ``keep`` also returns what the backward reads, (d [B,H,S], Cs
    [B,H,nc-1,dh,dh], ns [B,H,nc-1,dh], ms [B,H,nc-1]): the signed
    denominators before the clamp and the carries entering chunks 1..nc-1
    (nc = S / L)."""
    B, H, S, dh = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    q, k, v, i_gate, f_log = (_at_least_f32(t)
                              for t in (q, k, v, i_gate, f_log))
    C, n, m = _mlstm_entry(state, 0, None, q)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    ys, ds, kept = [], [], []
    for c0 in range(0, S, L):
        if c0:
            kept.append((C, n, m))
        qc, kc, vc = (t[:, :, c0:c0 + L] for t in (q, k, v))
        g, a, _, _, M = _mlstm_gates(i_gate[:, :, c0:c0 + L],
                                     f_log[:, :, c0:c0 + L], m)
        w = torch.exp(a[..., None, :] - M[..., :, None])          # [B,H,L,L]
        scores = torch.where(causal, (qc @ kc.transpose(-1, -2)) * w, 0.0)
        inter = torch.exp(m[..., None] - M)                       # [B,H,L]
        num = scores @ vc + inter[..., None] * (qc @ C.transpose(-1, -2))
        den = scores.sum(-1) + inter * (qc @ n[..., None])[..., 0]
        ys.append(num / den.abs().clamp(min=1.0)[..., None])
        ds.append(den)
        M_L, g_L = M[..., -1], g[..., -1]
        wc = torch.exp(a - M_L[..., None])                        # [B,H,L]
        decay = torch.exp(m - M_L)
        C = (vc * wc[..., None]).transpose(-1, -2) @ kc \
            + decay[..., None, None] * C
        n = (wc[..., None] * kc).sum(-2) + decay[..., None] * n
        m = g_L + M_L
    y = torch.cat(ys, dim=2)
    if not keep:
        return y, (C, n, m)
    if kept:
        Cs, ns, ms = (torch.stack(t, dim=2) for t in zip(*kept))
    else:
        Cs, ns, ms = (q.new_zeros(B, H, 0, dh, dh), q.new_zeros(B, H, 0, dh),
                      q.new_zeros(B, H, 0))
    return y, (C, n, m), (torch.cat(ds, dim=2), Cs, ns, ms)


# The mLSTM scan's backward, written out as the passes its kernels take
# (csrc/mlstm_scan_bwd.cu).  Per chunk, with dnum_t = dy_t / den_t and
# dd_t = -(dy_t·y_t) / den_t · sign(d_t) where |d_t| > 1 (else 0, as
# jnp.maximum's and abs's slopes give), dP_ts = dnum_t·v_s + dd_t on
# s <= t, P = W ⊙ S, W_ts = e^{a_s - M_t}, S = q·kᵀ:
#
#   dv = Pᵀ·dnum, dq = (dP ⊙ W)·k, dk = (dP ⊙ W)ᵀ·q, da_s += Σ_t dP_ts P_ts;
#   the carry in: dq += ι_t (C₀ᵀ dnum_t + dd_t n₀), ι_t = e^{m₀ - M_t},
#   dC₀ += Σ_t ι_t dnum_t q_tᵀ, dn₀ += Σ_t ι_t dd_t q_t, dm₀ += Σ_t
#   q_t·(that dq term);
#   the carry out, wc_s = e^{a_s - M_L}, decay = e^{m₀ - M_L}: dk_s +=
#   wc_s (dC₁ᵀ v_s + dn₁), dv_s += wc_s dC₁ k_s, da_s += wc_s k_s·(dC₁ᵀ v_s
#   + dn₁), dC₀ += decay dC₁, dn₀ += decay dn₁, dm₀ += decay (<dC₁, C₀> +
#   dn₁·n₀), dM_L -= that and Σ_s wc_s (…), m₁ = g_L + M_L: dg_L += dm₁,
#   dM_L += dm₁.
#
# The stabilizer's own gradient: W and ι send dM_t = -(dnum_t·num_t +
# dd_t d_t), which is 0 where |d_t| > 1 (num and d both scale by e^{-M_t}
# and y = num / |d| does not) and -(dy_t·y_t) where the clamp makes y =
# num.  It is taken in that closed form (``ref_mlstm_bwd_rows``): where
# |d_t| > 1 the reference's dM is rounding noise around 0, here exactly 0.
# dM_t then goes to the argmax of max(m₀, cummax a), the chunk's da to
# di = da, dg = -da, and df_log is the reverse cumsum of dg in the chunk.


def ref_mlstm_bwd_rows(y, d, dy):
    """Per row, from y [B,H,S,dh], the signed denominators d [B,H,S] and
    dy: (rden = 1 / max(|d|, 1), dd = -(dy·y)·rden·sign(d) where |d| > 1
    else 0, dM = -(dy·y) where |d| <= 1 else 0: the row's own stabilizer
    gradient)."""
    dyy = (dy * y).sum(-1)
    big = d.abs() > 1.0
    rden = 1.0 / d.abs().clamp(min=1.0)
    zero = torch.zeros_like(dyy)
    return (rden, torch.where(big, -dyy * rden * torch.sign(d), zero),
            torch.where(big, zero, -dyy))


def ref_mlstm_bwd_carry(q, i_gate, f_log, dy, rden, dd, *, chunk: int,
                        state, carries, dC=None, dn=None):
    """The reverse walk of the carry's grads: from (dC, dn) of the final
    carry (None: zero), dC₀ = decay·dC₁ + Σ_t ι_t rden_t dy_t q_tᵀ and
    dn₀ = decay·dn₁ + Σ_t ι_t dd_t q_t chunk by chunk.  Returns (dCs
    [B,H,nc-1,dh,dh], dns [B,H,nc-1,dh]: the grads of the carries leaving
    chunks 0..nc-2; dC_state, dn_state: those entering chunk 0; ddec
    [B,H,nc]: <dC₁, C₀> + dn₁·n₀ of each chunk, the decay's grad over
    decay)."""
    B, H, S, dh = q.shape
    L = min(chunk, S)
    nc = S // L
    G = q.new_zeros(B, H, dh, dh) if dC is None else dC
    gn = q.new_zeros(B, H, dh) if dn is None else dn
    dCs, dns, ddec = [None] * (nc - 1), [None] * (nc - 1), [None] * nc
    for c in reversed(range(nc)):
        sl = slice(c * L, (c + 1) * L)
        C0, n0, m0 = _mlstm_entry(state, c, carries, q)
        _, _, _, _, M = _mlstm_gates(i_gate[:, :, sl], f_log[:, :, sl], m0)
        ddec[c] = (G * C0).sum((-2, -1)) + (gn * n0).sum(-1)
        iota = torch.exp(m0[..., None] - M)                      # [B,H,L]
        decay = torch.exp(m0 - M[..., -1])
        qc = q[:, :, sl]
        G = decay[..., None, None] * G + (
            dy[:, :, sl] * (iota * rden[:, :, sl])[..., None]
        ).transpose(-1, -2) @ qc
        gn = decay[..., None] * gn + (
            (iota * dd[:, :, sl])[..., None] * qc).sum(-2)
        if c:
            dCs[c - 1], dns[c - 1] = G, gn
    if nc > 1:
        dCs, dns = torch.stack(dCs, dim=2), torch.stack(dns, dim=2)
    else:
        dCs, dns = q.new_zeros(B, H, 0, dh, dh), q.new_zeros(B, H, 0, dh)
    return dCs, dns, G, gn, torch.stack(ddec, dim=-1)


def ref_mlstm_bwd_chunk(q, k, v, i_gate, f_log, dy, rden, dd, dCs, dns, *,
                        chunk: int, state, carries, dC=None, dn=None):
    """Every chunk at once, from its entering carry (the forward's) and
    the grads of the carry leaving it (``ref_mlstm_bwd_carry``'s; the
    last chunk's are dC, dn, None: zero).  Returns (dq, dk, dv [B,H,S,dh];
    dA [B,H,S]: Σ_t dP_ts P_ts, the a_s grad through the scores; dwc
    [B,H,S]: k_s·(dC₁ᵀ v_s + dn₁), the grad of wc_s; inter [B,H,S]: q_t·
    ι_t(C₀ᵀ dnum_t + dd_t n₀), row t's share of dm₀ through ι_t)."""
    B, H, S, dh = q.shape
    L = min(chunk, S)
    nc = S // L
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    outs = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, dyc = (t[:, :, sl] for t in (q, k, v, dy))
        C0, n0, m0 = _mlstm_entry(state, c, carries, q)
        _, a, _, _, M = _mlstm_gates(i_gate[:, :, sl], f_log[:, :, sl], m0)
        W = torch.where(causal, torch.exp(a[..., None, :] - M[..., :, None]),
                        0.0)
        P = W * (qc @ kc.transpose(-1, -2))
        dnum = dyc * rden[:, :, sl, None]
        dP = torch.where(causal, dnum @ vc.transpose(-1, -2)
                         + dd[:, :, sl, None], 0.0)
        dS = dP * W
        dq = dS @ kc
        dk = dS.transpose(-1, -2) @ qc
        dv = P.transpose(-1, -2) @ dnum
        dA = (dP * P).sum(-2)
        iota = torch.exp(m0[..., None] - M)
        dqi = iota[..., None] * (dnum @ C0) \
            + (iota * dd[:, :, sl])[..., None] * n0[:, :, None]
        dq = dq + dqi
        inter = (qc * dqi).sum(-1)
        if c + 1 < nc or dC is not None or dn is not None:
            G = dCs[:, :, c] if c + 1 < nc else (
                q.new_zeros(B, H, dh, dh) if dC is None else dC)
            gn = dns[:, :, c] if c + 1 < nc else (
                q.new_zeros(B, H, dh) if dn is None else dn)
            wc = torch.exp(a - M[..., -1:])[..., None]             # [B,H,L,1]
            X = vc @ G + gn[:, :, None]
            dk = dk + wc * X
            dv = dv + wc * (kc @ G.transpose(-1, -2))
            dwc = (kc * X).sum(-1)
        else:
            dwc = torch.zeros_like(dA)
        outs.append((dq, dk, dv, dA, dwc, inter))
    return tuple(torch.cat(t, dim=2) for t in zip(*outs))


def ref_mlstm_bwd_gates(i_gate, f_log, dA, dwc, inter, dM, ddec, *,
                        chunk: int, state, carries, dm=None):
    """The sequential pass over the gates, chunks in reverse: per chunk
    da_s = dA_s + wc_s dwc_s; dM_t = the row's own (``ref_mlstm_bwd_rows``)
    and, at t = L-1, dm₁ - Σ_s wc_s dwc_s - decay·ddec; dm₀ = Σ_t inter_t +
    decay·ddec (0 where m₀ = -inf) and each dM_t goes to m₀ or to the
    argmax a_s of max(m₀, cummax a) (half each on a tie, as jnp.maximum
    splits it); di = da, dg = -da (+ dm₁ at L-1), df_log = reverse
    cumsum of dg.  The chunk's dm₀ is the previous chunk's dm₁.  Returns
    (di, df [B,H,S], dm_state [B,H])."""
    B, H, S = i_gate.shape
    L = min(chunk, S)
    nc = S // L
    dm1 = i_gate.new_zeros(B, H) if dm is None else dm
    dis, dfs = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        sl = slice(c * L, (c + 1) * L)
        m0 = carries[2][:, :, c - 1] if c else (
            i_gate.new_full((B, H), float("-inf")) if state is None
            else _at_least_f32(state[2]))
        _, a, cm, arg, M = _mlstm_gates(i_gate[:, :, sl], f_log[:, :, sl], m0)
        wc = torch.exp(a - M[..., -1:])
        decay = torch.exp(m0 - M[..., -1])
        wdw = wc * dwc[:, :, sl]
        da = dA[:, :, sl] + wdw
        dMc = dM[:, :, sl].clone()
        dMc[..., -1] += dm1 - wdw.sum(-1) - decay * ddec[..., c]
        finite = m0 > float("-inf")
        dm0 = torch.where(finite,
                          inter[:, :, sl].sum(-1) + decay * ddec[..., c],
                          torch.zeros_like(m0))
        to_m = (m0[..., None] > cm).to(dMc.dtype) \
            + 0.5 * (m0[..., None] == cm).to(dMc.dtype)
        dm0 = dm0 + (dMc * to_m).sum(-1)
        da = da.scatter_add(-1, arg, dMc * (1.0 - to_m))
        dg = -da
        dg[..., -1] += dm1
        dis[c] = da
        dfs[c] = torch.flip(torch.cumsum(torch.flip(dg, [-1]), -1), [-1])
        dm1 = dm0
    return torch.cat(dis, dim=-1), torch.cat(dfs, dim=-1), dm1


def ref_mlstm_scan_bwd(q, k, v, i_gate, f_log, y, kept, dy, *,
                       chunk: int = 256, state=None, dC=None, dn=None,
                       dm=None):
    """The backward of ``ref_mlstm_scan`` from its inputs, its y and what
    ``keep=True`` returned (``kept`` = (d, Cs, ns, ms)), given dy and the
    final carry's grads (dC, dn, dm; None: zero): (dq, dk, dv, di, df,
    dC_state, dn_state, dm_state), the last three None without a
    ``state``.  The passes of the kernels: the row scalars, the carry's
    reverse walk, every chunk at once, the gates' sequential pass."""
    d, Cs, ns, ms = kept
    carries = (Cs, ns, ms)
    rden, dd, dM = ref_mlstm_bwd_rows(y, d, dy)
    kw = dict(chunk=chunk, state=state, carries=carries)
    dCs, dns, dC0, dn0, ddec = ref_mlstm_bwd_carry(
        q, i_gate, f_log, dy, rden, dd, dC=dC, dn=dn, **kw)
    dq, dk, dv, dA, dwc, inter = ref_mlstm_bwd_chunk(
        q, k, v, i_gate, f_log, dy, rden, dd, dCs, dns, dC=dC, dn=dn, **kw)
    di, df, dm0 = ref_mlstm_bwd_gates(i_gate, f_log, dA, dwc, inter, dM,
                                      ddec, dm=dm, **kw)
    if state is None:
        dC0 = dn0 = dm0 = None
    return dq, dk, dv, di, df, dC0, dn0, dm0


def ref_ssm_scan(dt, B_ssm, C_ssm, x, A, h0=None):
    """The Mamba selective scan (the function of the Pallas
    ``_ssm_kernel``; the reference's oracle ``ref_mamba_chunk_scan`` with
    its gates built step by step): dt [B,S,Di] (softplus'd), x [B,S,Di]
    (the conv branch), B_ssm/C_ssm [B,S,N], A [Di,N] (negative), all read
    in f32; h0 [B,Di,N] starts the state (default zero) ->
    (y [B,S,Di] f32, h [B,Di,N] f32), with

        a_t = exp(dt_t·A),  b_t = (dt_t·x_t)·B_t,
        h_t = a_t·h_{t-1} + b_t,  y_t = Σ_n C_t[n]·h_t[:, n].

    Sequential in time, one [B,Di,N] state at a time: the [B,S,Di,N]
    gates never exist."""
    Bt, S, Di = dt.shape
    dt, x, Bs, Cs, A = (t.float() for t in (dt, x, B_ssm, C_ssm, A))
    h = (dt.new_zeros(Bt, Di, A.shape[-1]) if h0 is None
         else h0.float().clone())
    bx = dt * x
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + bx[:, t, :, None] * Bs[:, t, None, :]
        ys.append(torch.einsum("bn,ben->be", Cs[:, t], h))
    return (torch.stack(ys, dim=1) if ys else dt.new_zeros(Bt, 0, Di)), h
