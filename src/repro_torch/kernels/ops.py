"""Kernel dispatch by device, and the kernels' launch counters.

Each public op takes the Hopper kernel for CUDA tensors and its plain
PyTorch version (``kernels.ref``) for CPU tensors; there is no other
switch and no fallback: a CUDA tensor the kernel does not take raises.
Every kernel wrapper counts its own launches (a plain int on its module);
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them, so a
run can show that its main path went through the kernels.

The differentiable ops ``flash_attention`` and ``swiglu_ffn`` are
``torch.autograd.Function``s (``FlashAttention``, ``SwiGLUFFN``) in place
of the reference's ``jax.custom_vjp``: their forward and backward both
dispatch by device, to the forward and backward kernels on the card and to
the plain forward and backward (``ref_attention_bwd``,
``ref_swiglu_ffn_bwd``) on the CPU.  As in the reference, flash attention
saves (q, k, v, out, lse) and the FFN (x, w_gate, w_up, w_down): nothing
[S, T]- or [N, F]-shaped.  Without grad (serving) they are the plain
forward calls they were: the Functions are entered only when an input
needs a gradient.  So is ``mlstm_scan`` (``MLSTMScan``), where the
reference differentiates its jnp chunk math: the port's backward is
written by hand, the kernels ``mlstm_scan_bwd`` on the card and their
plain passes (``ref_mlstm_scan_bwd``) on the CPU, and its forward keeps
what that backward reads (the denominators and the carry entering every
chunk) only while a gradient is taken.  So is the Mamba selective scan
(``SSMChunkScan``): the reference has no Pallas backward for it either,
and the port's is kernel #12b, ``ssm_scan_bwd`` on the card and its plain
version ``ref_ssm_scan_bwd`` on the CPU, fed the states the forward keeps
at each chunk start while a gradient is taken.  The int8 ops (kernels #10 and
#11 and the int8 pool's entry write) are bit for bit: their plain
versions and kernels round the same f32 values the same way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ffn as _ffn
from repro_torch.kernels import mlstm_scan as _ml
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quant as _qt
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm

# kernel name -> (wrapper module, its launch counter attribute)
KERNELS = {_fa.NAME: (_fa, "launches"), _ffn.NAME: (_ffn, "launches"),
           _da.NAME: (_da, "launches"), _pa.NAME: (_pa, "launches"),
           _pa.NAME_Q8: (_pa, "launches_q8"),
           _fa.NAME_BWD_DQ: (_fa, "launches_dq"),
           _fa.NAME_BWD_DKV: (_fa, "launches_dkv"),
           _ffn.NAME_BWD_DX: (_ffn, "launches_dx"),
           _ffn.NAME_BWD_DW: (_ffn, "launches_dw"),
           _ml.NAME: (_ml, "launches"),
           _ml.NAME_BWD: (_ml, "launches_bwd"),
           _qt.NAME_QUANT: (_qt, "launches_quant"),
           _qt.NAME_DEQUANT: (_qt, "launches_dequant"),
           _qt.NAME_WRITE: (_qt, "launches_write"),
           _ssm.NAME: (_ssm, "launches"),
           _ssm.NAME_BWD: (_ssm, "launches_bwd")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def _flash_fwd(q, k, v, causal: bool, window: int):
    if q.device.type == "cpu":
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def _ffn_fwd(x, w_gate, w_up, w_down):
    if x.device.type == "cpu":
        return ref.ref_swiglu_ffn(x, w_gate, w_up, w_down)
    return _ffn.swiglu_ffn(x, w_gate, w_up, w_down)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its flash backward (the reference's
    ``_flash`` custom_vjp).  ``lse`` is an output the backward reads, not
    a differentiable one."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = ref.ref_attention_bwd(q, k, v, out, lse, dout,
                                          causal=ctx.causal,
                                          window=ctx.window)
        else:
            grads = _fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                            causal=ctx.causal,
                                            window=ctx.window)
        return (*grads, None, None)


class SwiGLUFFN(torch.autograd.Function):
    """Fused SwiGLU FFN with its recomputing backward (the reference's
    ``_swiglu`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _ffn_fwd(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            return ref.ref_swiglu_ffn_bwd(x, w_gate, w_up, w_down, dy)
        return _ffn.swiglu_ffn_bwd(x, w_gate, w_up, w_down, dy)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,S,D]; k/v [B,Hkv,T,D] -> (out [B,H,S,D], lse [B,H,S]);
    differentiable in q, k and v."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    return _flash_fwd(q, k, v, causal, window)


def swiglu_ffn(x, w_gate, w_up, w_down):
    """x [N,D]; w_gate/w_up [D,F]; w_down [F,D] -> [N,D]; differentiable
    in all four."""
    if _needs_grad(x, w_gate, w_up, w_down):
        return SwiGLUFFN.apply(x, w_gate, w_up, w_down)
    return _ffn_fwd(x, w_gate, w_up, w_down)


def decode_attention(q, k, v, kv_pos, pos, *, window: int = 0):
    """q [B,H,D]; k/v [B,T,KV,D]; kv_pos [B,T]; pos [B] -> [B,H,D]."""
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, kv_pos, pos, window=window)
    return _da.decode_attention(q, k, v, kv_pos, pos, window=window)


def paged_decode_attention(q, k_pool, v_pool, pos_pool, block_table, pos):
    """q [B,H,D]; k/v pools [N,bs,KV,D]; pos_pool [N,bs]; block_table
    [B,M]; pos [B] -> [B,H,D]."""
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention(q, k_pool, v_pool, pos_pool,
                                              block_table, pos)
    return _pa.paged_decode_attention(q, k_pool, v_pool, pos_pool,
                                      block_table, pos)


def paged_decode_attention_q8(q, k_pool, v_pool, k_scale, v_scale, pos_pool,
                              block_table, pos):
    """As ``paged_decode_attention`` over int8 pools with f32 [N,KV]
    scales."""
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention_q8(
            q, k_pool, v_pool, k_scale, v_scale, pos_pool, block_table, pos)
    return _pa.paged_decode_attention_q8(q, k_pool, v_pool, k_scale, v_scale,
                                         pos_pool, block_table, pos)


def _mlstm_fwd(q, k, v, i_gate, f_log, chunk: int, state, keep: bool):
    if q.device.type == "cpu":
        return ref.ref_mlstm_scan(q, k, v, i_gate, f_log, chunk=chunk,
                                  state=state, keep=keep)
    return _ml.mlstm_scan(q, k, v, i_gate, f_log, chunk=chunk, state=state,
                          keep=keep)


class MLSTMScan(torch.autograd.Function):
    """The chunkwise mLSTM with its backward written by hand (the
    reference takes ``jax.grad`` of its jnp chunk scan).  Saves the
    inputs, y, the signed denominators and the carries entering chunks
    1..nc-1; the final carry (C, n, m) is differentiable too.  The state
    arguments are None for a scan from zero."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_log, C0, n0, m0, chunk: int):
        state = None if C0 is None else (C0, n0, m0)
        y, (C, n, m), kept = _mlstm_fwd(q, k, v, i_gate, f_log, chunk,
                                        state, keep=True)
        ctx.save_for_backward(q, k, v, i_gate, f_log, y, *kept,
                              *(state or ()))
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, C, n, m

    @staticmethod
    def backward(ctx, dy, dC, dn, dm):
        q, k, v, i_gate, f_log, y, *rest = ctx.saved_tensors
        kept, state = tuple(rest[:4]), (tuple(rest[4:]) or None)
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        dC, dn, dm = (None if t is None else t.contiguous()
                      for t in (dC, dn, dm))
        bwd = (ref.ref_mlstm_scan_bwd if q.device.type == "cpu"
               else _ml.mlstm_scan_bwd)
        grads = bwd(q, k, v, i_gate, f_log, y, kept, dy, chunk=ctx.chunk,
                    state=state, dC=dC, dn=dn, dm=dm)
        return (*grads, None)


def mlstm_scan(q, k, v, i_gate, f_log, *, chunk: int = 256, state=None):
    """q/k/v [B,H,S,dh] (k pre-scaled); i_gate/f_log [B,H,S], f32 ->
    (y [B,H,S,dh], (C, n, m)) with the final carry; ``state`` starts the
    carry (default zero).  Differentiable in every input and the state
    (``MLSTMScan``)."""
    state = None if state is None else tuple(state[:3])
    if _needs_grad(q, k, v, i_gate, f_log, *(state or ())):
        y, C, n, m = MLSTMScan.apply(q, k, v, i_gate, f_log,
                                     *(state or (None,) * 3), chunk)
        return y, (C, n, m)
    return _mlstm_fwd(q, k, v, i_gate, f_log, chunk, state, keep=False)


def _ssm_fwd(dt, B_ssm, C_ssm, x, A, h0, chunk: int, keep: bool):
    if dt.device.type == "cpu":
        return ref.ref_ssm_scan(dt, B_ssm, C_ssm, x, A, h0, chunk=chunk,
                                keep=keep)
    return _ssm.ssm_scan(dt, B_ssm, C_ssm, x, A, h0, chunk=chunk, keep=keep)


class SSMChunkScan(torch.autograd.Function):
    """The Mamba selective scan with its backward written by hand (the
    reference takes ``jax.grad`` of its jnp chunk scan): the forward runs
    #12 keeping the state entering each ``chunk``-step chunk and saves
    the inputs and those states; the backward is #12b on the card,
    ``ref_ssm_scan_bwd`` on the CPU.  The final state h is differentiable
    too.  ``h0`` is None for a scan from zero."""

    @staticmethod
    def forward(ctx, dt, B_ssm, C_ssm, x, A, h0, chunk: int):
        y, h, states = _ssm_fwd(dt, B_ssm, C_ssm, x, A, h0, chunk, keep=True)
        ctx.save_for_backward(dt, B_ssm, C_ssm, x, A, states)
        ctx.chunk, ctx.from_state = chunk, h0 is not None
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, B_ssm, C_ssm, x, A, states = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        bwd = (ref.ref_ssm_scan_bwd if dt.device.type == "cpu"
               else _ssm.ssm_scan_bwd)
        ddt, dx, dB, dC, dA, dh0 = bwd(
            dt, B_ssm, C_ssm, x, A, states[:, 0] if ctx.from_state else None,
            states, dy, dh=dh, chunk=ctx.chunk)
        return ddt, dB, dC, dx, dA, dh0, None


def ssm_chunk_scan(dt, B_ssm, C_ssm, x, A, *, h0=None, chunk: int = 256):
    """The Mamba selective scan: dt [B,S,Di] f32 (softplus'd), B_ssm/C_ssm
    [B,S,N] and x [B,S,Di] in the activation dtype, A [Di,N] f32 ->
    (y [B,S,Di] f32, h [B,Di,N] f32) with the final state; ``h0`` starts
    the state (default zero).  Differentiable in every input and h0
    (``SSMChunkScan``, whose backward rebuilds the states from one kept
    every ``chunk`` steps); without a gradient it is the serving path's
    plain call."""
    if _needs_grad(dt, B_ssm, C_ssm, x, A, *(() if h0 is None else (h0,))):
        return SSMChunkScan.apply(dt, B_ssm, C_ssm, x, A, h0, chunk)
    return _ssm_fwd(dt, B_ssm, C_ssm, x, A, h0, chunk, keep=False)


def quantize_int8(x):
    """x [nb, n] f32 -> (q int8 [nb, n], scale f32 [nb]): max-abs int8 per
    row (the reference's ``quantize_int8``)."""
    if x.device.type == "cpu":
        return ref.ref_quantize_rows(x)
    return _qt.quantize_rows(x)


def quantize_kv_tiles(x, block_size: int, nb: int):
    """Prefill caches x [R,B,T,KV,Dh] -> (q int8 [R,B,nb*bs,KV,Dh], scale
    f32 [R,B,nb,KV]), one max-abs scale per (block column, kv head) tile
    (the int8 pool's admission splice).  ``x`` may also be a pair (K and
    V): a pair of results, from one launch on the card."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            return ref.ref_quantize_kv_tiles(x, block_size, nb)
        return _qt.quantize_rows(x.contiguous(), block_size=block_size,
                                 nb=nb)
    if x[0].device.type == "cpu":
        return tuple(ref.ref_quantize_kv_tiles(t, block_size, nb) for t in x)
    return _qt.quantize_rows(tuple(t.contiguous() for t in x),
                             block_size=block_size, nb=nb)


def dequantize_int8(q, scale):
    """int8 q [nb, n] x f32 scale [nb] -> f32 [nb, n] (the reference's
    ``dequantize_int8``)."""
    if q.device.type == "cpu":
        return ref.ref_dequantize_rows(q, scale)
    return _qt.dequantize_rows(q, scale)


def dequantize_gather(pool, scale, block_table, dtype):
    """int8 pool [N,bs,KV,Dh], f32 scales [N,KV], block_table [B,M] ->
    each row's blocks [B, M*bs, KV, Dh] dequantized in f32 and rounded to
    ``dtype`` (the reference's ``_dequantize_gather``).  ``pool`` and
    ``scale`` may also be pairs (K and V): a pair of results, from one
    launch on the card."""
    if isinstance(pool, torch.Tensor):
        if pool.device.type == "cpu":
            return ref.ref_dequantize_gather(pool, scale, block_table, dtype)
    elif pool[0].device.type == "cpu":
        return tuple(ref.ref_dequantize_gather(p, s, block_table, dtype)
                     for p, s in zip(pool, scale))
    return _qt.dequantize_rows(pool, scale, block_table, dtype)


def quantized_block_write(pools, scale_pools, news, write_bids, off) -> None:
    """In place, for each leaf i (K and V, or one of them): quantize
    ``news[i]`` [R,KV,Dh] into the int8 pool ``pools[i]`` [N,bs,KV,Dh] at
    (``write_bids``, ``off``) [R] against its per-(block, kv head) scales
    ``scale_pools[i]`` [N,KV] (``ref.ref_quantized_block_write``)."""
    if write_bids.device.type == "cpu":
        for pool, scale, new in zip(pools, scale_pools, news):
            ref.ref_quantized_block_write(pool, scale, new, write_bids, off)
        return
    _qt.quantized_block_write(pools, scale_pools, news,
                              write_bids.to(torch.int32),
                              off.to(torch.int32))
