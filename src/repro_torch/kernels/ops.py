"""Kernel dispatch by device, and the kernels' launch counters.

Each public op takes the Hopper kernel for CUDA tensors and its plain
PyTorch version (``kernels.ref``) for CPU tensors; there is no other
switch and no fallback: a CUDA tensor the kernel does not take raises.
Every kernel wrapper counts its own launches (a plain int on its module);
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ffn as _ffn
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

# kernel name -> (wrapper module, its launch counter attribute)
KERNELS = {_fa.NAME: (_fa, "launches"), _ffn.NAME: (_ffn, "launches"),
           _da.NAME: (_da, "launches"), _pa.NAME: (_pa, "launches"),
           _pa.NAME_Q8: (_pa, "launches_q8")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,S,D]; k/v [B,Hkv,T,D] -> (out [B,H,S,D], lse [B,H,S])."""
    if q.device.type == "cpu":
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def swiglu_ffn(x, w_gate, w_up, w_down):
    """x [N,D]; w_gate/w_up [D,F]; w_down [F,D] -> [N,D]."""
    if x.device.type == "cpu":
        return ref.ref_swiglu_ffn(x, w_gate, w_up, w_down)
    return _ffn.swiglu_ffn(x, w_gate, w_up, w_down)


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
