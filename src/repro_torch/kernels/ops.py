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
from repro_torch.kernels import ref

KERNELS = {_fa.NAME: _fa, _ffn.NAME: _ffn, _da.NAME: _da}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


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
