"""Single-token flash-decode attention on Hopper: the wrapper of
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:28``
``_decode_kernel`` (reached through ``decode_attention:72``).  One CUDA
block per (batch row, kv head) loops over the [T] cache in 64-entry tiles
with an f32 online softmax; the G = H / KV q heads of the kv head share
each K/V tile staged in shared memory.  The mask is the reference's:
``kv_pos >= 0 and kv_pos <= pos`` (and ``kv_pos > pos - window`` with a
window), so empty entries (``kv_pos = -1``) are never attended.

B × KV blocks under-fill a 132-SM card at serving batch sizes; splitting T
across blocks with a combine pass is the planned optimisation (PERF.md).

The plain version is ``kernels.ref.ref_decode_attention``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 1024   # G * D outputs per block (8 per thread)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q [B,H,D]; k/v [B,T,KV,D] (KV divides H); kv_pos [B,T] int32
    (-1 = empty); pos [B] int32; all contiguous on one CUDA device, q/k/v
    all f32 or all bf16 -> [B,H,D] in q's dtype."""
    global launches
    ts = (q, k, v, kv_pos, pos)
    if not all(t.is_cuda for t in ts):
        raise ValueError("decode_attention kernel takes CUDA tensors; "
                         "kernels.ops.decode_attention dispatches CPU "
                         "tensors to the plain version")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,D], k/v [B,T,KV,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, head groups)")
    if tuple(kv_pos.shape) != (B, T) or tuple(pos.shape) != (B,):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / pos "
                         f"{tuple(pos.shape)} must be [B,T] / [B]")
    if kv_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("kv_pos and pos must be int32")
    if T == 0 or not 0 < D <= MAX_HEAD_DIM or (H // KV) * D > MAX_GROUP_WIDTH:
        raise ValueError(f"unsupported decode shape T={T} D={D} "
                         f"G={H // KV} (D <= {MAX_HEAD_DIM}, "
                         f"G*D <= {MAX_GROUP_WIDTH})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("decode inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention needs contiguous inputs")
    if window < 0:
        raise ValueError(f"negative window {window}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
                        B, H, KV, T, D, int(window), DTYPES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, code, "decode_attention launch")
    launches += 1
    return out
