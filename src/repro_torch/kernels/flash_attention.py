"""Flash attention forward (prefill) on Hopper: the wrapper of
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:67``
``_attn_kernel`` (reached through ``_forward:112``).  One CUDA block per
(batch, head, 64-row q tile) streams 64-key K/V tiles through shared
memory with an f32 online softmax, skips the tiles past the causal
diagonal and before the sliding window, masks the ragged edges of any S
and T, and emits ``out`` plus the f32 per-row ``lse`` (0 on rows with no
attended key) that the training slice's backward will read.  K/V may have
fewer heads than Q (q head h reads kv head ``h // (H // Hkv)``), so GQA
needs no materialized repeat.  Any q/k/v strides are accepted as long as
the head dim is contiguous; ``out`` takes q's memory layout.

The plain version is ``kernels.ref.ref_attention``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0):
    """q [B,H,S,D]; k/v [B,Hkv,T,D] (Hkv divides H) on one CUDA device, all
    f32 or all bf16 -> (out [B,H,S,D] in q's dtype and layout,
    lse [B,H,S] f32).  ``window > 0`` applies only with ``causal``."""
    global launches
    if not all(t.is_cuda for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes CUDA tensors; "
                         "kernels.ops.flash_attention dispatches CPU "
                         "tensors to the plain version")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,S,D], k/v [B,Hkv,T,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, head groups)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of "
                         f"{list(DTYPES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q/k/v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    if S == 0 or T == 0 or window < 0:
        raise ValueError(f"empty sequence or negative window "
                         f"(S={S}, T={T}, window={window})")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), B, H, Hkv, S, T, D,
                        strides, int(causal), int(window) if causal else 0,
                        DTYPES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, code, "flash_attention launch")
    launches += 1
    return out, lse
