"""Flash attention on Hopper: the wrappers of ``csrc/flash_attention.cu``
(forward: prefill and training) and ``csrc/flash_attention_bwd.cu``
(backward: training).

Replaces the TPU kernel ``repro/kernels/flash_attention.py:67``
``_attn_kernel`` (reached through ``_forward:112``).  The route is chosen
from the dtype and the head dim (:func:`route`), with no fallback:

* bf16 at head dims 64 and 128 (every model path on the card) runs on the
  tensor cores: one block per 64-row q tile, head and batch, two blocks an
  SM, K/V tiles streamed by TMA through a shared-memory ring, S = Q·Kᵀ and
  P·V on wgmma with the online softmax in registers and P cast to bf16 in
  place.  Its TMA loads need every stride but the head dim's a multiple of
  8 elements and 16-byte aligned tensors; another layout raises (it is
  never copied).
* f32 (the parity checks) and bf16 at head dims 16, 32 and 256 run the
  first SIMT version: one block per (batch, head, 64-row q tile), 64-key
  K/V tiles in shared memory, an f32 online softmax.

Both skip the tiles past the causal diagonal and before the sliding
window, mask the ragged edges of any S and T, and emit ``out`` plus the
f32 per-row ``lse`` (0 on rows with no attended key) that the backward
reads.  K/V may have fewer heads than Q (q head h reads kv head
``h // (H // Hkv)``), so GQA needs no materialized repeat.  Strided q/k/v
are taken as they are as long as the head dim is contiguous; ``out``
takes q's memory layout.

The backward (:func:`flash_attention_bwd`) replaces the TPU kernels
``repro/kernels/flash_attention.py:145`` ``_bwd_dq_kernel`` and ``:180``
``_bwd_dkv_kernel`` (reached through ``_backward:224``): the dq kernel
(one block per batch, head and 64-row q tile) also writes ``delta =
rowsum(dO ⊙ O)`` for the dkv kernel (one block per batch, kv head and
64-key tile, looping over the kv head's q heads, so grouped dK/dV are
summed in f32 inside the block, without atomics).  Both recompute ``p =
exp(s − lse)`` from the forward's lse, with p = 0 where the forward
masked.  :func:`route_bwd` picks them as :func:`route` picks the forward:
bf16 at head dims 64 and 128 on the tensor cores (TMA loads of
q/k/v/dO, wgmma products, P and dS rounded to bf16 as register A; dO is
copied when TMA cannot load it as it lies), f32 and bf16 at 16, 32 and
256 on the SIMT kernels.  At head dim 256 (gemma-2b) the SIMT kernels
take tiles of 32 q rows / keys instead of 64: four f32 [64][257] tiles
would need 263 KB of shared memory, past the 227 KB a block may use, and
at 32 rows they need 132-140 KB, with dK / dV 32 f32 registers a thread
each.

The plain versions are ``kernels.ref.ref_attention`` and
``ref_attention_bwd``; ``kernels.ops`` dispatches between them and the
kernels by device, the backward through ``ops.FlashAttention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
NAME_BWD_DQ = "flash_attention_bwd_dq"
NAME_BWD_DKV = "flash_attention_bwd_dkv"
BWD_LIB = "flash_attention_bwd"
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128)            # bf16 on the tensor cores
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)   # the backward's
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Forward kernel launches (either route) since the last
``ops.reset_launch_counts()``."""
launches_dq = 0
"""Backward dq kernel launches (one per backward call)."""
launches_dkv = 0
"""Backward dkv kernel launches (one per backward call)."""


@functools.cache
def _bwd_entries():
    """(dq, dkv) SIMT entries, then (dq, dkv) tensor-core ones; the latter
    take no dtype."""
    lib = _build.library(BWD_LIB)
    common = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
              + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 2)
    fns = (lib.repro_flash_attention_bwd_dq, lib.repro_flash_attention_bwd_dkv,
           lib.repro_flash_attention_bwd_dq_tc,
           lib.repro_flash_attention_bwd_dkv_tc)
    for i, fn in enumerate(fns):
        fn.argtypes = common + ([ctypes.c_int] if i < 2 else []) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


@functools.cache
def _entries():
    lib = _build.library(NAME)
    simt, tc = lib.repro_flash_attention_fwd, lib.repro_flash_attention_fwd_tc
    common = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
              + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int])
    simt.argtypes = common + [ctypes.c_int, ctypes.c_void_p]
    tc.argtypes = common + [ctypes.c_void_p]
    simt.restype = tc.restype = ctypes.c_int
    return simt, tc


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel for (dtype, head dim): ``"tc"`` (bf16 at head dims
    64 and 128, on the tensor cores) or ``"simt"`` (f32; bf16 at the other
    head dims)."""
    return ("tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            else "simt")


def _tma_able(t: torch.Tensor) -> bool:
    """Whether a TMA map can take ``t`` as it lies: 16-byte aligned, each
    (batch, head, row) stride a multiple of 8 elements (16 bytes), but a
    size-1 dim's, which is never stepped."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, row) element strides a TMA map of ``t`` takes (a
    size-1 dim's as 8).  Raises where :func:`_tma_able` says no."""
    if not _tma_able(t):
        raise ValueError(
            f"the tensor-core flash kernel's TMA loads need 16-byte aligned "
            f"tensors and strides that are multiples of 8 elements; got "
            f"strides {tuple(t.stride())} at offset {t.data_ptr() % 16} "
            f"(copy the tensor to take it)")
    return tuple(st if n > 1 else 8 for n, st in zip(t.shape[:3],
                                                      t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0):
    """q [B,H,S,D]; k/v [B,Hkv,T,D] (Hkv divides H) on one CUDA device, all
    f32 or all bf16 -> (out [B,H,S,D] in q's dtype and layout,
    lse [B,H,S] f32).  ``window > 0`` applies only with ``causal``.  The
    kernel is the one :func:`route` names."""
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
    tc = route(q.dtype, D) == "tc"
    ins = ([x for t in (q, k, v) for x in _tma_strides(t)] if tc
           else [x for t in (q, k, v) for x in t.stride()[:3]])
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*ins, *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Hkv, S, T, D, strides, int(causal),
            int(window) if causal else 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    simt, tc_fn = _entries()
    with torch.cuda.device(q.device):
        code = (tc_fn(*args, stream) if tc
                else simt(*args, DTYPES[q.dtype], stream))
    _build.check(NAME, code, "flash_attention launch")
    launches += 1
    return out, lse


def route_bwd(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels for (dtype, head dim), as :func:`route` names
    the forward's: ``"tc"`` (bf16 at head dims 64 and 128, on the tensor
    cores) or ``"simt"`` (f32; bf16 at head dims 16, 32 and 256).  A head
    dim outside ``BWD_HEAD_DIMS`` raises."""
    if head_dim not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {BWD_HEAD_DIMS} "
                         f"(backward)")
    return route(dtype, head_dim)


def _check_bwd(q, k, v, rows: tuple, stats: tuple, what: str):
    """Validate backward inputs: q and ``rows`` (out / dout) [B,H,S,D],
    k/v [B,Hkv,T,D] in one dtype, ``stats`` (lse / delta) contiguous f32
    [B,H,S], all on one CUDA device."""
    ts = (q, k, v) + rows
    if not all(t.is_cuda for t in ts + stats):
        raise ValueError(f"{what} kernel takes CUDA tensors; "
                         f"kernels.ops.FlashAttention dispatches CPU "
                         f"tensors to the plain backward")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,S,D], k/v [B,Hkv,T,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, head groups)")
    if any(t.shape != q.shape for t in rows):
        raise ValueError(f"{[tuple(t.shape) for t in rows]} must match q "
                         f"{tuple(q.shape)}")
    if any(tuple(t.shape) != (B, H, S) or t.dtype != torch.float32
           or not t.is_contiguous() for t in stats):
        raise ValueError(f"lse/delta must be contiguous f32 [B,H,S]; got "
                         f"{[(t.dtype, tuple(t.shape)) for t in stats]}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"q/k/v/out/dout must share one dtype of "
                         f"{list(DTYPES)}; got {[t.dtype for t in ts]}")
    if len({t.device for t in ts + stats}) != 1:
        raise ValueError(f"{what} inputs must be on one device")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{what} needs a contiguous head dim (stride 1)")
    return B, H, Hkv, S, k.shape[2], D


def _strides(tc: bool, ins, outs):
    """The 18 (batch, head, row) element strides of the six tensors a
    backward kernel takes: its inputs through :func:`_tma_strides` on the
    tensor-core route, as they are on the SIMT one; its outputs as they
    are."""
    if tc:
        ins = [x for t in ins for x in _tma_strides(t)]
    else:
        ins = [x for t in ins for x in t.stride()[:3]]
    return (ctypes.c_int64 * 18)(*ins, *(x for t in outs
                                           for x in t.stride()[:3]))


def _window(causal: bool, window: int) -> int:
    if window < 0:
        raise ValueError(f"negative window {window}")
    return int(window) if causal else 0


def _tc(q) -> bool:
    return route_bwd(q.dtype, q.shape[-1]) == "tc"


def _dq(q, k, v, out, lse, dout, shape, causal, window, tc):
    """Launch the dq kernel on checked inputs -> (dq, delta)."""
    global launches_dq
    B, H, Hkv, S, T, D = shape
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = _strides(tc, (q, k, v, out, dout), (dq,))
    dev = q.device
    fns = _bwd_entries()
    with _build.on_device(dev):
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), B, H, Hkv, S, T, D, strides, int(causal),
                window)
        stream = _build.stream_handle(dev)
        code = (fns[2](*args, stream) if tc
                else fns[0](*args, DTYPES[q.dtype], stream))
    _build.check(BWD_LIB, code, "flash_attention_bwd_dq launch")
    launches_dq += 1
    return dq, delta


def _dkv(q, k, v, dout, lse, delta, shape, causal, window, tc):
    """Launch the dkv kernel on checked inputs -> (dk, dv)."""
    global launches_dkv
    B, H, Hkv, S, T, D = shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    strides = _strides(tc, (q, k, v, dout), (dk, dv))
    dev = q.device
    fns = _bwd_entries()
    with _build.on_device(dev):
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, H, Hkv, S, T, D, strides, int(causal),
                window)
        stream = _build.stream_handle(dev)
        code = (fns[3](*args, stream) if tc
                else fns[1](*args, DTYPES[q.dtype], stream))
    _build.check(BWD_LIB, code, "flash_attention_bwd_dkv launch")
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True,
                           window: int = 0):
    """Backward kernel #1 (replaces ``_bwd_dq_kernel``): q/out/dout
    [B,H,S,D], k/v [B,Hkv,T,D] in one dtype, lse [B,H,S] f32, on one CUDA
    device -> (dq in q's dtype and layout, delta = rowsum(dout ⊙ out)
    [B,H,S] f32).  Strided inputs are taken as they are when their head
    dim is contiguous (on the tensor-core route, when :func:`_tma_strides`
    takes them too).  The kernel is :func:`route_bwd`'s."""
    shape = _check_bwd(q, k, v, (out, dout), (lse,), NAME_BWD_DQ)
    return _dq(q, k, v, out, lse, dout, shape, causal,
               _window(causal, window), _tc(q))


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            window: int = 0):
    """Backward kernel #2 (replaces ``_bwd_dkv_kernel``): as
    :func:`flash_attention_bwd_dq`, with its ``delta`` -> (dk, dv) in k's
    and v's dtype and layouts, summed over each kv head's q heads."""
    shape = _check_bwd(q, k, v, (dout,), (lse, delta), NAME_BWD_DKV)
    return _dkv(q, k, v, dout, lse, delta, shape, causal,
                _window(causal, window), _tc(q))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The backward of :func:`flash_attention` from its inputs, output and
    lse residual: the inputs checked once, then the dq kernel (which also
    writes delta) and the dkv kernel, both on :func:`route_bwd`'s route ->
    (dq, dk, dv).  ``dout`` (whatever layout autograd hands over) is
    copied only when its head dim is not contiguous or, on the
    tensor-core route, when TMA cannot load it as it lies."""
    tc = _tc(q)
    if dout.stride(-1) != 1 or (tc and not _tma_able(dout)):
        dout = dout.clone(memory_format=torch.contiguous_format)
    shape = _check_bwd(q, k, v, (out, dout), (lse,), "flash_attention_bwd")
    window = _window(causal, window)
    dq, delta = _dq(q, k, v, out, lse, dout, shape, causal, window, tc)
    dk, dv = _dkv(q, k, v, dout, lse, delta, shape, causal, window, tc)
    return dq, dk, dv
