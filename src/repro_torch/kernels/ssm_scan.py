"""Mamba selective scan on Hopper: the wrapper of ``csrc/ssm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py:32`` ``_ssm_kernel``
(reached through ``ssm_chunk_scan:65``), the chunk body of
``models/ssm.py::mamba``.  N / 8 lanes of a warp share a (batch row,
inner channel), 8 states each in registers, and walk the time axis in
order; a block of 64 channels stages tiles of 32 steps of dt and x
(16-byte ``cp.async``, double-buffered) and the shared B_t / C_t in
shared memory and writes y through it (see the source).  The [B,S,Di,N]
gates are never built.  Like the Pallas kernel it returns y in f32 and
the final state h, which the model's prefill keeps as the decode state;
unlike it, it takes any S (the model still pads to a multiple of the
chunk, as the reference does) and an optional start state.  Rows of dt,
x and y move in 16-byte pieces, so Di must be a multiple of
``DI_MULTIPLE`` and the tensors 16-byte aligned.

The plain version is ``kernels.ref.ref_ssm_scan``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "ssm_scan"
MAX_STATE = 64       # N: the states of a channel live in registers
DI_MULTIPLE = 8      # channels of a 16-byte piece of bf16 x
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan(dt: torch.Tensor, B_ssm: torch.Tensor, C_ssm: torch.Tensor,
             x: torch.Tensor, A: torch.Tensor, h0=None):
    """dt [B,S,Di] f32 (softplus'd); B_ssm/C_ssm [B,S,N] and x [B,S,Di]
    of one dtype, f32 or bf16; A [Di,N] f32 (negative); ``h0`` [B,Di,N]
    f32 starts the state (default zero).  All contiguous, on one CUDA
    device; 0 < N <= 64, Di a multiple of 8, dt and x 16-byte aligned.
    Returns (y [B,S,Di] f32, h [B,Di,N] f32)."""
    global launches
    ts = (dt, B_ssm, C_ssm, x, A) + ((h0,) if h0 is not None else ())
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssm_scan kernel takes CUDA tensors; "
                         "kernels.ops.ssm_chunk_scan dispatches CPU tensors "
                         "to the plain version")
    if dt.ndim != 3 or x.shape != dt.shape:
        raise ValueError(f"expected dt/x [B,S,Di] of one shape; got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    Bt, S, Di = dt.shape
    N = A.shape[-1] if A.ndim == 2 else 0
    if tuple(A.shape) != (Di, N) or tuple(B_ssm.shape) != (Bt, S, N) \
            or tuple(C_ssm.shape) != (Bt, S, N):
        raise ValueError(f"A {tuple(A.shape)}, B_ssm {tuple(B_ssm.shape)}, "
                         f"C_ssm {tuple(C_ssm.shape)} do not match dt "
                         f"{tuple(dt.shape)} as [Di,N], [B,S,N], [B,S,N]")
    if h0 is not None and tuple(h0.shape) != (Bt, Di, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not [B,Di,N] = "
                         f"{(Bt, Di, N)}")
    if not (0 < N <= MAX_STATE and S > 0 and 0 < Bt <= 65535):
        raise ValueError(f"unsupported ssm_scan shape: N {N} (<= "
                         f"{MAX_STATE}), S {S}, B {Bt}")
    if any(t.dtype != torch.float32 for t in (dt, A) + ts[5:]):
        raise ValueError("dt, A and h0 must be f32")
    if x.dtype not in DTYPES or B_ssm.dtype != x.dtype \
            or C_ssm.dtype != x.dtype:
        raise ValueError(f"x, B_ssm and C_ssm must share one dtype of "
                         f"{list(DTYPES)}; got {x.dtype}, {B_ssm.dtype}, "
                         f"{C_ssm.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("ssm_scan inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssm_scan needs contiguous inputs")
    if Di % DI_MULTIPLE or dt.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"ssm_scan moves rows of dt, x and y in 16-byte "
                         f"pieces: Di ({Di}) must be a multiple of "
                         f"{DI_MULTIPLE} and dt, x 16-byte aligned")
    y = torch.empty_like(dt)
    h = dt.new_empty(Bt, Di, N)
    with torch.cuda.device(dt.device):
        code = _entry()(dt.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
                        x.data_ptr(), A.data_ptr(),
                        None if h0 is None else h0.data_ptr(),
                        y.data_ptr(), h.data_ptr(), Bt, S, Di, N,
                        DTYPES[x.dtype],
                        torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(NAME, code, "ssm_scan launch")
    launches += 1
    return y, h
