"""Chunkwise-parallel mLSTM scan on Hopper: the wrapper of
``csrc/mlstm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/mlstm_scan.py:21``
``_mlstm_kernel`` (reached through ``mlstm_scan:70``), the chunk math of
``models/ssm.py::_mlstm_chunk`` scanned over the sequence.  One CUDA block
per (batch row, head, 64-row tile of C's v axis) walks the chunks in order;
its rows of C stay in the output buffer between chunks, and it rebuilds
the chunk's causal score tiles and denominator itself (see the source).
Unlike the Pallas kernel, which drops its carry, the kernel writes the
final (C, n, m): the model's prefill keeps it as the decode state.

The plain version is ``kernels.ref.ref_mlstm_scan``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "mlstm_scan"
MAX_CHUNK = 4096     # the chunk's gate statistics live in shared memory
MAX_HEAD_DIM = 2048

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_gate: torch.Tensor, f_log: torch.Tensor, *,
               chunk: int = 256, state=None):
    """q/k/v [B,H,S,dh] (k pre-scaled by dh^-0.5); i_gate/f_log [B,H,S]
    (f already log-sigmoid); all f32, contiguous, on one CUDA device; S a
    multiple of L = min(chunk, S).  ``state`` = (C [B,H,dh,dh], n [B,H,dh],
    m [B,H]) f32 starts the carry (default: zero, m = -inf).  Returns
    (y [B,H,S,dh], (C, n, m)) with the final carry."""
    global launches
    ts = (q, k, v, i_gate, f_log) + tuple(state[:3] if state else ())
    if not all(t.is_cuda for t in ts):
        raise ValueError("mlstm_scan kernel takes CUDA tensors; "
                         "kernels.ops.mlstm_scan dispatches CPU tensors to "
                         "the plain version")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q/k/v [B,H,S,dh] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, dh = q.shape
    if tuple(i_gate.shape) != (B, H, S) or tuple(f_log.shape) != (B, H, S):
        raise ValueError(f"i_gate {tuple(i_gate.shape)} / f_log "
                         f"{tuple(f_log.shape)} must be [B,H,S] = "
                         f"{(B, H, S)}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"mlstm_scan takes f32 only; got "
                         f"{sorted({str(t.dtype) for t in ts})}")
    L = min(chunk, S)
    if S == 0 or L <= 0 or S % L:
        raise ValueError(f"sequence {S} must be a positive multiple of the "
                         f"chunk {L} (the caller pads)")
    if L > MAX_CHUNK or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"unsupported mlstm_scan shape: chunk {L} (<= "
                         f"{MAX_CHUNK}), dh {dh} (<= {MAX_HEAD_DIM})")
    if state is not None and (tuple(state[0].shape) != (B, H, dh, dh)
                              or tuple(state[1].shape) != (B, H, dh)
                              or tuple(state[2].shape) != (B, H)):
        raise ValueError(f"state shapes {[tuple(t.shape) for t in state[:3]]}"
                         f" do not match C [B,H,dh,dh], n [B,H,dh], m [B,H]")
    if len({t.device for t in ts}) != 1:
        raise ValueError("mlstm_scan inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_scan needs contiguous inputs")
    y = torch.empty_like(q)
    n = q.new_empty(B, H, dh)
    m = q.new_empty(B, H)
    if state is None:
        C = q.new_empty(B, H, dh, dh)     # the kernel writes it from zero
        n0 = m0 = None
    else:
        C = state[0].clone()              # the kernel updates it in place
        n0, m0 = state[1].data_ptr(), state[2].data_ptr()
    with torch.cuda.device(q.device):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        i_gate.data_ptr(), f_log.data_ptr(), n0, m0,
                        y.data_ptr(), C.data_ptr(), n.data_ptr(),
                        m.data_ptr(), B, H, S, dh, L,
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, code, "mlstm_scan launch")
    launches += 1
    return y, (C, n, m)
