"""Chunkwise-parallel mLSTM scan on Hopper: the wrapper of
``csrc/mlstm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/mlstm_scan.py:21``
``_mlstm_kernel`` (reached through ``mlstm_scan:70``), the chunk math of
``models/ssm.py::_mlstm_chunk`` scanned over the sequence.  One call is
two CUDA kernels (counted as one launch): ``mlstm_carry_kernel`` walks the
chunks per (batch row, head, tile of C), folding each chunk's own state,
built under its own stabilizer, into the carry, and writes the carry
entering every chunk to a scratch; ``mlstm_out_kernel`` then computes y
for every (chunk, 64-row q tile) in parallel, its scores built once.  All
products run on the tensor cores in 3xTF32 (see the source).  Unlike the
Pallas kernel, which drops its carry, the kernel writes the final
(C, n, m): the model's prefill keeps it as the decode state.

The plain version is ``kernels.ref.ref_mlstm_scan``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "mlstm_scan"
MAX_CHUNK = 256      # one gate a thread; the [64, L] P tile in shared memory
HEAD_DIM_MULTIPLE = 4   # rows move in 16-byte copies
MAX_HEAD_DIM = 2048

launches = 0
"""Wrapper calls that launched the kernels since the last
``ops.reset_launch_counts()``."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
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
    if L > MAX_CHUNK or not 0 < dh <= MAX_HEAD_DIM \
            or dh % HEAD_DIM_MULTIPLE:
        raise ValueError(f"unsupported mlstm_scan shape: chunk {L} "
                         f"(MAX_CHUNK {MAX_CHUNK}), dh {dh} (MAX_HEAD_DIM "
                         f"{MAX_HEAD_DIM}, a multiple of HEAD_DIM_MULTIPLE "
                         f"{HEAD_DIM_MULTIPLE})")
    if state is not None and (tuple(state[0].shape) != (B, H, dh, dh)
                              or tuple(state[1].shape) != (B, H, dh)
                              or tuple(state[2].shape) != (B, H)):
        raise ValueError(f"state shapes {[tuple(t.shape) for t in state[:3]]}"
                         f" do not match C [B,H,dh,dh], n [B,H,dh], m [B,H]")
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError("mlstm_scan inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_scan needs contiguous inputs")
    # q, k, v and C0 are staged by 16-byte copies: a view that starts off
    # that alignment is copied (a fresh allocation is aligned)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    nc = S // L
    y = torch.empty_like(q)
    C = q.new_empty(B, H, dh, dh)
    n = q.new_empty(B, H, dh)
    m = q.new_empty(B, H)
    init = (None, None, None)
    if state is not None:
        C0 = state[0] if state[0].data_ptr() % 16 == 0 else state[0].clone()
        init = (C0.data_ptr(), state[1].data_ptr(), state[2].data_ptr())
    scratch = (None, None, None)
    if nc > 1:   # the carries entering chunks 1..nc-1
        Cs = q.new_empty(B, H, nc - 1, dh, dh)
        ns = q.new_empty(B, H, nc - 1, dh)
        ms = q.new_empty(B, H, nc - 1)
        scratch = (Cs.data_ptr(), ns.data_ptr(), ms.data_ptr())
    with _build.on_device(dev):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        i_gate.data_ptr(), f_log.data_ptr(), *init,
                        y.data_ptr(), C.data_ptr(), n.data_ptr(),
                        m.data_ptr(), *scratch, B, H, S, dh, L,
                        _build.stream_handle(dev))
    _build.check(NAME, code, "mlstm_scan launch")
    launches += 1
    return y, (C, n, m)
