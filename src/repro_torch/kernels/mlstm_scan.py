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

``mlstm_scan_bwd`` wraps ``csrc/mlstm_scan_bwd.cu``, the hand-written
backward (the reference has no Pallas backward: it differentiates its jnp
chunk math).  One call is five CUDA kernels, counted as one launch
(``launches_bwd``): the row scalars, the carry grads' reverse walk, the
keys' and the queries' grads of every chunk in parallel, and the gates'
sequential pass.  Its plain version is ``kernels.ref.ref_mlstm_scan_bwd``.
With ``keep=True`` the forward also returns what the backward reads: the
denominators and the carries entering chunks 1..nc-1, which it writes to
its scratch anyway.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "mlstm_scan"
NAME_BWD = "mlstm_scan_bwd"
MAX_CHUNK = 256      # one gate a thread; the [64, L] P tile in shared memory
HEAD_DIM_MULTIPLE = 4   # rows move in 16-byte copies
MAX_HEAD_DIM = 2048

launches = 0
"""Wrapper calls that launched the kernels since the last
``ops.reset_launch_counts()``."""
launches_bwd = 0
"""``mlstm_scan_bwd`` calls that launched the backward kernels."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_bwd():
    fn = _build.library(NAME_BWD).repro_mlstm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 34 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    """``t``, copied where its data does not start on 16 bytes (the
    kernels move rows in 16-byte copies; a fresh allocation is
    aligned)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, i_gate, f_log, chunk: int, state, what: str):
    """The shapes, types, device and layout both directions take; returns
    L = min(chunk, S)."""
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
        raise ValueError(f"{what} needs contiguous inputs")
    return L


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_gate: torch.Tensor, f_log: torch.Tensor, *,
               chunk: int = 256, state=None, keep: bool = False):
    """q/k/v [B,H,S,dh] (k pre-scaled by dh^-0.5); i_gate/f_log [B,H,S]
    (f already log-sigmoid); all f32, contiguous, on one CUDA device; S a
    multiple of L = min(chunk, S).  ``state`` = (C [B,H,dh,dh], n [B,H,dh],
    m [B,H]) f32 starts the carry (default: zero, m = -inf).  Returns
    (y [B,H,S,dh], (C, n, m)) with the final carry, and with ``keep``
    also (d [B,H,S], Cs, ns, ms) as ``ref.ref_mlstm_scan`` does."""
    global launches
    L = _check(q, k, v, i_gate, f_log, chunk, state, "mlstm_scan")
    B, H, S, dh = q.shape
    dev = q.device
    # q, k, v and C0 are staged by 16-byte copies
    q, k, v = (_aligned(t) for t in (q, k, v))
    nc = S // L
    y = torch.empty_like(q)
    C = q.new_empty(B, H, dh, dh)
    n = q.new_empty(B, H, dh)
    m = q.new_empty(B, H)
    init = (None, None, None)
    if state is not None:
        init = (_aligned(state[0]).data_ptr(), state[1].data_ptr(),
                state[2].data_ptr())
    # the carries entering chunks 1..nc-1
    Cs = q.new_empty(B, H, nc - 1, dh, dh)
    ns = q.new_empty(B, H, nc - 1, dh)
    ms = q.new_empty(B, H, nc - 1)
    scratch = (Cs.data_ptr(), ns.data_ptr(), ms.data_ptr()) if nc > 1 \
        else (None, None, None)
    d = q.new_empty(B, H, S) if keep else None
    with _build.on_device(dev):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        i_gate.data_ptr(), f_log.data_ptr(), *init,
                        y.data_ptr(), C.data_ptr(), n.data_ptr(),
                        m.data_ptr(), *scratch, _ptr(d), B, H, S, dh, L,
                        _build.stream_handle(dev))
    _build.check(NAME, code, "mlstm_scan launch")
    launches += 1
    if keep:
        return y, (C, n, m), (d, Cs, ns, ms)
    return y, (C, n, m)


def mlstm_scan_bwd(q, k, v, i_gate, f_log, y, kept, dy, *, chunk: int = 256,
                   state=None, dC=None, dn=None, dm=None,
                   return_passes: bool = False):
    """The backward of ``mlstm_scan`` (``ref.ref_mlstm_scan_bwd``'s
    function): from the forward's inputs, its y and ``kept`` = (d, Cs, ns,
    ms) (``keep=True``), given dy [B,H,S,dh] and the final carry's grads
    (dC, dn, dm; None: zero) -> (dq, dk, dv, di, df, dC_state, dn_state,
    dm_state), the last three None without a ``state``.  All f32,
    contiguous, on one CUDA device.  ``return_passes`` also returns the
    passes' intermediates as ``ref.ref_mlstm_bwd_*`` state them: {"rows":
    (rden, dd, dM), "carry": (dCs, dns, dC0, dn0, ddec), "chunk": (dq, dk,
    dv, dA, dwc, inter), "gates": (di, df, dm0)}, the column-tile shares
    summed."""
    global launches_bwd
    L = _check(q, k, v, i_gate, f_log, chunk, state, "mlstm_scan_bwd")
    B, H, S, dh = q.shape
    nc = S // L
    d, Cs, ns, ms = kept
    if (dC is None) != (dn is None):   # the kernels take both or neither
        dC = q.new_zeros(B, H, dh, dh) if dC is None else dC
        dn = q.new_zeros(B, H, dh) if dn is None else dn
    given = (y, dy, d, Cs, ns, ms, dC, dn, dm)
    want = ((B, H, S, dh), (B, H, S, dh), (B, H, S), (B, H, nc - 1, dh, dh),
            (B, H, nc - 1, dh), (B, H, nc - 1), (B, H, dh, dh), (B, H, dh),
            (B, H))
    for t, shape in zip(given, want):
        if t is None:
            continue
        if (not t.is_cuda or t.device != q.device
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"mlstm_scan_bwd: expected a contiguous f32 "
                             f"{shape} on {q.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    q, k, v, y, dy, Cs, dC = (_aligned(t) for t in (q, k, v, y, dy, Cs, dC))
    C0, n0, m0 = (None, None, None) if state is None else (
        _aligned(state[0]), state[1], state[2])
    ncol = -(-dh // 128)
    ntA = -(-dh // 64) * ncol
    rows = [q.new_empty(B, H, S) for _ in range(3)]          # rden, dd, dM
    dCs = q.new_empty(B, H, nc - 1, dh, dh)
    dns = q.new_empty(B, H, nc - 1, dh)
    st_grads = (None, None, None) if state is None else (
        q.new_empty(B, H, dh, dh), q.new_empty(B, H, dh), q.new_empty(B, H))
    ddp = q.new_empty(B, H, nc, ntA)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dA = q.new_empty(B, H, S)
    dwcp, interp = q.new_empty(B, H, S, ncol), q.new_empty(B, H, S, ncol)
    di, df = q.new_empty(B, H, S), q.new_empty(B, H, S)
    many = nc > 1
    with _build.on_device(q.device):
        code = _entry_bwd()(
            *(_ptr(t) for t in (q, k, v, i_gate, f_log, y, dy, d, C0, n0, m0,
                                Cs if many else None, ns if many else None,
                                ms if many else None, dC, dn, dm, *rows,
                                dCs if many else None, dns if many else None,
                                *st_grads, ddp, dq, dk, dv, dA, dwcp, interp,
                                di, df)),
            B, H, S, dh, L, _build.stream_handle(q.device))
    _build.check(NAME_BWD, code, "mlstm_scan_bwd launch")
    launches_bwd += 1
    grads = (dq, dk, dv, di, df, *st_grads)
    if not return_passes:
        return grads
    return grads, {"rows": tuple(rows),
                   "carry": (dCs, dns, st_grads[0], st_grads[1],
                             ddp.sum(-1)),
                   "chunk": (dq, dk, dv, dA, dwcp.sum(-1), interp.sum(-1)),
                   "gates": (di, df, st_grads[2])}
