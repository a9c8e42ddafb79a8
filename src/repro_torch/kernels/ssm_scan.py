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
``DI_MULTIPLE`` and the tensors 16-byte aligned.  With ``keep`` (the
training forward) it also writes the state entering each chunk, which
#12b reads.

#12b, ``ssm_scan_bwd`` (``csrc/ssm_scan_bwd.cu``), is its backward, which
the reference leaves to ``jax.grad`` of its jnp chunk body: a thread a
(channel, state), 512 / N channels a block; per chunk, last to first, it
finds the state at every 16-step segment start from the kept chunk start,
rebuilds each segment's states in registers and walks it back carrying
the adjoint; ddt and dx are summed over the lanes, dB and dC over the
block's channels, through shared memory, and dB, dC and dA go to
per-block partials that a second launch sums in a fixed order (no
atomics).  It takes N <= ``BWD_MAX_STATE`` and chunks of at most
``BWD_MAX_CHUNK`` steps.

The plain versions are ``kernels.ref.ref_ssm_scan`` and
``ref_ssm_scan_bwd``; ``kernels.ops`` dispatches between them and the
kernels by device, the backward through ``ops.SSMChunkScan``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "ssm_scan"
NAME_BWD = "ssm_scan_bwd"
MAX_STATE = 64       # N: the states of a channel live in registers
DI_MULTIPLE = 8      # channels of a 16-byte piece of bf16 x
BWD_MAX_STATE = 16   # #12b: a thread a state, 8 or 16 lanes a channel
BWD_MAX_CHUNK = 256  # #12b: 16 segment starts of 16 steps in shared memory
BWD_THREADS = 512    # #12b's block (csrc/ssm_scan_bwd.cu kThreads)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""
launches_bwd = 0
"""#12b calls (its scan and the partials' sum) since the last reset."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.library(NAME_BWD).repro_ssm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_grads(what: str, ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{what} is not differentiable itself: "
                         f"kernels.ops.ssm_chunk_scan takes inputs that "
                         f"need a gradient (ops.SSMChunkScan)")


def ssm_scan(dt: torch.Tensor, B_ssm: torch.Tensor, C_ssm: torch.Tensor,
             x: torch.Tensor, A: torch.Tensor, h0=None, *, chunk: int = 0,
             keep: bool = False):
    """dt [B,S,Di] f32 (softplus'd); B_ssm/C_ssm [B,S,N] and x [B,S,Di]
    of one dtype, f32 or bf16; A [Di,N] f32 (negative); ``h0`` [B,Di,N]
    f32 starts the state (default zero).  All contiguous, on one CUDA
    device; 0 < N <= 64, Di a multiple of 8, dt and x 16-byte aligned.
    Returns (y [B,S,Di] f32, h [B,Di,N] f32), and with ``keep`` also the
    state entering each ``chunk``-step chunk, [B,ceil(S/chunk),Di,N] f32
    (``ssm_scan_bwd``'s ``states``)."""
    global launches
    ts = (dt, B_ssm, C_ssm, x, A) + ((h0,) if h0 is not None else ())
    _refuse_grads("ssm_scan", ts)
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
    if keep and chunk <= 0:
        raise ValueError("keep=True needs the chunk the states are kept at")
    y = torch.empty_like(dt)
    h = dt.new_empty(Bt, Di, N)
    hs = dt.new_empty(Bt, -(-S // chunk), Di, N) if keep else None
    with torch.cuda.device(dt.device):
        code = _entry()(dt.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
                        x.data_ptr(), A.data_ptr(),
                        None if h0 is None else h0.data_ptr(),
                        y.data_ptr(), h.data_ptr(),
                        None if hs is None else hs.data_ptr(), Bt, S, Di, N,
                        chunk if keep else 0, DTYPES[x.dtype],
                        torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(NAME, code, "ssm_scan launch")
    launches += 1
    return (y, h, hs) if keep else (y, h)


def bwd_blocks(Di: int, N: int) -> int:
    """#12b's blocks a batch row: ``BWD_THREADS`` / NMAX channels each,
    NMAX = 8 for N <= 8, else 16 (the shape of its dB / dC partials)."""
    nmax = 8 if N <= 8 else 16
    return -(-Di // (BWD_THREADS // nmax))


def ssm_scan_bwd(dt: torch.Tensor, B_ssm: torch.Tensor, C_ssm: torch.Tensor,
                 x: torch.Tensor, A: torch.Tensor, h0, states: torch.Tensor,
                 dy: torch.Tensor, *, dh=None, chunk: int):
    """#12b, the backward of :func:`ssm_scan` (``ref_ssm_scan_bwd``'s
    function): the forward's inputs (h0 only says whether dh0 is wanted),
    ``states`` [B,nc,Di,N] f32 as ``ssm_scan(..., chunk=chunk,
    keep=True)`` returns them, dy [B,S,Di] f32 and ``dh`` [B,Di,N] f32
    (None: zero).  All contiguous, on one CUDA device; 0 < N <= 16,
    0 < chunk <= 256.  Returns (ddt [B,S,Di] f32, dx [B,S,Di], dB, dC
    [B,S,N] in x's dtype, dA [Di,N] f32, dh0 [B,Di,N] f32 or None without
    h0).  Two launches: the scan, then the fixed-order sum of its dB, dC
    and dA partials."""
    global launches_bwd
    extra = (states, dy) + (() if dh is None else (dh,))
    ts = (dt, B_ssm, C_ssm, x, A) + extra
    _refuse_grads("ssm_scan_bwd", ts)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssm_scan_bwd kernel takes CUDA tensors; "
                         "kernels.ops.SSMChunkScan dispatches CPU tensors "
                         "to the plain version")
    if dt.ndim != 3 or x.shape != dt.shape or dy.shape != dt.shape:
        raise ValueError(f"expected dt/x/dy [B,S,Di] of one shape; got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    Bt, S, Di = dt.shape
    N = A.shape[-1] if A.ndim == 2 else 0
    if tuple(A.shape) != (Di, N) or tuple(B_ssm.shape) != (Bt, S, N) \
            or tuple(C_ssm.shape) != (Bt, S, N):
        raise ValueError(f"A {tuple(A.shape)}, B_ssm {tuple(B_ssm.shape)}, "
                         f"C_ssm {tuple(C_ssm.shape)} do not match dt "
                         f"{tuple(dt.shape)} as [Di,N], [B,S,N], [B,S,N]")
    if not (0 < N <= BWD_MAX_STATE and 0 < chunk <= BWD_MAX_CHUNK
            and S > 0 and 0 < Bt <= 65535):
        raise ValueError(f"unsupported ssm_scan_bwd shape: N {N} (<= "
                         f"{BWD_MAX_STATE}), chunk {chunk} (<= "
                         f"{BWD_MAX_CHUNK}), S {S}, B {Bt}")
    nc = -(-S // chunk)
    if tuple(states.shape) != (Bt, nc, Di, N) or (
            dh is not None and tuple(dh.shape) != (Bt, Di, N)):
        raise ValueError(f"states {tuple(states.shape)} / dh "
                         f"{None if dh is None else tuple(dh.shape)} are "
                         f"not [B,nc,Di,N] = {(Bt, nc, Di, N)} / [B,Di,N]")
    if any(t.dtype != torch.float32 for t in (dt, A) + extra):
        raise ValueError("dt, A, states, dy and dh must be f32")
    if x.dtype not in DTYPES or B_ssm.dtype != x.dtype \
            or C_ssm.dtype != x.dtype:
        raise ValueError(f"x, B_ssm and C_ssm must share one dtype of "
                         f"{list(DTYPES)}; got {x.dtype}, {B_ssm.dtype}, "
                         f"{C_ssm.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("ssm_scan_bwd inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssm_scan_bwd needs contiguous inputs")
    ddt = torch.empty_like(dt)
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B_ssm), torch.empty_like(C_ssm)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else dt.new_empty(Bt, Di, N)
    part = Bt * bwd_blocks(Di, N) * S * N
    work = dt.new_empty(2 * part + Bt * Di * N)
    with torch.cuda.device(dt.device):
        code = _bwd_entry()(
            dt.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(), x.data_ptr(),
            A.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dh is None else dh.data_ptr(), ddt.data_ptr(),
            dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), work.data_ptr(), Bt, S,
            Di, N, chunk, DTYPES[x.dtype],
            torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(NAME_BWD, code, "ssm_scan_bwd launch")
    launches_bwd += 1
    return ddt, dx, dB, dC, dA, dh0
