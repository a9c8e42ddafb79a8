"""Fused SwiGLU FFN on Hopper: the wrappers of ``csrc/fused_ffn.cu``
(forward) and ``csrc/fused_ffn_bwd.cu`` (backward).

Replaces the TPU kernel ``repro/kernels/fused_ffn.py:50`` ``_ffn_kernel``
(reached through ``_forward:71``): ``y = (silu(x·Wg) ⊙ x·Wu)·Wd`` with the
[N, F] hidden kept on chip.  A CUDA block owns ``br`` rows and a range of
F: its rows are staged once in shared memory, and for each 32-wide F tile
it computes the [br, 32] hidden tile, parks it in shared memory and folds
it into an f32 [br, D] accumulator held in shared memory.  When there are
too few row tiles to fill the card (decode: N = num_slots), F is split
across blocks that write f32 partial sums to a [splits, N, D] workspace,
and a second small kernel adds them in split order — deterministic, no
atomics.

The backward (:func:`swiglu_ffn_bwd`) replaces the TPU kernels
``repro/kernels/fused_ffn.py:108`` ``_bwd_dx_kernel`` and ``:131``
``_bwd_dw_kernel`` (reached through ``_backward:159``).  Both recompute
the (g, u, dh) tile they need from x, the weights and dy; nothing
[N, F]-shaped is stored.  The dx kernel walks F per block of rows, as the
forward; the dw kernel owns a narrow F tile (``plan_dw``) and walks rows,
split across blocks into an f32 workspace added in order by a second
kernel when the F tiles alone would leave SMs idle.

The plain versions are ``kernels.ref.ref_swiglu_ffn`` and
``ref_swiglu_ffn_bwd``; ``kernels.ops`` dispatches between them and the
kernels by device, the backward through ``ops.SwiGLUFFN``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "fused_ffn"
NAME_BWD_DX = "fused_ffn_bwd_dx"
NAME_BWD_DW = "fused_ffn_bwd_dw"
BWD_LIB = "fused_ffn_bwd"
BF = 32            # F tile width (csrc/fused_ffn.cu)
SMEM_ROWS_X_D = 24576  # br * D: the f32 [br, D] rows + accumulator in smem
MAX_D = SMEM_ROWS_X_D // 4   # forward: br >= 4 (d_model 4096 takes br 4)
BWD_MAX_D = SMEM_ROWS_X_D // 8   # the dx kernel's blocks take 8 rows
# dw kernel: its three f32 weight-gradient tiles (12 * D * bf bytes) and
# its [512/bf, bf] hidden tiles share one block's shared memory
DW_SMEM_BYTES = 200 * 1024
DW_TILES = (16, 8, 4, 2, 1)
DW_CHUNK_X_BF = 512          # rows per chunk * bf (csrc/fused_ffn_bwd.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``: one per
call, two when F is split (the partial-sum kernel and the reduce)."""
launches_dx = 0
"""Backward dx kernel launches (one per backward call)."""
launches_dw = 0
"""Backward dw kernel launches: one per backward call, two when the rows
are split (the partial-sum kernel and the reduce)."""


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_swiglu_ffn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bwd_entries():
    lib = _build.library(BWD_LIB)
    dx = lib.repro_swiglu_ffn_bwd_dx
    dx.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    dx.restype = ctypes.c_int
    dw = lib.repro_swiglu_ffn_bwd_dw
    dw.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    dw.restype = ctypes.c_int
    return dx, dw


def plan(N: int, D: int, F: int, num_sms: int) -> tuple[int, int, int]:
    """(rows per block, F columns per split, splits).

    Rows per block: 32, or fewer when N is smaller (decode) or D is wide
    (the f32 rows and accumulator share one block's shared memory: 8 rows
    up to D 3072, 4 beyond, up to ``MAX_D``).  F is
    split only when the row tiles alone would leave more than half the SMs
    idle (decode): then into about one block per SM, each split a whole
    number of 32-wide F tiles."""
    br = next(b for b in (8, 16, 32) if b >= min(N, 32))
    while br * D > SMEM_ROWS_X_D:
        br //= 2
    row_tiles = -(-N // br)
    f_tiles = -(-F // BF)
    splits = 1 if 2 * row_tiles > num_sms else min(f_tiles,
                                                -(-num_sms // row_tiles))
    f_per_split = -(-f_tiles // splits) * BF
    return br, f_per_split, -(-F // f_per_split)


def plan_dx(N: int, D: int) -> int:
    """Rows per block of the dx kernel: 16 (two blocks' f32 rows and
    accumulators fit one SM at D = 768), or 8 for few rows or wide D."""
    return 16 if N > 8 and 16 * D <= SMEM_ROWS_X_D else 8


def plan_dw(N: int, D: int, F: int, num_sms: int) -> tuple[int, int, int]:
    """(F tile bf, rows per split, splits) of the dw kernel.

    bf: the widest of 16, 8, ..., 1 whose three f32 [D, bf] gradient tiles
    fit the block's shared memory.  The rows are split across blocks only
    when the F tiles alone would leave more than half the SMs idle: then
    into about one block per SM, each split a whole number of row chunks
    (``512 // bf`` rows)."""
    bf = next((b for b in DW_TILES
               if 12 * D * b + 12 * DW_CHUNK_X_BF <= DW_SMEM_BYTES), None)
    if bf is None:
        raise ValueError(f"d_model {D} too wide for the dw kernel's "
                         f"shared-memory tiles")
    chunk = DW_CHUNK_X_BF // bf
    chunks = -(-N // chunk)
    f_tiles = -(-F // bf)
    splits = 1 if 2 * f_tiles > num_sms else min(chunks,
                                                -(-num_sms // f_tiles))
    per_split = -(-chunks // splits)
    return bf, per_split * chunk, -(-chunks // per_split)


def _check(what: str, x, w_gate, w_up, w_down, *extra):
    ts = (x, w_gate, w_up, w_down) + extra
    max_d = BWD_MAX_D if extra else MAX_D
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} kernel takes CUDA tensors; "
                         f"kernels.ops dispatches CPU tensors to the plain "
                         f"version")
    if x.ndim != 2 or w_gate.ndim != 2:
        raise ValueError(f"expected x [N,D], w_gate [D,F]; got "
                         f"{tuple(x.shape)}, {tuple(w_gate.shape)}")
    N, D = x.shape
    F = w_gate.shape[1]
    if (tuple(w_gate.shape) != (D, F) or tuple(w_up.shape) != (D, F)
            or tuple(w_down.shape) != (F, D)):
        raise ValueError(f"weights {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if any(tuple(t.shape) != (N, D) for t in extra):
        raise ValueError(f"dy {[tuple(t.shape) for t in extra]} does not "
                         f"match x {tuple(x.shape)}")
    if N == 0 or F == 0 or not 0 < D <= max_d or D % 4:
        raise ValueError(f"unsupported FFN shape N={N} D={D} F={F} "
                         f"(0 < D <= {max_d}, D % 4 == 0)")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"x and weights must share one dtype of "
                         f"{list(DTYPES)}; got {[t.dtype for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x and weights must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous inputs")
    return N, D, F


def swiglu_ffn_bwd_dx(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      dy: torch.Tensor) -> torch.Tensor:
    """Backward kernel #1 (replaces ``_bwd_dx_kernel``): x, dy [N,D];
    w_gate/w_up [D,F]; w_down [F,D], contiguous, on one CUDA device, all
    f32 or all bf16 -> dx [N,D] in x's dtype."""
    global launches_dx
    N, D, F = _check(NAME_BWD_DX, x, w_gate, w_up, w_down, dy)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _bwd_entries()[0](
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dx.data_ptr(), N, D, F,
            plan_dx(N, D), DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dx launch")
    launches_dx += 1
    return dx


def swiglu_ffn_bwd_dw(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      dy: torch.Tensor):
    """Backward kernel #2 (replaces ``_bwd_dw_kernel``): as
    :func:`swiglu_ffn_bwd_dx` -> (dw_gate, dw_up, dw_down) in the weights'
    dtype; with the rows split (``plan_dw``) a second kernel adds the f32
    partials in split order."""
    global launches_dw
    N, D, F = _check(NAME_BWD_DW, x, w_gate, w_up, w_down, dy)
    bf, rows_per_split, splits = plan_dw(N, D, F,
                                         _num_sms(x.device.index or 0))
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    ws = (torch.empty((splits, 3, D * F), dtype=torch.float32,
                      device=x.device) if splits > 1 else dwg)
    with torch.cuda.device(x.device):
        code = _bwd_entries()[1](
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), ws.data_ptr(), N, D, F, bf, rows_per_split,
            splits, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dw launch")
    launches_dw += 2 if splits > 1 else 1
    return dwg, dwu, dwd


def swiglu_ffn_bwd(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, dy: torch.Tensor):
    """The backward of :func:`swiglu_ffn`: the dx kernel, then the dw
    kernel -> (dx, dw_gate, dw_up, dw_down)."""
    return (swiglu_ffn_bwd_dx(x, w_gate, w_up, w_down, dy),
            *swiglu_ffn_bwd_dw(x, w_gate, w_up, w_down, dy))


def swiglu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """x [N,D]; w_gate/w_up [D,F]; w_down [F,D], contiguous, on one CUDA
    device, all f32 or all bf16 -> [N,D] in x's dtype."""
    global launches
    N, D, F = _check("fused_ffn", x, w_gate, w_up, w_down)
    br, f_per_split, splits = plan(N, D, F, _num_sms(x.device.index or 0))
    out = torch.empty_like(x)
    ws = (torch.empty((splits, N, D), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    with torch.cuda.device(x.device):
        code = _entry()(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                        w_down.data_ptr(), out.data_ptr(), ws.data_ptr(),
                        N, D, F, br, f_per_split, splits, DTYPES[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, code, "fused_ffn launch")
    launches += 2 if splits > 1 else 1
    return out
