"""Fused SwiGLU FFN forward on Hopper: the wrapper of ``csrc/fused_ffn.cu``.

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

The plain version is ``kernels.ref.ref_swiglu_ffn``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "fused_ffn"
BF = 32            # F tile width (csrc/fused_ffn.cu)
SMEM_ROWS_X_D = 24576  # br * D: the f32 [br, D] rows + accumulator in smem
MAX_D = SMEM_ROWS_X_D // 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``: one per
call, two when F is split (the partial-sum kernel and the reduce)."""


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


def plan(N: int, D: int, F: int, num_sms: int) -> tuple[int, int, int]:
    """(rows per block, F columns per split, splits).

    Rows per block: 32, or fewer when N is smaller (decode) or D is wide
    (the f32 rows and accumulator share one block's shared memory).  F is
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


def swiglu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """x [N,D]; w_gate/w_up [D,F]; w_down [F,D], contiguous, on one CUDA
    device, all f32 or all bf16 -> [N,D] in x's dtype."""
    global launches
    ts = (x, w_gate, w_up, w_down)
    if not all(t.is_cuda for t in ts):
        raise ValueError("fused_ffn kernel takes CUDA tensors; "
                         "kernels.ops.swiglu_ffn dispatches CPU tensors to "
                         "the plain version")
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
    if N == 0 or F == 0 or not 0 < D <= MAX_D or D % 4:
        raise ValueError(f"unsupported FFN shape N={N} D={D} F={F} "
                         f"(0 < D <= {MAX_D}, D % 4 == 0)")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"x and weights must share one dtype of "
                         f"{list(DTYPES)}; got {[t.dtype for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x and weights must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_ffn needs contiguous x and weights")
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
