"""Fused SwiGLU FFN on Hopper: the wrappers of ``csrc/fused_ffn.cu``
(forward) and ``csrc/fused_ffn_bwd.cu`` (backward).

Replaces the TPU kernel ``repro/kernels/fused_ffn.py:50`` ``_ffn_kernel``
(reached through ``_forward:71``): ``y = (silu(x·Wg) ⊙ x·Wu)·Wd``.  The
route is chosen from ``x.dtype``:

* bf16 (every serve and train run on the card) runs on the tensor cores
  in two launches over the wgmma/TMA mainloop of ``csrc/gemm_sm90.cuh``:
  the gate/up kernel stores ``h = silu(x·Wg) ⊙ x·Wu`` as bf16 into an
  [N, F] scratch, the down kernel computes ``h·Wd``.  When the down
  kernel's output tiles alone would leave SMs idle (decode), its K = F is
  split across blocks whose f32 partials a third kernel adds in split
  order — deterministic, no atomics.  ``plan_tc`` picks the tiles and the
  splits.
* f32 (the parity checks) runs the first SIMT version, which keeps the
  [N, F] hidden on chip: a block owns ``br`` rows and a range of F, stages
  its rows in shared memory and folds each 32-wide hidden tile into an f32
  [br, D] accumulator there; with too few row tiles F is split across
  blocks and reduced in order (``plan``).

The backward (:func:`swiglu_ffn_bwd`) replaces the TPU kernels
``repro/kernels/fused_ffn.py:108`` ``_bwd_dx_kernel`` and ``:131``
``_bwd_dw_kernel`` (reached through ``_backward:159``).  dx in bf16 is two
tensor-core launches: one stores dg and du as bf16 [N, F] scratch from
the three products g, u and dh, one computes ``dg·Wgᵀ + du·Wuᵀ`` over
K = 2F (split like the forward's down kernel).  dx in f32 walks F per
block of rows, as the f32 forward (``plan_dx``).  dw, in both dtypes,
owns a narrow F tile (``plan_dw``) and walks rows, recomputing the
(g, u, dh) tile it needs, split across blocks into an f32 workspace added
in order by a second kernel when the F tiles alone would leave SMs idle.

The plain versions are ``kernels.ref.ref_swiglu_ffn`` and
``ref_swiglu_ffn_bwd``; ``kernels.ops`` dispatches between them and the
kernels by device, the backward through ``ops.SwiGLUFFN``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
TC_BK = 64       # the tensor-core kernels' K tile (csrc/gemm_sm90.cuh)
TC_BN_DOWN = 128  # output columns a block of the down and dx kernels
TC_BN_GRAD = 64   # F columns a block of the bwd gradient kernel

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``.  bf16:
two per call (gate/up, down), three when the down kernel's K is split (its
reduce).  f32: one per call, two when F is split (the partial-sum kernel
and the reduce)."""
launches_dx = 0
"""Backward dx kernel launches.  bf16: two per call (gradients, dx), three
when dx's K is split.  f32: one per call."""
launches_dw = 0
"""Backward dw kernel launches: one per backward call, two when the rows
are split (the partial-sum kernel and the reduce)."""


@functools.cache
def _entries():
    lib = _build.library(NAME)
    simt, tc = lib.repro_swiglu_ffn_fwd, lib.repro_swiglu_ffn_fwd_tc
    simt.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    tc.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    simt.restype = tc.restype = ctypes.c_int
    return simt, tc


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bwd_entries():
    lib = _build.library(BWD_LIB)
    dx = lib.repro_swiglu_ffn_bwd_dx
    dx.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    dx.restype = ctypes.c_int
    dx_tc = lib.repro_swiglu_ffn_bwd_dx_tc
    dx_tc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    dx_tc.restype = ctypes.c_int
    dw = lib.repro_swiglu_ffn_bwd_dw
    dw.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    dw.restype = ctypes.c_int
    return dx, dw, dx_tc


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


class TcPlan(NamedTuple):
    """Tiles of the bf16 tensor-core route (``plan_tc``).  The first kernel
    (forward gate/up, backward gradients) writes the [N, F] bf16 scratch on
    a ``grid1`` of (row tiles, F tiles); the second (forward down, backward
    dx) writes [N, D] on a ``grid2`` of (row tiles, D tiles, K splits),
    its K (F, or 2F for dx) in ``k_tiles`` 64-deep tiles,
    ``k_tiles_per_split`` to a split."""
    bm: int
    bn1: int
    grid1: tuple[int, int]
    grid2: tuple[int, int, int]
    k_tiles: int
    k_tiles_per_split: int
    scratch: tuple[int, int]

    @property
    def splits(self) -> int:
        return self.grid2[2]


@functools.lru_cache(maxsize=256)
def plan_tc(N: int, D: int, F: int, num_sms: int,
            backward: bool = False) -> TcPlan:
    """Tiles and K splits of the bf16 forward (or, ``backward``, dx).

    Rows per block: 64 (one consumer warpgroup) up to 64 rows, else 128.
    The forward's gate/up kernel takes 128 F columns a block, or 64 when
    128 would leave SMs without a block (decode); the backward's gradient
    kernel, with three accumulators, takes 64.  The second kernel's K is
    split only when its output tiles alone would leave SMs idle: then into
    about one block per SM, each split a whole number of K tiles, none
    empty."""
    bm = 64 if N <= 64 else 128
    rows = -(-N // bm)
    if backward:
        bn1 = TC_BN_GRAD
    else:
        bn1 = 128 if rows * -(-F // 128) >= num_sms else 64
    k_tiles = -(-F // TC_BK) * (2 if backward else 1)
    tiles2 = rows * -(-D // TC_BN_DOWN)
    splits = 1 if tiles2 >= num_sms else min(k_tiles, -(-num_sms // tiles2))
    per = -(-k_tiles // splits)
    return TcPlan(bm, bn1, (rows, -(-F // bn1)),
                  (rows, -(-D // TC_BN_DOWN), -(-k_tiles // per)), k_tiles,
                  per, (N, F))


def _check(what: str, x, w_gate, w_up, w_down, *extra, tc: bool = False):
    """(N, D, F) of valid inputs, else ValueError.  ``tc``: the bf16
    tensor-core route, whose TMA loads need D and F multiples of 8 (16-byte
    row strides) and 16-byte aligned tensors; the SIMT kernels take
    D <= ``MAX_D`` (``BWD_MAX_D`` in the backward) with D % 4 == 0."""
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
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"x and weights must share one dtype of "
                         f"{list(DTYPES)}; got {[t.dtype for t in ts]}")
    if tc:
        if N == 0 or D == 0 or F == 0 or D % 8 or F % 8:
            raise ValueError(f"unsupported FFN shape N={N} D={D} F={F} "
                             f"(D % 8 == 0 and F % 8 == 0 for TMA's 16-byte "
                             f"strides)")
        if any(t.data_ptr() % 16 for t in ts):
            raise ValueError(f"{what} needs 16-byte aligned tensors")
    elif N == 0 or F == 0 or not 0 < D <= max_d or D % 4:
        raise ValueError(f"unsupported FFN shape N={N} D={D} F={F} "
                         f"(0 < D <= {max_d}, D % 4 == 0)")
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
    f32 or all bf16 -> dx [N,D] in x's dtype.  bf16 runs the tensor-core
    route (``plan_tc``), whose dg/du scratch is freed on return; f32 the
    SIMT kernel (``plan_dx``)."""
    global launches_dx
    tc = x.dtype == torch.bfloat16
    N, D, F = _check(NAME_BWD_DX, x, w_gate, w_up, w_down, dy, tc=tc)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc:
        pl = plan_tc(N, D, F, _num_sms(x.device.index or 0), backward=True)
        dg, du = (torch.empty(pl.scratch, dtype=x.dtype, device=x.device)
                  for _ in range(2))
        ws = (torch.empty((pl.splits, N, D), dtype=torch.float32,
                          device=x.device) if pl.splits > 1 else dx)
        with torch.cuda.device(x.device):
            code = _bwd_entries()[2](
                x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                w_down.data_ptr(), dy.data_ptr(), dg.data_ptr(),
                du.data_ptr(), dx.data_ptr(), ws.data_ptr(), N, D, F,
                pl.bm // 64, pl.splits, pl.k_tiles_per_split, stream)
        _build.check(BWD_LIB, code, "fused_ffn_bwd_dx launch")
        launches_dx += 3 if pl.splits > 1 else 2
        return dx
    with torch.cuda.device(x.device):
        code = _bwd_entries()[0](
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dx.data_ptr(), N, D, F,
            plan_dx(N, D), stream)
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
    device, all f32 or all bf16 -> [N,D] in x's dtype.  bf16 runs the
    tensor-core route (``plan_tc``), whose h scratch is freed on return;
    f32 the SIMT kernel (``plan``)."""
    global launches
    tc = x.dtype == torch.bfloat16
    N, D, F = _check(NAME, x, w_gate, w_up, w_down, tc=tc)
    sms = _num_sms(x.device.index or 0)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc:
        pl = plan_tc(N, D, F, sms)
        h = torch.empty(pl.scratch, dtype=x.dtype, device=x.device)
        ws = (torch.empty((pl.splits, N, D), dtype=torch.float32,
                          device=x.device) if pl.splits > 1 else out)
        with torch.cuda.device(x.device):
            code = _entries()[1](
                x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                w_down.data_ptr(), h.data_ptr(), out.data_ptr(),
                ws.data_ptr(), N, D, F, pl.bm // 64, pl.bn1, pl.splits,
                pl.k_tiles_per_split, stream)
        _build.check(NAME, code, "fused_ffn launch")
        launches += 3 if pl.splits > 1 else 2
        return out
    br, f_per_split, splits = plan(N, D, F, sms)
    ws = (torch.empty((splits, N, D), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    with torch.cuda.device(x.device):
        code = _entries()[0](x.data_ptr(), w_gate.data_ptr(),
                             w_up.data_ptr(), w_down.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), N, D, F, br,
                             f_per_split, splits, stream)
    _build.check(NAME, code, "fused_ffn launch")
    launches += 2 if splits > 1 else 1
    return out
