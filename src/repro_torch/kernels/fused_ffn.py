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
``_bwd_dw_kernel`` (reached through ``_backward:159``).  In bf16 it is
three tensor-core launches: the gradient kernel stores dg, du and
``h = silu(g)·u`` as [2, N, F] bf16 (hi, lo) pairs from the three
products g, u and dh (:func:`swiglu_ffn_bwd_grads`), staged in shared
memory so that whole rows leave in 16-byte stores; the dx kernel
computes ``dg·Wgᵀ + du·Wuᵀ`` from the hi parts over K = 2F (split like the
forward's down kernel); the dW kernel computes ``xᵀ·dg``, ``xᵀ·du`` and
``(dyᵀ·h)ᵀ`` over both parts, K = 2N (:func:`swiglu_ffn_bwd_dw_tc`,
``plan_dw_tc``), with the rows split across blocks and added in order
when its output tiles alone would leave SMs idle.  The pairs keep ~16
bits of dg, du and h: rounded once to bf16, the N-term weight-grad sums
drift ~2^-9 of their RMS from the f32 result, past the reference's
elementwise bound on their small entries.  In f32, dx walks F per block
of rows, as the f32 forward (``plan_dx``), and dW owns a narrow F tile
(``plan_dw``) and walks rows, recomputing the (g, u, dh) tile it needs,
split across blocks into an f32 workspace added in order by a second
kernel when the F tiles alone would leave SMs idle.

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
BWD_MAX_D = SMEM_ROWS_X_D // 4   # the dx kernel's blocks take 4 rows up
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
"""Backward dx kernel launches.  bf16: the gradient kernel (once per
backward, also when only the weight grads are asked for), then the dx
kernel and, when its K is split, the reduce.  f32: one per call."""
launches_dw = 0
"""Backward dW kernel launches: one per call, two when the rows are split
(the partial-sum kernel and the reduce); in bf16 from the gradient
kernel's scratch."""


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


class _BwdEntries(NamedTuple):
    dx: object       # f32 SIMT dx
    dw: object       # f32 SIMT dW
    grad_tc: object  # bf16: dg, du (and h) scratch
    dx_tc: object    # bf16: dx from dg, du
    dw_tc: object    # bf16: dW from x, dy, dg, du, h


@functools.cache
def _bwd_entries() -> _BwdEntries:
    lib = _build.library(BWD_LIB)
    fns = _BwdEntries(lib.repro_swiglu_ffn_bwd_dx, lib.repro_swiglu_ffn_bwd_dw,
                      lib.repro_swiglu_ffn_bwd_grad_tc,
                      lib.repro_swiglu_ffn_bwd_dx_tc,
                      lib.repro_swiglu_ffn_bwd_dw_tc)
    for fn, ptrs, ints in zip(fns, (6, 9, 8, 6, 9), (4, 6, 4, 6, 6)):
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


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
    accumulators fit one SM at D = 768), 8 for few rows or wide D, 4 past
    D 3072 (jamba-v0.1-52b's 4096)."""
    if N > 8 and 16 * D <= SMEM_ROWS_X_D:
        return 16
    return 8 if 8 * D <= SMEM_ROWS_X_D else 4


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


class DwPlan(NamedTuple):
    """Tiles of the bf16 dW kernel (``plan_dw_tc``): [bm, bn] tiles of
    [D, F] on a ``grid`` of (D tiles, F tiles, K splits), each tile the
    three products dWg, dWu and dWdᵀ; K = 2N rows (the pairs' hi rows,
    then their lo rows) in ``k_tiles`` 64-row tiles, ``k_tiles_per_split``
    to a split."""
    bm: int
    bn: int
    grid: tuple[int, int, int]
    k_tiles: int
    k_tiles_per_split: int

    @property
    def splits(self) -> int:
        return self.grid[2]


@functools.lru_cache(maxsize=256)
def plan_dw_tc(N: int, D: int, F: int, num_sms: int) -> DwPlan:
    """Tiles and row splits of the bf16 dW kernel.

    A block owns a [bm, 64] tile of [D, F] (bm 128: two consumer
    warpgroups, or 64 where D is that narrow) for all three products, so
    dWg and dWu read one xᵀ tile.  The rows (K) are split only when the
    output tiles alone would leave SMs idle: then into about one block per
    SM, each split a whole number of 64-row tiles, none empty."""
    bm = 64 if D <= 64 else 128
    tiles = -(-D // bm) * -(-F // TC_BN_GRAD)
    k_tiles = 2 * -(-N // TC_BK)
    splits = 1 if tiles >= num_sms else min(k_tiles, -(-num_sms // tiles))
    per = -(-k_tiles // splits)
    return DwPlan(bm, TC_BN_GRAD, (-(-D // bm), -(-F // TC_BN_GRAD),
                                   -(-k_tiles // per)), k_tiles, per)


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def swiglu_ffn_bwd_grads(x: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, w_down: torch.Tensor,
                         dy: torch.Tensor):
    """The bf16 gradient kernel: x, dy [N,D]; w_gate/w_up [D,F]; w_down
    [F,D], bf16, contiguous, on one CUDA device -> (dg, du, h) with
    dh = dy·Wdᵀ, du = dh·silu(g), dg = dh·u·silu'(g), h = silu(g)·u, from
    f32, each a bf16 [2, N, F] pair (hi = the value rounded to bf16, lo =
    the rest rounded to bf16): the dx kernel reads the hi planes, the dW
    kernel both."""
    global launches_dx
    N, D, F = _check(NAME_BWD_DX, x, w_gate, w_up, w_down, dy, tc=True)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the gradient kernel is bf16 only; got {x.dtype}")
    pl = plan_tc(N, D, F, _num_sms(x.device.index or 0), backward=True)
    dg, du, h = (torch.empty((2, *pl.scratch), dtype=x.dtype,
                             device=x.device) for _ in range(3))
    with torch.cuda.device(x.device):
        code = _bwd_entries().grad_tc(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dg.data_ptr(), du.data_ptr(),
            h.data_ptr(), N, D, F, pl.bm // 64,
            _stream(x))
    _build.check(BWD_LIB, code, "fused_ffn_bwd gradient launch")
    launches_dx += 1
    return dg, du, h


def _dx_tc(w_gate, w_up, dg, du) -> torch.Tensor:
    """dx = dg·Wgᵀ + du·Wuᵀ on the tensor cores from the hi planes of the
    gradient kernel's [2, N, F] pairs (the dx kernel, its K split as
    ``plan_tc`` says)."""
    global launches_dx
    (N, F), D = dg.shape[1:], w_gate.shape[0]
    pl = plan_tc(N, D, F, _num_sms(dg.device.index or 0), backward=True)
    dx = torch.empty((N, D), dtype=dg.dtype, device=dg.device)
    ws = (torch.empty((pl.splits, N, D), dtype=torch.float32,
                      device=dg.device) if pl.splits > 1 else dx)
    with torch.cuda.device(dg.device):
        code = _bwd_entries().dx_tc(
            w_gate.data_ptr(), w_up.data_ptr(), dg.data_ptr(), du.data_ptr(),
            dx.data_ptr(), ws.data_ptr(), N, D, F, pl.bm // 64, pl.splits,
            pl.k_tiles_per_split, _stream(dg))
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dx launch")
    launches_dx += 2 if pl.splits > 1 else 1
    return dx


def swiglu_ffn_bwd_dw_tc(x: torch.Tensor, dy: torch.Tensor,
                         dg: torch.Tensor, du: torch.Tensor,
                         h: torch.Tensor):
    """The bf16 dW kernel alone (replaces ``_bwd_dw_kernel``): x, dy [N,D]
    and the gradient kernel's dg, du, h (hi, lo) pairs [2,N,F], bf16,
    contiguous, 16-byte aligned, on one CUDA device, D and F multiples of
    8 -> (dw_gate [D,F], dw_up [D,F], dw_down [F,D]) = (xᵀ·dg, xᵀ·du,
    hᵀ·dy) in bf16, each of dg, du, h the sum of its pair; with the rows
    split (``plan_dw_tc``) a second kernel adds the f32 partials in split
    order."""
    global launches_dw
    ts = (x, dy, dg, du, h)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{NAME_BWD_DW} kernel takes CUDA tensors")
    if x.ndim != 2 or dg.ndim != 3:
        raise ValueError(f"expected x [N,D], dg [2,N,F]; got "
                         f"{tuple(x.shape)}, {tuple(dg.shape)}")
    (N, D), F = x.shape, dg.shape[2]
    if (tuple(dy.shape) != (N, D)
            or any(tuple(t.shape) != (2, N, F) for t in (dg, du, h))):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} are not "
                         f"x, dy [N,D] and dg, du, h [2,N,F]")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"the dW kernel is bf16 only; got "
                         f"{[t.dtype for t in ts]}")
    if N == 0 or D == 0 or F == 0 or D % 8 or F % 8:
        raise ValueError(f"unsupported FFN shape N={N} D={D} F={F} "
                         f"(D % 8 == 0 and F % 8 == 0 for TMA's 16-byte "
                         f"strides)")
    if len({t.device for t in ts}) != 1:
        raise ValueError("dW inputs must be on one device")
    if not all(t.is_contiguous() for t in ts) or any(t.data_ptr() % 16
                                                      for t in ts):
        raise ValueError(f"{NAME_BWD_DW} needs contiguous 16-byte aligned "
                         f"inputs")
    pl = plan_dw_tc(N, D, F, _num_sms(x.device.index or 0))
    dwg, dwu = (torch.empty((D, F), dtype=x.dtype, device=x.device)
                for _ in range(2))
    dwd = torch.empty((F, D), dtype=x.dtype, device=x.device)
    ws = (torch.empty((pl.splits, 3, D * F), dtype=torch.float32,
                      device=x.device) if pl.splits > 1 else dwg)
    with torch.cuda.device(x.device):
        code = _bwd_entries().dw_tc(
            x.data_ptr(), dy.data_ptr(), dg.data_ptr(), du.data_ptr(),
            h.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(),
            ws.data_ptr(), N, D, F, pl.bm // 64, pl.splits,
            pl.k_tiles_per_split, _stream(x))
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dw launch")
    launches_dw += 2 if pl.splits > 1 else 1
    return dwg, dwu, dwd


def swiglu_ffn_bwd_dx(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      dy: torch.Tensor) -> torch.Tensor:
    """Backward kernel #1 (replaces ``_bwd_dx_kernel``): x, dy [N,D];
    w_gate/w_up [D,F]; w_down [F,D], contiguous, on one CUDA device, all
    f32 or all bf16 -> dx [N,D] in x's dtype.  bf16 runs the gradient
    kernel and the dx kernel over its hi planes (``plan_tc``), as
    :func:`swiglu_ffn_bwd` does, the scratch freed on return; f32 the SIMT
    kernel (``plan_dx``)."""
    global launches_dx
    if x.dtype == torch.bfloat16:
        dg, du, _ = swiglu_ffn_bwd_grads(x, w_gate, w_up, w_down, dy)
        return _dx_tc(w_gate, w_up, dg, du)
    N, D, F = _check(NAME_BWD_DX, x, w_gate, w_up, w_down, dy)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _bwd_entries().dx(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dx.data_ptr(), N, D, F,
            plan_dx(N, D), _stream(x))
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dx launch")
    launches_dx += 1
    return dx


def swiglu_ffn_bwd_dw(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      dy: torch.Tensor):
    """Backward kernel #2 (replaces ``_bwd_dw_kernel``): as
    :func:`swiglu_ffn_bwd_dx` -> (dw_gate, dw_up, dw_down) in the weights'
    dtype.  bf16 runs the gradient kernel, then the dW kernel on its
    scratch (:func:`swiglu_ffn_bwd_dw_tc`); f32 the SIMT kernel, with the
    rows split (``plan_dw``) and a second kernel adding the f32 partials in
    split order."""
    global launches_dw
    if x.dtype == torch.bfloat16:
        dg, du, h = swiglu_ffn_bwd_grads(x, w_gate, w_up, w_down, dy)
        return swiglu_ffn_bwd_dw_tc(x, dy, dg, du, h)
    N, D, F = _check(NAME_BWD_DW, x, w_gate, w_up, w_down, dy)
    bf, rows_per_split, splits = plan_dw(N, D, F,
                                         _num_sms(x.device.index or 0))
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    ws = (torch.empty((splits, 3, D * F), dtype=torch.float32,
                      device=x.device) if splits > 1 else dwg)
    with torch.cuda.device(x.device):
        code = _bwd_entries().dw(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), ws.data_ptr(), N, D, F, bf, rows_per_split,
            splits, _stream(x))
    _build.check(BWD_LIB, code, "fused_ffn_bwd_dw launch")
    launches_dw += 2 if splits > 1 else 1
    return dwg, dwu, dwd


def swiglu_ffn_bwd(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, dy: torch.Tensor):
    """The backward of :func:`swiglu_ffn` -> (dx, dw_gate, dw_up, dw_down).
    bf16: the gradient kernel once (the dg, du, h pairs), then the dx and
    dW kernels on that scratch, which is freed on return; f32: the dx
    kernel, then the dW kernel."""
    if x.dtype == torch.bfloat16:
        dg, du, h = swiglu_ffn_bwd_grads(x, w_gate, w_up, w_down, dy)
        return (_dx_tc(w_gate, w_up, dg, du),
                *swiglu_ffn_bwd_dw_tc(x, dy, dg, du, h))
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
    stream = _stream(x)
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
