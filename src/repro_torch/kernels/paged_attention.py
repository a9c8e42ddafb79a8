"""Single-token decode attention over a paged KV pool on Hopper: the
wrapper of ``csrc/paged_attention.cu``.

Two entry points, each with its own launch counter:

* :func:`paged_decode_attention` replaces the TPU kernel
  ``repro/kernels/paged_attention.py:75`` ``_paged_kernel`` (reached through
  ``paged_decode_attention:111``): pools in the working dtype (f32 or
  bf16, q's dtype).  The work is bound by the bytes of the blocks the
  chains reach, so it is the split-KV flash-decode of
  ``csrc/split_decode.cuh``: each slot's table row is split over whole
  columns (:func:`decode_attention.plan_splits`: 16 columns of 16-entry
  blocks, fewer where that gives under 512 blocks); each split gathers
  only the pool blocks that hold a valid entry, a kv head's rows at a
  time in 16-byte ``cp.async`` pieces through the table it holds in
  shared memory, and the last split of each (slot, kv head) to finish
  combines the splits' f32 partials, which this wrapper allocates.
* :func:`paged_decode_attention_q8` replaces ``:92`` ``_paged_q8_kernel``
  (``paged_decode_attention_q8:157``): int8 pools with f32 per-(block,
  kv head) scales, dequantized in registers as each tile is staged; one
  CUDA block per (slot, kv head) follows the slot's table row through the
  pool in tiles of up to 64 entries (the first version's design).

Both walks stop at the first NULL column after column 0 (chains are
contiguous, so such columns are the chain's unused tail); a slot with no
valid entry averages V over its chain's entries.  The mask is the
reference's: ``kv_pos >= 0 and kv_pos <= pos``.

The plain versions are ``kernels.ref.ref_paged_decode_attention`` and
``ref_paged_decode_attention_q8``; ``kernels.ops`` dispatches by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da

SOURCE = "paged_attention"
NAME = "paged_decode_attention"
NAME_Q8 = "paged_decode_attention_q8"
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 1024   # q8: G * D outputs per block (8 per thread)
MAX_SMEM = 227 * 1024    # bytes of shared memory a block may use
TARGET_TILE = 64         # q8: entries per tile (csrc kTargetTile)
SPLIT_STATIC_SMEM = 4 * 1024   # the split kernel's bit mask, tile list,
                               # warp maxima
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""``paged_decode_attention`` launches since the last reset."""
launches_q8 = 0
"""``paged_decode_attention_q8`` launches since the last reset."""


@functools.cache
def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.library(SOURCE), f"repro_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, pos_pool, block_table, pos, extra=()):
    """Shape, type, device and layout checks shared by both entry points;
    returns (B, H, KV, D, bs, M)."""
    ts = (q, k_pool, v_pool, pos_pool, block_table, pos, *extra)
    for t in ts:
        if not t.is_cuda:
            raise ValueError("paged decode kernels take CUDA tensors; "
                             "kernels.ops dispatches CPU tensors to the "
                             "plain versions")
    if q.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"expected q [B,H,D], pools [N,bs,KV,D]; got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, H, D = q.shape
    N, bs, KV = k_pool.shape[:3]
    if k_pool.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)} (head dim, head groups)")
    if block_table.ndim != 2 or block_table.shape[0] != B \
            or pos.shape != (B,) or pos_pool.shape != (N, bs):
        raise ValueError(f"block_table {tuple(block_table.shape)} / pos "
                         f"{tuple(pos.shape)} / pos_pool "
                         f"{tuple(pos_pool.shape)} must be [B,M] / [B] / "
                         f"[N,bs]")
    if pos_pool.dtype != torch.int32 or block_table.dtype != torch.int32 \
            or pos.dtype != torch.int32:
        raise ValueError("pos_pool, block_table and pos must be int32")
    if block_table.shape[1] == 0:
        raise ValueError("block_table has no columns")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {list(DTYPES)}; got {q.dtype}")
    dev = q.device
    for t in ts:
        if t.device != dev:
            raise ValueError("paged decode inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("paged decode kernels need contiguous inputs")
    return B, H, KV, D, bs, block_table.shape[1]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pos_pool: torch.Tensor,
                           block_table: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B,H,D] (H / KV <= 8, D in ``decode_attention.HEAD_DIMS``);
    k_pool/v_pool [N,bs,KV,D] in q's dtype (f32 or bf16); pos_pool [N,bs]
    int32 (-1 = empty); block_table [B,M] int32 of block ids in [0, N);
    pos [B] int32; all contiguous on one CUDA device -> [B,H,D] in q's
    dtype."""
    global launches
    B, H, KV, D, bs, M = _check(q, k_pool, v_pool, pos_pool, block_table,
                                pos)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q and the pools must share one dtype; got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    itemsize = q.element_size()
    smem = _da.stage_bytes(D, itemsize) + 4 * M + SPLIT_STATIC_SMEM
    if D not in _da.HEAD_DIMS or H // KV > _da.MAX_GROUP or smem > MAX_SMEM:
        raise ValueError(f"unsupported paged decode shape M={M} D={D} "
                         f"G={H // KV} (D in {_da.HEAD_DIMS}, G <= "
                         f"{_da.MAX_GROUP}, {smem} of {MAX_SMEM} bytes of "
                         f"shared memory)")
    splits, split_len = _da.plan_splits(B * KV, M * bs,
                                        _da.tile_entries(D, itemsize), bs)
    out = torch.empty_like(q)
    dev = q.device
    part = _da.scratch(B, KV, H // KV, D, splits, dev)
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arrived = _da.arrival_counters(dev, stream, B * KV)
        code = _entry(NAME, 9, 9)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part.data_ptr(), arrived.data_ptr(), B, H, KV, D,
            bs, M, splits, split_len // bs, DTYPES[q.dtype], stream)
    _build.check(SOURCE, code, "paged_decode_attention launch")
    launches += 1
    return out


def paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, pos_pool: torch.Tensor,
                              block_table: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """As :func:`paged_decode_attention` over int8 pools [N,bs,KV,D] with
    f32 k_scale/v_scale [N,KV]; q f32 or bf16 -> [B,H,D] in q's dtype
    (D <= 256, G * D <= 1024)."""
    global launches_q8
    B, H, KV, D, bs, M = _check(q, k_pool, v_pool, pos_pool, block_table,
                                pos, (k_scale, v_scale))
    N = k_pool.shape[0]
    G = H // KV
    tile = bs * max(1, TARGET_TILE // bs)
    smem = 4 * (G * D + tile * (2 * D + 1) + G * tile + 3 * G + M + tile)
    if not 0 < D <= MAX_HEAD_DIM or G * D > MAX_GROUP_WIDTH \
            or smem > MAX_SMEM:
        raise ValueError(f"unsupported paged decode shape M={M} D={D} G={G} "
                         f"bs={bs} (D <= {MAX_HEAD_DIM}, G*D <= "
                         f"{MAX_GROUP_WIDTH}, {smem} of {MAX_SMEM} bytes of "
                         f"shared memory)")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"the q8 kernel takes int8 pools; got "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if any(s.dtype != torch.float32 or tuple(s.shape) != (N, KV)
           for s in (k_scale, v_scale)):
        raise ValueError(f"k_scale/v_scale must be f32 [{N},{KV}]; got "
                         f"{k_scale.dtype} {tuple(k_scale.shape)}, "
                         f"{v_scale.dtype} {tuple(v_scale.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _entry(NAME_Q8, 9, 7)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), pos_pool.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, KV,
            D, bs, M, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(SOURCE, code, "paged_decode_attention_q8 launch")
    launches_q8 += 1
    return out
