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
  combines the splits' f32 partials, which this wrapper allocates.  A
  kv head's q heads run in groups of at most 8
  (:func:`decode_attention.head_groups`): G 48 is six groups, each
  gathering the chain's blocks for its kv head.
* :func:`paged_decode_attention_q8` replaces ``:92`` ``_paged_q8_kernel``
  (``paged_decode_attention_q8:157``): int8 pools with f32 per-(block,
  kv head) scales, through the same split kernel and planner.  The int8
  rows move as int8 with each entry's two scales staged beside them; K's
  scale multiplies the entry's f32 score and V's its p.  With bf16 q each
  lane widens the int8 it loads to exact bf16 ``mma.sync`` fragments in
  registers; with f32 q the CUDA-core kernel widens them to f32.

Both walks stop at the first NULL column after column 0 (chains are
contiguous, so such columns are the chain's unused tail); a slot with no
valid entry averages V (dequantized, for int8) over its chain's entries.
The mask is the reference's: ``kv_pos >= 0 and kv_pos <= pos``.

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
MAX_SMEM = 227 * 1024    # bytes of shared memory a block may use
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
    """Shape, type, device and layout checks shared by both entry
    points."""
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


def _launch(name: str, q, pools, scales, pos_pool, block_table, pos,
            pool_itemsize: int) -> torch.Tensor:
    """Plan, allocate and launch one split decode over the paged pools
    (``scales``: the int8 pools' two [N,KV] scale tensors, else none)."""
    B, H, D = q.shape
    bs, KV = pools[0].shape[1:3]
    M = block_table.shape[1]
    itemsize = q.element_size()
    smem = (_da.stage_bytes(D, itemsize, pool_itemsize) + 4 * M
            + SPLIT_STATIC_SMEM)
    if D not in _da.HEAD_DIMS or smem > MAX_SMEM:
        raise ValueError(f"unsupported paged decode shape M={M} D={D} "
                         f"(D in {_da.HEAD_DIMS}, {smem} of {MAX_SMEM} "
                         f"bytes of shared memory)")
    groups = KV * _da.head_groups(H // KV)
    splits, split_len = _da.plan_splits(B * groups, M * bs,
                                        _da.tile_entries(D, itemsize), bs)
    out = torch.empty_like(q)
    dev = q.device
    part = _da.scratch(B, KV, H // KV, D, splits, dev)
    ptrs = [t.data_ptr() for t in (q, *pools, *scales, pos_pool, block_table,
                                   pos, out, part)]
    with _build.on_device(dev):
        stream = _build.stream_handle(dev)
        arrived = _da.arrival_counters(dev, stream, B * groups)
        code = _entry(name, len(ptrs) + 1, 9)(
            *ptrs, arrived.data_ptr(), B, H, KV, D, bs, M, splits,
            split_len // bs, DTYPES[q.dtype], stream)
    _build.check(SOURCE, code, f"{name} launch")
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pos_pool: torch.Tensor,
                           block_table: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B,H,D] (any G = H / KV, D in ``decode_attention.HEAD_DIMS``);
    k_pool/v_pool [N,bs,KV,D] in q's dtype (f32 or bf16); pos_pool [N,bs]
    int32 (-1 = empty); block_table [B,M] int32 of block ids in [0, N);
    pos [B] int32; all contiguous on one CUDA device -> [B,H,D] in q's
    dtype."""
    global launches
    _check(q, k_pool, v_pool, pos_pool, block_table, pos)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q and the pools must share one dtype; got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    out = _launch(NAME, q, (k_pool, v_pool), (), pos_pool, block_table, pos,
                  q.element_size())
    launches += 1
    return out


def paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, pos_pool: torch.Tensor,
                              block_table: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """As :func:`paged_decode_attention` over int8 pools [N,bs,KV,D] with
    f32 k_scale/v_scale [N,KV] (one scale per pool block and kv head); q
    f32 or bf16 -> [B,H,D] in q's dtype.  The same limits: any G, D in
    ``decode_attention.HEAD_DIMS``, the table row within shared memory."""
    global launches_q8
    _check(q, k_pool, v_pool, pos_pool, block_table, pos, (k_scale, v_scale))
    N, _, KV = k_pool.shape[:3]
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"the q8 kernel takes int8 pools; got "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if any(s.dtype != torch.float32 or tuple(s.shape) != (N, KV)
           for s in (k_scale, v_scale)):
        raise ValueError(f"k_scale/v_scale must be f32 [{N},{KV}]; got "
                         f"{k_scale.dtype} {tuple(k_scale.shape)}, "
                         f"{v_scale.dtype} {tuple(v_scale.shape)}")
    out = _launch(NAME_Q8, q, (k_pool, v_pool), (k_scale, v_scale), pos_pool,
                  block_table, pos, 1)
    launches_q8 += 1
    return out
