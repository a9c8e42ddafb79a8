"""int8 max-abs quantization on Hopper: the wrappers of ``csrc/quant.cu``.

Three entry points, each with its own launch counter:

* :func:`quantize_rows` replaces the TPU kernel
  ``repro/kernels/quant.py:39`` ``_quant_kernel`` (reached through
  ``_quantize_int8:73``): per row, ``scale = max|x| / 127`` (a zero scale
  divides as 1), ``clip(round(x / scale), -127, 127)`` with round half to
  even.  A row is a [nb, 256] matrix's row, or a (block column, kv head)
  tile [bs, Dh] read in place from prefill caches [..., T, KV, Dh] (the
  int8 pool's admission splice).
* :func:`dequantize_rows` replaces ``:48`` ``_dequant_kernel``
  (``_dequantize_int8:102``): ``q * scale`` per row in f32; with a block
  table it emits each table row's blocks as one contiguous
  [B, M*bs, KV, Dh] gather in the activation dtype (the int8 chunk
  append's ``_dequantize_gather``, ``repro/models/attention.py:406``).
* :func:`quantized_block_write` is the int8 pool's entry write
  (``repro/models/attention.py:378``, the reference's jnp form of
  ``block_quant``): clear the scales of blocks written at offset 0, grow
  each written block's scale by its new entries' max / 127, requantize the
  block's payload once by ``round(q * old / new)``, write the entries.
  K and V go in one launch.

The plain versions are ``kernels.ref.ref_quantize_rows``,
``ref_quantize_kv_tiles``, ``ref_dequantize_rows``,
``ref_dequantize_gather`` and ``ref_quantized_block_write``;
``kernels.ops`` dispatches by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

SOURCE = "quant"
NAME_QUANT = "quantize_int8"
NAME_DEQUANT = "dequantize_int8"
NAME_WRITE = "quantized_block_write"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KV_HEADS = 256

launches_quant = 0
"""``quantize_rows`` launches since the last reset."""
launches_dequant = 0
"""``dequantize_rows`` launches since the last reset."""
launches_write = 0
"""``quantized_block_write`` launches since the last reset."""


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(_build.library(SOURCE), f"repro_{name}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _cuda(*ts, what: str) -> torch.device:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors; kernels.ops "
                         f"dispatches CPU tensors to the plain version")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what} inputs must be on one device")
    return ts[0].device


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def quantize_rows(x: torch.Tensor, *, block_size: Optional[int] = None,
                  nb: Optional[int] = None):
    """Without ``block_size``: x [rows, n] f32 or bf16 -> (q int8 [rows, n],
    scale f32 [rows]).  With ``block_size`` and ``nb``: prefill caches
    x [R, B, T, KV, Dh] -> (q int8 [R, B, nb*bs, KV, Dh], scale f32
    [R, B, nb, KV]), one scale per (block column, kv head) tile of the
    first ``nb * block_size`` entries; entries past T quantize as zeros.
    x contiguous on a CUDA device."""
    global launches_quant
    dev = _cuda(x, what="quantize_rows")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"quantize_rows takes a contiguous f32 or bf16 "
                         f"tensor; got {x.dtype}, contiguous="
                         f"{x.is_contiguous()}")
    if block_size is None:
        if x.ndim != 2 or 0 in x.shape:
            raise ValueError(f"expected x [rows, n]; got {tuple(x.shape)}")
        rows, n = x.shape
        q = torch.empty(rows, n, dtype=torch.int8, device=dev)
        scale = torch.empty(rows, dtype=torch.float32, device=dev)
        args = (rows, n, 1, 1, 1, n, 1)
    else:
        if x.ndim != 5 or nb is None or nb < 1 or block_size < 1 \
                or 0 in x.shape:
            raise ValueError(f"expected x [R,B,T,KV,Dh] and nb >= 1; got "
                             f"{tuple(x.shape)}, nb={nb}")
        R, B, T, KV, Dh = x.shape
        q = torch.empty(R, B, nb * block_size, KV, Dh, dtype=torch.int8,
                        device=dev)
        scale = torch.empty(R, B, nb, KV, dtype=torch.float32, device=dev)
        args = (R * B, T * KV * Dh, nb, block_size, KV, Dh, T)
    with torch.cuda.device(dev):
        code = _entry("quantize_rows", (_P, _P, _P, _L, _L) + (_I,) * 6
                      + (_P,))(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               *args, DTYPES[x.dtype], _stream(dev))
    _build.check(SOURCE, code, "quantize_rows launch")
    launches_quant += 1
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    block_table: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Without a table: q int8 [rows, n] x scale f32 [rows] -> f32
    [rows, n].  With ``block_table`` [B,M] int32: int8 pool q [N,bs,KV,Dh]
    with scale [N,KV] -> each row's blocks [B, M*bs, KV, Dh] in ``dtype``
    (f32 or bf16; the product is taken in f32 and rounded once).  All
    contiguous on one CUDA device."""
    global launches_dequant
    ts = (q, scale) + ((block_table,) if block_table is not None else ())
    dev = _cuda(*ts, what="dequantize_rows")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or dtype not in DTYPES:
        raise ValueError(f"dequantize_rows takes int8 q, f32 scales and an "
                         f"f32 or bf16 output; got {q.dtype}, {scale.dtype}, "
                         f"{dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dequantize_rows needs contiguous inputs")
    if block_table is None:
        if q.ndim != 2 or tuple(scale.shape) != (q.shape[0],) \
                or 0 in q.shape:
            raise ValueError(f"expected q [rows, n], scale [rows]; got "
                             f"{tuple(q.shape)}, {tuple(scale.shape)}")
        rows, (bs, KV, D) = q.shape[0], (1, 1, q.shape[1])
        out = torch.empty(q.shape, dtype=dtype, device=dev)
        tbl = None
    else:
        if q.ndim != 4 or tuple(scale.shape) != (q.shape[0], q.shape[2]) \
                or block_table.ndim != 2 or block_table.dtype != torch.int32 \
                or 0 in block_table.shape:
            raise ValueError(f"expected pool [N,bs,KV,Dh], scale [N,KV], "
                             f"int32 table [B,M]; got {tuple(q.shape)}, "
                             f"{tuple(scale.shape)}, {block_table.dtype} "
                             f"{tuple(block_table.shape)}")
        B, M = block_table.shape
        _, bs, KV, D = q.shape
        rows = B * M
        out = torch.empty(B, M * bs, KV, D, dtype=dtype, device=dev)
        tbl = block_table.data_ptr()
    with torch.cuda.device(dev):
        code = _entry("dequantize_rows", (_P, _P, _P, _P, _L) + (_I,) * 4
                      + (_P,))(q.data_ptr(), scale.data_ptr(), tbl,
                               out.data_ptr(), rows, bs, KV, D,
                               DTYPES[dtype], _stream(dev))
    _build.check(SOURCE, code, "dequantize_rows launch")
    launches_dequant += 1
    return out


def quantized_block_write(pools: Sequence[torch.Tensor],
                          scale_pools: Sequence[torch.Tensor],
                          news: Sequence[torch.Tensor],
                          write_bids: torch.Tensor,
                          off: torch.Tensor) -> None:
    """In place, for one or two leaves (K, V): quantize the new entries
    ``news[i]`` [R,KV,Dh] (f32 or bf16) into the int8 pool ``pools[i]``
    [N,bs,KV,Dh] at (``write_bids``, ``off``) [R] int32 against its f32
    per-(block, kv head) scales ``scale_pools[i]`` [N,KV]; all contiguous on
    one CUDA device.  Rows that repeat a block (the trash block, a chunk's
    tokens) are allowed; the block is requantized once."""
    global launches_write
    n = len(pools)
    if not 1 <= n <= 2 or len(scale_pools) != n or len(news) != n:
        raise ValueError("quantized_block_write takes one or two leaves")
    ts = (*pools, *scale_pools, *news, write_bids, off)
    dev = _cuda(*ts, what="quantized_block_write")
    N, bs, KV, D = pools[0].shape
    R = write_bids.shape[0] if write_bids.ndim == 1 else -1
    if any(p.dtype != torch.int8 or tuple(p.shape) != (N, bs, KV, D)
           for p in pools) \
            or any(s.dtype != torch.float32 or tuple(s.shape) != (N, KV)
                   for s in scale_pools) \
            or R < 1 or tuple(off.shape) != (R,) \
            or write_bids.dtype != torch.int32 or off.dtype != torch.int32 \
            or any(tuple(x.shape) != (R, KV, D) for x in news) \
            or len({x.dtype for x in news}) != 1 \
            or news[0].dtype not in DTYPES or KV > MAX_KV_HEADS:
        raise ValueError(
            f"quantized_block_write: expected int8 pools [N,bs,KV,Dh], f32 "
            f"scales [N,KV], new entries [R,KV,Dh] (f32 or bf16) and int32 "
            f"bids/off [R]; got pools {[tuple(p.shape) for p in pools]}, "
            f"scales {[tuple(s.shape) for s in scale_pools]}, new "
            f"{[(tuple(x.shape), x.dtype) for x in news]}, bids "
            f"{write_bids.dtype} {tuple(write_bids.shape)}, off "
            f"{off.dtype} {tuple(off.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quantized_block_write needs contiguous inputs")
    ptrs = [(p.data_ptr(), s.data_ptr(), x.data_ptr())
            for p, s, x in zip(pools, scale_pools, news)]
    if n == 1:
        ptrs.append((None, None, None))
    with torch.cuda.device(dev):
        code = _entry("quantized_block_write", (_P,) * 8 + (_I,) * 6
                      + (_P,))(*ptrs[0], *ptrs[1], write_bids.data_ptr(),
                               off.data_ptr(), n, R, bs, KV, D,
                               DTYPES[news[0].dtype], _stream(dev))
    _build.check(SOURCE, code, "quantized_block_write launch")
    launches_write += 1
