"""int8 max-abs quantization on Hopper: the wrappers of ``csrc/quant.cu``.

Three entry points, each with its own launch counter:

* :func:`quantize_rows` replaces the TPU kernel
  ``repro/kernels/quant.py:39`` ``_quant_kernel`` (reached through
  ``_quantize_int8:73``): per row, ``scale = max|x| / 127`` (a zero scale
  divides as 1), ``clip(round(x / scale), -127, 127)`` with round half to
  even.  A row is a [nb, 256] matrix's row, or a (block column, kv head)
  tile [bs, Dh] read in place from prefill caches [..., T, KV, Dh] (the
  int8 pool's admission splice).  A warp takes a row of up to 1,024
  values (more warps a longer row), holds it in registers between its max
  and its write (a row of over 8,192 values is read twice), and K and V
  go in one launch.
* :func:`dequantize_rows` replaces ``:48`` ``_dequant_kernel``
  (``_dequantize_int8:102``): ``q * scale`` per row in f32; with a block
  table it emits each table row's blocks as one contiguous
  [B, M*bs, KV, Dh] gather in the activation dtype (the int8 chunk
  append's ``_dequantize_gather``, ``repro/models/attention.py:406``).
  A thread moves 16 values (one 16-byte load of one (entry, kv head)
  row's int8, one scale), so rows must be multiples of 16 long; K and V
  go in one launch.
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
ROW_MULTIPLE = 8      # values of a 16-byte piece of bf16 (two of f32)

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
_DEQUANT_ARGS = (_P,) * 7 + (_I, _L) + (_I,) * 4 + (_P,)
_QUANT_ARGS = (_P,) * 6 + (_I, _L, _L) + (_I,) * 6 + (_P,)


def _cuda(*ts, what: str) -> torch.device:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors; kernels.ops "
                         f"dispatches CPU tensors to the plain version")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what} inputs must be on one device")
    return ts[0].device


def quantize_rows(x, *, block_size: Optional[int] = None,
                  nb: Optional[int] = None):
    """Without ``block_size``: x [rows, n] f32 or bf16 -> (q int8 [rows, n],
    scale f32 [rows]).  With ``block_size`` and ``nb``: prefill caches
    x [R, B, T, KV, Dh] -> (q int8 [R, B, nb*bs, KV, Dh], scale f32
    [R, B, nb, KV]), one scale per (block column, kv head) tile of the
    first ``nb * block_size`` entries; entries past T quantize as zeros.
    ``x`` is one tensor, or two (K and V, of one shape and dtype): then one
    launch quantizes both and a pair of (q, scale) comes back, each a
    contiguous view of one buffer.  A row (n, or bs * Dh) is read in
    16-byte pieces of 8 values, so n or Dh must be a multiple of
    ``ROW_MULTIPLE``; x contiguous and 16-byte aligned on a CUDA
    device."""
    global launches_quant
    pair = not isinstance(x, torch.Tensor)
    xs = tuple(x) if pair else (x,)
    if not 1 <= len(xs) <= 2:
        raise ValueError("quantize_rows takes one or two leaves")
    dev = _cuda(*xs, what="quantize_rows")
    x0 = xs[0]
    if x0.dtype not in DTYPES or not all(t.is_contiguous() for t in xs) \
            or any(t.dtype != x0.dtype or t.shape != x0.shape for t in xs):
        raise ValueError(f"quantize_rows takes contiguous f32 or bf16 "
                         f"tensors of one shape and dtype; got "
                         f"{[(t.dtype, tuple(t.shape)) for t in xs]}, "
                         f"contiguous={[t.is_contiguous() for t in xs]}")
    if block_size is None:
        if x0.ndim != 2 or 0 in x0.shape:
            raise ValueError(f"expected x [rows, n]; got {tuple(x0.shape)}")
        rows, n = x0.shape
        qshape, sshape = (rows, n), (rows,)
        args = (rows, n, 1, 1, 1, n, 1)
        D, slab = n, n
    else:
        if x0.ndim != 5 or nb is None or nb < 1 or block_size < 1 \
                or 0 in x0.shape:
            raise ValueError(f"expected x [R,B,T,KV,Dh] and nb >= 1; got "
                             f"{tuple(x0.shape)}, nb={nb}")
        R, B, T, KV, D = x0.shape
        qshape = (R, B, nb * block_size, KV, D)
        sshape = (R, B, nb, KV)
        args = (R * B, T * KV * D, nb, block_size, KV, D, T)
        slab = max(T, nb * block_size) * KV * D
    if D % ROW_MULTIPLE or slab >= 2 ** 31 \
            or any(t.data_ptr() % 16 for t in xs):
        raise ValueError(f"quantize_rows reads rows in 16-byte pieces of "
                         f"{ROW_MULTIPLE} values: n or Dh ({D}) must be a "
                         f"multiple of {ROW_MULTIPLE}, a [T, KV, Dh] slab "
                         f"below 2^31 values, x 16-byte aligned")
    n = len(xs)
    q = torch.empty((n, *qshape) if pair else qshape, dtype=torch.int8,
                    device=dev)
    scale = torch.empty((n, *sshape) if pair else sshape,
                        dtype=torch.float32, device=dev)
    qs, ss = (q.unbind(0), scale.unbind(0)) if pair else ((q,), (scale,))
    leaves = [(t.data_ptr(), qi.data_ptr(), si.data_ptr())
              for t, qi, si in zip(xs, qs, ss)]
    if n == 1:
        leaves.append((None, None, None))
    with _build.on_device(dev):
        code = _entry("quantize_rows", _QUANT_ARGS)(
            *leaves[0], *leaves[1], n, *args, DTYPES[x0.dtype],
            _build.stream_handle(dev))
    _build.check(SOURCE, code, "quantize_rows launch")
    launches_quant += 1
    return tuple(zip(qs, ss)) if pair else (q, scale)


def dequantize_rows(q, scale, block_table: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32):
    """Without a table: q int8 [rows, n] x scale f32 [rows] -> f32
    [rows, n] (n % 16 == 0).  With ``block_table`` [B,M] int32: int8 pool
    q [N,bs,KV,Dh] with scale [N,KV] -> each row's blocks [B, M*bs, KV, Dh]
    in ``dtype`` (f32 or bf16; the product is taken in f32 and rounded
    once; Dh % 16 == 0).  ``q`` and ``scale`` are one tensor each, or two
    (K and V, of one shape): then one launch computes both into one
    buffer, returned as a pair of contiguous views.  All contiguous and
    16-byte aligned on one CUDA device."""
    global launches_dequant
    pair = not isinstance(q, torch.Tensor)
    qs, ss = (tuple(q), tuple(scale)) if pair else ((q,), (scale,))
    n = len(qs)
    if not 1 <= n <= 2 or len(ss) != n:
        raise ValueError("dequantize_rows takes one or two leaves")
    q0, s0 = qs[0], ss[0]
    idx = q0.get_device()
    if idx < 0:
        raise ValueError("dequantize_rows takes CUDA tensors; kernels.ops "
                         "dispatches CPU tensors to the plain version")
    if dtype not in DTYPES:
        raise ValueError(f"dequantize_rows writes f32 or bf16; got {dtype}")
    ts = qs + ss + (() if block_table is None else (block_table,))
    for t in ts:
        if t.get_device() != idx or not t.is_contiguous():
            raise ValueError("dequantize_rows needs contiguous inputs on "
                             "one CUDA device")
    qshape, sshape = q0.shape, s0.shape
    if any(x.dtype != torch.int8 for x in qs) \
            or any(sc.dtype != torch.float32 for sc in ss) \
            or (n == 2 and (qs[1].shape != qshape or ss[1].shape != sshape)):
        got = [(t.dtype, tuple(t.shape)) for t in qs + ss]
        raise ValueError(f"dequantize_rows takes int8 q and f32 scales of "
                         f"one shape each; got {got}")
    if block_table is None:
        if len(qshape) != 2 or sshape != qshape[:1] or 0 in qshape \
                or qshape[1] % 16:
            raise ValueError(f"expected q [rows, n] with n % 16 == 0, scale "
                             f"[rows]; got {tuple(qshape)}, {tuple(sshape)}")
        rows, bs, KV, D = qshape[0], 1, 1, qshape[1]
        shape = qshape
        tbl = None
    else:
        tshape = block_table.shape
        if len(qshape) != 4 or sshape != (qshape[0], qshape[2]) \
                or qshape[3] % 16 or len(tshape) != 2 or 0 in tshape \
                or block_table.dtype != torch.int32:
            raise ValueError(f"expected pool [N,bs,KV,Dh] (Dh % 16 == 0), "
                             f"scale [N,KV], int32 table [B,M]; got "
                             f"{tuple(qshape)}, {tuple(sshape)}, "
                             f"{block_table.dtype} {tuple(tshape)}")
        B, M = tshape
        _, bs, KV, D = qshape
        rows = B * M
        shape = (B, M * bs, KV, D)
        tbl = block_table.data_ptr()
    dev = q0.device
    out = torch.empty((n, *shape) if pair else shape, dtype=dtype,
                      device=dev)
    o = out.data_ptr()
    step = out.numel() // n * out.element_size()   # bytes of a leaf's out
    leaves = [(x.data_ptr(), sc.data_ptr(), o + i * step)
              for i, (x, sc) in enumerate(zip(qs, ss))]
    if any(leaf[0] % 16 for leaf in leaves):
        raise ValueError("dequantize_rows reads q in 16-byte pieces: its "
                         "data must be 16-byte aligned")
    if n == 1:
        leaves.append((None, None, None))
    with _build.on_device(dev):
        code = _entry("dequantize_rows", _DEQUANT_ARGS)(
            *leaves[0], *leaves[1], tbl, n, rows, bs, KV, D, DTYPES[dtype],
            _build.stream_handle(dev))
    _build.check(SOURCE, code, "dequantize_rows launch")
    launches_dequant += 1
    return out.unbind(0) if pair else out


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
    with _build.on_device(dev):
        code = _entry("quantized_block_write", (_P,) * 8 + (_I,) * 6
                      + (_P,))(*ptrs[0], *ptrs[1], write_bids.data_ptr(),
                               off.data_ptr(), n, R, bs, KV, D,
                               DTYPES[news[0].dtype],
                               _build.stream_handle(dev))
    _build.check(SOURCE, code, "quantized_block_write launch")
    launches_write += 1
