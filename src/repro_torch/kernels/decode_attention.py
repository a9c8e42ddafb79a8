"""Single-token flash-decode attention on Hopper: the wrapper of
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:28``
``_decode_kernel`` (reached through ``decode_attention:72``).  The work is
bound by the bytes of the cache's valid entries, so the kernel is a
split-KV flash-decode (``csrc/split_decode.cuh``): the [T] walk of each
(row, kv head) is split across blocks (:func:`plan_splits`: runs of 256
entries, shorter where that gives fewer than 512 blocks); each split
copies only the tiles that hold a valid entry, in their storage dtype,
through a 16-byte ``cp.async`` ring, and computes up to ``GROUP_BLOCK`` =
8 q heads of its kv head (bf16 on the tensor cores, f32 on the CUDA
cores) with an f32 online softmax; the last split of each (row, head
group) to finish combines the splits' f32 partials, which this wrapper
allocates, counting arrivals in :func:`arrival_counters`.  A kv head's G
= H / KV q heads run as :func:`head_groups` groups of equal size, each
group's blocks walking the kv head's cache as a G <= 8 launch does
(granite-20b's G 48: six groups of 8, so its single kv head's K/V are
read six times, mostly from L2); any G is taken, and G <= 8 is one group,
as before.  The mask is the reference's:
``kv_pos >= 0 and kv_pos <= pos`` (and ``kv_pos > pos - window`` with a
window); a row with no valid entry averages V over all T entries, as the
reference does.

The plain version is ``kernels.ref.ref_decode_attention``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUP_BLOCK = 8          # q heads a block (csrc split_decode kMaxGroup)
TARGET_BLOCKS = 512      # split blocks to have in flight: ~4 on 132 SMs
SPLIT_ENTRIES = 256      # entries a split walks where the walk is long
MAX_SPLITS = 128         # csrc kMaxSplits
MAX_SPLIT_LEN = 8192     # entries a split covers (csrc kMaxSplitLen)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
"""Kernel launches since the last ``ops.reset_launch_counts()``."""


@functools.cache
def tile_entries(head_dim: int, itemsize: int) -> int:
    """Entries of one K/V tile of the split kernel for q of ``itemsize``
    bytes (the pools' storage does not change it): in bf16 (csrc
    ``MmaLayout::kTile``) 16 entries for each of the 4 warps; in f32
    (``SimtLayout::kTile``) 4 row passes of 4 warps, each pass as many rows
    as a warp's 32 lanes hold at 4 values a lane."""
    if itemsize == 2:
        return 64
    lanes = min(32, head_dim // 4)
    return 16 * (32 // lanes)


@functools.cache
def stage_bytes(head_dim: int, itemsize: int,
                pool_itemsize: int | None = None) -> int:
    """Dynamic shared memory of the split kernel besides a cache policy's
    own (csrc ``MmaLayout`` / ``SimtLayout::kBytes``), for q of
    ``itemsize`` bytes over K/V stored in ``pool_itemsize`` (default q's;
    1 is int8, which also stages each entry's two f32 scales): bf16 q, 2
    stages of K and V [64] rows padded by 16 bytes; f32 q, 3 stages of
    [tile][D] rows.  At least what a split reuses at its end: the 4 warps'
    acc [8][D] f32 and the combine's 2 * 128 * 8 + 16 floats."""
    S = itemsize if pool_itemsize is None else pool_itemsize
    tile = tile_entries(head_dim, itemsize)
    scales = 8 * tile if S == 1 else 0
    if itemsize == 2:
        ring = 2 * (2 * tile * (head_dim * S + 16) + scales)
    else:
        ring = 3 * (2 * tile * head_dim * S + scales)
    return max(ring, 4 * GROUP_BLOCK * head_dim * 4,
               (2 * MAX_SPLITS * GROUP_BLOCK + 2 * GROUP_BLOCK) * 4)


@functools.cache
def head_groups(group: int) -> int:
    """The groups a kv head's ``group`` q heads run in (csrc
    ``split_decode::head_groups``): the fewest of equal size, each at most
    GROUP_BLOCK heads (1 up to G 8, 6 of 8 at granite-20b's G 48, 3 of 3
    at G 9)."""
    n = -(-group // GROUP_BLOCK)
    while group % n:
        n += 1
    return n


@functools.lru_cache(maxsize=1024)
def plan_splits(rows: int, length: int, tile: int,
                unit: int = 1) -> tuple[int, int]:
    """(splits, split_len): cut a walk of ``length`` entries, for each of
    ``rows`` (batch row, kv head) pairs, into runs of whole ``unit``s (a
    paged pool's blocks) at least a ``tile`` long: at most SPLIT_ENTRIES
    long (4 bf16 tiles), shorter where rows × splits would stay under
    TARGET_BLOCKS, longer only where MAX_SPLITS would not cover the walk.
    At 2048 entries, 16 rows × 4 kv heads and 16 × 8 both give 8 splits of
    256; one row × 4 kv heads, 32 splits of 64.  (``chip_smoke.py``'s
    ``split_sweep`` line times 2-16 splits at the kernels phase's
    shapes.)"""
    if rows < 1 or length < 1:
        raise ValueError(f"nothing to split: rows={rows} length={length}")
    step = unit * -(-tile // unit)
    if step > MAX_SPLIT_LEN:
        raise ValueError(f"a block of {unit} entries outgrows a split "
                         f"({MAX_SPLIT_LEN} entries)")
    steps = -(-length // step)
    want = -(-TARGET_BLOCKS // rows)
    per = max(min(-(-steps // want), max(1, SPLIT_ENTRIES // step)),
              -(-steps // MAX_SPLITS), 1)
    if per * step > MAX_SPLIT_LEN:
        raise ValueError(f"a walk of {length} entries needs more than "
                         f"{MAX_SPLITS} splits of {MAX_SPLIT_LEN}")
    splits = -(-steps // per)
    return splits, per * step


def scratch(B: int, KV: int, G: int, D: int, splits: int,
            device) -> torch.Tensor:
    """The splits' f32 partials: m and l [B, KV, splits, G], then acc
    [B, KV, splits, G, D], in one buffer (with G > 8 the kernel reads KV
    as the head groups and G as a group's heads: the same product)."""
    return torch.empty(B * KV * splits * G * (D + 2), dtype=torch.float32,
                       device=device)


_arrived: dict = {}


def arrival_counters(device, stream: int, rows: int) -> torch.Tensor:
    """The split kernels' arrival counters [>= rows] int32 for launches on
    ``stream``, one a (row, head group): zero, and left zero by every
    launch (the last split of a (row, head group) resets its count), so
    one buffer a stream serves every launch in that stream's order."""
    buf = _arrived.get((device, stream))
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
        _arrived[(device, stream)] = buf
    return buf


@functools.cache
def _entry():
    fn = _build.library(NAME).repro_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q [B,H,D]; k/v [B,T,KV,D] (KV divides H, D in HEAD_DIMS); kv_pos [B,T] int32 (-1 = empty); pos [B] int32; all
    contiguous on one CUDA device, q/k/v all f32 or all bf16 -> [B,H,D] in
    q's dtype."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda and kv_pos.is_cuda
            and pos.is_cuda):
        raise ValueError("decode_attention kernel takes CUDA tensors; "
                         "kernels.ops.decode_attention dispatches CPU "
                         "tensors to the plain version")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,D], k/v [B,T,KV,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    _, T, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, head groups)")
    if kv_pos.shape != (B, T) or pos.shape != (B,):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / pos "
                         f"{tuple(pos.shape)} must be [B,T] / [B]")
    if kv_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("kv_pos and pos must be int32")
    if T == 0 or D not in HEAD_DIMS:
        raise ValueError(f"unsupported decode shape T={T} D={D} "
                         f"(D in {HEAD_DIMS})")
    dtype = DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if (k.device != dev or v.device != dev or kv_pos.device != dev
            or pos.device != dev):
        raise ValueError("decode inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and kv_pos.is_contiguous() and pos.is_contiguous()):
        raise ValueError("decode_attention needs contiguous inputs")
    if window < 0:
        raise ValueError(f"negative window {window}")
    groups = KV * head_groups(H // KV)
    splits, split_len = plan_splits(B * groups, T,
                                    tile_entries(D, q.element_size()))
    out = torch.empty_like(q)
    part = scratch(B, KV, H // KV, D, splits, dev)
    with _build.on_device(dev):
        stream = _build.stream_handle(dev)
        arrived = arrival_counters(dev, stream, B * groups)
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
                        part.data_ptr(), arrived.data_ptr(), B, H, KV, T, D,
                        int(window), splits, split_len, dtype, stream)
    _build.check(NAME, code, "decode_attention launch")
    launches += 1
    return out
