"""Silent-data-corruption detection primitives: fingerprints + bit surgery
(port of ``repro.ft.integrity``).

The serve engine seals device state with these checksums and re-verifies
them on a scrub cadence (serve/engine.py); ``flip_bit`` is the
deterministic bit flip behind ``ft/inject.py``'s ``kind=corrupt`` faults.

Fingerprint design (the reference's, bit for bit)
-------------------------------------------------

Every leaf is reinterpreted as unsigned words (f32 bit-patterns as u32,
bf16/f16 as u16, integers value-wrapped mod 2^32: int8 -1 is 0xFFFFFFFF)
and reduced with a position-weighted sum

    fp(x) = sum_i (2*i + 1) * K * x_i      (mod 2^32, K = 0x9E3779B1)

Each weight is odd, hence invertible mod 2^32, so a single bit flip
anywhere in the fingerprinted span always moves the sum.  Multi-leaf
fingerprints combine per-leaf sums with odd salts by leaf index, in the
reference's leaf order (``models.common.tree_leaves``: sorted dict keys,
as ``jax.tree.leaves``).

The reference reduces in uint32.  Torch has no unsigned 32-bit type, but
int32 arithmetic wraps mod 2^32 too: the port takes each word as the
int32 with its bit pattern (an int8 sign-extends to exactly the
reference's wrapped uint32), multiplies in int32 and sums the wrapped
products in int64, whose low 32 bits are the reference's sum.  The
position ``i`` is the reference's ``arange(size, uint32)``, which wraps
past 2^32 elements; the port's weights wrap the same way.  A leaf is
walked in chunks of at most ``CHUNK`` elements with the global flat offset
carried into the weights, so no copy of a whole stacked leaf is ever
made (granite-20b's ``wi_gate`` holds 7.85e9 elements), and a region
fingerprint reads only the span of regions with a nonzero count.

The host mirrors (numpy, same arithmetic) back the device->host token
payload check.  None of this is a kernel of the reference (it computes
them in jnp), so the port's are plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_leaves

# odd multiplier (golden-ratio constant): makes every position weight odd
_K = 0x9E3779B1
_MOD = 1 << 32
_MASK = _MOD - 1
# elements per chunk of a leaf's reduction (bounds the temporaries)
CHUNK = 1 << 26


def _salt(j: int) -> int:
    """Odd per-leaf salt: odd * odd stays odd (invertible mod 2^32)."""
    return ((2 * j + 1) * _K) & _MASK


# -- bit reinterpretation (device) ------------------------------------------


def _words(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 words of ``x`` as int32 bit patterns: float
    bits by bitcast (bf16 / f16 zero-extended), integers and bools
    value-wrapped."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    if x.dtype == torch.int64:
        return _wrap32(x & _MASK)
    if x.dtype == torch.bool or not (x.dtype.is_floating_point
                                     or x.dtype.is_complex):
        return x.to(torch.int32)
    raise TypeError(f"no uint32 reinterpretation for dtype {x.dtype}")


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(v >= 1 << 31, v - _MOD, v).to(torch.int32)


def _weights(idx: torch.Tensor) -> torch.Tensor:
    """(2*i + 1) * K mod 2^32 of int64 positions (wrapped like uint32), as
    int32 bit patterns."""
    return _wrap32(((((idx & _MASK) * 2 + 1) & _MASK) * _K) & _MASK)


def _host_bits_u32(a: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`_words` (uint32 words, numpy)."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    if a.dtype == np.float16:
        return a.view(np.uint16).astype(np.uint32)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.uint16).astype(np.uint32)       # bfloat16 words
    if a.dtype == np.bool_ or a.dtype.kind in "iu":
        return a.astype(np.int64).astype(np.uint32)
    raise TypeError(f"no uint32 reinterpretation for dtype {a.dtype}")


# -- fingerprints (device) ---------------------------------------------------


def leaf_fingerprint(x: torch.Tensor) -> torch.Tensor:
    """Position-weighted mod-2^32 checksum of one leaf -> 0-d int64 tensor
    on the leaf's device, in [0, 2^32).  Element ``o + i`` of a chunk
    starting at ``o`` weighs ``(2o + 1) K + 2K i``, so a chunk adds
    ``(2o + 1) K * sum(u) + 2K * sum(u * i)`` (mod 2^32): one product a
    word."""
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for o in range(0, flat.numel(), CHUNK):
        u = _words(flat[o:o + CHUNK])
        s0 = u.sum(dtype=torch.int64)
        i = torch.arange(u.numel(), dtype=torch.int32, device=x.device)
        s1 = (u * i).sum(dtype=torch.int64)
        total += s0 * (((2 * o + 1) * _K) & _MASK) + s1 * ((2 * _K) & _MASK)
    return total & _MASK


def tree_fingerprint(tree) -> torch.Tensor:
    """Salted combination of every leaf's fingerprint -> 0-d int64 tensor.
    Registered for the params at engine build and re-verified by the
    health gate / scrub (``HealthReason.DATA_CORRUPTION`` on mismatch)."""
    total = None
    for j, leaf in enumerate(tree_leaves(tree)):
        part = (leaf_fingerprint(leaf) * _salt(j)) & _MASK
        total = part if total is None else (total + part) & _MASK
    return torch.zeros((), dtype=torch.int64) if total is None else total


def region_fingerprints(caches, counts) -> torch.Tensor:
    """Per-region fingerprints of a pooled / slotted KV cache tree.

    Every leaf is shaped ``[R, N, E, ...]``: axis 1 the region (pool block
    or dense slot, ``N`` of them), axis 2 the entry within it (block
    offset or cache position).  ``counts`` [N] (host array or tensor)
    masks each region to its first ``counts[n]`` entries, so junk past a
    sequence's write cursor never alarms.  Returns [N] int64 in [0, 2^32)
    on the caches' device; a region with count 0 fingerprints to 0.
    Within a region the reference orders the words as ``[E, R, ...]``
    (entry-major), which the weights reproduce."""
    leaves = tree_leaves(caches)
    N = leaves[0].shape[1]
    dev = leaves[0].device
    host = torch.as_tensor(np.asarray(counts), dtype=torch.int64)
    total = torch.zeros((N,), dtype=torch.int64, device=dev)
    live = torch.nonzero(host).reshape(-1)
    if live.numel() == 0:
        return total
    lo, hi = int(live[0]), int(live[-1]) + 1
    cnt = host[lo:hi].to(dev)
    for j, leaf in enumerate(leaves):
        R, E = leaf.shape[0], leaf.shape[2]
        rest = int(np.prod(leaf.shape[3:], dtype=np.int64))
        idx = (torch.arange(R, dtype=torch.int64, device=dev)[:, None, None]
               * rest
               + torch.arange(E, dtype=torch.int64, device=dev)[None, :, None]
               * (R * rest)
               + torch.arange(rest, dtype=torch.int64, device=dev)[None, None])
        w = _weights(idx)[:, None]                       # [R, 1, E, rest]
        mask = (torch.arange(E, device=dev)[None, :]
                < cnt[:, None]).to(torch.int64)          # [n, E]
        rows = max(1, CHUNK // max(1, R * E * rest))
        fp = torch.empty((hi - lo,), dtype=torch.int64, device=dev)
        for a in range(lo, hi, rows):
            b = min(a + rows, hi)
            u = _words(leaf[:, a:b]).reshape(R, b - a, E, rest)
            s = (u * w).sum(dim=(0, 3), dtype=torch.int64)   # [n, E]
            fp[a - lo:b - lo] = (s * mask[a - lo:b - lo]).sum(1)
        total[lo:hi] = (total[lo:hi]
                        + ((fp & _MASK) * _salt(j)) & _MASK) & _MASK
    return total


# -- fingerprints (host mirrors) --------------------------------------------


def host_leaf_fingerprint(a) -> int:
    """Exact numpy mirror of :func:`leaf_fingerprint` (mod-2^64 partials
    reduce to the same mod-2^32 value since 2^32 | 2^64)."""
    u = _host_bits_u32(a).astype(np.uint64).reshape(-1)
    idx = np.arange(u.size, dtype=np.uint64) & np.uint64(_MASK)
    w = (idx * np.uint64(2) + np.uint64(1)) * np.uint64(_K)
    return int((u * w).sum(dtype=np.uint64) % _MOD)


def host_tree_fingerprint(tree) -> int:
    total = 0
    for j, leaf in enumerate(tree_leaves(tree)):
        total = (total + _salt(j) * host_leaf_fingerprint(leaf)) % _MOD
    return total


# -- deterministic bit surgery ----------------------------------------------


def _word_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.bfloat16, torch.float16):
        return torch.int16
    size = torch.empty((), dtype=dtype).element_size()
    if size == 4:
        return torch.int32
    if size == 1:
        return torch.uint8 if dtype == torch.bool else torch.int8
    raise TypeError(f"flip_bit: unsupported dtype {dtype}")


def flip_bit_(x: torch.Tensor, flat_index: int, bit: int) -> torch.Tensor:
    """In place: flip bit ``bit`` of flat element ``flat_index`` of ``x``
    (XOR on the bit pattern).  ``x`` must be contiguous."""
    word = _word_dtype(x.dtype)
    flat = x.view(word).view(-1)
    mask = 1 << bit
    if mask >= 1 << (8 * flat.element_size() - 1):
        mask -= 1 << (8 * flat.element_size())   # the sign bit, signed
    flat[flat_index] ^= mask
    return x


def flip_bit(x: torch.Tensor, flat_index: int, bit: int) -> torch.Tensor:
    """A copy of ``x`` with bit ``bit`` of flat element ``flat_index``
    flipped: the injection primitive behind ``kind=corrupt`` faults."""
    return flip_bit_(x.clone(memory_format=torch.contiguous_format),
                     flat_index, bit)


def bit_width(dtype) -> int:
    """Bits per element a :func:`flip_bit` target exposes."""
    return torch.empty((), dtype=dtype).element_size() * 8


def clear_regions(caches, ids: torch.Tensor):
    """In place: wipe region columns ``ids`` across every leaf (K/V to zero,
    integer position leaves to -1, the empty sentinel), the way a
    quarantined pool block is scrubbed before it rejoins the free list."""
    ids = ids.to(device=tree_leaves(caches)[0].device, dtype=torch.long)
    for pool in tree_leaves(caches):
        pool[:, ids] = 0 if pool.dtype.is_floating_point else -1
    return caches
