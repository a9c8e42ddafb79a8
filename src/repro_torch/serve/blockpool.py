"""Paged KV-cache block pool: host allocator, pooled device caches, splice
(port of ``repro.serve.blockpool``).

Per layer the K/V live in one ``[num_blocks, block_size, KV, Dh]`` pool
shared by every slot, and each slot owns a row of an int32 block table
``[max_blocks_per_seq]`` naming the pool blocks of its sequence, in order.
One table serves every layer: block i of a sequence is the same pool index
in each layer's pool.

* :class:`BlockPool` is the host allocator (numpy): free list, per-block
  refcounts, the content-chain prefix cache, copy-on-write bookkeeping and
  worst-case reservation.  It never touches a tensor.
* The module functions own the device side.  Where the reference returns
  updated copies, they update the pools in place.

Two pool blocks are reserved: ``NULL_BLOCK`` (0) stays empty (``pos`` = -1
everywhere) and is what unused table entries point at; ``TRASH_BLOCK`` (1)
takes every junk write (pad rows of an admission batch, shared or unused
bucket columns, inactive slots' decode writes) and no table references it.

Prefix reuse: each full block of prompt tokens is keyed by its content
chain (the block's tokens and the whole key before it, as a nested tuple:
exact equality, no hash collisions).  A later prompt with the same chain
shares the physical block (refcount + 1, no write).  Released blocks keep
their registration on the free list until they are recycled.

Data integrity: a corrupted block is quarantined (``poison``: off the
prefix cache and the free list) until the engine's scrub has wiped it
(``scrub_poisoned``); ``alloc_gen`` counts each block's fresh
allocations, so a sealed fingerprint can tell a recycled block from a
corrupted one, and ``chain`` is the slot's block chain an evacuation
records.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.obs.metrics import NULL_REGISTRY

NULL_BLOCK = 0     # permanently empty; unused table entries point here
TRASH_BLOCK = 1    # junk-write sink; never referenced by any table
NUM_RESERVED = 2
KV_DTYPES = ("f32", "int8")


class PoolExhausted(RuntimeError):
    """No free block: grow ``num_blocks`` (or wait for evictions)."""


class BlockPool:
    """Host-side block allocator for one engine's paged KV pool.

    ``num_blocks`` counts the two reserved blocks; ``max_blocks_per_seq``
    is the table width; ``max_entries`` (default the table's whole span)
    is the longest storable sequence, so a capacity that is not a whole
    number of blocks junks writes at the position the dense layout drops
    them."""

    def __init__(self, num_blocks: int, block_size: int, num_slots: int,
                 max_blocks_per_seq: int,
                 max_entries: Optional[int] = None, registry=None):
        if num_blocks < NUM_RESERVED + 1:
            raise ValueError(f"num_blocks={num_blocks} leaves no usable "
                             f"blocks past the {NUM_RESERVED} reserved ones")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_slots = num_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_entries = (max_entries if max_entries is not None
                            else max_blocks_per_seq * block_size)
        # per-slot state
        self.table = np.full((num_slots, max_blocks_per_seq), NULL_BLOCK,
                             np.int32)
        self.seq_blocks = np.zeros(num_slots, np.int32)   # allocated per slot
        self.next_pos = np.zeros(num_slots, np.int64)     # next write position
        self.reserved = np.zeros(num_slots, np.int32)     # worst-case blocks
        # per-block state
        self.refcount = np.zeros(num_blocks, np.int32)
        self.refcount[:NUM_RESERVED] = 2**30              # never freed
        self._free: deque[int] = deque(range(NUM_RESERVED, num_blocks))
        # prefix cache: content chain -> block id, and the reverse
        self._cached: dict = {}
        self._key_of: dict[int, object] = {}
        # data integrity: quarantined (poisoned) blocks are parked off the
        # free list until scrubbed clean; alloc_gen bumps whenever a block
        # is handed out fresh, so a seal can tell "recycled" from
        # "corrupted"
        self.poisoned: set[int] = set()
        self.alloc_gen = np.zeros(num_blocks, np.int64)
        self.prefix_hits = 0
        self.cow_copies = 0
        self.high_water = 0
        self.poisoned_total = 0
        self.scrubbed_total = 0
        reg = NULL_REGISTRY if registry is None else registry
        self._c_hits = reg.counter("blockpool_prefix_hits_total",
                                   "prompt blocks shared from prefix cache")
        self._c_misses = reg.counter("blockpool_prefix_misses_total",
                                     "keyed prompt blocks freshly allocated")
        self._c_cow = reg.counter("blockpool_cow_copies_total",
                                  "copy-on-write block duplications")
        self._c_poisoned = reg.counter("blockpool_quarantined_total",
                                       "blocks quarantined as corrupt")
        self._c_scrubbed = reg.counter("blockpool_scrubbed_total",
                                       "quarantined blocks scrubbed clean")
        self._g_used = reg.gauge("blockpool_used_blocks",
                                 "pool blocks referenced by >= 1 slot")
        self._g_free = reg.gauge("blockpool_free_blocks",
                                 "pool blocks on the free list")
        self._g_hwm = reg.gauge("blockpool_high_water_blocks",
                                "max used_blocks ever observed")
        self._g_poisoned = reg.gauge("blockpool_poisoned_blocks",
                                     "blocks currently quarantined")
        self._sync_occupancy()

    def _sync_occupancy(self):
        self._g_used.set(self.used_blocks)
        self._g_free.set(self.free_blocks)
        self._g_hwm.set(self.high_water)
        self._g_poisoned.set(len(self.poisoned))

    # -- introspection ------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks currently referenced by at least one slot."""
        return self.num_blocks - NUM_RESERVED - len(self._free)

    @property
    def available_blocks(self) -> int:
        """Free blocks not already spoken for by admitted slots' pending
        worst-case growth; admission gates on this, so decode-time lazy
        growth never exhausts the pool mid-tick."""
        pending = int(np.maximum(self.reserved - self.seq_blocks, 0).sum())
        return len(self._free) - pending

    def blocks_needed(self, entries: int) -> int:
        return -(-entries // self.block_size)

    def chain(self, slot: int) -> list[int]:
        """The slot's live block chain (pool ids, in sequence order): with
        the token prefix it was built from, what an evacuation records
        before the engine replays the request."""
        return [int(b) for b in self.table[slot, :int(self.seq_blocks[slot])]]

    # -- allocation core ----------------------------------------------------

    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"KV block pool exhausted ({self.num_blocks} blocks of "
                f"{self.block_size}); grow num_blocks or wait for evictions")
        bid = self._free.popleft()
        assert bid not in self.poisoned, \
            f"poisoned block {bid} leaked onto the free list"
        key = self._key_of.pop(bid, None)
        if key is not None:               # recycled: drop stale registration
            del self._cached[key]
        self.refcount[bid] = 1
        self.alloc_gen[bid] += 1          # fresh owner: stale seals invalid
        self.high_water = max(self.high_water, self.used_blocks)
        return bid

    def _share(self, bid: int):
        if self.refcount[bid] == 0:       # cached-free: resurrect
            self._free.remove(bid)
            self.high_water = max(self.high_water, self.used_blocks)
        self.refcount[bid] += 1

    # -- admission ----------------------------------------------------------

    def admit(self, slot: int, prompt: np.ndarray, bucket_blocks: int,
              reserve_blocks: Optional[int] = None) -> np.ndarray:
        """Allocate ``slot``'s block chain for ``prompt``, reusing cached
        prefix blocks, and return the [bucket_blocks] int32 splice
        destinations: the pool block each bucket column is written to,
        ``TRASH_BLOCK`` for columns that are shared (already written) or
        beyond the prompt.  ``reserve_blocks`` is the request's worst-case
        chain length (default: the prompt's own), held back from
        ``available_blocks`` until release.  On ``PoolExhausted`` every
        block acquired by this call is given back before it propagates."""
        L = len(prompt)
        nb = self.blocks_needed(L)
        if nb > self.max_blocks_per_seq:
            raise ValueError(
                f"prompt of {L} tokens needs {nb} blocks > "
                f"max_blocks_per_seq={self.max_blocks_per_seq}")
        if self.seq_blocks[slot]:
            raise RuntimeError(f"slot {slot} still holds blocks")
        reserve = min(max(nb, reserve_blocks or nb), self.max_blocks_per_seq)

        bs = self.block_size
        dst = np.full(bucket_blocks, TRASH_BLOCK, np.int32)
        key: object = None
        acquired: list = []               # (bid, registered_key, shared)
        try:
            for col in range(L // bs):    # full blocks: shareable
                key = (key,
                       tuple(int(t) for t in prompt[col * bs:(col + 1) * bs]))
                hit = self._cached.get(key)
                if hit is not None:
                    self._share(hit)
                    self.table[slot, col] = hit
                    self.prefix_hits += 1  # dst stays TRASH: no write
                    self._c_hits.inc()
                    acquired.append((hit, None, True))
                else:
                    bid = self._alloc()
                    self.table[slot, col] = bid
                    self._cached[key] = bid
                    self._key_of[bid] = key
                    dst[col] = bid
                    self._c_misses.inc()
                    acquired.append((bid, key, False))
            col = L // bs
            if col < nb:                  # partial tail: exclusive, unkeyed
                bid = self._alloc()
                self.table[slot, col] = bid
                dst[col] = bid
                acquired.append((bid, None, False))
        except PoolExhausted:
            for bid, k, shared in reversed(acquired):
                self.refcount[bid] -= 1
                if self.refcount[bid] == 0:
                    self._free.append(bid)
                if k is not None:
                    del self._cached[k]
                    del self._key_of[bid]
                if shared:
                    self.prefix_hits -= 1
            self.table[slot, :] = NULL_BLOCK
            raise
        self.seq_blocks[slot] = nb
        self.next_pos[slot] = L
        self.reserved[slot] = reserve
        self._sync_occupancy()
        return dst

    def release(self, slot: int):
        """Drop ``slot``'s references.  Refcount-0 blocks return to the free
        list but keep their prefix registration until recycled."""
        for col in range(int(self.seq_blocks[slot])):
            bid = int(self.table[slot, col])
            self.refcount[bid] -= 1
            if self.refcount[bid] == 0 and bid not in self.poisoned:
                self._free.append(bid)    # poisoned blocks stay parked
        self.table[slot, :] = NULL_BLOCK
        self.seq_blocks[slot] = 0
        self.next_pos[slot] = 0
        self.reserved[slot] = 0
        self._sync_occupancy()

    # -- quarantine (data integrity) ----------------------------------------

    def poison(self, bid: int):
        """Quarantine a corrupted block: deregister it from the prefix cache
        at once (a later identical prompt must not share it) and park it
        off the free list until :meth:`scrub_poisoned` clears it.  Blocks
        still referenced stay in their tables until those slots release
        (the engine replays the affected streams in the same breath)."""
        if bid < NUM_RESERVED or bid in self.poisoned:
            return
        self.poisoned.add(bid)
        self.poisoned_total += 1
        self._c_poisoned.inc()
        key = self._key_of.pop(bid, None)
        if key is not None:
            del self._cached[key]
        if self.refcount[bid] == 0:       # cached/plain free: pull it out
            self._free.remove(bid)
        self._sync_occupancy()

    def drop_prefix_cache(self):
        """Deregister every cached prefix block (block contents are
        wholesale untrustworthy, e.g. KV appended under corrupted params):
        blocks stay where they are, but no admission may share one."""
        self._cached.clear()
        self._key_of.clear()

    def scrub_poisoned(self) -> list[int]:
        """Return quarantined blocks with no remaining references to the
        free list and report them.  The caller wipes their device contents
        (``ft.integrity.clear_regions``)."""
        ready = sorted(b for b in self.poisoned if self.refcount[b] == 0)
        for bid in ready:
            self.poisoned.discard(bid)
            self.scrubbed_total += 1
            self._c_scrubbed.inc()
            self._free.append(bid)
        self._sync_occupancy()
        return ready

    def fork(self, src: int, dst: int):
        """Point ``dst`` at ``src``'s chain (shared, refcounted); the next
        write into the shared tail copies it (``write_plan``)."""
        if self.seq_blocks[dst]:
            raise RuntimeError(f"slot {dst} still holds blocks")
        nb = int(self.seq_blocks[src])
        for col in range(nb):
            self._share(int(self.table[src, col]))
        self.table[dst, :] = self.table[src, :]
        self.seq_blocks[dst] = nb
        self.next_pos[dst] = self.next_pos[src]
        self.reserved[dst] = self.reserved[src]

    # -- per-tick decode write planning ------------------------------------

    def write_plan(self, slot: int, active: bool):
        """Plan this tick's KV write for ``slot``: ``(write_bid, copies)``,
        the pool block the decode step writes (``TRASH_BLOCK`` for inactive
        slots and writes past ``max_entries``) and the (src, dst)
        copy-on-write pairs to apply with :func:`copy_blocks` before the
        step.  Advances the slot's write cursor when active."""
        if not active:
            return TRASH_BLOCK, []
        p = int(self.next_pos[slot])
        col = p // self.block_size
        self.next_pos[slot] = p + 1
        if col >= self.max_blocks_per_seq or p >= self.max_entries:
            return TRASH_BLOCK, []
        copies = []
        if col >= int(self.seq_blocks[slot]):      # lazy growth
            bid = self._alloc()
            self.table[slot, col] = bid
            self.seq_blocks[slot] = col + 1
            self._sync_occupancy()
        else:
            bid = int(self.table[slot, col])
            if self.refcount[bid] > 1:             # shared tail: COW
                priv = self._alloc()
                copies.append((bid, priv))
                self.refcount[bid] -= 1
                self.table[slot, col] = priv
                self.cow_copies += 1
                self._c_cow.inc()
                bid = priv
                self._sync_occupancy()
        return bid, copies

    def __repr__(self) -> str:
        return (f"BlockPool(blocks={self.num_blocks}x{self.block_size}, "
                f"free={self.free_blocks}, hits={self.prefix_hits}, "
                f"cow={self.cow_copies}, hwm={self.high_water}"
                + (f", poisoned={len(self.poisoned)}" if self.poisoned
                   else "") + ")")


# ---------------------------------------------------------------------------
# Device side: pooled caches, splice, copy (all in place)
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: str = "f32", device="cpu") -> list:
    """Empty pooled caches, one dict per layer group mirroring
    ``kvcache.init_cache``: every sub-layer holds ``k``/``v``
    [L, num_blocks, block_size, KV, Dh] (the working dtype, or int8 under
    ``kv_dtype="int8"``) and ``pos`` [L, num_blocks, block_size] (-1 =
    empty); int8 pools add ``k_scale``/``v_scale`` f32 [L, num_blocks, KV],
    one max-abs scale per (block, kv head)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; valid choices: "
                         f"{', '.join(KV_DTYPES)}")
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    pool_dtype = torch.int8 if kv_dtype == "int8" else cfg.dtype
    caches = []
    for g in cfg.groups:
        L, per = g.repeats, {}
        for j, kind in enumerate(g.pattern):
            if kind != "attn":
                raise ValueError(f"paged KV cache only supports "
                                 f"self-attention stacks; got {kind!r}")
            shape = (L, num_blocks, block_size, KV, Dh)
            sub = {"k": torch.zeros(shape, dtype=pool_dtype, device=device),
                   "v": torch.zeros(shape, dtype=pool_dtype, device=device),
                   "pos": torch.full((L, num_blocks, block_size), -1,
                                     dtype=torch.int32, device=device)}
            if kv_dtype == "int8":
                for name in ("k_scale", "v_scale"):
                    sub[name] = torch.zeros((L, num_blocks, KV),
                                            dtype=torch.float32,
                                            device=device)
            per[f"sub{j}"] = sub
        caches.append(per)
    return caches


def cache_kv_dtype(caches: list) -> str:
    """The ``kv_dtype`` a pooled cache tree was built with."""
    sub = next(iter(caches[0].values()))
    return "int8" if "k_scale" in sub else "f32"


def _pad_entries(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """x [R, B, T, ...] cut or padded with ``fill`` to n entries on axis 2."""
    x = x[:, :, :n]
    short = n - x.shape[2]
    if short <= 0:
        return x
    pad = [0, 0] * (x.ndim - 3) + [0, short]
    return F.pad(x, pad, value=fill)


def quantize_paged_part(part: list, block_size: int, nb: int) -> list:
    """Capacity-padded prefill caches -> the int8 + scales layout of an int8
    pool: per (bucket block column, kv head) max-abs over the [block_size,
    Dh] tile, scale = max / 127, payload ``clip(round(x / scale))`` (round
    half to even, as ``jnp.round``), through ``kernels.ops.quantize_kv_tiles``
    (kernel #10 on the card, K and V in one launch).  Payload leaves come
    back with ``nb * block_size`` entries (zero-padded when the capacity is
    not block-aligned), scale leaves as [R, Bp, nb, KV]."""
    out = []
    for grp in part:
        per = {}
        for name, sub in grp.items():
            (qk, ks), (qv, vs) = ops.quantize_kv_tiles(
                (sub["k"], sub["v"]), block_size, nb)
            per[name] = {"k": qk, "v": qv, "k_scale": ks, "v_scale": vs,
                         "pos": sub["pos"]}
        out.append(per)
    return out


def paged_splice(caches: list, part: list, dst: torch.Tensor) -> list:
    """In place: scatter admitted prefill caches into their pool blocks.

    ``caches`` leaves are pooled [R, N, bs, ...]; ``part`` leaves [R, Bp,
    T, ...], the same capacity-padded prefill caches the dense engine
    splices, of which the first ``nb = dst.shape[1]`` block columns are
    read (a short tail is padded: ``pos`` -1, payload 0).  ``dst`` [Bp, nb]
    names each (row, column)'s destination block, ``TRASH_BLOCK`` for
    columns that must not land anywhere.  Real destinations are unique, so
    repeated indices only ever collide on the trash block.  An int8 pool
    quantizes an f32 part first (:func:`quantize_paged_part`); its scale
    rows land through the same plan."""
    Bp, nb = dst.shape
    bs = next(iter(caches[0].values()))["k"].shape[2]
    if cache_kv_dtype(caches) == "int8" and \
            "k_scale" not in next(iter(part[0].values())):
        part = quantize_paged_part(part, bs, nb)
    flat = dst.reshape(-1).long()
    for grp_c, grp_p in zip(caches, part):
        for name, sub_c in grp_c.items():
            for leaf, pool in sub_c.items():
                p = grp_p[name][leaf].to(pool.dtype)
                if leaf.endswith("_scale"):            # [R, Bp, nb, KV]
                    pool[:, flat] = p.reshape(p.shape[0], Bp * nb,
                                              *p.shape[3:])
                    continue
                fill = -1 if leaf == "pos" else 0
                p = _pad_entries(p, nb * bs, fill)
                pool[:, flat] = p.reshape(p.shape[0], Bp * nb, bs,
                                          *p.shape[3:])
    return caches


def copy_blocks(caches: list, src: torch.Tensor, dst: torch.Tensor) -> list:
    """In place copy-on-write duplication: pool[:, dst[i]] = pool[:, src[i]]
    for every pair, across all layers and leaves (the right-hand side is
    gathered before the write)."""
    src, dst = src.long(), dst.long()
    for gc in caches:
        for sub in gc.values():
            for pool in sub.values():
                pool[:, dst] = pool[:, src]
    return caches
