"""Continuous-batching serve engine over the dense KV layout or the paged
block pool (port of ``repro.serve.engine.ServeEngine``'s
monolithic-admission path).

A fixed pool of ``num_slots`` decode slots runs in lock-step, one decode
step per tick.  Queued requests are admitted into free slots through
batched, bucketed prefill; a request that reaches ``max_new_tokens`` or
its EOS frees its slot.  The semantics are the reference's:

* **In-place state.**  The reference jits the decode step and the
  admission splice with the cache donated; the port keeps one set of
  preallocated cache tensors and updates them in place (the decode step
  writes each token's K/V entry, admission copies prefill rows into their
  slots).
* **Batched, bucketed admission.**  Up to one queued request per free
  slot, of the head request's bucket (found within the first
  ``4 * num_slots`` queue entries), share one prefill call: prompts are right-padded to a
  power-of-two bucket (>= 8, capped at capacity), the batch is padded to a
  power-of-two row count by repeating the last request, pad entries get
  ``pos = -1`` and each row's next token comes from its true last
  position.
* **One-tick-lag token collection.**  Tokens and positions live on the
  device and advance inside the step.  Each tick dispatches step t, starts
  a non-blocking copy of its tokens into pinned host memory, then waits
  for step t-1's copy and applies it, so the host's bookkeeping overlaps
  the device's step.  EOS / max-token detection lags one tick; the extra
  speculative token of a finished slot is discarded at collection.
* **Inactive slots still compute.**  Their positions keep advancing and
  their cache writes are junk that no live query attends to; a write past
  the cache's end is dropped (``models.attention.write_kv``).
* **Paged layout** (``kv_layout="paged"``, ``kv_dtype="f32"|"int8"``).
  A ``serve.blockpool.BlockPool`` sized for the worst case (every slot at
  capacity, unless ``num_blocks`` says otherwise) hands out blocks:
  admission allocates each prompt's chain, sharing full prompt blocks
  whose content chain is cached, and scatters the same capacity-padded
  prefill caches the dense layout splices into the blocks it wrote;
  admission defers a request until its worst-case chain (prompt + new
  tokens) fits the unreserved pool, and ``submit`` rejects one the pool
  can never hold.  Each tick plans every slot's write (lazy growth at
  block boundaries, copy-on-write of shared tails, the trash block for
  inactive slots), applies the copies, and passes the block table and the
  plan to the step through a pinned, double-buffered staging tensor, so
  the host never waits for the device there.  A finished request's blocks
  are released at once; the prefix cache keeps their content until they
  are recycled.

The reference's chunked-prefill scheduler, fault tolerance, integrity
scrubbing and telemetry are later slices; their knobs raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.ssm import F32_PARAMS
from repro_torch.runtime import check_kv_layout
from repro_torch.serve import blockpool, kvcache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1                 # -1 = never
    # filled by the engine
    generated: list = field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: float = 0.0         # queue exit (prefill start)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    token_times: list = field(default_factory=list)   # decode-token arrivals
    done: bool = False


@dataclass
class EngineStats:
    ticks: int = 0
    tokens_out: int = 0
    admitted: int = 0
    finished: int = 0
    prefill_calls: int = 0

    @property
    def summary(self) -> str:
        return (f"ticks={self.ticks} tokens={self.tokens_out} "
                f"admitted={self.admitted} finished={self.finished} "
                f"prefills={self.prefill_calls}")


def percentile(values: Sequence[float], q: float) -> float:
    """Linearly interpolated percentile (q in [0, 100]); 0.0 when empty."""
    xs = sorted(values)
    if not xs:
        return 0.0
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] * (1.0 - (rank - lo)) + xs[hi] * (rank - lo))


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


class ServeEngine:
    """Continuous-batching engine over a ``repro_torch.runtime.Runtime``.

    The Runtime owns the config, device, capacity, params and step
    factories; the engine owns slots, admission and the device-resident
    hot loop.  Serving
    weights are cast once to the config's working dtype here (the
    reference casts every matrix to the activation dtype before each
    product); RMSNorm scales stay f32."""

    def __init__(self, runtime, *, num_slots: int = 4,
                 kv_layout: str = "dense", kv_dtype: str = "f32",
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 scheduler: bool = False, health_every: int = 0,
                 scrub_every: int = 0, injector=None):
        check_kv_layout(runtime.caps, runtime.cfg.name, kv_layout, kv_dtype)
        if kv_layout == "dense" and any(
                v is not None for v in (block_size, num_blocks,
                                        max_blocks_per_seq)):
            raise ValueError(
                "block_size/num_blocks/max_blocks_per_seq size the paged "
                "block pool; pass kv_layout='paged' (a dense engine would "
                "silently ignore them)")
        if scheduler:
            _unsupported("the chunked-prefill scheduler",
                         "ROADMAP queue 1, item 8")
        if health_every or scrub_every or injector is not None:
            _unsupported("fault tolerance / integrity scrubbing",
                         "ROADMAP queue 1, item 10")
        rt = self.rt = runtime
        self.cfg, self.caps, self.device = rt.cfg, rt.caps, rt.device
        self.num_slots = num_slots
        self.capacity = rt.capacity
        # bounded queue scan for admission grouping (see _admit_batch)
        self.admit_window = 4 * num_slots
        self.params = serving_params(rt.params, self.cfg.dtype)
        self.kv_layout, self.kv_dtype = kv_layout, kv_dtype
        self.paged = kv_layout == "paged"
        pin = self.device.type == "cuda"
        # one capacity-padded prefill for both layouts: the paged splice
        # reads block columns out of the same caches the dense one splices
        self._prefill = rt.make_prefill_step()
        if self.paged:
            bs = block_size if block_size is not None else 16
            M = (max_blocks_per_seq if max_blocks_per_seq is not None
                 else -(-self.capacity // bs))
            nblocks = (num_blocks if num_blocks is not None
                       else num_slots * M + blockpool.NUM_RESERVED)
            # max_entries=capacity junks writes where the dense layout
            # drops them, also when capacity % block_size != 0
            self.pool = blockpool.BlockPool(nblocks, bs, num_slots, M,
                                            max_entries=self.capacity)
            self.caches = blockpool.init_paged_cache(
                self.cfg, nblocks, bs, kv_dtype, device=self.device)
            self._decode = rt.make_paged_decode_step()
            # each tick's block table [S*M] and write plan [S], staged in
            # one of two pinned host buffers (the copy of tick t reads its
            # buffer until tick t's collection has waited on the device)
            n = num_slots * (M + 1)
            self._host_plan = [torch.empty(n, dtype=torch.int32,
                                           pin_memory=pin) for _ in range(2)]
            self._plan = torch.empty(n, dtype=torch.int32,
                                     device=self.device)
        else:
            self.pool = None
            self.caches = kvcache.init_cache(self.cfg, num_slots,
                                             self.capacity,
                                             device=self.device)
            self._decode = rt.make_decode_step(advance_pos=True)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.stats = EngineStats()
        self.slot_req: list[Optional[Request]] = [None] * num_slots
        # host mirror of each request's next position (0 when free); the
        # hot loop reads the device-resident ``_pos``, which also advances
        # on inactive slots
        self.slot_pos = np.zeros(num_slots, np.int32)
        self._tok = torch.zeros((num_slots, 1), dtype=torch.int32,
                                device=self.device)
        self._pos = torch.zeros((num_slots,), dtype=torch.int32,
                                device=self.device)
        # two host buffers for the one-tick-lag collection: step t copies
        # into one while step t-1's is read from the other
        self._host_tok = [torch.empty(num_slots, dtype=torch.int32,
                                      pin_memory=pin) for _ in range(2)]
        self._inflight = None   # (host buffer, copy-done event, slot->req)

    # -- admission ----------------------------------------------------------

    def _paged_reserve(self, req: Request) -> int:
        """Worst-case block-chain length of ``req``: prompt plus its whole
        generation budget, capped at the table width (writes past it go to
        the trash block, where the dense layout drops them)."""
        return min(self.pool.blocks_needed(len(req.prompt)
                                           + req.max_new_tokens),
                   self.pool.max_blocks_per_seq)

    def submit(self, req: Request):
        if self.paged:
            # fail fast on a request the pool can never hold: admission
            # would otherwise wait forever for evictions
            nbp = self.pool.blocks_needed(len(req.prompt))
            usable = self.pool.num_blocks - blockpool.NUM_RESERVED
            need = self._paged_reserve(req)
            if nbp > self.pool.max_blocks_per_seq or need > usable:
                raise ValueError(
                    f"request rid={req.rid} needs {need} KV blocks "
                    f"worst-case (prompt alone {nbp}) but the pool has "
                    f"{usable} usable blocks and tables hold "
                    f"{self.pool.max_blocks_per_seq}; grow num_blocks / "
                    f"max_blocks_per_seq or shrink the request")
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def _bucket_len(self, n: int) -> int:
        """Prefill padding bucket: next power of two (>= 8) capped at
        capacity; the exact length for SWA archs or prompts longer than
        the capacity."""
        if self.caps.swa or n > self.capacity:
            return n
        b = 8
        while b < n:
            b *= 2
        return min(b, self.capacity)

    def _admit_batch(self) -> int:
        """Admit queued requests through one padded batched prefill per
        group.  A group is the head request plus later requests of its
        bucket within the first ``admit_window`` (4 x ``num_slots``) queue
        entries, at most one per free slot; a full group ends the scan, and
        so, under the paged layout, does the first request whose worst-case
        chain no longer fits the unreserved pool, so no request is
        overtaken by a look-alike submitted after it.  Returns the number
        admitted."""
        admitted = 0
        free = [s for s in range(self.num_slots) if self.slot_req[s] is None]
        while free and self.queue:
            blen = self._bucket_len(len(self.queue[0].prompt))
            avail = self.pool.available_blocks if self.paged else 0
            need, idxs = 0, []
            for i in range(min(len(self.queue), self.admit_window)):
                r = self.queue[i]
                if i and self._bucket_len(len(r.prompt)) != blen:
                    continue
                if len(idxs) >= len(free):
                    break
                if self.paged:
                    nb = self._paged_reserve(r)
                    if need + nb > avail:
                        break       # the pool cannot fit this one yet
                    need += nb
                idxs.append(i)
            if not idxs:            # the head does not fit: wait
                break
            group = [self.queue[i] for i in idxs]
            for i in reversed(idxs):
                del self.queue[i]
            slots, free = free[:len(group)], free[len(group):]
            self._admit_group(slots, group, blen)
            admitted += len(group)
        return admitted

    def _admit_group(self, slots: list, group: list, blen: int):
        """One prefill call for ``group`` (one bucket), spliced into
        ``slots``.  The batch is padded to a power-of-two row count by
        repeating the last request."""
        B = len(group)
        now = time.perf_counter()
        for r in group:
            r.admitted_at = now
        Bp = 1 << (B - 1).bit_length()
        toks = np.zeros((Bp, blen), np.int32)
        lens = np.zeros(Bp, np.int32)
        slot_ids = np.zeros(Bp, np.int32)
        for i, (s, r) in enumerate(zip(slots, group)):
            L = len(r.prompt)
            toks[i, :L] = r.prompt
            lens[i], slot_ids[i] = L, s
        toks[B:] = toks[B - 1]
        lens[B:], slot_ids[B:] = lens[B - 1], slot_ids[B - 1]

        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "lengths": torch.from_numpy(lens).to(dev)}
        next_tok, part = self._prefill(self.params, batch)
        self.stats.prefill_calls += 1
        if self.paged:
            # each row's chain (shared prompt blocks and pad rows splice to
            # the trash block) and the scatter of its bucket columns
            nb = -(-blen // self.pool.block_size)
            dst = np.full((Bp, nb), blockpool.TRASH_BLOCK, np.int32)
            for i, (s, r) in enumerate(zip(slots, group)):
                dst[i] = self.pool.admit(
                    s, r.prompt, nb, reserve_blocks=self._paged_reserve(r))
            blockpool.paged_splice(self.caches, part,
                                   torch.from_numpy(dst).to(dev))
        else:
            kvcache.splice_slots(self.caches, part, slot_ids.tolist())
        # seed the hot loop for the B authentic rows (pad rows repeat row
        # B-1 and its slot, so they would write the same values)
        idx = torch.from_numpy(slot_ids[:B].astype(np.int64)).to(dev)
        self._tok[idx, 0] = next_tok[:B]
        self._pos[idx] = torch.from_numpy(lens[:B]).to(dev)
        first = next_tok.cpu().numpy()
        now = time.perf_counter()
        for i, (s, r) in enumerate(zip(slots, group)):
            self.slot_req[s] = r
            self.slot_pos[s] = lens[i]
            tok = int(first[i])
            r.generated.append(tok)
            r.first_token_at = now
            self.stats.admitted += 1
            if len(r.generated) >= r.max_new_tokens or tok == r.eos_id:
                self._free(s)     # done at prefill

    def _free(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        req.finished_at = time.perf_counter()
        self.finished.append(req)
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self.stats.finished += 1
        if self.paged:
            self.pool.release(slot)

    # -- main loop ----------------------------------------------------------

    def _dispatch(self):
        """Enqueue one decode step over every slot and a non-blocking copy
        of its tokens to the host; returns what the next tick collects."""
        reqs = list(self.slot_req)
        if self.paged:
            self._tok, self.caches, self._pos = self._decode(
                self.params, self._tok, self.caches, self._pos,
                *self._write_plan(reqs))
        else:
            self._tok, self.caches, self._pos = self._decode(
                self.params, self._tok, self.caches, self._pos)
        self.stats.ticks += 1
        host = self._host_tok[self.stats.ticks % 2]
        host.copy_(self._tok.view(-1), non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done, reqs

    def _write_plan(self, reqs: list):
        """This tick's paged write plan: plan each slot's write, apply the
        copy-on-write copies (ahead of the step on the same stream), and
        stage the block table and the plan to the device.  Returns
        (block_table [S,M], write_bids [S]) on the device."""
        S, M = self.num_slots, self.pool.max_blocks_per_seq
        host = self._host_plan[self.stats.ticks % 2]
        bids = host[S * M:].numpy()
        copies = []
        for s in range(S):
            bids[s], cp = self.pool.write_plan(s, reqs[s] is not None)
            copies.extend(cp)
        if copies:
            src, dst = zip(*copies)
            blockpool.copy_blocks(
                self.caches, torch.tensor(src, device=self.device),
                torch.tensor(dst, device=self.device))
        host[:S * M].numpy().reshape(S, M)[:] = self.pool.table
        self._plan.copy_(host, non_blocking=True)
        return self._plan[:S * M].view(S, M), self._plan[S * M:]

    def _collect(self, inflight):
        """Apply the previous tick's tokens (waits for their copy only)."""
        host, done, reqs = inflight
        if done is not None:
            done.synchronize()
        vals = host.numpy()
        now = time.perf_counter()
        for slot, req in enumerate(reqs):
            if req is None or req.done:
                continue
            tok = int(vals[slot])
            req.generated.append(tok)
            req.token_times.append(now)
            self.slot_pos[slot] += 1
            self.stats.tokens_out += 1
            if len(req.generated) >= req.max_new_tokens or tok == req.eos_id:
                self._free(slot)

    def tick(self) -> bool:
        """Dispatch one step, collect the previous one, admit.  Admissions
        take effect in the next tick's step.  Returns whether anything
        happened."""
        dispatched = None
        if any(r is not None for r in self.slot_req):
            dispatched = self._dispatch()
        processed = self._inflight is not None
        if processed:
            self._collect(self._inflight)
        self._inflight = dispatched
        admitted = self._admit_batch()
        return dispatched is not None or processed or admitted > 0

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.tick() and not self.queue:
                break
        return self.stats

    # -- reporting -----------------------------------------------------------

    def latency_summary(self) -> dict:
        """p50/p95/p99 time to first token (submit -> prefill token),
        inter-token latency (consecutive token arrivals at collection) and
        queue wait (submit -> prefill start), in seconds, over finished
        requests."""
        ttfts, itls, waits = [], [], []
        for r in self.finished:
            if r.first_token_at:
                ttfts.append(r.first_token_at - r.submitted_at)
            if r.admitted_at:
                waits.append(r.admitted_at - r.submitted_at)
            times = [r.first_token_at] + list(r.token_times)
            itls.extend(b - a for a, b in zip(times, times[1:]))
        out = {"requests": len(ttfts)}
        for name, xs in (("ttft", ttfts), ("itl", itls),
                         ("queue_wait", waits)):
            out.update({f"{name}_p{q}": percentile(xs, q)
                        for q in (50, 95, 99)})
        return out


    def kv_cache_bytes(self) -> int:
        """Bytes of decode-state storage as allocated: the dense per-slot
        K/V slabs or the paged pool (int8 scale pools included), and the
        xLSTM layers' recurrent states; the attention positions are not
        counted.  (The reference counts K/V only, so for an xLSTM stack
        its figure is 0.)"""
        return sum(t.numel() * t.element_size()
                   for gc in self.caches for sub in gc.values()
                   for n, t in sub.items() if n != "pos")

    def kv_cache_f32_equiv_bytes(self) -> int:
        """Bytes the same K/V entries would take in the working dtype (no
        scale pools), plus the recurrent states as allocated; equals
        :meth:`kv_cache_bytes` unless the pool is int8."""
        itemsize = self.cfg.dtype.itemsize
        return sum(t.numel() * (itemsize if n in ("k", "v")
                                else t.element_size())
                   for gc in self.caches for sub in gc.values()
                   for n, t in sub.items()
                   if n not in ("pos", "k_scale", "v_scale"))


def serving_params(params, dtype: torch.dtype):
    """The parameter tree with every matrix cast once to ``dtype``;
    RMSNorm scales (any key containing "norm") and the xLSTM parameters
    the reference reads in f32 (``models.ssm.F32_PARAMS``: gate biases,
    sLSTM recurrent weights) stay f32."""
    def cast(tree, key=""):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, key) for v in tree]
        keep = "norm" in key or key in F32_PARAMS
        return tree if keep else tree.to(dtype)
    return cast(params)
