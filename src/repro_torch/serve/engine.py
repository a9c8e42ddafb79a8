"""Continuous-batching serve engine over the dense KV layout or the paged
block pool, with monolithic admission or the chunked-prefill scheduler
(port of ``repro.serve.engine.ServeEngine``).

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

* **Chunked-prefill scheduler** (``scheduler=True``,
  ``serve.scheduler``).  Admission becomes part of the decode tick: the
  scheduler picks the next waiting request (weighted round robin across
  priority classes, with starvation aging) when a slot is free and no
  prompt is in flight, reserves the slot (paged: the request's whole
  chain, prefix-shared blocks included, through ``pool.admit`` with the
  worst-case reservation, or ``requeue_front`` when the pool cannot hold
  it yet), and each tick appends one [1, C] chunk of its prompt, sized by
  the token budget left after the decoding slots, inside the mixed step
  (``serve.steps.make_mixed_step``).  Non-decoding slots' positions are
  parked at ``attention.PAD_POS``, so their decode writes are dropped
  (dense) or go to the trash block (paged) and never touch the row being
  built.  The final chunk's sampled token is the request's first, seeded
  into the hot loop on the device and collected with the decode tokens
  one tick later.  The chunk's inputs go to the device in one pinned,
  double-buffered copy.

The reference's fault tolerance, integrity scrubbing and telemetry are
later slices; their knobs raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.attention import PAD_POS
from repro_torch.runtime import check_kv_layout
from repro_torch.serve import blockpool, kvcache
from repro_torch.serve.scheduler import Scheduler


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1                 # -1 = never
    priority: int = 0                # scheduler class (weights are per-class
    #                                  knobs; lower id is not higher priority)
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
    chunk_ticks: int = 0     # scheduler: mixed (decode + chunk) ticks

    @property
    def summary(self) -> str:
        s = (f"ticks={self.ticks} tokens={self.tokens_out} "
             f"admitted={self.admitted} finished={self.finished} "
             f"prefills={self.prefill_calls}")
        if self.chunk_ticks:
            s += f" chunk_ticks={self.chunk_ticks}"
        return s


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
    product); RMSNorm scales stay f32.  ``scheduler`` (default: the
    Runtime's) selects chunked-prefill admission; ``token_budget``,
    ``chunk_size``, ``class_weights`` and ``aging_ticks`` override the
    Runtime's ``sched_kw`` and are refused without it."""

    def __init__(self, runtime, *, num_slots: int = 4,
                 kv_layout: str = "dense", kv_dtype: str = "f32",
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 scheduler: Optional[bool] = None,
                 token_budget: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 class_weights: Optional[dict] = None,
                 aging_ticks: Optional[int] = None, health_every: int = 0,
                 scrub_every: int = 0, injector=None):
        check_kv_layout(runtime.caps, runtime.cfg.name, kv_layout, kv_dtype)
        if kv_layout == "dense" and any(
                v is not None for v in (block_size, num_blocks,
                                        max_blocks_per_seq)):
            raise ValueError(
                "block_size/num_blocks/max_blocks_per_seq size the paged "
                "block pool; pass kv_layout='paged' (a dense engine would "
                "silently ignore them)")
        if health_every or scrub_every or injector is not None:
            _unsupported("fault tolerance / integrity scrubbing",
                         "ROADMAP queue 1, item 10")
        rt = self.rt = runtime
        self.cfg, self.caps, self.device = rt.cfg, rt.caps, rt.device
        self.num_slots = num_slots
        self.capacity = rt.capacity
        self.scheduler = (scheduler if scheduler is not None
                          else getattr(rt, "scheduler", False))
        if self.scheduler and not self.caps.supports_chunked_prefill:
            raise ValueError(
                f"arch {self.cfg.name!r} does not support chunked prefill "
                f"(caps: {self.caps.summary}); the scheduler needs a pure "
                f"self-attention, non-SWA stack — use scheduler=False")
        knobs = dict(token_budget=token_budget, chunk_size=chunk_size,
                     class_weights=class_weights, aging_ticks=aging_ticks)
        if not self.scheduler and any(v is not None for v in knobs.values()):
            raise ValueError(
                "token_budget/chunk_size/class_weights/aging_ticks tune the "
                "chunked-prefill scheduler; pass scheduler=True (a "
                "monolithic engine would silently ignore them)")
        self.sched = None
        if self.scheduler:
            skw = dict(getattr(rt, "sched_kw", None) or {})
            skw.update({k: v for k, v in knobs.items() if v is not None})
            self.sched = Scheduler(**skw)
            if self.sched.chunk_size > self.capacity:
                raise ValueError(
                    f"chunk_size={self.sched.chunk_size} exceeds the decode "
                    f"capacity {self.capacity}")
        # bounded queue scan for admission grouping (see _admit_batch)
        self.admit_window = 4 * num_slots
        self.params = serving_params(rt.params, self.cfg.dtype)
        self.kv_layout, self.kv_dtype = kv_layout, kv_dtype
        self.paged = kv_layout == "paged"
        pin = self.device.type == "cuda"
        # one capacity-padded prefill for both layouts: the paged splice
        # reads block columns out of the same caches the dense one splices
        self._prefill = rt.make_prefill_step()
        M = 0
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
        self._inflight = None   # (host buffer, copy-done event, slot->req,
        #                          chunk-final (req, slot) | None)
        # scheduler state: the one prompt mid-chunked-prefill (req, slot,
        # consumed token count, paged per-column dst) and this tick's chunk
        self._prefilling: Optional[dict] = None
        self._chunk: Optional[dict] = None
        if self.scheduler:
            self._mixed = (rt.make_paged_mixed_step() if self.paged
                           else rt.make_mixed_step())
            # park every (free) slot: see _free
            self._pos.fill_(PAD_POS)
            # a chunk's tokens, positions, write blocks [C] each, its
            # owner's table row [M], its last real index and its reset
            # flag, staged like the write plan
            C = self.sched.chunk_size
            n = 3 * C + M + 2
            self._host_chunk = [torch.empty(n, dtype=torch.int32,
                                            pin_memory=pin)
                                for _ in range(2)]
            self._chunk_dev = torch.empty(n, dtype=torch.int32,
                                          device=self.device)

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
        if self.scheduler:
            self.sched.enqueue(req)
        else:
            self.queue.append(req)

    def _decoding(self, s: int) -> bool:
        """Slot ``s`` takes part in the decode tick: occupied, and not the
        slot receiving prefill chunks (the scheduler reserves it when its
        prompt starts)."""
        return self.slot_req[s] is not None and (
            self._prefilling is None or self._prefilling["slot"] != s)

    def _backlog(self) -> int:
        """Requests not yet decoding: queued, and the one mid-chunked-
        prefill."""
        n = len(self.queue)
        if self.scheduler:
            n += self.sched.pending + (self._prefilling is not None)
        return n

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
        bucket and priority class within the first ``admit_window`` (4 x
        ``num_slots``) queue entries, at most one per free slot; a full
        group ends the scan, and so, under the paged layout, does the first
        request whose worst-case chain no longer fits the unreserved pool,
        so no request is overtaken by a look-alike of its class submitted
        after it.  Returns the number admitted."""
        admitted = 0
        free = [s for s in range(self.num_slots) if self.slot_req[s] is None]
        while free and self.queue:
            head = self.queue[0]
            blen = self._bucket_len(len(head.prompt))
            avail = self.pool.available_blocks if self.paged else 0
            need, idxs = 0, []
            for i in range(min(len(self.queue), self.admit_window)):
                r = self.queue[i]
                if i and (r.priority != head.priority
                          or self._bucket_len(len(r.prompt)) != blen):
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
        if self.scheduler:
            # park the slot: the lock-step decode keeps computing over it,
            # but a parked lane's dense write falls past the cache and is
            # dropped, so a row later built chunk by chunk in this slot is
            # never clobbered (paged lanes of free slots write the trash
            # block)
            self._pos[slot] = PAD_POS
            self.sched.forget(req.rid)

    def _plan_chunk(self) -> Optional[dict]:
        """The scheduler's host planning of this tick's prefill chunk.

        Starts the next waiting request (``sched.select``) when no prompt
        is in flight and a slot is free; a paged engine allocates its
        whole chain here (``pool.admit``: prefix-shared blocks resolve now;
        the worst-case reservation gates as in monolithic admission, and a
        request the pool cannot hold yet goes back to the front of its
        class).  Then sizes this tick's chunk under the token budget
        (``sched.chunk_tokens``); a saturated tick returns None (decode
        only).  Chunk progress advances in ``_dispatch``, after the step
        ran."""
        if self._prefilling is None and self.sched.pending:
            free = next((s for s in range(self.num_slots)
                         if self.slot_req[s] is None), None)
            if free is not None:
                req = self.sched.select()
                if self.paged and \
                        self._paged_reserve(req) > self.pool.available_blocks:
                    self.sched.requeue_front([req])
                else:
                    req.admitted_at = time.perf_counter()
                    self.slot_req[free] = req
                    self.slot_pos[free] = 0
                    dst = None
                    if self.paged:
                        nb = self.pool.blocks_needed(len(req.prompt))
                        dst = self.pool.admit(
                            free, req.prompt, nb,
                            reserve_blocks=self._paged_reserve(req))
                    self._prefilling = {"req": req, "slot": free,
                                        "consumed": 0, "dst": dst}
        pf = self._prefilling
        if pf is None:
            return None
        req, slot = pf["req"], pf["slot"]
        L = len(req.prompt)
        active = sum(self._decoding(s) for s in range(self.num_slots))
        n = self.sched.chunk_tokens(active, L - pf["consumed"])
        if n == 0:
            return None             # budget saturated: decode-only tick
        start = pf["consumed"]
        return {"req": req, "slot": slot, "start": start, "n": n,
                "final": start + n >= L}

    def _stage_chunk(self, ch: dict) -> dict:
        """Stage ``ch``'s device inputs through one pinned buffer and one
        non-blocking copy: tokens and positions [1,C] (pads at PAD_POS),
        paged write blocks [1,C] (the admitted chain's column per token;
        the trash block for prefix-shared columns, already written by
        their first owner, and for pads) and the owner's table row [1,M],
        the last real index [1] and the reset flag [1] (a dense row's
        first chunk clears its stale positions)."""
        req, start, n = ch["req"], ch["start"], ch["n"]
        C = self.sched.chunk_size
        M = self.pool.max_blocks_per_seq if self.paged else 0
        host = self._host_chunk[self.stats.ticks % 2]
        h = host.numpy()
        h[:C] = 0
        h[:n] = req.prompt[start:start + n]
        h[C:2 * C] = PAD_POS
        h[C:C + n] = np.arange(start, start + n, dtype=np.int32)
        if self.paged:
            bs, dst = self.pool.block_size, self._prefilling["dst"]
            h[2 * C:3 * C] = blockpool.TRASH_BLOCK
            h[2 * C:2 * C + n] = dst[np.arange(start, start + n) // bs]
            h[3 * C:3 * C + M] = self.pool.table[ch["slot"]]
        h[3 * C + M] = n - 1
        h[3 * C + M + 1] = start == 0
        dev = self._chunk_dev
        dev.copy_(host, non_blocking=True)
        return {"tok": dev[:C].view(1, C), "pos": dev[C:2 * C].view(1, C),
                "bids": dev[2 * C:3 * C].view(1, C),
                "table": dev[3 * C:3 * C + M].view(1, M),
                "last": dev[3 * C + M:3 * C + M + 1],
                "reset": dev[3 * C + M + 1:] != 0}

    # -- main loop ----------------------------------------------------------

    def _dispatch(self):
        """Enqueue one step over every slot and a non-blocking copy of its
        tokens to the host; returns what the next tick collects.

        With a chunk planned this tick the step is the mixed one (decode
        over every slot, then the chunk appended into its slot's cache),
        else the decode step.  Chunk progress advances here, after the
        step; the final chunk seeds the slot's token and position on the
        device, so its sampled first token travels in the copied token
        lane of its slot.  The slot snapshot masks the prefilling slot:
        its decode lane is parked junk, not stream output."""
        ch = self._chunk
        reqs = [self.slot_req[s] if self._decoding(s) else None
                for s in range(self.num_slots)]
        c_next = None
        if ch is not None:
            c = self._stage_chunk(ch)
        if self.paged:
            plan = self._write_plan(reqs)
            if ch is not None:
                self._tok, self.caches, self._pos, c_next = self._mixed(
                    self.params, self._tok, self.caches, self._pos, *plan,
                    c["tok"], c["pos"], c["table"], c["bids"], c["last"])
            else:
                self._tok, self.caches, self._pos = self._decode(
                    self.params, self._tok, self.caches, self._pos, *plan)
        elif ch is not None:
            self._tok, self.caches, self._pos, c_next = self._mixed(
                self.params, self._tok, self.caches, self._pos, c["tok"],
                c["pos"], ch["slot"], c["reset"], c["last"])
        else:
            self._tok, self.caches, self._pos = self._decode(
                self.params, self._tok, self.caches, self._pos)
        self.stats.ticks += 1
        chunk_final = None
        if ch is not None:
            self.stats.chunk_ticks += 1
            self._prefilling["consumed"] = ch["start"] + ch["n"]
            if ch["final"]:
                req, slot = ch["req"], ch["slot"]
                L = len(req.prompt)
                # the chunk's sampled token at position L: the slot
                # decodes from the next tick on
                self._tok[slot] = c_next
                self._pos[slot] = L
                self.slot_pos[slot] = L
                self._prefilling = None
                chunk_final = (req, slot)
        host = self._host_tok[self.stats.ticks % 2]
        host.copy_(self._tok.view(-1), non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done, reqs, chunk_final

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
        """Apply the previous tick's tokens (waits for their copy only).  A
        tick that ran a prompt's final chunk also carries that request's
        first token, in its slot's lane."""
        host, done, reqs, chunk_final = inflight
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
        if chunk_final is not None:
            req, slot = chunk_final
            if not req.done:
                tok = int(vals[slot])
                req.generated.append(tok)
                req.first_token_at = now
                self.stats.admitted += 1
                if len(req.generated) >= req.max_new_tokens \
                        or tok == req.eos_id:
                    self._free(slot)      # done at prefill

    def tick(self) -> bool:
        """Plan (scheduler), dispatch one step, collect the previous one,
        admit (monolithic).  Monolithic admissions take effect in the next
        tick's step; the scheduler instead plans a prefill chunk before the
        dispatch and runs it inside the mixed step.  Returns whether
        anything happened or is still waiting."""
        self._chunk = None
        if self.scheduler:
            self.sched.on_tick()
            self._chunk = self._plan_chunk()
        dispatched = None
        if self._chunk is not None or any(self._decoding(s)
                                          for s in range(self.num_slots)):
            dispatched = self._dispatch()
        processed = self._inflight is not None
        if processed:
            self._collect(self._inflight)
        self._inflight = dispatched
        if self.scheduler:
            return (dispatched is not None or processed
                    or self._backlog() > 0)
        admitted = self._admit_batch()
        return dispatched is not None or processed or admitted > 0

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.tick() and not self._backlog():
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
        Mamba and xLSTM layers' recurrent states; the attention positions
        are not counted.  (The reference counts K/V only, so for an xLSTM stack
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


# leaves the models read in f32 whatever the activation dtype, as the
# reference does (``.astype(jnp.float32)``): the xLSTM gate biases and
# sLSTM recurrent weights, Mamba's A_log, dt bias and D skip, the MoE router
F32_PARAMS = frozenset({"b_if", "r_rec", "bias", "A_log", "dt_b", "D",
                        "router"})


def serving_params(params, dtype: torch.dtype):
    """The parameter tree with every matrix cast once to ``dtype``;
    RMSNorm scales (any key containing "norm") and the ``F32_PARAMS``
    leaves stay as they are.  With params stored in ``dtype`` already
    nothing is copied."""
    def cast(tree, key=""):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, key) for v in tree]
        keep = "norm" in key or key in F32_PARAMS
        return tree if keep else tree.to(dtype)
    return cast(params)
