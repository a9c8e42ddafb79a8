"""Continuous-batching serve engine, dense KV layout (port of
``repro.serve.engine.ServeEngine``'s monolithic-admission path).

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

The reference's paged pool, int8 KV, chunked-prefill scheduler, fault
tolerance, integrity scrubbing and telemetry are later slices; their
knobs raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.serve import kvcache


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
                 kv_layout: str = "dense", scheduler: bool = False,
                 health_every: int = 0, scrub_every: int = 0,
                 injector=None):
        if kv_layout != "dense":
            _unsupported(f"kv_layout={kv_layout!r}",
                         "ROADMAP queue 1, item 7 (paged KV)")
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
        self._prefill = rt.make_prefill_step()
        self._decode = rt.make_decode_step(advance_pos=True)
        self.caches = kvcache.init_cache(self.cfg, num_slots, self.capacity,
                                         device=self.device)
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
        pin = self.device.type == "cuda"
        self._host_tok = [torch.empty(num_slots, dtype=torch.int32,
                                      pin_memory=pin) for _ in range(2)]
        self._inflight = None   # (host buffer, copy-done event, slot->req)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request):
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
        entries, at most one per free slot; a full group ends the scan, so
        no request is overtaken by a look-alike submitted after it.
        Returns the number admitted."""
        admitted = 0
        free = [s for s in range(self.num_slots) if self.slot_req[s] is None]
        while free and self.queue:
            blen = self._bucket_len(len(self.queue[0].prompt))
            idxs = []
            for i in range(min(len(self.queue), self.admit_window)):
                if i and self._bucket_len(len(self.queue[i].prompt)) != blen:
                    continue
                if len(idxs) >= len(free):
                    break
                idxs.append(i)
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

    # -- main loop ----------------------------------------------------------

    def _dispatch(self):
        """Enqueue one decode step over every slot and a non-blocking copy
        of its tokens to the host; returns what the next tick collects."""
        reqs = list(self.slot_req)
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


def serving_params(params, dtype: torch.dtype):
    """The parameter tree with every matrix cast once to ``dtype``;
    RMSNorm scales (any key containing "norm") stay f32."""
    def cast(tree, key=""):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, key) for v in tree]
        return tree if "norm" in key else tree.to(dtype)
    return cast(params)
