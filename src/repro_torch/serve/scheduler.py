"""Token-budget continuous-batching scheduler (chunked prefill admission;
port of ``repro.serve.scheduler``, host code copied as it is).

The monolithic engine admits a request by running its *entire* prompt
through one prefill call, which stalls every in-flight decode stream for
the prompt's full forward pass (the reference's CPU smoke run in
BENCH_serve.json measured ITL p95 ~1000x its p50 from this head-of-line
blocking alone).  The paper's MCM makes the
opposing argument in hardware: many compute tiles stay saturated because
the fabric interleaves fine-grained traffic instead of letting one bulk
transfer monopolize the links.  This module is the software analog — the
serve-side traffic shaper.

Mechanism
---------

Prompts are split into fixed-size chunks of ``chunk_size`` tokens and one
chunk is interleaved with the decode tick inside a single mixed step
(serve/steps.py:make_mixed_step): a decode stream never waits for
more than one *chunk* of someone else's prefill.  Each tick the engine
asks the scheduler two questions:

* **Who prefills next?**  ``select()`` pops the next waiting request under
  weighted round-robin across priority classes (smooth WRR: per-class
  ``current += weight``, serve the argmax, subtract the total — the
  classic nginx scheme, deterministic and drift-free) with **starvation
  aging**: a request that has waited ``aging_ticks`` engine ticks
  overrides WRR entirely, oldest first, so a low-weight class can be
  slowed but never starved.  Within a class, order is strict FIFO — the
  scheduler never reorders same-class submissions (the invariant the
  monolithic ``_admit_batch`` window scan also preserves).
* **How many chunk tokens fit this tick?**  ``chunk_tokens()`` shapes the
  chunk under the per-tick **token budget**: ``active`` decode slots cost
  one token each, the chunk costs its real (non-pad) tokens, and their sum
  must stay <= ``token_budget``.  A saturated tick shrinks the chunk
  (shapes stay static — pads carry ``attention.PAD_POS``), possibly to
  zero (decode-only tick).  When nothing is decoding the chunk always
  proceeds at full size: budget pressure can slow prefill, never deadlock
  it.

Only one prompt is in prefill flight at a time; its chunks are the unit
the budget arbitrates against the decode streams.  The scheduler is pure
host-side bookkeeping (no tensors) — the engine owns slots, caches and the
mixed step; fault-tolerant evacuation re-enters interrupted requests at
the *front* of their class (``requeue_front``), preserving class order.

Ticks, not wall-clock, drive aging: deterministic under test and under
replay (the same submission sequence always schedules identically).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.metrics import NULL_REGISTRY

DEFAULT_TOKEN_BUDGET = 256
DEFAULT_CHUNK_SIZE = 32
DEFAULT_AGING_TICKS = 256


@dataclass
class SchedulerStats:
    selected: int = 0          # requests popped for prefill
    aged: int = 0              # selections forced by starvation aging
    chunks: int = 0            # chunk_tokens() calls that granted > 0
    deferred_chunks: int = 0   # chunk_tokens() calls budgeted to 0
    shrunk_chunks: int = 0     # chunks granted below the asked size


class Scheduler:
    """Priority/fairness policy + token-budget arbiter for chunked prefill.

    Parameters
    ----------
    token_budget:   max tokens one tick may compute (decode slots count 1
                    each, a prefill chunk its real tokens).
    chunk_size:     fixed prompt-chunk length C (the mixed step's [1, C]
                    shape; shorter grants are padded, not recompiled).
    class_weights:  {priority_class: weight} for smooth WRR; classes not
                    listed get weight 1 on first use.  Higher weight =
                    proportionally more prefill starts.
    aging_ticks:    a request waiting this many engine ticks overrides WRR
                    (oldest first) — the starvation bound.
    registry:       optional obs MetricsRegistry; None keeps the
                    scheduler dependency-free (no-op instruments).
    """

    def __init__(self, *, token_budget: int = DEFAULT_TOKEN_BUDGET,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 class_weights: Optional[dict] = None,
                 aging_ticks: int = DEFAULT_AGING_TICKS,
                 registry=None):
        if token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if aging_ticks < 1:
            raise ValueError(f"aging_ticks must be >= 1, got {aging_ticks}")
        self.token_budget = token_budget
        self.chunk_size = chunk_size
        self.aging_ticks = aging_ticks
        self.weights: dict[int, int] = dict(class_weights or {})
        for c, w in self.weights.items():
            if w < 1:
                raise ValueError(f"class {c} weight must be >= 1, got {w}")
        self._queues: dict[int, deque] = {}     # class -> FIFO of requests
        self._current: dict[int, int] = {}      # smooth-WRR running credit
        self._enq_tick: dict[int, int] = {}     # rid -> tick enqueued
        self._inflight_tick: dict[int, int] = {}  # selected, not yet done
        self._tick = 0
        self.stats = SchedulerStats()
        reg = NULL_REGISTRY if registry is None else registry
        self._c = {k: reg.counter(f"sched_{k}_total",
                                  f"scheduler {k.replace('_', ' ')}")
                   for k in ("selected", "aged", "chunks",
                             "deferred_chunks", "shrunk_chunks")}
        self._g_depth = reg.gauge("sched_queue_depth",
                                  "waiting requests per priority class",
                                  labels=("cls",))
        self._g_util = reg.gauge("sched_budget_utilization",
                                 "last tick's (decodes + chunk grant) "
                                 "over token_budget")

    # -- queue surface ------------------------------------------------------

    def _class_of(self, req) -> int:
        return int(getattr(req, "priority", 0))

    def _queue_for(self, cls: int) -> deque:
        if cls not in self._queues:
            self._queues[cls] = deque()
            self.weights.setdefault(cls, 1)
            self._current.setdefault(cls, 0)
        return self._queues[cls]

    def enqueue(self, req):
        cls = self._class_of(req)
        q = self._queue_for(cls)
        q.append(req)
        self._enq_tick.setdefault(req.rid, self._tick)
        self._g_depth.labels(cls=cls).set(len(q))

    def requeue_front(self, reqs):
        """Re-enter interrupted requests at the *front* of their classes,
        preserving their relative order (evacuation replay: they were the
        earliest-admitted of their class, and must lead it again).  Their
        original enqueue tick is restored (``select`` parked it in
        ``_inflight_tick``) — an evacuation must not reset a request's
        starvation age."""
        for req in reversed(list(reqs)):
            cls = self._class_of(req)
            q = self._queue_for(cls)
            q.appendleft(req)
            self._enq_tick.setdefault(
                req.rid, self._inflight_tick.pop(req.rid, self._tick))
            self._g_depth.labels(cls=cls).set(len(q))

    def forget(self, rid: int):
        """Drop bookkeeping for a finished request (the engine calls this
        when a stream completes, bounding ``_inflight_tick``)."""
        self._inflight_tick.pop(rid, None)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def waiting(self) -> list:
        """Every queued request, in the deterministic (class, FIFO) order a
        snapshot records: class ids ascending, submission order within."""
        return [r for c in sorted(self._queues) for r in self._queues[c]]

    # -- policy -------------------------------------------------------------

    def on_tick(self):
        self._tick += 1

    def _waited(self, req) -> int:
        return self._tick - self._enq_tick.get(req.rid, self._tick)

    def select(self):
        """Pop the next request to start prefilling, or None.

        Starvation aging first: among class heads that have waited >=
        ``aging_ticks``, the oldest wins (ties: lower class id).  Otherwise
        smooth WRR over the nonempty classes.  Heads only — within a class
        the queue is strict FIFO, so aging can never reorder a class."""
        live = [c for c in sorted(self._queues) if self._queues[c]]
        if not live:
            return None
        starved = [c for c in live
                   if self._waited(self._queues[c][0]) >= self.aging_ticks]
        if starved:
            cls = max(starved,
                      key=lambda c: (self._waited(self._queues[c][0]), -c))
            self.stats.aged += 1
            self._c["aged"].inc()
        else:
            total = sum(self.weights[c] for c in live)
            for c in live:
                self._current[c] += self.weights[c]
            cls = max(live, key=lambda c: (self._current[c], -c))
            self._current[cls] -= total
        req = self._queues[cls].popleft()
        # park the enqueue tick: requeue_front (evacuation) restores it so
        # the interruption does not reset the request's starvation age
        self._inflight_tick[req.rid] = self._enq_tick.pop(req.rid,
                                                          self._tick)
        self.stats.selected += 1
        self._c["selected"].inc()
        self._g_depth.labels(cls=cls).set(len(self._queues[cls]))
        return req

    def chunk_tokens(self, active_decodes: int, remaining: int) -> int:
        """Real chunk tokens this tick may spend: min(remaining, C) shaped
        by the budget left after ``active_decodes`` decode tokens.  With no
        active decodes the chunk always proceeds at full size (progress
        guarantee — the budget shapes interleaving, it cannot deadlock)."""
        ask = min(remaining, self.chunk_size)
        if active_decodes <= 0:
            grant = ask
        else:
            grant = max(0, min(ask, self.token_budget - active_decodes))
        if grant == 0:
            self.stats.deferred_chunks += 1
            self._c["deferred_chunks"].inc()
        else:
            self.stats.chunks += 1
            self._c["chunks"].inc()
            if grant < ask:
                self.stats.shrunk_chunks += 1
                self._c["shrunk_chunks"].inc()
        self._g_util.set((max(0, active_decodes) + grant)
                         / self.token_budget)
        return grant

    # -- reporting ----------------------------------------------------------

    def describe(self) -> str:
        w = ",".join(f"{c}:{self.weights[c]}" for c in sorted(self.weights))
        return (f"budget={self.token_budget} chunk={self.chunk_size} "
                f"aging={self.aging_ticks} weights[{w or '-'}] "
                f"pending={self.pending}")
