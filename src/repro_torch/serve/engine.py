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

Fault tolerance and data integrity (the reference's, on one device)
-------------------------------------------------------------------

* **Health-gated ticks.**  Every ``health_every`` ticks the engine runs
  ``ft.health.check_devices`` (a cached-checksum proof of work) on its
  device, scripted faults overlaid; an unhealthy report evacuates.
* **Bounded retry.**  A dispatch that raises is retried with exponential
  backoff up to ``tick_retries`` times, then the engine evacuates.
* **Straggler ladder.**  Tick wall times (dispatch plus the overlapped
  collection) feed an ``ft.straggler.StragglerMonitor`` with the
  reference's serving thresholds; ``remesh`` and ``abort`` evacuate.
* **Evacuation** (``_evacuate``) never drops a stream: it collects the
  in-flight tokens, folds every live request's generated tokens into its
  prompt, rebuilds the data path in place (the reference's rebuild "with
  no device attribution": the port runs on one device and takes no mesh;
  the params stay on the device) and requeues the requests at the head,
  so prefill replays each prefix and the continued stream is the one the
  uninterrupted run emits.
* **Integrity scrub** (``scrub_every``).  Each scrub tick fingerprints the
  written span of every tracked region (pool blocks, or dense slot rows)
  and re-verifies the previous seals; the params fingerprint registered
  at build is re-verified by the scrub and the health gate; the
  device->host token payload carries a device fingerprint the collector
  re-derives on the host copy.  A corrupted block is quarantined
  (``BlockPool.poison``) and only the streams that read it roll back to
  their last verified token and replay; corrupted params restore from a
  host backup taken at build and every live stream replays.
* **Warm restart.**  ``snapshot()`` / ``load_snapshot()`` carry the
  replay-ready requests across engines (``checkpoint.EngineSnapshot``).

Scripted faults (``ft.inject``; ``REPRO_TORCH_FAULT_PLAN``) exercise all of
it, and each corruption draws its (region, leaf, element, bit) from numpy
generators seeded as the reference's are, so the same plan flips the same
bit in both packages.  Every subsystem reports into the Runtime's
``obs.Telemetry``: counters backing ``EngineStats``, gauges and histograms,
and ``tick`` / ``plan`` / ``dispatch`` / ``collect`` / ``admit`` /
``health`` / ``scrub`` spans when the tracer is on.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import EngineSnapshot
from repro_torch.ft import health as ft_health
from repro_torch.ft import integrity as ft_integrity
from repro_torch.ft.inject import FaultInjector
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models.attention import PAD_POS
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.obs.metrics import latency_fields
from repro_torch.runtime import check_kv_layout
from repro_torch.serve import blockpool, kvcache
from repro_torch.serve.scheduler import Scheduler

_FROM_ENV = object()     # injector default: build from REPRO_TORCH_FAULT_PLAN
# the reference engine's serving thresholds for its straggler monitor
SERVE_STRAGGLER = dict(window=32, warn_ratio=4.0, remesh_ratio=10.0,
                       abort_ratio=100.0, sustained=3)


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
    # replay bookkeeping: how many ``generated`` tokens are already folded
    # into ``prompt`` (folding is idempotent across repeated evacuations)
    folded: int = 0
    # integrity watermark: tokens verified against clean state at the last
    # scrub; a corruption rollback truncates ``generated`` here (never
    # below ``folded``)
    verified: int = 0


_STAT_NAMES = ("ticks", "tokens_out", "admitted", "finished",
               "prefill_calls", "chunk_ticks", "evacuations", "tick_retries",
               "health_checks", "scrubs", "corruption_detected",
               "kv_quarantined", "streams_replayed", "params_restores",
               "transfer_retries")


@dataclass
class EngineStats:
    """Engine counters.  :meth:`bind` backs each field with a monotonic
    registry Counter (``serve_engine_<field>_total``), so one metrics
    snapshot carries them and no retry / evacuation / replay path can
    count backwards; each binding records its base offset, so the
    dataclass view stays per-engine while the registry accumulates."""

    ticks: int = 0
    tokens_out: int = 0
    admitted: int = 0
    finished: int = 0
    prefill_calls: int = 0
    chunk_ticks: int = 0     # scheduler: mixed (decode + chunk) ticks
    # fault tolerance
    evacuations: int = 0
    tick_retries: int = 0
    health_checks: int = 0
    # data integrity (scrub_every > 0)
    scrubs: int = 0
    corruption_detected: int = 0   # detection events (kv regions + params
    #                                restores + payload mismatches)
    kv_quarantined: int = 0        # pool blocks poisoned / dense rows hit
    streams_replayed: int = 0      # streams rolled back + requeued
    params_restores: int = 0
    transfer_retries: int = 0      # device->host payload re-fetches

    def bind(self, registry):
        counters, base = {}, {}
        for k in _STAT_NAMES:
            c = registry.counter(f"serve_engine_{k}_total",
                                 f"cumulative engine {k}")
            counters[k] = c
            base[k] = c.value - getattr(self, k)
        object.__setattr__(self, "_bound", (counters, base))

    def __setattr__(self, name, value):
        bound = getattr(self, "_bound", None)
        if bound is not None and name in bound[0]:
            # mirror first: Counter.set raises on a decrease, so a
            # would-be regression never lands in the dataclass either
            counters, base = bound
            counters[name].set(base[name] + value)
        object.__setattr__(self, name, value)

    @property
    def summary(self) -> str:
        s = (f"ticks={self.ticks} tokens={self.tokens_out} "
             f"admitted={self.admitted} finished={self.finished} "
             f"prefills={self.prefill_calls}")
        if self.chunk_ticks:
            s += f" chunk_ticks={self.chunk_ticks}"
        if self.evacuations or self.tick_retries or self.health_checks:
            s += (f" evacuations={self.evacuations} "
                  f"retries={self.tick_retries} "
                  f"health_checks={self.health_checks}")
        if self.scrubs or self.corruption_detected:
            s += (f" scrubs={self.scrubs} "
                  f"corruption_detected={self.corruption_detected} "
                  f"quarantined={self.kv_quarantined} "
                  f"replayed={self.streams_replayed}")
        return s


def _fold_replay_prefix(req: Request):
    """Fold a request's generated tokens into its prompt so one prefill
    replays the whole prefix: re-admission then computes the next token at
    position ``len(prompt)``, where the interrupted decode would have.
    Idempotent via ``Request.folded``."""
    fresh = req.generated[req.folded:]
    if fresh:
        req.prompt = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(fresh, np.int32)])
        req.folded = len(req.generated)


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
    Runtime's ``sched_kw`` and are refused without it.

    Fault-tolerance knobs, as the reference's: ``health_every`` gates
    ticks on device health checks (0 = off), ``tick_retries`` /
    ``retry_backoff_s`` bound the transient-failure retry loop,
    ``injector`` takes a ``FaultInjector`` (default: parsed from
    ``REPRO_TORCH_FAULT_PLAN``; ``None`` disables), ``straggler_kw``
    overrides the straggler thresholds, ``max_evacuations`` bounds repeated
    evacuation, ``scrub_every`` arms the integrity layer (0 = off) and
    ``trace`` turns the shared tracer on or off (None leaves it)."""

    def __init__(self, runtime, *, num_slots: int = 4,
                 kv_layout: str = "dense", kv_dtype: str = "f32",
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 scheduler: Optional[bool] = None,
                 token_budget: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 class_weights: Optional[dict] = None,
                 aging_ticks: Optional[int] = None,
                 health_every: int = 0, injector=_FROM_ENV,
                 tick_retries: int = 2, retry_backoff_s: float = 0.02,
                 straggler_kw: Optional[dict] = None,
                 max_evacuations: int = 8,
                 scrub_every: int = 0,
                 trace: Optional[bool] = None):
        check_kv_layout(runtime.caps, runtime.cfg.name, kv_layout, kv_dtype)
        if kv_layout == "dense" and any(
                v is not None for v in (block_size, num_blocks,
                                        max_blocks_per_seq)):
            raise ValueError(
                "block_size/num_blocks/max_blocks_per_seq size the paged "
                "block pool; pass kv_layout='paged' (a dense engine would "
                "silently ignore them)")
        rt = self.rt = runtime
        self.cfg, self.caps, self.device = rt.cfg, rt.caps, rt.device
        # observability: the Runtime's shared registry + tracer (the
        # engine keeps its own reference, so instruments survive a
        # rebuild)
        self.obs = rt.telemetry()
        self.tracer = self.obs.tracer
        if trace is not None:
            self.tracer.enabled = bool(trace)
        self._init_instruments()
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
            self.sched = Scheduler(registry=self.obs.registry, **skw)
            if self.sched.chunk_size > self.capacity:
                raise ValueError(
                    f"chunk_size={self.sched.chunk_size} exceeds the decode "
                    f"capacity {self.capacity}")
        # bounded queue scan for admission grouping (see _admit_batch)
        self.admit_window = 4 * num_slots
        self.params = serving_params(rt.params, self.cfg.dtype)
        self.kv_layout, self.kv_dtype = kv_layout, kv_dtype
        self.paged = kv_layout == "paged"
        self.quantized = kv_dtype == "int8"
        # data-path build knobs, kept so a rebuild sizes the pool alike
        self._block_size = block_size if block_size is not None else 16
        self._num_blocks = num_blocks
        self._max_blocks_per_seq = max_blocks_per_seq
        # data integrity: a sliding window's ring buffer rewrites sealed
        # entries in place, which a scrub cannot tell from corruption
        if scrub_every and self.caps.swa:
            raise ValueError(
                f"arch {self.cfg.name!r} uses a sliding-window (ring-buffer) "
                f"KV cache whose in-place rewrites are indistinguishable "
                f"from corruption; scrub_every needs a non-SWA arch")
        self.scrub_every = scrub_every
        # fault tolerance: watchdogs + scripted-fault harness
        self.health_every = health_every
        self.injector = (FaultInjector.from_env() if injector is _FROM_ENV
                         else injector)
        self.tick_retries = tick_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_evacuations = max_evacuations
        # serving thresholds: decode ticks are short and noisy on a shared
        # host, so the ratios sit far above the training defaults
        self.straggler = StragglerMonitor(
            registry=self.obs.registry,
            **(straggler_kw if straggler_kw is not None
               else SERVE_STRAGGLER))
        self.ft_events: list[dict] = []    # structured fault-handling log
        self._tick_no = 0                  # absolute tick count (fault plans
        #                                    address ticks by this number)
        self._devices = [self.device]
        # engine state that survives a rebuild
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.stats = EngineStats()
        self.stats.bind(self.obs.registry)
        self._params_fp: Optional[int] = None
        self._params_backup = None
        self._last_inject: dict = {}
        self._build_data_path()
        if self.scrub_every:
            self._register_params_integrity()

    def _init_instruments(self):
        """The engine's gauges and histograms (``EngineStats`` binds its
        counters separately)."""
        reg = self.obs.registry
        self._g_queue = reg.gauge(
            "serve_queue_depth", "requests waiting for admission")
        self._g_active = reg.gauge(
            "serve_active_slots", "slots decoding this tick")
        self._h_health = reg.histogram(
            "ft_health_check_seconds", "device health-gate latency")
        self._h_evac = reg.histogram(
            "ft_evacuation_seconds", "live evacuation latency")
        self._h_detect = reg.histogram(
            "ft_corruption_detect_ticks",
            "corruption detection latency in ticks since injection",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64))
        self._c_events = reg.counter(
            "serve_ft_events_total", "structured fault-handling events",
            labels=("event",))
        self._g_kv_bytes = reg.gauge(
            "blockpool_kv_pool_bytes",
            "bytes of KV pool storage as allocated (incl. scale pools)")
        self._g_kv_f32_bytes = reg.gauge(
            "blockpool_kv_pool_f32_equiv_bytes",
            "bytes the same KV pool entries would cost at full precision")
        self._c_dequant = reg.counter(
            "serve_kv_dequant_blocks_total",
            "pool blocks dequantized in-loop by decode dispatches")

    def _build_data_path(self):
        """(Re)build everything derived from the Runtime: steps, device
        caches, block pool, slot state and staging buffers.  Called at
        construction and again by an evacuation; the queue, finished list,
        stats and fault-tolerance state survive the rebuild."""
        rt, S = self.rt, self.num_slots
        pin = self.device.type == "cuda"
        # one capacity-padded prefill for both layouts: the paged splice
        # reads block columns out of the same caches the dense one splices
        self._prefill = rt.make_prefill_step()
        M = 0
        self.caches = None                 # free the old caches first
        if self.paged:
            bs = self._block_size
            M = (self._max_blocks_per_seq
                 if self._max_blocks_per_seq is not None
                 else -(-self.capacity // bs))
            nblocks = (self._num_blocks if self._num_blocks is not None
                       else S * M + blockpool.NUM_RESERVED)
            # max_entries=capacity junks writes where the dense layout
            # drops them, also when capacity % block_size != 0
            self.pool = blockpool.BlockPool(nblocks, bs, S, M,
                                            max_entries=self.capacity,
                                            registry=self.obs.registry)
            self.caches = blockpool.init_paged_cache(
                self.cfg, nblocks, bs, self.kv_dtype, device=self.device)
            self._decode = rt.make_paged_decode_step()
            # each tick's block table [S*M] and write plan [S], staged in
            # one of two pinned host buffers (the copy of tick t reads its
            # buffer until tick t's collection has waited on the device)
            n = S * (M + 1)
            self._host_plan = [torch.empty(n, dtype=torch.int32,
                                           pin_memory=pin) for _ in range(2)]
            self._plan = torch.empty(n, dtype=torch.int32,
                                     device=self.device)
        else:
            self.pool = None
            self.caches = kvcache.init_cache(self.cfg, S, self.capacity,
                                             device=self.device)
            self._decode = rt.make_decode_step(advance_pos=True)
        self._g_kv_bytes.set(self.kv_cache_bytes())
        self._g_kv_f32_bytes.set(self.kv_cache_f32_equiv_bytes())
        self.slot_req: list[Optional[Request]] = [None] * S
        # host mirror of each request's next position (0 when free); the
        # hot loop reads the device-resident ``_pos``, which also advances
        # on inactive slots
        self.slot_pos = np.zeros(S, np.int32)
        self._tok = torch.zeros((S, 1), dtype=torch.int32,
                                device=self.device)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=self.device)
        # two host buffers for the one-tick-lag collection: step t copies
        # into one while step t-1's is read from the other (and, with the
        # integrity layer armed, two for the tokens' device fingerprint)
        self._host_tok = [torch.empty(S, dtype=torch.int32, pin_memory=pin)
                          for _ in range(2)]
        self._host_sum = [torch.empty(1, dtype=torch.int64, pin_memory=pin)
                          for _ in range(2)]
        self._inflight = None   # (host buffer, copy-done event, slot->req,
        #                          chunk-final (req, slot) | None, device
        #                          tokens, host fingerprint buffer | None)
        # integrity: region seals {block|slot: (count, fp, alloc gen)},
        # copy-on-write pairs since the last scrub (a bad source condemns
        # its copies) and the dense slots' admission generations
        self._sealed: dict = {}
        self._cow_since_scrub: list = []
        self._slot_gen = np.zeros(S, np.int64)
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
        # the first dispatch after a (re)build runs cold (allocation,
        # kernel builds): keep it out of the straggler's baseline
        # (scheduler engines run two programs: mixed and decode-only)
        self._straggler_skip = 2 if self.scheduler else 1

    # -- admission ----------------------------------------------------------

    def _paged_reserve(self, req: Request) -> int:
        """Worst-case block-chain length of ``req``: prompt plus its whole
        generation budget, capped at the table width (writes past it go to
        the trash block, where the dense layout drops them).  ``folded``
        tokens already live inside a replayed request's prompt, so they
        are not counted twice."""
        return min(self.pool.blocks_needed(len(req.prompt)
                                           + req.max_new_tokens
                                           - req.folded),
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
            self._slot_gen[s] += 1    # fresh occupant: stale seals invalid
            tok = int(first[i])
            r.generated.append(tok)
            r.first_token_at = now
            self.stats.admitted += 1
            self.tracer.instant("req:admit", rid=r.rid, slot=s)
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
        self.tracer.instant("req:finish", rid=req.rid, slot=slot,
                            tokens=len(req.generated))
        if self.paged:
            self.pool.release(slot)
        if self.scheduler:
            self._park(slot)
            self.sched.forget(req.rid)

    def _park(self, slot: int):
        """Park a slot's position at ``PAD_POS``: the lock-step decode keeps
        computing over it, but a parked lane's dense write falls past the
        cache and is dropped, so a row later built chunk by chunk in this
        slot is never clobbered (paged lanes of free slots write the
        trash block)."""
        self._pos[slot] = PAD_POS

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
                    self._slot_gen[free] += 1
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
        its decode lane is parked junk, not stream output.  With the
        integrity layer armed the copied tokens are a private copy (later
        admissions seed the live array in place) and their device
        fingerprint travels with them."""
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
        parity = self.stats.ticks % 2
        tok, host_sum = self._tok, None
        if self.scrub_every:
            tok = self._tok.clone()
            host_sum = self._host_sum[parity]
            host_sum.copy_(ft_integrity.leaf_fingerprint(tok).view(1),
                           non_blocking=True)
        host = self._host_tok[parity]
        host.copy_(tok.view(-1), non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done, reqs, chunk_final, tok, host_sum

    def _write_plan(self, reqs: list):
        """This tick's paged write plan: plan each slot's write, apply the
        copy-on-write copies (ahead of the step on the same stream), and
        stage the block table and the plan to the device.  Returns
        (block_table [S,M], write_bids [S]) on the device."""
        S, M = self.num_slots, self.pool.max_blocks_per_seq
        host = self._host_plan[self.stats.ticks % 2]
        bids = host[S * M:].numpy()
        copies = []
        dequant_blocks = 0
        for s in range(S):
            active = reqs[s] is not None
            bids[s], cp = self.pool.write_plan(s, active)
            copies.extend(cp)
            if active:
                dequant_blocks += int(self.pool.seq_blocks[s])
        if self.quantized and dequant_blocks:
            # every active slot's chain streams through the in-loop dequant
            self._c_dequant.inc(dequant_blocks)
        if self.scrub_every:
            # corruption propagates through a block copy: the scrub
            # condemns a bad source's copies along this log
            self._cow_since_scrub.extend(copies)
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
        first token, in its slot's lane.  With the integrity layer armed
        the host copy is re-fingerprinted against the device's
        fingerprint first (:meth:`_verify_payload`)."""
        host, done, reqs, chunk_final, tok_dev, host_sum = inflight
        if done is not None:
            done.synchronize()
        vals = host.numpy()
        if host_sum is not None:
            vals = self._verify_payload(tok_dev, vals, int(host_sum[0]))
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
                self.tracer.instant("req:admit", rid=req.rid, slot=slot)
                if len(req.generated) >= req.max_new_tokens \
                        or tok == req.eos_id:
                    self._free(slot)      # done at prefill

    def _dispatch_with_retry(self, t: int):
        """Dispatch with bounded retry-with-backoff: a failed tick is
        retried up to ``tick_retries`` times before the engine evacuates.
        Scripted faults fire via ``injector.on_tick`` before the step, so a
        failed attempt never half-applies it."""
        last = None
        for attempt in range(self.tick_retries + 1):
            try:
                if self.injector is not None:
                    self.injector.on_tick(t)
                return self._dispatch()
            except Exception as e:  # noqa: BLE001 — retry, then escalate
                last = e
                self.stats.tick_retries += 1
                self._log_event("tick_retry", tick=t, attempt=attempt,
                                error=repr(e))
                time.sleep(self.retry_backoff_s * (2 ** attempt))
        self._evacuate(tick=t,
                       reason=(f"tick failed {self.tick_retries + 1} "
                               f"attempts: {last!r}"),
                       bad=self._suspects())
        return None

    def tick(self) -> bool:
        """Plan (scheduler), dispatch one step, collect the previous one,
        admit (monolithic).  Monolithic admissions take effect in the next
        tick's step; the scheduler instead plans a prefill chunk before the
        dispatch and runs it inside the mixed step.

        The health gate (every ``health_every`` ticks), the retried
        dispatch, the straggler monitor and the scrub (every
        ``scrub_every`` ticks, after the in-flight swap, so a detection can
        still drop the just-dispatched lane) wrap the loop.  The whole tick
        is a ``tick`` span with strictly nested ``plan`` / ``dispatch`` /
        ``collect`` / ``admit`` / ``health`` / ``scrub`` child spans; with
        the tracer off each is a shared no-op.  Returns whether anything
        happened or is still waiting."""
        self._tick_no += 1
        t = self._tick_no
        with self.tracer.span("tick", tick=t):
            busy = self._tick_body(t)
        self._g_queue.set(self._backlog())
        self._g_active.set(sum(self._decoding(s)
                               for s in range(self.num_slots)))
        return busy

    def _tick_body(self, t: int) -> bool:
        if self.health_every and t % self.health_every == 0:
            with self.tracer.span("health", tick=t):
                self._health_gate(t)
        if self.scrub_every and self.injector is not None:
            # scripted silent corruption lands before dispatch: this tick's
            # step reads the flipped bits, and the scrub below catches them
            # before its output is collected
            self._apply_corruptions(t)

        self._chunk = None
        if self.scheduler:
            with self.tracer.span("plan", tick=t):
                self.sched.on_tick()
                self._chunk = self._plan_chunk()

        t_start = time.perf_counter()
        dispatched = None
        if self._chunk is not None or any(self._decoding(s)
                                          for s in range(self.num_slots)):
            with self.tracer.span("dispatch", tick=t):
                dispatched = self._dispatch_with_retry(t)

        processed = self._inflight is not None
        if processed:
            with self.tracer.span("collect", tick=t):
                self._collect(self._inflight)
        self._inflight = dispatched

        if dispatched is not None:
            if self._straggler_skip:
                self._straggler_skip -= 1       # cold tick: not baseline
            else:
                # the tick's critical path (dispatch + overlapped collect)
                rep = self.straggler.observe(t,
                                             time.perf_counter() - t_start)
                if rep.action != "ok":
                    self._on_straggler(t, rep)

        if self.scrub_every and t % self.scrub_every == 0:
            with self.tracer.span("scrub", tick=t):
                self._scrub(t)

        if self.scheduler:
            return (dispatched is not None or processed
                    or self._backlog() > 0)
        with self.tracer.span("admit", tick=t):
            admitted = self._admit_batch()
        return dispatched is not None or processed or admitted > 0

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.tick() and not self._backlog():
                break
        return self.stats

    # -- fault handling -------------------------------------------------------

    def _log_event(self, kind: str, **fields):
        self.ft_events.append({"event": kind, **fields})
        self._c_events.labels(event=kind).inc()
        self.tracer.instant("ft:" + kind, **fields)

    def _suspects(self) -> set:
        """Device ids implicated by fired scripted faults."""
        return (self.injector.suspect_devices()
                if self.injector is not None else set())

    def _health_gate(self, t: int):
        """Proof-of-work health check of the engine's device, scripted
        faults overlaid; an unhealthy report evacuates.  With the integrity
        layer armed the gate first re-verifies the params fingerprint: a
        mismatch is silent data corruption (``HealthReason.
        DATA_CORRUPTION``), recovered by a params restore and a replay of
        every stream, not by an evacuation."""
        if self._params_fp is not None and not self._verify_params():
            self._log_event(
                "health", tick=t,
                failed=[{"device": "params",
                         "reason": ft_health.HealthReason
                         .DATA_CORRUPTION.value,
                         "detail": "params fingerprint mismatch"}])
            self._recover_params(t, origin="health_gate")
        t0 = time.perf_counter()
        reports = ft_health.check_devices(self._devices)
        if self.injector is not None:
            reports = self.injector.apply_health(reports, self._devices, t)
        self._h_health.observe(time.perf_counter() - t0)
        self.stats.health_checks += 1
        bad = [(r, d) for r, d in zip(reports, self._devices) if not r.ok]
        if not bad:
            return
        self._log_event(
            "health", tick=t,
            failed=[{"device": r.device, "reason": r.reason.value,
                     "detail": r.detail} for r, _ in bad])
        self._evacuate(
            tick=t,
            reason="unhealthy devices: " + ", ".join(
                f"{r.device}[{r.reason.value}]" for r, _ in bad),
            bad={ft_health.device_id(d) for _, d in bad})

    def _on_straggler(self, t: int, rep):
        self._log_event("straggler", tick=t, action=rep.action,
                        ratio=round(rep.ratio, 2),
                        step_time=round(rep.step_time, 5),
                        median=round(rep.median, 5))
        if rep.action in ("remesh", "abort"):
            self._evacuate(
                tick=t,
                reason=f"straggler {rep.action} "
                       f"(tick {rep.ratio:.1f}x rolling median)",
                bad=self._suspects())

    # -- data integrity -------------------------------------------------------

    def _register_params_integrity(self):
        """Register the params fingerprint and a host copy to restore from
        (the stand-in for the last checkpoint)."""
        self._params_fp = int(ft_integrity.tree_fingerprint(self.params))
        self._params_backup = tree_map(
            lambda t: t.detach().to("cpu", copy=True), self.params)

    def _verify_params(self) -> bool:
        return self._params_fp == int(
            ft_integrity.tree_fingerprint(self.params))

    def _verify_payload(self, tok_dev: torch.Tensor, vals: np.ndarray,
                        expect: int) -> np.ndarray:
        """Fingerprint-check the device->host token copy.  Scripted
        ``target=collective`` faults flip a bit in the host copy here (the
        transfer is the corruption point); a mismatch re-fetches from the
        still-resident device tokens, so a corrupted payload is never
        applied to any stream."""
        t = self._tick_no
        if self.injector is not None:
            for f in self.injector.due_corruptions(t, "collective"):
                f.fired += 1
                rng = np.random.default_rng((0x7A6, f.seed, f.fired))
                i = int(rng.integers(vals.size))
                b = int(rng.integers(32))
                vals = vals.copy()
                vals[i] = np.int32(np.uint32(vals[i]) ^ np.uint32(1 << b))
                self._last_inject["collective"] = t
                self._log_event("corrupt_inject", tick=t,
                                target="collective", index=i, bit=b)
        if ft_integrity.host_leaf_fingerprint(vals) == expect:
            return vals
        self.stats.corruption_detected += 1
        self.stats.transfer_retries += 1
        lat = t - self._last_inject.get("collective", t)
        self._h_detect.observe(lat)
        self._log_event("corruption", tick=t, target="collective",
                        detect_latency_ticks=lat)
        fresh = tok_dev.reshape(-1).cpu().numpy()
        if ft_integrity.host_leaf_fingerprint(fresh) != expect:
            raise RuntimeError(
                "token payload checksum mismatch persists after re-fetch: "
                "the device-resident payload itself is corrupt")
        return fresh

    def _apply_corruptions(self, t: int):
        """Fire due scripted ``kind=corrupt`` faults (kv and params targets)
        before dispatch; ``target=collective`` fires at collection.  A kv
        fault with nothing sealed yet stays armed."""
        for f in self.injector.due_corruptions(t, "kv"):
            if self._corrupt_kv(t, f):
                f.fired += 1
        for f in self.injector.due_corruptions(t, "params"):
            f.fired += 1
            self._corrupt_params(t, f)

    def _corrupt_kv(self, t: int, f) -> bool:
        """Flip one seeded bit inside a currently sealed span (decode only
        appends past a seal, so the flip cannot be legitimately
        overwritten before the next scrub).  Draws (region, leaf, element,
        bit) in the reference's order from the same seeded generator."""
        cand = []
        for r, (cnt, fp, gen) in sorted(self._sealed.items()):
            cur = (self.pool.alloc_gen[r] if self.paged
                   else self._slot_gen[r])
            if cnt > 0 and gen == int(cur):
                cand.append((r, cnt))
        if not cand:
            return False
        rng = np.random.default_rng((0xC0, f.seed, f.fired))
        r, cnt = cand[int(rng.integers(len(cand)))]
        leaves = tree_leaves(self.caches)
        j = int(rng.integers(len(leaves)))
        leaf = leaves[j]
        shape = tuple(leaf.shape)              # [R, region, entry, ...]
        # the entry axis is the block offset for payload / pos leaves but
        # the kv head for the int8 pool's [R, N, KV] scales: bound it by
        # both so the flip stays inside the sealed span
        mi = (int(rng.integers(shape[0])), r,
              int(rng.integers(min(cnt, shape[2]))),
              *(int(rng.integers(d)) for d in shape[3:]))
        flat = int(np.ravel_multi_index(mi, shape))
        bit = int(rng.integers(ft_integrity.bit_width(leaf.dtype)))
        ft_integrity.flip_bit_(leaf, flat, bit)
        self._last_inject["kv"] = t
        self._log_event("corrupt_inject", tick=t, target="kv",
                        region=int(r), leaf=j, bit=bit)
        return True

    def _corrupt_params(self, t: int, f):
        leaves = tree_leaves(self.params)
        rng = np.random.default_rng((0xBAD, f.seed, f.fired))
        j = int(rng.integers(len(leaves)))
        leaf = leaves[j]
        flat = int(rng.integers(leaf.numel()))
        bit = int(rng.integers(ft_integrity.bit_width(leaf.dtype)))
        # a copy: the engine's serving params may share tensors with the
        # Runtime's
        leaves[j] = ft_integrity.flip_bit(leaf, flat, bit)
        self.params = tree_unflatten(self.params, leaves)
        self._last_inject["params"] = t
        self._log_event("corrupt_inject", tick=t, target="params",
                        leaf=j, bit=bit)

    def _scrub(self, t: int):
        """Integrity scrub: wipe and release blocks quarantined last round,
        re-verify every seal at its recorded extent, recover from anything
        that fails, then reseal the current state and advance the
        per-request ``verified`` watermarks."""
        self.stats.scrubs += 1
        if self.paged:
            ready = self.pool.scrub_poisoned()
            if ready:
                ft_integrity.clear_regions(
                    self.caches, torch.tensor(ready, device=self.device))
                self._log_event("scrub_clean", tick=t,
                                blocks=[int(b) for b in ready])
        bad = self._verify_seals()
        if bad:
            self._recover_kv(t, bad)
        if self._params_fp is not None and not self._verify_params():
            self._recover_params(t, origin="scrub")
        self._reseal()
        self._cow_since_scrub = []

    def _region_fps(self, counts: np.ndarray) -> np.ndarray:
        return ft_integrity.region_fingerprints(
            self.caches, torch.from_numpy(counts)).cpu().numpy()

    def _verify_seals(self) -> list:
        """Regions whose recorded fingerprint no longer matches; seals of
        regions recycled since (allocation generation moved) are skipped."""
        if not self._sealed:
            return []
        N = self.pool.num_blocks if self.paged else self.num_slots
        counts = np.zeros(N, np.int32)
        valid = {}
        for r, (cnt, fp, gen) in self._sealed.items():
            cur = (self.pool.alloc_gen[r] if self.paged
                   else self._slot_gen[r])
            if cnt > 0 and gen == int(cur):
                counts[r] = cnt
                valid[r] = fp
        if not valid:
            return []
        fps = self._region_fps(counts)
        return sorted(r for r, fp in valid.items() if int(fps[r]) != fp)

    def _reseal(self):
        """Fingerprint the written span of every tracked region: pool
        blocks along live chains (shared blocks at their fullest view) and
        registered cached-free blocks (a future prompt may share them), or
        the dense occupied slot rows up to the collected watermark."""
        counts: dict = {}
        pf = self._prefilling
        if self.paged:
            pool, bs = self.pool, self.pool.block_size
            for s in range(self.num_slots):
                nb = int(pool.seq_blocks[s])
                if nb == 0:
                    continue
                entries = (pf["consumed"]
                           if pf is not None and pf["slot"] == s
                           else int(pool.next_pos[s]))
                for col in range(nb):
                    bid = int(pool.table[s, col])
                    cnt = min(max(entries - col * bs, 0), bs)
                    # int8 pool: a partly filled block's entries can be
                    # requantized in place when a later append grows the
                    # block's scale, so only full blocks seal
                    if self.quantized and cnt < bs:
                        continue
                    counts[bid] = max(counts.get(bid, 0), cnt)
            for bid in pool._key_of:
                if int(pool.refcount[bid]) == 0:
                    counts[bid] = bs
            N = pool.num_blocks
            gen = pool.alloc_gen
        else:
            for s in range(self.num_slots):
                if self.slot_req[s] is None:
                    continue
                entries = (pf["consumed"]
                           if pf is not None and pf["slot"] == s
                           else int(self.slot_pos[s]))
                counts[s] = min(entries, self.capacity)
            N = self.num_slots
            gen = self._slot_gen
        counts = {r: c for r, c in counts.items() if c > 0}
        if counts:
            vec = np.zeros(N, np.int32)
            for r, c in counts.items():
                vec[r] = c
            fps = self._region_fps(vec)
            self._sealed = {r: (c, int(fps[r]), int(gen[r]))
                            for r, c in counts.items()}
        else:
            self._sealed = {}
        # clean scrub: every collected token of a live stream came from
        # state now proven intact
        for s in range(self.num_slots):
            r = self.slot_req[s]
            if r is not None:
                r.verified = len(r.generated)

    def _recover_kv(self, t: int, bad: list):
        """Quarantine-and-replay for corrupted KV: poison the blocks (and
        their copy-on-write copies), roll every affected stream back to its
        verified watermark and requeue it through prefill admission."""
        self.stats.corruption_detected += len(bad)
        lat = t - self._last_inject.get("kv", t)
        self._h_detect.observe(lat)
        bad = set(bad)
        if self.paged:
            for src, dst in self._cow_since_scrub:
                if src in bad:
                    bad.add(dst)
            affected = [s for s in range(self.num_slots)
                        if int(self.pool.seq_blocks[s])
                        and any(b in bad for b in self.pool.chain(s))]
            for bid in sorted(bad):
                self.pool.poison(bid)
        else:
            affected = sorted(bad)
        self.stats.kv_quarantined += len(bad)
        replayed = self._replay_streams(affected)
        self._log_event(
            "corruption", tick=t, target="kv",
            regions=[int(b) for b in sorted(bad)],
            streams=[r.rid for r in replayed],
            detect_latency_ticks=lat)

    def _recover_params(self, t: int, origin: str):
        """Silent params corruption: restore from the host backup and roll
        back every live stream (KV appended under corrupted params is
        garbage with a valid seal), quarantining their chains and dropping
        the prefix cache."""
        self.stats.corruption_detected += 1
        self.stats.params_restores += 1
        self.params = tree_map(lambda h: h.to(self.device),
                               self._params_backup)
        affected = [s for s in range(self.num_slots)
                    if self.slot_req[s] is not None]
        if self.paged:
            bad = set()
            for s in affected:
                bad.update(self.pool.chain(s))
            for bid in sorted(bad):
                self.pool.poison(bid)
            self.pool.drop_prefix_cache()
            self.stats.kv_quarantined += len(bad)
        replayed = self._replay_streams(affected)
        self._sealed = {}       # every seal is suspect under bad params
        lat = t - self._last_inject.get("params", t)
        self._h_detect.observe(lat)
        self._log_event(
            "corruption", tick=t, target="params", origin=origin,
            streams=[r.rid for r in replayed],
            detect_latency_ticks=lat)

    def _replay_streams(self, slots: list) -> list:
        """Roll the given slots' streams back to their verified watermarks
        and requeue them at the head: truncate suspect tokens, drop the
        not-yet-collected in-flight lane, fold, release the slot."""
        replayed = []
        for s in sorted(slots):
            req = self.slot_req[s]
            if req is None:
                continue
            inf = self._inflight
            if inf is not None:
                reqs, chunk_final = inf[2], inf[3]
                if reqs[s] is req:
                    reqs[s] = None      # suspect lane: never collect it
                if chunk_final is not None and chunk_final[0] is req:
                    self._inflight = inf[:3] + (None,) + inf[4:]
            keep = max(req.verified, req.folded)
            del req.generated[keep:]
            del req.token_times[max(0, keep - 1):]
            _fold_replay_prefix(req)
            self.slot_req[s] = None
            self.slot_pos[s] = 0
            if self.paged:
                self.pool.release(s)
            if self.scheduler:
                self._park(s)
            if self._prefilling is not None \
                    and self._prefilling["slot"] == s:
                self._prefilling = None
            replayed.append(req)
        if replayed:
            self.stats.streams_replayed += len(replayed)
            if self.scheduler:
                self.sched.requeue_front(replayed)
            else:
                for r in reversed(replayed):
                    self.queue.appendleft(r)
        return replayed

    def _evacuate(self, *, tick: int, reason: str, bad: set):
        """Live evacuation, in place: collect the in-flight tokens, record
        each live request's block chain (paged) and fold its generated
        tokens into its prompt, rebuild the data path on the same device
        (``Runtime.reshape()``; the port takes no mesh, so the implicated
        devices ``bad`` name no survivor to move to) and requeue the live
        requests at the head, so prefill replays each prefix."""
        if self.stats.evacuations >= self.max_evacuations:
            raise RuntimeError(
                f"giving up after {self.stats.evacuations} evacuations "
                f"(latest trigger: {reason})")
        t0 = time.perf_counter()
        if self._inflight is not None:
            self._collect(self._inflight)
            self._inflight = None
        live, chains = [], {}
        mid_prefill = (self._prefilling["req"].rid
                       if self._prefilling is not None else None)
        for s in range(self.num_slots):
            r = self.slot_req[s]
            if r is None:
                continue
            if self.paged:
                chains[r.rid] = self.pool.chain(s)
            # a mid-prefill request has no unfolded generated tail, so
            # folding is a no-op and re-admission replays the prompt once
            _fold_replay_prefix(r)
            live.append(r)
        self._prefilling = None
        self._chunk = None
        self.rt = self.rt.reshape()
        self._build_data_path()
        if self.scheduler:
            self.sched.requeue_front(live)
        else:
            for r in reversed(live):
                self.queue.appendleft(r)
        # the rebuilt engine's tick times are a new distribution
        self.straggler.reset()
        self.stats.evacuations += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur = time.perf_counter() - t0
        self._h_evac.observe(dur)
        self._log_event(
            "evacuate", tick=tick, reason=reason, requeued=len(live),
            replayed=[r.rid for r in live], mid_prefill=mid_prefill,
            kv_chains=chains or None, mesh=None, latency_s=round(dur, 4))

    # -- warm restart ---------------------------------------------------------

    def snapshot(self) -> EngineSnapshot:
        """Warm-restart snapshot: every in-flight (slot order) and queued
        request in replay-ready form.  Collects the in-flight tokens first,
        so taking one advances the engine by the tokens it had computed;
        device caches are not captured (restore replays prompts through
        prefill, as evacuation does)."""
        if self._inflight is not None:
            self._collect(self._inflight)
            self._inflight = None
        live = [r for r in self.slot_req if r is not None]
        waiting = self.sched.waiting() if self.scheduler else list(self.queue)
        reqs = []
        for r in list(live) + waiting:
            _fold_replay_prefix(r)
            reqs.append({"rid": int(r.rid),
                         "prompt": [int(x) for x in np.asarray(r.prompt)],
                         "generated": [int(x) for x in r.generated],
                         "max_new_tokens": int(r.max_new_tokens),
                         "eos_id": int(r.eos_id),
                         "priority": int(r.priority)})
        return EngineSnapshot(
            requests=reqs,
            stats={k: getattr(self.stats, k)
                   for k in ("ticks", "tokens_out", "admitted", "finished",
                             "prefill_calls", "evacuations", "tick_retries",
                             "health_checks")},
            meta={"arch": self.cfg.name, "kv_layout": self.kv_layout,
                  "kv_dtype": self.kv_dtype,
                  "capacity": self.capacity, "num_slots": self.num_slots,
                  "scheduler": bool(self.scheduler),
                  "tick": self._tick_no})

    def load_snapshot(self, snap: EngineSnapshot) -> int:
        """Warm restart: requeue a snapshot's requests into this idle
        engine; each replays through prefill admission and continues its
        stream (``folded`` marks the whole ``generated`` prefix as already
        in the prompt).  Returns the request count."""
        if any(r is not None for r in self.slot_req) or self._backlog():
            raise RuntimeError(
                "load_snapshot needs an idle engine (no live slots, empty "
                "queue) — restore into a freshly built engine")
        if snap.meta.get("arch") not in (None, self.cfg.name):
            raise ValueError(
                f"snapshot was taken on arch {snap.meta.get('arch')!r} but "
                f"this engine serves {self.cfg.name!r}")
        for d in snap.requests:
            gen = list(d.get("generated", []))
            self.submit(Request(
                rid=int(d["rid"]),
                prompt=np.asarray(d["prompt"], np.int32),
                max_new_tokens=int(d["max_new_tokens"]),
                eos_id=int(d.get("eos_id", -1)),
                priority=int(d.get("priority", 0)),
                generated=gen, folded=len(gen)))
        return len(snap.requests)

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
            out.update(latency_fields(name, xs))
        return out

    def kv_cache_bytes(self) -> int:
        """Bytes of decode-state storage as allocated: the dense per-slot
        K/V slabs or the paged pool (int8 scale pools included), and the
        Mamba and xLSTM layers' recurrent states; the attention positions
        are not counted.  (The reference counts K/V only, so for an xLSTM
        stack its figure is 0.)"""
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
