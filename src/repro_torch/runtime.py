"""One ``repro_torch.runtime`` surface: config -> params -> steps -> engine
(port of ``repro.runtime.Runtime`` for one device, without a ``Plan``).

    rt = Runtime.create("exanode-100m", capacity=2048)    # on the GPU
    logits, caches = rt.prefill(tokens)
    logits = rt.decode_step(token, caches, pos)           # caches in place
    engine = rt.engine(num_slots=16)
    rt = Runtime.create("exanode-100m", capacity=2048, kv_layout="paged",
                        kv_dtype="int8")                  # int8 block pool
    engine = rt.engine(num_slots=16, block_size=16)
    rt = Runtime.create("exanode-100m", shape_kind="train", seq_len=512)
    state = rt.init_train_state()
    state, metrics = rt.train_step(state, batch)          # in place
    rt = Runtime.create("xlstm-125m", capacity=2048)      # recurrent stack
    engine = rt.engine(num_slots=16)                      # mLSTM/sLSTM states
    cfg = jamba_v0_1_52b.one_period()
    rt = Runtime.create(cfg, capacity=2048, param_dtype=torch.bfloat16,
                        params=init_params(model_specs(cfg), 0, torch.bfloat16,
                                           "cuda", draw_on_device=True))
    engine = rt.engine(num_slots=16)                      # Mamba + MoE hybrid
    rt = Runtime.create("exanode-100m", capacity=2048, scheduler=True)
    engine = rt.engine(num_slots=16)                      # chunked prefill
    engine = rt.engine(num_slots=16, health_every=4, scrub_every=1,
                       injector=FaultInjector.parse(
                           "tick=6,kind=corrupt,target=kv"))  # ft layer
    rt.telemetry().snapshot()                              # every metric

Entry points run on the card: ``device=None`` means ``"cuda"``, and
without a GPU ``create`` raises rather than carrying on on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import registry
from repro_torch.models.blocks import MAMBA_KINDS, STATE_LEAVES
from repro_torch.models.common import ModelConfig, count_params, init_params
from repro_torch.serve import kvcache
from repro_torch.serve import steps as serve_steps
from repro_torch.train import state as train_state_mod
from repro_torch.train import steps as train_steps

KV_LAYOUTS = ("dense", "paged")
KV_DTYPES = ("f32", "int8")
SHAPE_KINDS = ("train", "prefill", "decode")
GRAD_SYNCS = ("flat", "hierarchical", "hierarchical_int8")
# The reference's plan runs the lm_head + cross-entropy fused over
# 512-token chunks for train shapes longer than that (``make_plan``'s
# ``ce_chunk``).
CE_CHUNK = 512


def check_kv_layout(caps: registry.Capabilities, name: str, kv_layout: str,
                    kv_dtype: str) -> None:
    """The reference's ``ValueError``s for a serve KV layout: unknown
    values, a layout or pool the arch cannot serve, and an int8 pool
    without the paged layout."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"unknown kv_layout {kv_layout!r}; valid choices: "
                         f"{', '.join(KV_LAYOUTS)}")
    if kv_layout == "paged" and not caps.supports_paged_decode:
        raise ValueError(f"arch {name!r} does not support the paged KV "
                         f"layout (caps: {caps.summary})")
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; valid choices: "
                         f"{', '.join(KV_DTYPES)}")
    if kv_dtype == "int8":
        if kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(the dense slab cache has no quantized layout)")
        if not caps.supports_quantized_kv:
            raise ValueError(f"arch {name!r} does not support the quantized "
                             f"KV pool (caps: {caps.summary})")


def resolve_device(device) -> torch.device:
    """``None`` -> the current CUDA device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA GPU by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


# the prefill kernel of each recurrent block kind that has one (sLSTM's
# step loop is plain PyTorch)
PREFILL_KERNELS = {"mlstm": "mlstm_scan (mLSTM prefill)",
                   **{k: "ssm_scan (Mamba prefill)" for k in MAMBA_KINDS}}


def recurrent_kinds(cfg: ModelConfig) -> dict[str, int]:
    """Layers of each recurrent (Mamba, xLSTM) block kind in ``cfg``, e.g.
    ``{"mlstm": 9, "slstm": 3}`` for xlstm-125m; empty for an attention
    stack."""
    out: dict[str, int] = {}
    for g in cfg.groups:
        for k in g.pattern:
            if k in STATE_LEAVES:
                out[k] = out.get(k, 0) + g.repeats
    return out


class Runtime:
    """Everything one served config needs, in one object.  Build with
    :meth:`create`."""

    def __init__(self, *, arch: str, cfg: ModelConfig, device: torch.device,
                 capacity: int, seed: int, params=None,
                 kv_layout: str = "dense", kv_dtype: str = "f32",
                 shape_kind: str = "decode", seq_len: int = 128,
                 param_dtype=torch.float32, scheduler: bool = False,
                 sched_kw=None):
        self.arch = arch
        self.cfg = cfg
        self.caps = registry.capabilities(cfg)
        self.device = device
        self.specs = registry.model_specs(cfg)
        self.capacity = capacity
        self.seed = seed
        self.kv_layout = kv_layout      # serve KV layout: dense | paged
        self.kv_dtype = kv_dtype        # paged pool storage: f32 | int8
        self.scheduler = scheduler      # chunked-prefill serve scheduler
        self.sched_kw = dict(sched_kw or {})  # token_budget/chunk_size/...
        self.shape_kind = shape_kind    # train | prefill | decode
        self.seq_len = seq_len
        self.param_dtype = param_dtype
        self.ce_chunk = (CE_CHUNK if shape_kind == "train"
                         and seq_len > CE_CHUNK else 0)
        self._params = params
        self._train_step = None
        self._telemetry = None     # lazy obs.Telemetry (telemetry())

    @classmethod
    def create(cls, arch: Union[str, ModelConfig], *,
               shape_kind: str = "decode", smoke: bool = False,
               seq_len: Optional[int] = None,
               capacity: Optional[int] = None, seed: int = 0, params=None,
               device=None, kv_layout: str = "dense",
               kv_dtype: str = "f32", param_dtype=torch.float32,
               grad_sync: str = "hierarchical", scheduler: bool = False,
               sched_kw: Optional[dict] = None) -> "Runtime":
        """Build the chain for one config.

        ``arch`` is a registry name (``smoke`` selects the reduced config)
        or a ready ``ModelConfig``.  ``shape_kind`` ("train", "prefill" or
        "decode") and ``seq_len`` size the activation decisions: a train
        shape longer than 512 tokens fuses the lm_head and cross-entropy
        over 512-token chunks, as the reference's plan does.
        ``capacity`` is the decode-cache length of the prefill/decode
        steps and the engine; the two default to each other, else 128.
        ``param_dtype`` is the params' storage type (bf16 selects mixed
        precision in training: an f32 master copy in the optimizer state).
        A train shape of a stack with attention needs
        ``caps.supports_flash_train`` (the flash backward kernel's head
        dims).  ``grad_sync`` takes the
        reference's strategies: on one device ``flat`` and ``hierarchical``
        are the same step (the reference degrades to ``flat`` without a
        mesh), and ``hierarchical_int8``, which needs a pod axis and its
        error-feedback residual, raises.  ``kv_layout`` picks
        the engine's KV layout ("dense" per-slot slabs or "paged" pooled
        blocks) and ``kv_dtype`` the paged pool's storage ("f32" is the
        working dtype, "int8" quantized blocks with per-(block, kv head)
        scales, paged only); bad values raise ``ValueError`` here.  A
        config outside the port (any family but the dense decoder-only
        ``attn`` stack, the xLSTM stack and the Jamba hybrid) raises
        ``NotImplementedError`` naming the ROADMAP item that will bring
        it.  A config with
        recurrent blocks (xlstm-125m; jamba-v0.1-52b, whose Mamba states
        sit beside one attention layer's K/V) serves over the dense
        layout only (its states are O(1) per stream: the paged layout and
        the int8 pool raise the reference's ``ValueError``).  xlstm-125m
        trains (the mLSTM backward kernel, autograd over the sLSTM cell
        under chunked remat); a train shape for a Mamba or MoE config
        raises ``NotImplementedError`` (``registry.check_trainable``):
        their training is not ported.  ``scheduler`` turns
        on the engine's token-budget chunked-prefill scheduler
        (``serve.scheduler``; it needs ``caps.supports_chunked_prefill``,
        a pure self-attention stack without a sliding window, and raises
        the reference's ``ValueError`` here otherwise) and ``sched_kw``
        carries its knobs (``token_budget``, ``chunk_size``,
        ``class_weights``, ``aging_ticks``)."""
        if isinstance(arch, ModelConfig):
            if smoke:
                raise ValueError("smoke=True only applies when arch is a "
                                 "registry name")
            cfg, name = arch, arch.name
        else:
            name = arch
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
        registry.check_supported(cfg)
        caps = registry.capabilities(cfg)
        check_kv_layout(caps, cfg.name, kv_layout, kv_dtype)
        if scheduler and not caps.supports_chunked_prefill:
            raise ValueError(
                f"arch {cfg.name!r} does not support chunked prefill "
                f"(caps: {caps.summary}); the serve scheduler needs a pure "
                f"self-attention, non-SWA stack — use scheduler=False")
        if shape_kind not in SHAPE_KINDS:
            raise ValueError(f"unknown shape_kind {shape_kind!r}; valid "
                             f"choices: {', '.join(SHAPE_KINDS)}")
        if grad_sync not in GRAD_SYNCS:
            raise ValueError(f"unknown grad_sync {grad_sync!r}; valid "
                             f"choices: {', '.join(GRAD_SYNCS)}")
        if grad_sync == "hierarchical_int8":
            raise ValueError("grad_sync='hierarchical_int8' needs a pod axis "
                             "and its error-feedback residual; the port runs "
                             "on one device (ROADMAP queue 1, item 9)")
        if shape_kind == "train":
            registry.check_trainable(cfg)
        if shape_kind == "train" and registry.needs_flash_train(cfg) \
                and not caps.supports_flash_train:
            raise ValueError(f"arch {cfg.name!r} cannot train through the "
                             f"flash kernels (caps: {caps.summary})")
        capacity = capacity if capacity is not None else (seq_len or 128)
        seq_len = seq_len if seq_len is not None else capacity
        return cls(arch=name, cfg=cfg, device=resolve_device(device),
                   capacity=capacity, seed=seed, params=params,
                   kv_layout=kv_layout, kv_dtype=kv_dtype,
                   shape_kind=shape_kind, seq_len=seq_len,
                   param_dtype=param_dtype, scheduler=scheduler,
                   sched_kw=sched_kw)

    def reshape(self, *, shape_kind: Optional[str] = None,
                mesh=None, seq_len: Optional[int] = None,
                capacity: Optional[int] = None,
                kv_layout: Optional[str] = None,
                kv_dtype: Optional[str] = None,
                scheduler: Optional[bool] = None,
                sched_kw: Optional[dict] = None) -> "Runtime":
        """A new Runtime over the same config, device and params with other
        shape or serving knobs (e.g. train -> decode); ``sched_kw``
        entries merge over the current ones.  The telemetry carries over,
        so counters stay monotonic and the tick timeline continuous across
        an evacuation's rebuild.  The port runs on one device: a ``mesh``
        raises ``NotImplementedError`` (ROADMAP queue 1, item 9)."""
        if mesh is not None:
            raise NotImplementedError(
                "reshape(mesh=...) needs sharding, which the port does not "
                "have yet (ROADMAP queue 1, item 9); it runs on one device")
        new = Runtime.create(
            self.cfg,
            shape_kind=(shape_kind if shape_kind is not None
                        else self.shape_kind),
            seq_len=seq_len if seq_len is not None else self.seq_len,
            capacity=capacity if capacity is not None else self.capacity,
            seed=self.seed, params=self._params, device=self.device,
            kv_layout=kv_layout if kv_layout is not None else self.kv_layout,
            kv_dtype=kv_dtype if kv_dtype is not None else self.kv_dtype,
            param_dtype=self.param_dtype,
            scheduler=scheduler if scheduler is not None else self.scheduler,
            sched_kw={**self.sched_kw, **(sched_kw or {})})
        new.arch = self.arch
        new._telemetry = self._telemetry
        return new

    # -- observability -------------------------------------------------------

    def telemetry(self):
        """This Runtime's ``obs.Telemetry`` (lazy): the metrics registry and
        tracer every subsystem built on it reports into, carried over by
        :meth:`reshape`."""
        if self._telemetry is None:
            from repro_torch.obs import Telemetry
            self._telemetry = Telemetry()
        return self._telemetry

    # -- params -------------------------------------------------------------

    @property
    def params(self):
        """Materialized params (lazy; drawn from a ``torch.Generator``
        seeded with ``seed``).  Assignable, e.g. to weights carried over
        from the reference by ``repro_torch.bridge``."""
        if self._params is None:
            self._params = init_params(self.specs, self.seed,
                                       self.param_dtype, self.device)
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    @property
    def params_fingerprint(self) -> int:
        """mod-2^32 checksum of the params (``ft.integrity``), the one the
        serve engine registers at build and re-verifies; recomputed on
        every read.  Equal to the reference's on the same values."""
        from repro_torch.ft import integrity as ft_integrity
        return int(ft_integrity.tree_fingerprint(self.params))

    @property
    def num_params(self) -> int:
        return count_params(self.specs)

    # -- training -----------------------------------------------------------

    def init_train_state(self, seed: Optional[int] = None):
        """A fresh ``TrainState`` on this Runtime's device: params drawn
        from ``seed`` (default: the Runtime's) in ``param_dtype``, and
        zero AdamW moments."""
        return train_state_mod.init_train_state(
            self.specs, self.seed if seed is None else seed,
            self.param_dtype, self.device)

    def make_train_step(self, *, schedule=None, opt_cfg=None,
                        microbatches: int = 1):
        """step(state, batch) -> (state, metrics); the schedule defaults
        to a constant 3e-4 and the optimizer to ``AdamWConfig()``."""
        return train_steps.make_train_step(
            self.cfg, schedule=schedule, opt_cfg=opt_cfg,
            microbatches=microbatches, ce_chunk=self.ce_chunk)

    def compile_train_step(self, *, schedule=None, opt_cfg=None,
                           microbatches: int = 1):
        """The reference jits and donates its step here; the port runs
        eagerly and updates the state in place, so this is
        :meth:`make_train_step`."""
        return self.make_train_step(schedule=schedule, opt_cfg=opt_cfg,
                                    microbatches=microbatches)

    @property
    def train_step(self):
        """The default train step (constant 3e-4 schedule)."""
        if self._train_step is None:
            self._train_step = self.compile_train_step()
        return self._train_step

    def loss(self, batch: dict, *, params=None):
        """(loss, metrics) of ``batch`` at ``params`` (default: the
        Runtime's)."""
        return registry.model_loss(self.params if params is None else params,
                                   batch, self.cfg, ce_chunk=self.ce_chunk)

    # -- steps --------------------------------------------------------------

    def make_prefill_step(self):
        return serve_steps.make_prefill_step(self.cfg, capacity=self.capacity)

    def make_decode_step(self, *, advance_pos: bool = False):
        return serve_steps.make_decode_step(self.cfg, advance_pos=advance_pos)

    def make_paged_decode_step(self):
        return serve_steps.make_paged_decode_step(self.cfg)

    def make_mixed_step(self):
        """The scheduler's mixed step (a decode tick plus one prompt
        chunk) over the dense layout: ``serve.steps.make_mixed_step``."""
        return serve_steps.make_mixed_step(self.cfg)

    def make_paged_mixed_step(self):
        """The scheduler's mixed step over the paged pool (f32 or int8):
        ``serve.steps.make_paged_mixed_step``."""
        return serve_steps.make_paged_mixed_step(self.cfg)

    def prefill(self, tokens: torch.Tensor, *, last_only: bool = False):
        """tokens [B,S] -> (logits, caches padded to ``capacity``)."""
        return registry.model_prefill(self.params, tokens, self.cfg,
                                      self.capacity, last_only=last_only)

    def decode_step(self, token: torch.Tensor, caches: list,
                    pos: torch.Tensor) -> torch.Tensor:
        """token [B,1], pos [B] -> logits [B,1,Vp]; ``caches`` take the
        token's K/V in place."""
        return registry.model_decode_step(self.params, token, caches,
                                          self.cfg, pos=pos)

    # -- serving ------------------------------------------------------------

    def engine(self, *, num_slots: int = 4, kv_layout=None, kv_dtype=None,
               **engine_kw):
        """A continuous-batching ``ServeEngine`` over this Runtime.
        ``kv_layout`` / ``kv_dtype`` default to the Runtime's own;
        ``engine_kw`` forwards the paged pool's sizing (``block_size``,
        ``num_blocks``, ``max_blocks_per_seq``), the scheduler and its
        knobs (defaulting to the Runtime's ``scheduler`` / ``sched_kw``)
        and the fault-tolerance knobs (``health_every``, ``injector``,
        ``tick_retries``, ``retry_backoff_s``, ``straggler_kw``,
        ``max_evacuations``, ``scrub_every``, ``trace``)."""
        from repro_torch.serve.engine import ServeEngine
        return ServeEngine(
            self, num_slots=num_slots,
            kv_layout=kv_layout if kv_layout is not None else self.kv_layout,
            kv_dtype=kv_dtype if kv_dtype is not None else self.kv_dtype,
            **engine_kw)

    def kv_bytes_per_stream(self, kv_dtype=None, *,
                            block_size: int = 16) -> int:
        """Per-stream KV bytes at ``capacity``: attention layers x 2 (K+V) x
        capacity x KV x Dh x itemsize, plus, for ``kv_dtype="int8"``, the
        two f32 per-(block, kv head) scale rows of the ceil(capacity /
        block_size) blocks.  Exact for the dense slab; for paged pools the
        per-entry cost (block rounding and prefix sharing move the
        realized number: ``ServeEngine.kv_cache_bytes``)."""
        kv_dtype = kv_dtype if kv_dtype is not None else self.kv_dtype
        cfg = self.cfg
        layers = sum(g.repeats * sum(1 for k in g.pattern if k == "attn")
                     for g in cfg.groups)
        itemsize = 1 if kv_dtype == "int8" else cfg.dtype.itemsize
        total = (layers * self.capacity * 2 * cfg.num_kv_heads
                 * cfg.head_dim * itemsize)
        if kv_dtype == "int8":
            blocks = -(-self.capacity // block_size)
            total += layers * blocks * 2 * cfg.num_kv_heads * 4
        return total

    def describe(self) -> str:
        where = (torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda"
                 else "cpu (plain PyTorch versions of the kernels)")
        impl = "Hopper CUDA" if self.device.type == "cuda" else "plain"
        rec = recurrent_kinds(self.cfg)
        lines = [f"runtime[{self.cfg.name}] params={self.num_params:,} "
                 f"device={self.device} ({where})",
                 f"  caps      : {self.caps.summary}"]
        if rec:
            lines.append(
                f"  family    : {self.cfg.family} (recurrent: " + ", ".join(
                    f"{k} x{n}" for k, n in rec.items())
                + f"; state bytes/stream="
                  f"{kvcache.state_bytes_per_stream(self.cfg):,})")
            kernels = list(dict.fromkeys(PREFILL_KERNELS[k] for k in rec
                                         if k in PREFILL_KERNELS))
            if "attn" in {k for g in self.cfg.groups for k in g.pattern}:
                kernels.append("flash_attention fused_ffn decode_attention")
            lines.append(
                f"  kernels   : {' '.join(kernels)} (the recurrent decode "
                f"steps and the rest in plain PyTorch) ({impl})")
        else:
            decode = {("dense", "f32"): "decode_attention",
                      ("paged", "f32"): "paged_decode_attention",
                      ("paged", "int8"): "paged_decode_attention_q8 "
                                         "quantized_block_write "
                                         "quantize_int8"}[
                          (self.kv_layout, self.kv_dtype)]
            if self.scheduler and self.kv_dtype == "int8":
                decode += " dequantize_int8"
            ffn = " fused_ffn" if self.caps.supports_fused_ffn else ""
            lines.append(
                f"  kernels   : flash_attention{ffn} {decode} ({impl})")
        if "attn" in {k for g in self.cfg.groups for k in g.pattern}:
            lines.append(f"  routes    : {self.routes()}")
        try:
            registry.check_trainable(self.cfg)
            kernels = ("mlstm_scan + mlstm_scan_bwd (torch.autograd."
                       f"Function; {impl}), the sLSTM cell by autograd "
                       "under chunked remat" if "mlstm" in rec else
                       "flash_attention + flash_attention_bwd_dq/_dkv"
                       + (", fused_ffn + fused_ffn_bwd_dx/_dw"
                          if self.caps.supports_fused_ffn else "")
                       + f" (torch.autograd.Function; {impl})")
            lines.append(
                f"  train     : seq_len={self.seq_len} "
                f"ce_chunk={self.ce_chunk} remat={self.cfg.remat_policy} "
                f"param_dtype={self.param_dtype} kernels: {kernels}")
        except NotImplementedError as e:
            lines.append(f"  train     : not ported: {e}")
        sched = ("scheduler[" + ", ".join(
            f"{k}={v}" for k, v in sorted(self.sched_kw.items()))
            + ("]" if self.sched_kw else "defaults]")
            if self.scheduler else "scheduler=off")
        lines.append(f"  serve     : capacity={self.capacity} "
                     f"kv_layout={self.kv_layout} kv_dtype={self.kv_dtype} "
                     f"kv_bytes/stream={self.kv_bytes_per_stream():,} "
                     f"dtype={self.cfg.dtype} {sched} chunked_prefill_ok="
                     f"{self.caps.supports_chunked_prefill}")
        lines.append(self._ft_status())
        lines.append("  obs       : " + (
            self._telemetry.describe() if self._telemetry is not None
            else "not wired (Runtime.telemetry())"))
        return "\n".join(lines)

    def _ft_status(self) -> str:
        """Fault-tolerance posture on one device: losing it leaves no
        survivor, so an evacuation rebuilds in place; and any armed
        ``REPRO_TORCH_FAULT_PLAN``."""
        import os
        plan = os.environ.get("REPRO_TORCH_FAULT_PLAN", "").strip() or "none"
        return (f"  ft        : devices=1 tp=1 evac(lose-1)->in-place "
                f"rebuild (one device; mesh shrink: ROADMAP queue 1, item "
                f"9) fault_plan={plan}\n"
                f"  burn-in   : not ported (ROADMAP queue 1, item 12)")

    def routes(self) -> str:
        """Which kernel computes each attention-stack op in the working
        dtype on the card: the FFN through #2 (SwiGLU) or in plain
        PyTorch (GeGLU, as the reference keeps it on jnp), the flash
        forward's and backward's routes (``"tc"``: tensor cores, or
        ``"simt"``) at the config's head dim, and the q-head groups of
        the split-KV decode (``decode_attention.head_groups``)."""
        cfg, dt = self.cfg, self.cfg.dtype
        D, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
        ffn = ("fused_ffn (#2, SwiGLU)" if cfg.mlp_act == "silu" else
               f"plain {cfg.mlp_act} gating (GeGLU: three torch.matmul, as "
               f"the reference keeps it on jnp)")
        bwd = (flash_kernel.route_bwd(dt, D)
               if D in flash_kernel.BWD_HEAD_DIMS else "none")
        groups = decode_kernel.head_groups(G)
        return (f"ffn={ffn}; flash forward={flash_kernel.route(dt, D)} "
                f"backward={bwd} ({str(dt).split('.')[1]}, head dim {D}); "
                f"decode G={G} in {groups} head group"
                f"{'s' if groups > 1 else ''} of {G // groups}")

    def __repr__(self) -> str:
        return f"Runtime({self.cfg.name!r}, device={self.device})"
