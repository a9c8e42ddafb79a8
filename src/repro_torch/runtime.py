"""One ``repro_torch.runtime`` surface: config -> params -> steps -> engine
(port of ``repro.runtime.Runtime`` for one device, without a ``Plan``).

    rt = Runtime.create("exanode-100m", capacity=2048)    # on the GPU
    logits, caches = rt.prefill(tokens)
    logits = rt.decode_step(token, caches, pos)           # caches in place
    engine = rt.engine(num_slots=16)

Entry points run on the card: ``device=None`` means ``"cuda"``, and
without a GPU ``create`` raises rather than carrying on on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry
from repro_torch.models.common import ModelConfig, count_params, init_params
from repro_torch.serve import steps as serve_steps


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


class Runtime:
    """Everything one served config needs, in one object.  Build with
    :meth:`create`."""

    def __init__(self, *, arch: str, cfg: ModelConfig, device: torch.device,
                 capacity: int, seed: int, params=None):
        self.arch = arch
        self.cfg = cfg
        self.caps = registry.capabilities(cfg)
        self.device = device
        self.specs = registry.model_specs(cfg)
        self.capacity = capacity
        self.seed = seed
        self._params = params

    @classmethod
    def create(cls, arch: Union[str, ModelConfig], *, smoke: bool = False,
               capacity: int = 128, seed: int = 0, params=None,
               device=None) -> "Runtime":
        """Build the chain for one config.

        ``arch`` is a registry name (``smoke`` selects the reduced config)
        or a ready ``ModelConfig``.  ``capacity`` is the decode-cache length
        of the prefill/decode steps and the engine.  A config outside this
        slice (any family but the dense decoder-only ``attn`` stack)
        raises ``NotImplementedError`` naming the ROADMAP item that will
        bring it."""
        if isinstance(arch, ModelConfig):
            if smoke:
                raise ValueError("smoke=True only applies when arch is a "
                                 "registry name")
            cfg, name = arch, arch.name
        else:
            name = arch
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
        registry.check_supported(cfg)
        return cls(arch=name, cfg=cfg, device=resolve_device(device),
                   capacity=capacity, seed=seed, params=params)

    # -- params -------------------------------------------------------------

    @property
    def params(self):
        """Materialized params (lazy; drawn from a ``torch.Generator``
        seeded with ``seed``).  Assignable, e.g. to weights carried over
        from the reference by ``repro_torch.bridge``."""
        if self._params is None:
            self._params = init_params(self.specs, self.seed,
                                       self.cfg.param_dtype, self.device)
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    @property
    def num_params(self) -> int:
        return count_params(self.specs)

    # -- steps --------------------------------------------------------------

    def make_prefill_step(self):
        return serve_steps.make_prefill_step(self.cfg, capacity=self.capacity)

    def make_decode_step(self, *, advance_pos: bool = False):
        return serve_steps.make_decode_step(self.cfg, advance_pos=advance_pos)

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

    def engine(self, *, num_slots: int = 4, **engine_kw):
        """A continuous-batching ``ServeEngine`` over this Runtime;
        ``engine_kw`` forwards the knobs of later slices (which raise)."""
        from repro_torch.serve.engine import ServeEngine
        return ServeEngine(self, num_slots=num_slots, **engine_kw)

    def describe(self) -> str:
        where = (torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda"
                 else "cpu (plain PyTorch versions of the kernels)")
        return "\n".join([
            f"runtime[{self.cfg.name}] params={self.num_params:,} "
            f"device={self.device} ({where})",
            f"  caps      : {self.caps.summary}",
            f"  kernels   : flash_attention fused_ffn decode_attention "
            f"({'Hopper CUDA' if self.device.type == 'cuda' else 'plain'})",
            f"  serve     : capacity={self.capacity} kv_layout=dense "
            f"dtype={self.cfg.dtype} scheduler=off",
        ])

    def __repr__(self) -> str:
        return f"Runtime({self.cfg.name!r}, device={self.device})"
