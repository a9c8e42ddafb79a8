"""Dense SwiGLU MLP through the fused FFN kernel (port of
``repro.models.mlp``; GeGLU is not in this slice and is rejected by
``models.registry.check_supported``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, PSpec


def mlp_specs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": PSpec((D, F), init=f"scaled:{D}"),
        "wi_up": PSpec((D, F), init=f"scaled:{D}"),
        "wo": PSpec((F, D), init=f"scaled:{F}"),
    }


def mlp(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """x [B,S,D] -> [B,S,D]: ``(silu(x·Wg) ⊙ x·Wu)·Wd``, weights cast to
    x's dtype as the reference does before each product (a no-op for the
    serve engine's weights, which are cast once at build)."""
    B, S, D = x.shape
    y = ops.swiglu_ffn(x.reshape(B * S, D).contiguous(),
                       params["wi_gate"].to(x.dtype),
                       params["wi_up"].to(x.dtype), params["wo"].to(x.dtype))
    return y.view(B, S, D)
