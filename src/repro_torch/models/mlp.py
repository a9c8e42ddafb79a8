"""Dense gated MLP (port of ``repro.models.mlp``): SwiGLU through the
fused FFN kernel; GeGLU (and any other gate) in plain PyTorch, as the
reference keeps it on jnp (its fused kernel is SwiGLU-only)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, PSpec
from repro_torch.models.layers import act_fn


def mlp_specs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": PSpec((D, F), init=f"scaled:{D}"),
        "wi_up": PSpec((D, F), init=f"scaled:{D}"),
        "wo": PSpec((F, D), init=f"scaled:{F}"),
    }


def mlp(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """x [B,S,D] -> [B,S,D]: ``(act(x·Wg) ⊙ x·Wu)·Wd``, weights cast to
    x's dtype as the reference does before each product (a no-op for the
    serve engine's weights, which are cast once at build).  ``silu`` runs
    the fused SwiGLU kernel; another ``cfg.mlp_act`` (gemma-2b's and
    granite-20b's GeGLU) runs the reference's three plain products, whose
    gradient is autograd's, as the reference differentiates its jnp."""
    B, S, D = x.shape
    wg, wu, wd = (params[k].to(x.dtype) for k in ("wi_gate", "wi_up", "wo"))
    if cfg.mlp_act != "silu":
        return (act_fn(cfg.mlp_act)(x @ wg) * (x @ wu)) @ wd
    y = ops.swiglu_ffn(x.reshape(B * S, D).contiguous(), wg, wu, wd)
    return y.view(B, S, D)
