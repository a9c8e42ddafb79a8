"""Primitive layers: RMSNorm, rotary embeddings, the embedding table's
spec and lm_head (port of ``repro.models.layers``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, PSpec

NEG_INF = -1e30


def rmsnorm_spec(dim: int) -> PSpec:
    return PSpec((dim,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalizes in f32 with an f32 scale, returns the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, Dh]; positions broadcastable to [..., S].

    Rotates the two *halves* of the head dim, ``[x1·cos − x2·sin,
    x2·cos + x1·sin]`` with ``x1, x2 = split(x, 2)`` — what the reference
    code computes (its docstring's "pairs (x[2i], x[2i+1])" does not
    describe its code)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq      # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embedding_spec(cfg: ModelConfig) -> PSpec:
    return PSpec((cfg.padded_vocab, cfg.d_model), init=f"scaled:{cfg.d_model}")


def lm_head(x: torch.Tensor, table: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x [B,S,D] · table [Vp,D]ᵀ -> logits [B,S,Vp]; pad-vocab logits are
    set to -1e30."""
    logits = x @ table.to(x.dtype).t()
    if table.shape[0] != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits
