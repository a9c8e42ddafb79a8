"""Primitive layers: RMSNorm, rotary embeddings, the embedding table's
spec, lm_head, the cross-entropy losses and the gating activations (port
of ``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed NLL of the labelled tokens (labels -1 = ignore) under f32
    logits [..., V]; the max is detached (the reference's
    ``stop_gradient``)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((lse - ll) * mask).sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy: logits [B,S,V], labels [B,S] int (-1 =
    ignore) -> f32 scalar, the sum divided by max(count, 1).  (The
    reference's logit softcap is not ported: ``registry.check_supported``
    rejects softcapped configs.)"""
    return _nll_sum(logits.float(), labels) / (labels >= 0).sum().clamp(min=1)


def _chunk_nll(xc: torch.Tensor, table: torch.Tensor, lc: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Summed NLL of one sequence chunk from its lm_head logits in f32."""
    return _nll_sum(lm_head(xc, table, cfg).float(), lc)


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, cfg: ModelConfig,
                         chunk: int) -> torch.Tensor:
    """Fused lm_head + cross-entropy over sequence chunks: x [B,S,D],
    labels [B,S] (-1 = ignore) -> mean NLL (f32 scalar).  The [B,S,V]
    logits never materialize: each chunk's body is recomputed in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so the peak is one [B,chunk,V] block."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled() and (x.requires_grad
                                        or table.requires_grad):
            nll = nll + checkpoint(_chunk_nll, xc, table, lc, cfg,
                                   use_reentrant=False)
        else:
            nll = nll + _chunk_nll(xc, table, lc, cfg)
    count = (labels >= 0).sum()
    return nll / count.clamp(min=1)


def act_fn(name: str):
    """The gating activation ``name``: ``silu``, ``gelu`` (the tanh
    approximation, as the reference's ``jax.nn.gelu(x, approximate=True)``)
    or ``relu``."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(name)
