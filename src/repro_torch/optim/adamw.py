"""AdamW with decoupled weight decay, bias-corrected (port of
``repro.optim.adamw`` for one device).

The moments are f32 trees shaped like the params.  When the params are
low-precision (bf16 compute weights), the state also carries an f32 master
copy, and the params are casts of it.  The update runs in the reference's
order of operations — global-norm clip, then moments with the bias
correction of ``count + 1``, then the decoupled decay applied to the f32
weights ``pf``, then the cast back to the param dtype — and the reference's
dtypes (a bf16 gradient's ``(1 − b1)·g`` is rounded to bf16 before it
meets the f32 moment, as JAX's weak types do).  Where the reference
returns new trees, ``adamw_update`` writes params, moments and master in
place and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map


class OptState(NamedTuple):
    mu: Any            # first moment (f32, param-shaped)
    nu: Any            # second moment (f32, param-shaped)
    count: int         # steps taken
    master: Any = ()   # f32 master copy when params are low-precision


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0       # global-norm clip; 0 disables


def adamw_init(params) -> OptState:
    """Zero f32 moments, step 0, and an f32 master copy when any param
    leaf is not f32."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    low_precision = any(p.dtype != torch.float32 for p in tree_leaves(params))
    master = tree_map(lambda p: p.float().clone(), params) \
        if low_precision else ()
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=0, master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``tree_leaves`` order) of each
    leaf's f32 sum of squares."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale grads to a max global norm; the norm is f32, the scaled grads
    keep their dtype.  Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr: float, *,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step.  Returns (params, new_state, {"grad_norm"}); params,
    moments and master are updated in place."""
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        grads = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(grads)
    count = state.count + 1
    c1 = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(count))
    mixed = state.master != ()
    flat_p = tree_leaves(params)
    flat_f = tree_leaves(state.master) if mixed else flat_p
    for p, g, m, v, pf in zip(flat_p, tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu),
                              flat_f):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        pf.sub_(lr * (upd + cfg.weight_decay * pf))
        if mixed:
            p.copy_(pf)
    return params, state._replace(count=count), {"grad_norm": gnorm}
