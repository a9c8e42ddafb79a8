"""Train-step factory: loss -> grads -> AdamW update (port of
``repro.train.steps`` for one device).

The reference's gradient-sync strategies differ only in how gradients
cross the mesh.  This is the one-device step, which is what the
reference's ``flat`` and ``hierarchical`` compute without a mesh; the
choice of strategy (``Runtime.create(grad_sync=...)``) comes back here
with sharding (ROADMAP queue 1, item 9).

Gradients come from ``torch.autograd`` over ``models.registry.model_loss``,
which reaches the flash-attention and fused-SwiGLU kernels through their
``torch.autograd.Function``s (``kernels.ops``), as the reference's
``jax.value_and_grad`` reaches its Pallas kernels through their
``custom_vjp``s.  ``microbatches > 1`` splits the batch into k row blocks
and accumulates f32 grads / k and loss / k, as the reference's scan does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.common import (ModelConfig, tree_leaves,
                                       tree_unflatten)
from repro_torch.models.registry import model_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedules import make_schedule
from repro_torch.train.state import TrainState

def value_and_grad(params, batch: dict, cfg: ModelConfig, *,
                   ce_chunk: int = 0):
    """(loss, metrics, grads) of ``model_loss`` at ``params``; the grads
    have the params' dtypes and tree.  ``params`` are not modified: the
    loss is taken over detached copies that require grad."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model_loss(tree_unflatten(params, leaves), batch,
                                   cfg, ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _grads_and_loss(params, batch: dict, cfg: ModelConfig,
                    microbatches: int, *, ce_chunk: int = 0):
    """(grads, loss, metrics).  With ``microbatches = k > 1`` the batch's
    rows are split into k consecutive blocks; grads are accumulated in f32
    as ``acc + g / k`` and the loss as ``acc + l / k``, and the metrics are
    the blocks' means."""
    if microbatches <= 1:
        loss, metrics, grads = value_and_grad(params, batch, cfg,
                                              ce_chunk=ce_chunk)
        return grads, loss, metrics
    k = microbatches
    rows = batch["tokens"].shape[0]
    if rows % k:
        raise ValueError(f"batch of {rows} rows does not split into {k} "
                         f"microbatches")
    n = rows // k
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    loss, per = None, []
    for i in range(k):
        mb = {name: v[i * n:(i + 1) * n] for name, v in batch.items()}
        l, m, g = value_and_grad(params, mb, cfg, ce_chunk=ce_chunk)
        acc = [a + b.float() / k for a, b in zip(acc, tree_leaves(g))]
        loss = l / k if loss is None else loss + l / k
        per.append(m)
    metrics = {name: torch.stack([m[name] for m in per]).mean()
               for name in per[0]}
    return tree_unflatten(params, acc), loss, metrics


def make_train_step(cfg: ModelConfig, *, schedule=None,
                    opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1, ce_chunk: int = 0) -> Callable:
    """Returns step(state, batch) -> (state, metrics); batch {"tokens",
    "labels"} [B,S] tensors on the params' device.

    ``schedule`` maps the step count to the learning rate (default: a
    constant 3e-4, as the reference's); ``ce_chunk`` as in
    ``models.lm.lm_loss``.  The update writes the state's tensors in place
    (``optim.adamw.adamw_update``) and returns the same tensors in a new
    ``TrainState``."""
    schedule = schedule or make_schedule("constant", peak=3e-4)
    opt_cfg = opt_cfg or AdamWConfig()

    def step(state: TrainState, batch: dict):
        grads, loss, metrics = _grads_and_loss(state.params, batch, cfg,
                                               microbatches,
                                               ce_chunk=ce_chunk)
        lr = schedule(state.opt.count)
        params, opt, m2 = adamw_update(grads, state.opt, state.params, lr,
                                       cfg=opt_cfg)
        metrics = dict(metrics, lr=lr, **m2)
        return TrainState(params, opt, state.residual), metrics

    return step
