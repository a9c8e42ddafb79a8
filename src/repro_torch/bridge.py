"""Carry the reference's parameters over to the port.

The port keeps the reference's parameter tree as it is: the same keys,
with each group's layers stacked along a leading axis
(``groups[0]["sub0"]`` holds ``norm1``, ``attn.{wq [L,D,H,Dh], wk, wv,
wo [L,H,Dh,D]}``, ``norm2`` and ``ffn.{wi_gate, wi_up, wo}``; a Mamba
sub-layer ``mixer.{in_proj, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D,
out_proj}``; an MoE FFN ``ffn.{router [L,D,E], wi_gate / wi_up [L,E,D,F],
wo [L,E,F,D]}``).  Each leaf keeps its dtype (the MoE router is f32 in
both packages whatever the param dtype).  So the bridge is a leaf-by-leaf
conversion of numpy arrays, e.g. of
``jax.tree.map(np.asarray, repro.models.common.init_params(specs, key))``,
with shapes checked against the port's own specs when a config is given.
``opt_state_from_reference`` carries an AdamW state across the same way
(moments, step count and, with bf16 params, the f32 master copy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.models.registry import model_specs
from repro_torch.optim.adamw import OptState


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: via f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(device)
    # the reference's arrays are read-only views: copy before from_numpy
    return torch.from_numpy(a.copy()).to(device)


def params_from_reference(tree, cfg: Optional[ModelConfig] = None, *,
                          device="cpu") -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's params
    on ``device``.  With ``cfg``, the tree must match the port's specs
    leaf for leaf, in structure and shape."""
    params = tree_map(lambda a: _to_torch(a, device), tree)
    if cfg is not None:
        specs = model_specs(cfg)
        got = tree_map(lambda t: tuple(t.shape), params)
        want = tree_map(lambda s: tuple(s.shape), specs)
        if got != want:
            raise ValueError(f"reference params do not match the port's "
                             f"specs for {cfg.name!r}: got {got}, want "
                             f"{want}")
    return params


def opt_state_from_reference(opt, cfg: Optional[ModelConfig] = None, *,
                             device="cpu") -> OptState:
    """The reference's ``OptState`` (numpy or jax leaves: mu, nu, count,
    master or ``()``) -> the port's, on ``device``."""
    return OptState(
        mu=params_from_reference(opt.mu, cfg, device=device),
        nu=params_from_reference(opt.nu, cfg, device=device),
        count=int(np.asarray(opt.count)),
        master=(() if opt.master == () else
                params_from_reference(opt.master, cfg, device=device)))
