"""Train state: params + optimizer state (port of ``repro.train.state``,
the single-device subset).

``residual`` is kept for the reference's layout and is always ``()``: the
error-feedback residual of the int8 cross-pod sync comes with sharding
(ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import init_params
from repro_torch.optim.adamw import OptState, adamw_init


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residual: Any = ()


def init_train_state(specs, seed: int = 0, param_dtype=torch.float32,
                     device="cpu", *, draw_on_device: bool = False
                     ) -> TrainState:
    """Params drawn from ``seed`` (``models.common.init_params``, on
    ``device`` itself with ``draw_on_device``) and a fresh AdamW state;
    ``param_dtype=torch.bfloat16`` selects mixed precision (bf16 compute
    weights, f32 master copy in the optimizer)."""
    params = init_params(specs, seed, param_dtype, device,
                         draw_on_device=draw_on_device)
    return TrainState(params, adamw_init(params))
