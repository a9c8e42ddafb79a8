"""Model configuration and parameter specs (port of ``repro.models.common``).

A model is described by a ``ModelConfig`` whose dtypes are ``torch``
dtypes: ``dtype`` is the activation (working) type, ``param_dtype`` the
storage type of the master parameters.  Parameters are declared once as a
tree of ``PSpec`` (shape + init law); ``init_params`` materializes it from
a ``torch.Generator``.  The reference's logical sharding axes are not
carried: the port runs on one device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (the reference's ``MoEConfig``): experts,
    experts per token, each expert's hidden width, the capacity factor of
    the token-dropping dispatch and the load-balance loss weight.  The
    router jitter is carried for parity; serving does not read it."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba mixer widths (the reference's ``SSMConfig``): state size N,
    causal-conv window, inner expansion, dt rank (0 -> ceil(d_model / 16))
    and the chunk the prefill pads the sequence to."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    chunk: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """mLSTM / sLSTM widths (the reference's ``XLSTMConfig``): the xLSTM
    paper's projection factors, the mLSTM's causal-conv window and its scan
    chunk."""
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_window: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class LayerGroup:
    pattern: tuple[str, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class ModelConfig:
    """Field-for-field mirror of ``repro.models.common.ModelConfig``.

    ``moe``, ``ssm`` and ``xlstm`` are read by attribute only, so the
    reference's own sub-config objects work in their place (the parity
    tests pass them through); ``encoder`` is kept as an opaque value: no
    ported config sets it, and ``models.registry.check_supported`` rejects
    any config that does."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    groups: tuple[LayerGroup, ...] = ()
    rope_theta: float = 10000.0
    use_rope: bool = True
    pos_emb: str = "rope"          # rope | learned
    max_position_embeddings: int = 0
    scale_embeddings: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    attn_mode: str = "auto"
    mlp_act: str = "silu"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[Any] = None
    frontend: Optional[str] = None
    frontend_len: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat_policy: str = "minimal"
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.groups:
            object.__setattr__(self, "groups",
                               (LayerGroup(("attn",), self.num_layers),))
        n = sum(g.num_layers for g in self.groups)
        if n != self.num_layers:
            raise ValueError(
                f"groups cover {n} layers != num_layers {self.num_layers}")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's table
        layout); lm_head masks the pad logits."""
        return -(-self.vocab_size // 256) * 256

    def scaled(self, **overrides) -> "ModelConfig":
        """A copy with overridden fields (smoke configs, f32 parity runs)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class PSpec:
    """Parameter spec: shape + init law (normal | zeros | ones |
    scaled:<fan_in> | arange_log | const:<value>) + optional dtype (None
    -> the param dtype)."""
    shape: tuple[int, ...]
    init: str = "normal"
    dtype: Optional[torch.dtype] = None


def tree_leaves(tree) -> list:
    """Leaves of a dict / list tree in a fixed order (sorted dict keys, the
    order ``jax.tree.flatten`` uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict / list tree, visiting leaves in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(tree, leaves) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _init_leaf(spec: PSpec, gen: torch.Generator, param_dtype: torch.dtype,
               device) -> torch.Tensor:
    dtype = spec.dtype or param_dtype
    kw = dict(dtype=dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, **kw)
    if spec.init == "ones":
        return torch.ones(spec.shape, **kw)
    if spec.init == "arange_log":
        # S4/Mamba A-matrix init: A = -exp(A_log), A_log = log(1..N) per row
        row = torch.arange(1, spec.shape[-1] + 1, dtype=torch.float32,
                           device=device).log()
        return row.expand(spec.shape).to(dtype).contiguous()
    if spec.init.startswith("const:"):
        return torch.full(spec.shape, float(spec.init.split(":")[1]), **kw)
    if spec.init.startswith("scaled:"):
        std = 1.0 / math.sqrt(max(float(spec.init.split(":")[1]), 1.0))
    elif spec.init == "normal":
        std = 0.02
    else:
        raise ValueError(f"unknown init {spec.init}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(specs, seed: int = 0, param_dtype=torch.float32,
                device="cpu", *, draw_on_device: bool = False):
    """Materialize a PSpec tree.  Values are drawn from one
    ``torch.Generator`` seeded with ``seed``, leaf by leaf in
    ``tree_leaves`` order: on the CPU, then moved to ``device``, so the
    same seed gives the same weights on every device.  ``draw_on_device``
    draws each leaf on ``device`` itself from a generator of that device
    instead (other values than the CPU draw for the same seed), which is
    what makes a model of billions of parameters quick to build on the
    card.  (Both differ from the reference's ``jax.random`` draws; parity
    tests carry the reference's weights over through
    ``repro_torch.bridge``.)"""
    where = torch.device(device) if draw_on_device else torch.device("cpu")
    gen = torch.Generator(device=where).manual_seed(seed)
    return tree_map(
        lambda s: _init_leaf(s, gen, param_dtype, where).to(device), specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))
