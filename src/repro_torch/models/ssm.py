"""State-space and recurrent mixers: Mamba (the selective SSM), and the
xLSTM blocks' mLSTM and sLSTM, each with its one-token decode step (port
of ``repro.models.ssm``).

Mamba's prefill runs the selective scan through ``kernels.ops.
ssm_chunk_scan`` (the Hopper kernel on the card, the plain
``ref_ssm_scan`` on the CPU), which also returns the final state; its
projections, causal conv and gates are plain PyTorch, as the reference's
are jnp, and so is its decode step.

The mLSTM keeps a matrix memory C [B,H,dh,dh] with a normalizer n and a
stabilizer m.  Its prefill runs the chunkwise-parallel form through
``kernels.ops.mlstm_scan`` (the Hopper kernel on the card, the plain
``ref_mlstm_scan`` on the CPU), which also returns the final state; its
decode step is the sequential cell in plain PyTorch, as the reference's
is jnp; its backward is ``MLSTMScan``'s, written by hand.  The sLSTM is
a sequential recurrence (R·h_{t-1} has no parallel form) in plain
PyTorch, one step per token, differentiated by autograd under chunked
remat, as the reference's jnp cell is under ``jax.checkpoint``.  Matrix
products of the projections are ``torch.matmul``; layouts and the order
of operations follow the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_mlstm_chunk
from repro_torch.models.common import (ModelConfig, PSpec, SSMConfig,
                                       XLSTMConfig)

PAD_GATE = -1e30      # i-gate of a pad step: it weighs e^-1e30 = 0
SLSTM_REMAT_CHUNK = 256   # the reference's _slstm_cell chunk


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds in x's dtype. x [B,S,Di],
    w [K,Di]."""
    K, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for k in range(K):
        shift = K - 1 - k
        xk = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xk * w[k].to(x.dtype)
    return out + b.to(x.dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,E] · w [E,H,dh] -> [B,S,H,dh] in f32 (the product in x's
    dtype, as the reference's einsum then ``astype(f32)``)."""
    E, H, dh = w.shape
    y = x @ w.to(x.dtype).reshape(E, H * dh)
    return y.view(*x.shape[:-1], H, dh).float()


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig, ssm: SSMConfig) -> int:
    return ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_specs(cfg: ModelConfig, ssm: SSMConfig) -> dict:
    D = cfg.d_model
    Di = ssm.expand * D
    N, K, R = ssm.d_state, ssm.d_conv, _dt_rank(cfg, ssm)
    return {
        "in_proj": PSpec((D, 2 * Di), init=f"scaled:{D}"),
        "conv_w": PSpec((K, Di), init=f"scaled:{K}"),
        "conv_b": PSpec((Di,), init="zeros"),
        "x_proj": PSpec((Di, R + 2 * N), init=f"scaled:{Di}"),
        "dt_w": PSpec((R, Di), init=f"scaled:{R}"),
        "dt_b": PSpec((Di,), init="const:-4.0"),
        "A_log": PSpec((Di, N), init="arange_log"),
        "D": PSpec((Di,), init="ones"),
        "out_proj": PSpec((Di, D), init=f"scaled:{Di}"),
    }


def _ssm_gates(xc: torch.Tensor, p: dict, cfg: ModelConfig,
               ssm: SSMConfig):
    """dt [.., Di] f32 (softplus'd) and B_ssm / C_ssm [.., N] in xc's
    dtype from the conv branch (the back half of the reference's
    ``_ssm_inputs``)."""
    R, N = _dt_rank(cfg, ssm), ssm.d_state
    xdb = xc @ p["x_proj"].to(xc.dtype)
    dt_in, B_ssm, C_ssm = xdb.split([R, N, N], dim=-1)
    dt = F.softplus((dt_in @ p["dt_w"].to(xc.dtype)).float()
                    + p["dt_b"].float())
    return dt, B_ssm, C_ssm


def _ssm_inputs(x: torch.Tensor, p: dict, cfg: ModelConfig,
                ssm: SSMConfig):
    """The projections, the causal conv and the gates: x [B,S,D] ->
    (dt [B,S,Di] f32, B_ssm/C_ssm [B,S,N], xc, z, x_in), xz in x's dtype
    (the reference's ``_ssm_inputs``)."""
    xz = x @ p["in_proj"].to(x.dtype)
    x_in, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, B_ssm, C_ssm = _ssm_gates(xc, p, cfg, ssm)
    return dt, B_ssm, C_ssm, xc, z, x_in


def _mamba_out(y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor, p: dict,
               dtype: torch.dtype) -> torch.Tensor:
    """The D skip in f32, the cast to the activation dtype, the z gate
    and the out projection."""
    y = (y + xc.float() * p["D"].float()).to(dtype)
    return (y * F.silu(z)) @ p["out_proj"].to(dtype)


def mamba(x: torch.Tensor, p: dict, cfg: ModelConfig, ssm: SSMConfig,
          h0=None, return_state: bool = False):
    """Mamba mixer over a sequence. x [B,S,D] -> out [B,S,D], and with
    ``return_state`` (out, (h [B,Di,N] f32, conv_buf [B,K-1,Di])): the
    final state and the last K-1 rows of the conv input (x's dtype) for
    the decode step.  ``h0`` starts the scan (default zero).

    As in the reference, S is padded to a multiple of min(chunk, S) with
    pad steps whose dt is 0 (a = 1, b = 0: they leave h as it is), so the
    kernel and the plain path see the reference's inputs."""
    B, S, _ = x.shape
    Q = min(ssm.chunk, S)
    pad = (-S) % Q
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    dt, B_ssm, C_ssm, xc, z, x_in = _ssm_inputs(xp, p, cfg, ssm)
    if pad:
        dt = dt * (torch.arange(S + pad, device=x.device) < S)[None, :, None]
    A = -torch.exp(p["A_log"].float())
    y, h = ops.ssm_chunk_scan(dt.contiguous(), B_ssm.contiguous(),
                              C_ssm.contiguous(), xc.contiguous(),
                              A.contiguous(), h0=h0)
    out = _mamba_out(y[:, :S], xc[:, :S], z[:, :S], p, x.dtype)
    if not return_state:
        return out
    K = ssm.d_conv
    buf = F.pad(x_in[:, :S], (0, 0, max(0, (K - 1) - S), 0))[:, -(K - 1):]
    return out, (h, buf)


def mamba_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 ssm: SSMConfig, h: torch.Tensor, conv_buf: torch.Tensor):
    """One-token Mamba step in plain PyTorch. x [B,1,D]; h [B,Di,N] f32;
    conv_buf [B,K-1,Di] -> (out [B,1,D], h', conv_buf')."""
    dt_ = x.dtype
    xz = x @ p["in_proj"].to(dt_)
    x_in, z = xz.chunk(2, dim=-1)                               # [B,1,Di]
    window = torch.cat([conv_buf.to(dt_), x_in], dim=1)         # [B,K,Di]
    xc = torch.einsum("bke,ke->be", window, p["conv_w"].to(dt_))
    xc = F.silu(xc + p["conv_b"].to(dt_))                       # [B,Di]
    dt, B_ssm, C_ssm = _ssm_gates(xc, p, cfg, ssm)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None] * A)                            # [B,Di,N]
    b = (dt * xc.float())[..., None] * B_ssm.float()[:, None, :]
    h = a * h + b
    y = torch.einsum("bn,ben->be", C_ssm.float(), h)
    out = _mamba_out(y, xc, z[:, 0], p, dt_)
    return out[:, None], h, window[:, 1:]


def mamba_init_state(cfg: ModelConfig, ssm: SSMConfig, batch: int,
                     dtype=torch.float32, device="cpu") -> tuple:
    """Zero state: h [B,Di,N] f32 and the conv buffer [B,K-1,Di] in
    ``dtype``."""
    Di = ssm.expand * cfg.d_model
    return (torch.zeros(batch, Di, ssm.d_state, dtype=torch.float32,
                        device=device),
            torch.zeros(batch, ssm.d_conv - 1, Di, dtype=dtype,
                        device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_widths(cfg: ModelConfig, xl: XLSTMConfig) -> tuple[int, int]:
    Di = int(xl.mlstm_proj_factor * cfg.d_model)
    return Di, Di // cfg.num_heads


def mlstm_specs(cfg: ModelConfig, xl: XLSTMConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    Di, dh = _mlstm_widths(cfg, xl)
    return {
        "up_proj": PSpec((D, 2 * Di), init=f"scaled:{D}"),
        "conv_w": PSpec((xl.conv_window, Di), init=f"scaled:{xl.conv_window}"),
        "conv_b": PSpec((Di,), init="zeros"),
        "wq": PSpec((Di, H, dh), init=f"scaled:{Di}"),
        "wk": PSpec((Di, H, dh), init=f"scaled:{Di}"),
        "wv": PSpec((Di, H, dh), init=f"scaled:{Di}"),
        "w_if": PSpec((Di, 2 * H), init=f"scaled:{Di}"),
        "b_if": PSpec((2 * H,), init="zeros"),
        "out_norm": PSpec((Di,), init="ones"),
        "down_proj": PSpec((Di, D), init=f"scaled:{Di}"),
    }


def _mlstm_gates(xc: torch.Tensor, p: dict):
    """(i_gate, log-sigmoid f) [B,S,H] in f32 from the conv branch."""
    gates = (xc @ p["w_if"].to(xc.dtype)).float() + p["b_if"].float()
    i_gate, f_gate = gates.chunk(2, dim=-1)
    return i_gate, F.logsigmoid(f_gate)


def _mlstm_cell(q, k, v, i_gate, f_log, C0, n0, m0):
    """The sequential mLSTM recurrence (the reference's ``_mlstm_cell``):
    q/k/v [B,S,H,dh] with k not yet scaled, gates [B,S,H] f32 -> (y
    [B,S,H,dh], (C, n, m)); k is scaled by dh^-0.5 inside."""
    return ref_mlstm_chunk(q, k * q.shape[-1] ** -0.5, v, i_gate, f_log,
                           C0, n0, m0)


def _mlstm_out(y: torch.Tensor, z: torch.Tensor, p: dict) -> torch.Tensor:
    """Per-channel out norm, the z gate and the down projection."""
    y = y * p["out_norm"].to(y.dtype)
    y = y * F.silu(z)
    return y @ p["down_proj"].to(y.dtype)


def mlstm(x: torch.Tensor, p: dict, cfg: ModelConfig, xl: XLSTMConfig,
          state=None):
    """mLSTM mixer over a sequence, chunkwise-parallel. x [B,S,D] ->
    (out [B,S,D], (C, n, m, conv_buf)): the final state, with the last
    K-1 rows of the conv input (f32) as the decode step's conv buffer.
    ``state`` = (C, n, m, ...) starts the scan (default: zero); the conv
    starts from zeros either way, as in the reference.

    S is padded to a multiple of L = min(chunk, S) with pad steps that
    weigh nothing (i = -1e30, f_log = 0, zero q/k/v)."""
    B, S, _ = x.shape
    Di, dh = _mlstm_widths(cfg, xl)
    dt = x.dtype
    xz = x @ p["up_proj"].to(dt)
    x_in, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    q, k, v = _heads(xc, p["wq"]), _heads(xc, p["wk"]), _heads(x_in, p["wv"])
    k = k * dh ** -0.5
    i_gate, f_log = _mlstm_gates(xc, p)

    L = min(xl.chunk, S)
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=PAD_GATE)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    heads = lambda t: t.transpose(1, 2).contiguous()     # noqa: E731
    y, (C, n, m) = ops.mlstm_scan(
        heads(q), heads(k), heads(v), heads(i_gate), heads(f_log), chunk=L,
        state=None if state is None else tuple(state[:3]))
    y = y.transpose(1, 2).reshape(B, S + pad, Di)[:, :S].to(dt)
    K = xl.conv_window
    buf = F.pad(x_in, (0, 0, max(0, (K - 1) - S), 0))[:, -(K - 1):]
    return _mlstm_out(y, z, p), (C, n, m, buf.float())


def mlstm_init_state(cfg: ModelConfig, xl: XLSTMConfig, batch: int,
                     device="cpu") -> tuple:
    """Zero state: C, n zero, m = -inf, conv buffer zero (all f32)."""
    H = cfg.num_heads
    Di, dh = _mlstm_widths(cfg, xl)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(batch, H, dh, dh, **f32),
            torch.zeros(batch, H, dh, **f32),
            torch.full((batch, H), float("-inf"), **f32),
            torch.zeros(batch, xl.conv_window - 1, Di, **f32))


def mlstm_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 xl: XLSTMConfig, state):
    """One-token mLSTM step. x [B,1,D]; state = (C, n, m, conv_buf) ->
    (out [B,1,D], new state)."""
    B = x.shape[0]
    C0, n0, m0, conv_buf = state
    Di, _ = _mlstm_widths(cfg, xl)
    dt = x.dtype
    xz = x @ p["up_proj"].to(dt)
    x_in, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv_buf.to(dt), x_in], dim=1)            # [B,K,Di]
    xc = torch.einsum("bke,ke->be", window, p["conv_w"].to(dt))
    xc = F.silu(xc + p["conv_b"].to(dt))[:, None]
    q, k, v = _heads(xc, p["wq"]), _heads(xc, p["wk"]), _heads(x_in, p["wv"])
    i_gate, f_log = _mlstm_gates(xc, p)
    y, (C, n, m) = _mlstm_cell(q, k, v, i_gate, f_log, C0, n0, m0)
    y = y.reshape(B, 1, Di).to(dt)
    return _mlstm_out(y, z, p), (C, n, m, window[:, 1:].float())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig, xl: XLSTMConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    dh = D // H
    Fd = int(xl.slstm_proj_factor * D)
    return {
        "w_in": PSpec((D, 4, H, dh), init=f"scaled:{D}"),     # z, i, f, o
        "r_rec": PSpec((4, H, dh, dh), init=f"scaled:{dh}"),  # per head
        "bias": PSpec((4, H, dh), init="zeros"),
        "out_norm": PSpec((D,), init="ones"),
        "ffn_gate": PSpec((D, Fd), init=f"scaled:{D}"),
        "ffn_up": PSpec((D, Fd), init=f"scaled:{D}"),
        "ffn_down": PSpec((Fd, D), init=f"scaled:{Fd}"),
    }


def _slstm_steps(zx, ix, fx, ox, r, bias, state):
    """The sLSTM steps over zx..ox [B,S,H,dh] from ``state``; ``r`` is
    r_rec as one [H] batch of [dh, 4·dh] blocks."""
    c, n, m, h = state
    B, S, H, dh = zx.shape
    ys = []
    for t in range(S):
        rec = torch.bmm(h.transpose(0, 1), r).view(H, B, 4, dh) \
            .permute(2, 1, 0, 3)                                 # [4,B,H,dh]
        z_ = torch.tanh(zx[:, t] + rec[0] + bias[0])
        i_ = ix[:, t] + rec[1] + bias[1]
        f_ = fx[:, t] + rec[2] + bias[2]
        o_ = torch.sigmoid(ox[:, t] + rec[3] + bias[3])
        f_log = F.logsigmoid(f_)
        m_new = torch.maximum(f_log + m, i_)
        i_e = torch.exp(i_ - m_new)
        f_e = torch.exp(f_log + m - m_new)
        c = f_e * c + i_e * z_
        n = f_e * n + i_e
        h = o_ * c / n.clamp(min=1.0)
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), (c, n, m, h)


def _slstm_cell(zx, ix, fx, ox, r_rec, bias, state):
    """The sequential sLSTM (the reference's ``_slstm_cell``): zx..ox
    [B,S,H,dh] input pre-activations, r_rec [4,H,dh,dh] per-head
    recurrent weights, bias [4,H,dh], state (c, n, m, h) [B,H,dh] -> (h_t
    stacked [B,S,H,dh], final state).  One host step per token.

    While a gradient is taken, each ``SLSTM_REMAT_CHUNK``-step chunk runs
    under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    chunk body: the backward keeps only the carry at chunk boundaries and
    recomputes the steps inside a chunk.  A sequence that is not a
    multiple of min(chunk, S) runs as one plain loop, as there.  This
    changes memory, not numbers."""
    B, S, H, dh = zx.shape
    # rec[g,b,h,i] = Σ_j r[g,h,i,j] h[b,h,j] as one [H] batch of
    # [B,dh] x [dh,4·dh] products
    r = r_rec.permute(1, 3, 0, 2).reshape(H, dh, 4 * dh)
    L = min(SLSTM_REMAT_CHUNK, S)
    trained = torch.is_grad_enabled() and any(
        t.requires_grad for t in (zx, ix, fx, ox, r_rec, bias, *state))
    if not trained or S % L:
        return _slstm_steps(zx, ix, fx, ox, r, bias, state)
    ys = []
    for c0 in range(0, S, L):
        y, state = checkpoint(
            _slstm_steps, *(t[:, c0:c0 + L] for t in (zx, ix, fx, ox)), r,
            bias, state, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def slstm_init_state(cfg: ModelConfig, batch: int, device="cpu") -> tuple:
    """Zero state: c, n, h zero and m = -inf, [B,H,dh] f32 each."""
    shape = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z, z, torch.full(shape, float("-inf"), device=device), z)


def slstm(x: torch.Tensor, p: dict, cfg: ModelConfig, xl: XLSTMConfig,
          state=None):
    """sLSTM block: the cell, the out norm and the GeLU-gated FFN.
    x [B,S,D] -> (out [B,S,D], (c, n, m, h))."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    dt = x.dtype
    pre = (x @ p["w_in"].to(dt).reshape(D, 4 * H * dh)).view(
        B, S, 4, H, dh).permute(2, 0, 1, 3, 4).float()           # [4,B,S,H,dh]
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    ys, state = _slstm_cell(pre[0], pre[1], pre[2], pre[3],
                            p["r_rec"].float(), p["bias"].float(), state)
    y = ys.reshape(B, S, D).to(dt) * p["out_norm"].to(dt)
    g = y @ p["ffn_gate"].to(dt)
    u = y @ p["ffn_up"].to(dt)
    out = (F.gelu(g, approximate="tanh") * u) @ p["ffn_down"].to(dt)
    return out, state


def slstm_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 xl: XLSTMConfig, state):
    """One-token sLSTM step: the block over S = 1 from ``state``."""
    return slstm(x, p, cfg, xl, state)
