"""Mamba2 (SSD) block: the counterpart of the reference's
``models/mamba2.py``.

A per-head scalar decay makes the sequence mixing 1-semiseparable:
within a chunk it is an attention-like masked sum with decay ratios <= 1
(their logs clipped to [-60, 0]); across chunks the state is carried,
here by a Python loop where the reference scans; with gradients on,
each chunk runs under ``torch.utils.checkpoint``, as the reference
checkpoints its scan's body.  Decode is the exact
O(1) recurrence.  Both are plain PyTorch ops, on the card too: the
reference runs them as jnp einsums, with no Pallas kernel to port.

Recurrence (head h, P = head channels, N = state dim, ngroups = 1):
  a_t   = exp(dt_t * A_h)                      (A_h < 0)
  S_t   = a_t S_{t-1} + (dt_t x_t) ⊗ B_t       S: [P, N]
  y_t   = S_t C_t + D_h x_t
The SSD state is fp32 whatever the model's dtype; the short causal
convolution's state is the last ``conv_width - 1`` inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import rms_norm

PARAMS = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
          "out_norm", "w_out")
# each parameter's explicit init scale in the reference's mamba2_params
# (the others are 1/sqrt(fan_in)); "conv_b" is a bias (zeros)
INIT_SCALES = {"conv_w": 0.5, "a_log": 0.5, "dt_bias": 0.5, "d_skip": 1.0}
# each parameter's logical axes in the reference's mamba2_params (one block)
AXES = {"w_in": ("embed", "heads_flat"), "conv_w": (None, "heads_flat"),
        **{n: ("heads_flat",) for n in ("conv_b", "a_log", "dt_bias",
                                        "d_skip", "out_norm")},
        "w_out": ("heads_flat", "embed")}


def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in = expand * d, heads, head channels P, state dim N)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.state_dim


def mamba2_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One block's parameters, by the reference's names
    (``layers.mamba.<name>``): the fused in-projection [z | x | B | C |
    dt], the depthwise conv over [x | B | C], and the rest."""
    d = cfg.d_model
    d_in, H, P, N = mamba2_dims(cfg)
    cw = cfg.ssm.conv_width
    return {"w_in": (d, 2 * d_in + 2 * N + H), "conv_w": (cw, d_in + 2 * N),
            "conv_b": (d_in + 2 * N,), "a_log": (H,), "dt_bias": (H,),
            "d_skip": (H,), "out_norm": (d_in,), "w_out": (d_in, d)}


def _split_in(cfg: ArchConfig, proj: torch.Tensor):
    """The in-projection [..., 2 d_in + 2N + H] as (z, xbc, dt)."""
    d_in, H, P, N = mamba2_dims(cfg)
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
            proj[..., 2 * d_in + 2 * N:])


def _conv(p: Dict[str, torch.Tensor], xbc: torch.Tensor,
          conv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over the sequence, then SiLU.  xbc [B, S,
    ch]; conv_in [B, cw - 1, ch], the inputs before xbc.  Returns (out
    [B, S, ch], conv_out: the last cw - 1 inputs)."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_in.to(xbc.dtype), xbc], dim=1)
    S = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(cw):
        out = out + full[:, i:i + S, :] * p["conv_w"][i]
    conv_out = full[:, -(cw - 1):, :] if cw > 1 else conv_in
    return F.silu(out + p["conv_b"]), conv_out


def _dt_decay(p: Dict[str, torch.Tensor], dt: torch.Tensor):
    """(dt = softplus(dt + dt_bias), A = -exp(a_log)), both fp32."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float())


def _output(p: Dict[str, torch.Tensor], y: torch.Tensor, xc: torch.Tensor,
            z: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    """y [..., H, P] fp32 plus the D skip, gated by SiLU(z), normed and
    projected out: [..., d] in ``dtype``."""
    y = y + p["d_skip"].float()[:, None] * xc.float()
    y = y.flatten(-2).to(dtype)
    return rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps) @ p["w_out"]


def _chunk(S_in: torch.Tensor, xcc: torch.Tensor, Bc: torch.Tensor,
           Cc: torch.Tensor, dtc: torch.Tensor, lac: torch.Tensor,
           upper: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the SSD: x [B, C, H, P], B and C [B, C, N], dt and
    log-decay [B, C, H], all fp32, from the state S_in [B, H, P, N] ->
    (y [B, C, H, P], state out)."""
    cum = torch.cumsum(lac, dim=1)                           # Σ_{s<=t}
    # intra: y_t = Σ_{j<=t} exp(cum_t - cum_j) dt_j (C_t·B_j) x_j
    L = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None], -60.0, 0.0))
    G = torch.einsum("btn,bjn->btj", Cc, Bc)
    M = G[..., None] * L * dtc[:, None]                      # [B, t, j, H]
    M = torch.where(upper, M, torch.zeros_like(M))
    y = torch.einsum("btjh,bjhp->bthp", M, xcc)
    # inter: y_t += exp(cum_t) S_in C_t
    y = y + torch.einsum("btn,bhpn->bthp", Cc, S_in) * torch.exp(cum)[..., None]
    dec_end = torch.exp(cum[:, -1])                          # [B, H]
    w = torch.exp(torch.clamp(cum[:, -1][:, None] - cum, -60.0, 0.0)) * dtc
    return y, S_in * dec_end[..., None, None] + torch.einsum(
        "bthp,btn->bhpn", xcc * w[..., None], Bc)


def mamba2_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ArchConfig, *, conv_in: torch.Tensor,
                   state_in: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence SSD, chunk by chunk.  x [B, S, d]; conv_in [B,
    cw - 1, d_in + 2N]; state_in [B, H, P, N].  Chunks of
    ``cfg.ssm.chunk_size`` positions, or one of S when it does not
    divide S.  Returns (y [B, S, d], conv_out, state_out in state_in's
    dtype)."""
    B, S, d = x.shape
    d_in, H, P, N = mamba2_dims(cfg)
    C = min(cfg.ssm.chunk_size, S)
    if S % C:
        C = S

    z, xbc, dt = _split_in(cfg, x @ p["w_in"])
    xbc, conv_out = _conv(p, xbc, conv_in)
    xc = xbc[..., :d_in].reshape(B, S, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N].float(), xbc[..., d_in + N:].float()
    dt, a = _dt_decay(p, dt)
    la = dt * a                                              # log-decay [B,S,H]
    xc32 = xc.float()
    upper = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device)
                       )[None, :, :, None]                   # j <= t
    # with gradients on, backward recomputes each chunk's [B, C, C, H]
    # masks from its inputs, as the reference's checkpointed body
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc32, Bm, Cm, dt, la, state_in))

    S_run = state_in.float()
    ys = []
    for c0 in range(0, S, C):
        args = (S_run, *(t[:, c0:c0 + C] for t in (xc32, Bm, Cm, dt, la)),
                upper)
        y, S_run = (checkpoint(_chunk, *args, use_reentrant=False) if remat
                    else _chunk(*args))
        ys.append(y)
    y = _output(p, torch.cat(ys, dim=1), xc, z, cfg, x.dtype)
    return y, conv_out, S_run.to(state_in.dtype)


def mamba2_step(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                *, conv_in: torch.Tensor, state_in: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact O(1) decode step.  x [B, d]; conv_in [B, cw - 1, ch];
    state_in [B, H, P, N].  Returns (y [B, d], conv_out, state_out in
    state_in's dtype)."""
    B, d = x.shape
    d_in, H, P, N = mamba2_dims(cfg)
    z, xbc, dt = _split_in(cfg, x @ p["w_in"])
    full = torch.cat([conv_in.to(xbc.dtype), xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", full, p["conv_w"]) + p["conv_b"])
    conv_out = full[:, 1:, :]
    xc = xbc[..., :d_in].reshape(B, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N].float(), xbc[..., d_in + N:].float()
    dt, a = _dt_decay(p, dt)
    S = state_in.float() * torch.exp(dt * a)[..., None, None]
    S = S + (dt[..., None] * xc.float())[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", S, Cm)
    return _output(p, y, xc, z, cfg, x.dtype), conv_out, S.to(state_in.dtype)
