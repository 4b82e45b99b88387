"""RWKV6 "Finch" time mix and channel mix (arXiv:2404.05892): the
counterpart of the reference's ``models/rwkv6.py``.

The WKV recurrence runs in the reference's *chunked linear-attention*
form: within a chunk of C positions it is a masked attention-like sum
with per-channel decay ratios (each <= 1, their logs clipped to
[-60, 0]), and the state is carried from chunk to chunk, here by a
Python loop where the reference scans; with gradients on, each chunk
runs under ``torch.utils.checkpoint``, as the reference checkpoints its
scan's body, so backward keeps no [B, C, C, H, K] tensor.  Decode is the exact O(1)
recurrence.  Both are plain PyTorch ops, on the card too: the reference
runs them as jnp einsums, with no Pallas kernel to port.

Recurrence (per head, K = V = head_dim channels):
  S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
  y_t = r_t · (S_{t-1} + diag(u) (k_t ⊗ v_t))
with data-dependent decay  w_t = exp(-exp(w0 + tanh(x_w A_w) B_w)).
The wkv state is fp32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

LORA_RANK = 32
GN_EPS = 64e-5            # the per-head group norm's eps

PARAMS = ("mu_x", "mu", "lora_a", "lora_b", "w_r", "w_k", "w_v", "w_g", "w_o",
          "w0", "w_lora_a", "w_lora_b", "bonus", "gn_scale", "cm_mu_k",
          "cm_mu_r", "cm_w_r", "cm_w_k", "cm_w_v")
# each parameter's explicit init scale in the reference's rwkv6_params
# (the others are 1/sqrt(fan_in)); "gn_scale" is a norm (ones)
INIT_SCALES = {"mu_x": 0.1, "mu": 0.1, "lora_b": 0.01, "w0": 0.5,
               "w_lora_b": 0.01, "bonus": 0.3, "cm_mu_k": 0.1,
               "cm_mu_r": 0.1}
# each parameter's logical axes in the reference's rwkv6_params (one layer)
AXES = {"mu_x": ("embed",), "mu": (None, "embed"),
        "lora_a": (None, "embed", None), "lora_b": (None, None, "embed"),
        **{n: ("embed", "heads_flat") for n in ("w_r", "w_k", "w_v", "w_g")},
        "w_o": ("heads_flat", "embed"), "w0": ("embed",),
        "w_lora_a": ("embed", None), "w_lora_b": (None, "embed"),
        "bonus": ("heads_flat", None), "gn_scale": ("embed",),
        "cm_mu_k": ("embed",), "cm_mu_r": ("embed",),
        "cm_w_r": ("embed", "embed2"), "cm_w_k": ("embed", "mlp"),
        "cm_w_v": ("mlp", "embed")}


def rwkv6_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's time-mix and channel-mix parameters, by the
    reference's names (``layers.tm.<name>``)."""
    d, K, r = cfg.d_model, cfg.ssm.head_dim, LORA_RANK
    H = d // K
    return {
        "mu_x": (d,), "mu": (5, d), "lora_a": (5, d, r), "lora_b": (5, r, d),
        "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
        "w_o": (d, d),
        "w0": (d,), "w_lora_a": (d, 64), "w_lora_b": (64, d), "bonus": (H, K),
        "gn_scale": (d,),
        "cm_mu_k": (d,), "cm_mu_r": (d,), "cm_w_r": (d, d),
        "cm_w_k": (d, cfg.d_ff), "cm_w_v": (cfg.d_ff, d),
    }


def _ddlerp(p: Dict[str, torch.Tensor], x: torch.Tensor,
            x_prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift mixing -> (xw, xk, xv, xr, xg)."""
    xx = x_prev - x
    xxx = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.einsum(
        "...ir,ird->...id",
        torch.tanh(torch.einsum("...d,idr->...ir", xxx, p["lora_a"])),
        p["lora_b"])
    mix = p["mu"].to(x.dtype) + lora                        # [..., 5, d]
    out = x[..., None, :] + xx[..., None, :] * mix
    return tuple(out[..., i, :] for i in range(5))


def _decay(p: Dict[str, torch.Tensor], xw: torch.Tensor) -> torch.Tensor:
    """log w_t (per channel) in fp32, in [-8, -exp(-6)]: the low-rank
    decay clipped to [-6, 2.079] before the outer exp."""
    lw = p["w0"].float() + torch.tanh(
        xw.float() @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    return -torch.exp(torch.clamp(lw, -6.0, 2.079))          # exp(2.079) ~ 8


def _group_norm(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head norm of the fp32 wkv output y [..., H, K] (population
    variance, eps GN_EPS), flattened to [..., d] and scaled."""
    mean = torch.mean(y, -1, keepdim=True)
    var = torch.var(y, -1, unbiased=False, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + GN_EPS)
    return y.flatten(-2) * scale.float()


def _chunk(S_in: torch.Tensor, rc: torch.Tensor, kc: torch.Tensor,
           vc: torch.Tensor, lwc: torch.Tensor, u: torch.Tensor,
           below: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the WKV recurrence: r, k, v, log w [B, C, H, K] fp32
    from the state S_in [B, H, K, K] -> (y [B, C, H, K], state out)."""
    cum = torch.cumsum(lwc, dim=1)                           # Σ_{s<=t}
    cum_prev = cum - lwc                                     # Σ_{s<=t-1}
    # intra-chunk scores: A[t,j] = Σ_k r_t k_j exp(cum_prev_t - cum_j), j<t
    ratio = torch.clamp(cum_prev[:, :, None] - cum[:, None], -60.0, 0.0)
    scores = torch.einsum("btjhk,bjhk->btjh",
                          rc[:, :, None] * torch.exp(ratio), kc)
    scores = torch.where(below, scores, torch.zeros_like(scores))
    diag = (rc * u * kc).sum(-1)                             # bonus term [B,C,H]
    y = torch.einsum("btjh,bjhk->bthk", scores, vc)
    y = y + diag[..., None] * vc
    # state contribution: r_t ⊙ exp(cum_prev_t) against S_in
    y = y + torch.einsum("bthk,bhkn->bthn", rc * torch.exp(cum_prev), S_in)
    decay_out = torch.exp(cum[:, -1])                        # [B, H, K]
    k_scaled = kc * torch.exp(torch.clamp(cum[:, -1][:, None] - cum,
                                          -60.0, 0.0))
    return y, S_in * decay_out[..., None] + torch.einsum(
        "bthk,bthn->bhkn", k_scaled, vc)


def rwkv6_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ArchConfig, *, shift_in: torch.Tensor,
                   state_in: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time mix, chunk by chunk.  x [B, S, d]; shift_in
    [B, d] (the previous segment's last input); state_in [B, H, K, K].
    Chunks of ``cfg.ssm.chunk_size`` positions, or one chunk of S when
    the size does not divide S, as the reference falls back.  Returns
    (y [B, S, d], shift_out [B, d], state_out in state_in's dtype)."""
    B, S, d = x.shape
    K = cfg.ssm.head_dim
    H = d // K
    C = min(cfg.ssm.chunk_size, S)
    if S % C:
        C = S                         # fallback: one chunk (small shapes)

    x_prev = torch.cat([shift_in[:, None, :], x[:, :-1, :]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["w_r"]).reshape(B, S, H, K).float()
    k = (xk @ p["w_k"]).reshape(B, S, H, K).float()
    v = (xv @ p["w_v"]).reshape(B, S, H, K).float()
    g = F.silu(xg @ p["w_g"])
    logw = _decay(p, xw).reshape(B, S, H, K)                 # fp32, negative
    u = p["bonus"].float()                                   # [H, K]
    below = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device),
                       -1)[None, :, :, None]                 # j < t
    # with gradients on, backward recomputes each chunk's [B, C, C, H, K]
    # decay tensors from its inputs, as the reference's checkpointed body
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u, state_in))

    S_run = state_in.float()
    ys = []
    for c0 in range(0, S, C):
        args = (S_run, *(t[:, c0:c0 + C] for t in (r, k, v, logw)), u, below)
        y, S_run = (checkpoint(_chunk, *args, use_reentrant=False) if remat
                    else _chunk(*args))
        ys.append(y)
    y = _group_norm(torch.cat(ys, dim=1), p["gn_scale"])     # [B, S, d] fp32
    out = (y.to(x.dtype) * g) @ p["w_o"]
    return out, x[:, -1, :], S_run.to(state_in.dtype)


def rwkv6_time_mix_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        cfg: ArchConfig, *, shift_in: torch.Tensor,
                        state_in: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact O(1) recurrence for one token.  x [B, d]; shift_in
    [B, d]; state_in [B, H, K, K].  Returns (y [B, d], shift_out = x,
    state_out in state_in's dtype)."""
    B, d = x.shape
    K = cfg.ssm.head_dim
    H = d // K
    xw, xk, xv, xr, xg = _ddlerp(p, x, shift_in)
    r = (xr @ p["w_r"]).reshape(B, H, K).float()
    k = (xk @ p["w_k"]).reshape(B, H, K).float()
    v = (xv @ p["w_v"]).reshape(B, H, K).float()
    g = F.silu(xg @ p["w_g"])
    w = torch.exp(_decay(p, xw).reshape(B, H, K))
    u = p["bonus"].float()
    S = state_in.float()                                     # [B, H, K, K]
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkn->bhn", r, S + u[None, :, :, None] * kv)
    S = S * w[..., None] + kv
    y = _group_norm(y, p["gn_scale"])
    return (y.to(x.dtype) * g) @ p["w_o"], x, S.to(state_in.dtype)


def rwkv6_channel_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      shift_in: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel mix (a squared-ReLU FFN with token shift) on x [B, S, d]
    or [B, d]; returns (y, shift_out)."""
    if x.dim() == 3:
        x_prev = torch.cat([shift_in[:, None, :], x[:, :-1, :]], dim=1)
        shift_out = x[:, -1, :]
    else:
        x_prev, shift_out = shift_in, x
    xk = x + (x_prev - x) * p["cm_mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * p["cm_mu_r"].to(x.dtype)
    rcv = torch.sigmoid(xr @ p["cm_w_r"])
    kk = torch.square(F.relu(xk @ p["cm_w_k"]))
    return rcv * (kk @ p["cm_w_v"]), shift_out
