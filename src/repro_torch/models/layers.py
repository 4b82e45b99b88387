"""Common model building blocks on tensors (no framework beyond torch).

Numerics follow the reference's ``models/layers.py`` exactly: RMSNorm in
fp32 with a ``(1 + scale)`` gain, rotary embedding over split halves with
fp32 angles, the gated MLP as ``act(x @ w_gate) * (x @ w_up)``, the
prefill's causal ``chunked_attention`` (fp32 scores, an optional sliding
window and logit softcap, probabilities cast to the K/V dtype before
P·V), and the token-mean ``cross_entropy_loss`` in fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _ACTS[name]


def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    rot_dim = int(head_dim * fraction) // 2 * 2
    exponents = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                             device=device) / max(rot_dim, 1)
    return 1.0 / (theta ** exponents)  # [rot_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, fraction: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * fraction) // 2 * 2
    if rot_dim == 0:
        return x
    freqs = rope_frequencies(head_dim, fraction, theta, device=x.device)
    angles = positions.float()[..., None] * freqs                # [..., seq, rot/2]
    cos = torch.cos(angles)[..., None, :]                        # [..., seq, 1, rot/2]
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
                gated: bool) -> torch.Tensor:
    """p: w_up [d, F], w_down [F, d] (+ w_gate [d, F] when gated)."""
    up = x @ p["w_up"]
    if gated:
        # conventional SwiGLU/GeGLU ordering: act(gate) * up
        h = activation(act)(x @ p["w_gate"]) * up
    else:
        h = activation(act)(up)
    return h @ p["w_down"]


def largest_divisor(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      window: Optional[int] = None,
                      softcap_val: Optional[float] = None,
                      kv_valid_len: Optional[torch.Tensor] = None,
                      chunk: int = 1024, q_chunk: int = 256) -> torch.Tensor:
    """Causal attention tiled over both the query and the KV dims, with an
    online softmax: the reference's ``layers.chunked_attention``.

    q [B, Sq, KVH, G, Dh] (grouped query heads); k, v [B, Skv, KVH, Dh];
    positions [Sq] and [Skv].  ``window`` W > 0 keeps the keys with
    ``qp - W < kp <= qp`` (gemma2's local layers; None or 0: global);
    ``softcap_val`` caps each fp32 score at ``c * tanh(s / c)`` before
    the mask; ``kv_valid_len`` [B] masks keys at positions >= it.  Live
    scores are [B, KVH, G, q_chunk, kv_chunk], never Sq x Skv.  Rounding
    as the reference's: q scaled in fp32, scores in fp32 against K in
    its own dtype's values, the probabilities cast to the V dtype before
    P·V, fp32 accumulation.  Returns [B, Sq, KVH, G, Dh] in q's dtype.
    """
    B, Sq, KVH, G, Dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    kv_c = largest_divisor(Skv, chunk)
    q_c = largest_divisor(Sq, q_chunk)
    outs = []
    for q0 in range(0, Sq, q_c):
        q32 = q[:, q0:q0 + q_c].float() * scale        # [B, q_c, KVH, G, Dh]
        qp = q_positions[q0:q0 + q_c][:, None]           # [q_c, 1]
        m = torch.full((B, KVH, G, q_c), float("-inf"), device=q.device)
        l = torch.zeros((B, KVH, G, q_c), device=q.device)
        acc = torch.zeros((B, KVH, G, q_c, Dh), device=q.device)
        for k0 in range(0, Skv, kv_c):
            kc, vc = k[:, k0:k0 + kv_c], v[:, k0:k0 + kv_c]
            s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", q32, kc.float()),
                        softcap_val)
            kp = kv_positions[k0:k0 + kv_c][None, :]
            mask = kp <= qp                                  # [q_c, kv_c]
            if window:
                mask = mask & (kp > qp - window)
            mask = mask[None, None, None]                    # [1,1,1,q_c,kv_c]
            if kv_valid_len is not None:
                mask = mask & (kp < kv_valid_len[:, None, None, None, None])
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.where(mask, torch.exp(s - m_safe[..., None]),
                            torch.zeros_like(s))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood in fp32: logits [..., V],
    labels [...] -> [...]."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean causal LM loss in fp32. logits [..., V]; labels [...];
    ``mask`` [...] weights each token (the mean is over its sum, at
    least 1)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
