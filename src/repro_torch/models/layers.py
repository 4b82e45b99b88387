"""Common model building blocks on tensors (no framework beyond torch).

Numerics follow the reference's ``models/layers.py`` exactly: RMSNorm in
fp32 with a ``(1 + scale)`` gain, rotary embedding over split halves with
fp32 angles, and the gated MLP as ``act(x @ w_gate) * (x @ w_up)``.
"""

from __future__ import annotations

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
