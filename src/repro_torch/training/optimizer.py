"""AdamW with a configurable moment dtype and a cosine schedule: the
reference's ``training/optimizer.py`` arithmetic on tensors, in place.

``moment_dtype="bfloat16"`` halves the optimizer state: Llama-3-8B's
bf16 weights (16.06 GB) with fp32 m and v (64.2 GB) and bf16 gradients
do not fit one 80 GB card; with bf16 m and v (32.1 GB) they do.

The update is the reference's per element, in fp32, then cast to the
parameter's and the moments' dtypes; it is not ``torch.optim.AdamW``
(which does not clip and orders the bias correction differently).
Parameters and moments are updated in place, one piece at a time:
each tensor is split along its first dim into pieces of at most
``PIECE`` elements (one layer of a stacked ``[L, ...]`` parameter), so
the fp32 scratch stays one layer big where an fp32 copy of Llama-3-8B's
stacked MLP weight alone would take 7.5 GB.  ``global_norm`` sums the
same pieces; ``sharded_global_norm`` is the same norm over a
tensor-parallel rank's blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Callable, Collection, Dict, Iterable, List, Mapping,
                    Optional, Tuple, Union)

import torch

# largest piece of a tensor updated at once, in elements (256 MB of fp32;
# one layer of the widest stacked Llama-3-8B weight is 58.7M)
PIECE = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # "float32" | "bfloat16"


def schedule(step: Union[int, torch.Tensor], cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step``: linear warm-up, then a cosine down to
    ``min_lr_frac`` of ``lr`` at ``total_steps``; an fp32 scalar on
    ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptConfig) -> Dict[str, object]:
    """Zero moments {"m", "v"} (by parameter name) in ``moment_dtype``
    and an int32 step counter, on the parameters' device."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def pieces(t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` as views of at most ``PIECE`` elements along its first dim."""
    if t.dim() == 0 or t.numel() <= PIECE:
        return [t]
    return list(t.split(max(1, PIECE // (t.numel() // t.shape[0]))))


def _sum_squares(tensors: Iterable[torch.Tensor]) -> Optional[torch.Tensor]:
    total = None
    for t in tensors:
        for piece in pieces(t):
            sq = torch.sum(torch.square(piece.float()))
            total = sq if total is None else total + sq
    return total


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(_sum_squares(tensors))


def sharded_global_norm(grads: Mapping[str, torch.Tensor],
                        axes: Mapping[str, Collection[str]],
                        reduce: Callable[[torch.Tensor, str], torch.Tensor],
                        ) -> torch.Tensor:
    """``global_norm`` of the whole tree when each rank holds the blocks
    ``grads``: ``axes[name]`` the group axes ("model", "data") whose
    ranks hold different blocks of ``name`` (none: the same tensor on
    every rank); each block's squares are summed over exactly those
    axes by ``reduce(t, axis)`` (an all-reduce), so a block replicated
    over an axis is counted once there.  One all-reduce over ``model``,
    and one over ``data`` where a block splits over it."""
    dev = next(iter(grads.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    by: Dict[frozenset, list] = {}
    for n, g in grads.items():
        by.setdefault(frozenset(axes.get(n, ())), []).append(g)
    sums = {k: _sum_squares(v) for k, v in by.items()}
    s = lambda *k: sums.get(frozenset(k), zero)
    data_only = zero
    part = s("model")
    if any("data" in k for k in sums):
        d = reduce(torch.stack([s("data"), s("model", "data")]), "data")
        data_only, part = d[0], part + d[1]
    total = reduce(zero + part, "model")
    return torch.sqrt(total + s() + data_only)


def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, object],
                 cfg: OptConfig, grad_norm: Optional[torch.Tensor] = None,
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object],
                            Dict[str, torch.Tensor]]:
    """One AdamW step, the reference's arithmetic, IN PLACE: the
    parameters and ``state``'s moments are overwritten and its step
    advanced.  Gradients are clipped to a global norm of ``grad_clip``
    (``grad_norm`` where given: a rank's blocks' ``sharded_global_norm``;
    the update stays elementwise on the blocks).  Returns (params, state,
    {"lr", "grad_norm"}) — the same objects, so the call reads as the
    reference's."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    with torch.no_grad():
        for name, p in params.items():
            for pp, g, m, v in zip(pieces(p), pieces(grads[name]),
                                   pieces(state["m"][name]),
                                   pieces(state["v"][name])):
                g32 = g.float() * clip
                m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
                v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                delta = delta + cfg.weight_decay * pp.float()
                pp.copy_(pp.float() - lr * delta)
                m.copy_(m32)
                v.copy_(v32)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
