"""Mixture-of-Experts layer: the reference's GShard capacity dispatch
(``models/moe.py``) in capacity-slot form.

The function is the reference's ``moe_forward`` exactly.  Tokens go in
dispatch groups of ``Tg`` (the largest divisor of the token count that
is at most ``group_size``); each expert takes at most
``C = min(Tg, max(1, ceil(Tg * K * capacity_factor / E)))`` tokens a
group.  The router's logits are the product in the activations' dtype,
then fp32; softmax in fp32; the top ``K`` experts (ties to the lower
expert index, as ``jax.lax.top_k`` breaks them: a stable descending
sort), renormalised over the selected.  A token takes capacity slot
``c`` of expert ``e`` where ``c`` is how many earlier tokens of its
group (in row order) selected ``e``; a token past capacity loses that
expert only.  Combine weights are rounded to the activations' dtype, as
the reference's ``combine.astype(x.dtype)``.  Arctic's dense residual
MLP is added to the expert output; ``aux`` is the GShard load-balancing
loss.

The reference forms one-hot dispatch and combine tensors [G, Tg, E, C]
and contracts them by einsum.  Here each kept (token, expert) pair
writes its token into slot ``(g, e, c)`` of an ``[E, G * C, d]`` buffer
and reads its expert's output back from the same slot, so a layer is
three batched expert products (``bmm``, as the reference leaves its
expert einsums to XLA) and a fixed number of small ops whatever E, with
no host sync: a dropped pair writes and reads a spare row past the
buffer, with combine weight 0.

On one rank of a tensor-parallel group (``tp``) the routing is the same
on every rank (the router is whole).  Where the experts split, the rank
holds experts [e0, e0 + E / model) and computes only the picks of those:
its buffer is [E / model, G * C, d], every other pick goes to the spare
row with weight 0, and the fp32 combine sum is all-reduced before the
one cast.  Where they do not (E not a multiple of the ranks), the expert
MLPs' hidden dim splits instead, each product row-parallel, and the same
fp32 sum is all-reduced.  Arctic's dense residual is a plain MLP,
all-reduced where its hidden dim splits.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, largest_divisor, mlp_forward

if TYPE_CHECKING:
    from repro_torch.distributed.tensor_parallel import TPRank


class Routing(NamedTuple):
    """One layer's dispatch of T tokens in G groups of Tg."""

    probs: torch.Tensor     # [G, Tg, E] fp32 router softmax
    experts: torch.Tensor   # [G, Tg, K] selected experts, best first
    weights: torch.Tensor   # [G, Tg, K] fp32 renormalised gates
    slot: torch.Tensor      # [G, Tg, K] capacity slot (may be >= C)
    keep: torch.Tensor      # [G, Tg, K] bool: slot < C
    capacity: int


def group_shape(tokens: int, cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, tokens a group) of ``tokens`` under ``cfg.moe``."""
    Tg = largest_divisor(tokens, min(cfg.moe.group_size, tokens))
    return tokens // Tg, Tg


def capacity(Tg: int, cfg: ArchConfig) -> int:
    """Per-expert slots in a group of ``Tg`` tokens."""
    mo = cfg.moe
    C = max(1, math.ceil(Tg * mo.top_k * mo.capacity_factor / mo.num_experts))
    return min(C, Tg)


def route(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Router, top-k and capacity slots of ``x`` [..., d] (flattened to
    T tokens in row order) under ``router`` [d, E]."""
    mo = cfg.moe
    d = x.shape[-1]
    T = x.numel() // d
    G, Tg = group_shape(T, cfg)
    C = capacity(Tg, cfg)
    xg = x.reshape(G, Tg, d)
    probs = torch.softmax((xg @ router).float(), dim=-1)        # [G, Tg, E]
    top_p, top_e = probs.sort(dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :mo.top_k], top_e[..., :mo.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    sel = torch.zeros_like(probs).scatter_(-1, top_e, 1.0)     # [G, Tg, E]
    before = torch.cumsum(sel, dim=1) - sel                    # earlier picks
    slot = before.gather(-1, top_e).long()                     # [G, Tg, K]
    return Routing(probs, top_e, top_p, slot, slot < C, C)


def moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, tp: Optional["TPRank"] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] -> (out [..., d] in x's dtype, aux loss fp32 scalar).

    ``p``: router [d, E], w_up and w_gate [E, d, F], w_down [E, F, d],
    and with a dense residual dense_w_up, dense_w_gate [d, Fd] and
    dense_w_down [Fd, d]; on a rank (``tp``) its blocks of the expert
    and dense weights (the router whole)."""
    mo = cfg.moe
    E, K = mo.num_experts, mo.top_k
    d = x.shape[-1]
    r = route(p["router"], x, cfg)
    G, Tg, _ = r.experts.shape
    C = r.capacity
    xt = x.reshape(G * Tg, d)
    keep, experts, El = r.keep, r.experts, E
    if tp is not None and tp.layout.experts is not None:
        e0, El = tp.layout.experts[0], p["w_up"].shape[0]  # this rank's only
        keep = keep & (experts >= e0) & (experts < e0 + El)
        experts = experts - e0
    # flat slot (e, g, c) of each (token, pick) in the [El, G * C] buffer;
    # a dropped pick goes to the spare row El * G * C
    flat = (experts * G + torch.arange(G, device=x.device)[:, None, None]) \
        * C + r.slot
    flat = torch.where(keep, flat, El * G * C).reshape(-1)
    xin = x.new_zeros((El * G * C + 1, d))
    xin[flat] = xt.repeat_interleave(K, dim=0)
    xe = xin[:-1].view(El, G * C, d)
    h = activation(cfg.mlp_act)(torch.bmm(xe, p["w_gate"])) \
        * torch.bmm(xe, p["w_up"])
    out_e = torch.cat([torch.bmm(h, p["w_down"]).view(El * G * C, d),
                       x.new_zeros((1, d))])
    comb = torch.where(keep, r.weights, 0.0).to(x.dtype).float()
    out = (out_e[flat].view(G * Tg, K, d).float() * comb.view(-1, K, 1)).sum(1)
    if tp is not None:
        out = tp.reduce(out, tp.layout.experts is not None
                        or tp.layout.mlp_split)
    out = out.to(x.dtype).view(x.shape)

    frac_tokens = torch.zeros_like(r.probs).scatter_(-1, r.experts, 1.0) \
        .mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * mo.aux_loss_weight
    if mo.dense_residual_d_ff:
        dense = {"w_up": p["dense_w_up"], "w_gate": p["dense_w_gate"],
                 "w_down": p["dense_w_down"]}
        res = mlp_forward(dense, x, cfg.mlp_act, True)
        if tp is not None:
            res = tp.reduce(res, tp.layout.dense_split)
        out = out + res
    return out, aux
