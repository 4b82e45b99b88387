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
on every rank (the router is whole).  Where the group carries a
``data`` axis of D > 1 shards, a rank holds T / D of the T tokens the
reference's global program groups (its rows, contiguous in row order):
the groups, their size ``Tg`` and the capacity ``C`` are the whole
batch's.  Where each shard holds whole groups, a rank routes its own
groups alone; where a group spans shards, the selected experts [T / D,
K] are all-gathered over ``data``, the slots of every token computed,
and the rank keeps its own (the expert MLP works per token, so nothing
else crosses shards).  The load-balancing loss's sums behind
``frac_tokens`` and ``frac_probs`` are all-reduced over ``data``
before the product (``frac_probs``' with the identity backward of
Megatron's "g", so each shard's gradient reaches its own tokens).  Where the experts split, the rank
holds experts [e0, e0 + E / model) and computes only the picks of those:
its buffer is [E / model, G * C, d], every other pick goes to the spare
row with weight 0, and the fp32 combine sum is all-reduced before the
one cast.  Where they do not (E not a multiple of the ranks), the expert
MLPs' hidden dim splits instead, each product row-parallel, and the same
fp32 sum is all-reduced.  Arctic's dense residual is a plain MLP,
all-reduced where its hidden dim splits.  With gradients on, the
layer input and the gates enter the split products through Megatron's
"f" (``TPRank.copy``), so the whole router's gradient is every rank's.
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
    """One layer's dispatch of a rank's T tokens, laid out [G', T', ...]
    (G' x T' = T): the whole groups [G, Tg] where the rank holds whole
    groups, else [1, T]."""

    probs: torch.Tensor     # [G', T', E] fp32 router softmax
    experts: torch.Tensor   # [G', T', K] selected experts, best first
    weights: torch.Tensor   # [G', T', K] fp32 renormalised gates
    slot: torch.Tensor      # [G', T', K] capacity slot (may be >= C)
    keep: torch.Tensor      # [G', T', K] bool: slot < C
    capacity: int
    group: torch.Tensor     # [G', T', 1] each token's group, from the rank's first
    groups: int             # groups the rank's tokens touch


def group_shape(tokens: int, cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, tokens a group) of ``tokens`` under ``cfg.moe``."""
    Tg = largest_divisor(tokens, min(cfg.moe.group_size, tokens))
    return tokens // Tg, Tg


def capacity(Tg: int, cfg: ArchConfig) -> int:
    """Per-expert slots in a group of ``Tg`` tokens."""
    mo = cfg.moe
    C = max(1, math.ceil(Tg * mo.top_k * mo.capacity_factor / mo.num_experts))
    return min(C, Tg)


def _data(tp: Optional["TPRank"]) -> Tuple[int, int]:
    """(data shards of the step's batch, this rank's shard): (1, 0) alone
    or where each data replica runs its own batch (a paged step)."""
    if tp is None or tp.data_size == 1:
        return 1, 0
    return tp.data_size, tp.group.data_rank


def route(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig,
          tp: Optional["TPRank"] = None) -> Routing:
    """Router, top-k and capacity slots of ``x`` [..., d] (flattened to
    T tokens in row order) under ``router`` [d, E]; on a rank whose
    group has a ``data`` axis of D shards, ``x`` is shard d's T tokens
    of the D x T that the groups are made of."""
    mo = cfg.moe
    d = x.shape[-1]
    T = x.numel() // d
    D, dr = _data(tp)
    G, Tg = group_shape(T * D, cfg)
    C = capacity(Tg, cfg)
    whole = T % Tg == 0             # the rank's tokens are whole groups
    Gl, Tl = (T // Tg, Tg) if whole else (1, T)
    xg = x.reshape(Gl, Tl, d)
    probs = torch.softmax((xg @ router).float(), dim=-1)        # [G', T', E]
    top_p, top_e = probs.sort(dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :mo.top_k], top_e[..., :mo.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    if whole:
        sel = torch.zeros_like(probs).scatter_(-1, top_e, 1.0)  # [G', T', E]
        before = torch.cumsum(sel, dim=1) - sel                # earlier picks
        group = torch.arange(Gl, device=x.device)[:, None, None]
    else:                           # a group spans shards: every shard's picks
        every = tp.group.all_gather_first(top_e.reshape(T, mo.top_k))
        sel = torch.zeros((T * D, mo.num_experts), dtype=torch.float32,
                          device=x.device).scatter_(-1, every, 1.0)
        sel = sel.view(G, Tg, -1)
        before = (torch.cumsum(sel, dim=1) - sel).view(T * D, -1)
        before = before[dr * T:(dr + 1) * T].view(1, T, -1)
        first = dr * T // Tg
        group = (torch.arange(dr * T, (dr + 1) * T, device=x.device)
                 // Tg - first).view(1, T, 1)
        Gl = ((dr + 1) * T - 1) // Tg - first + 1
    slot = before.gather(-1, top_e).long()                     # [G', T', K]
    return Routing(probs, top_e, top_p, slot, slot < C, C, group, Gl)


def moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, tp: Optional["TPRank"] = None,
                want_aux: bool = True,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [..., d] -> (out [..., d] in x's dtype, aux loss fp32 scalar, or
    None without ``want_aux``: a decode step's, which it drops).

    ``p``: router [d, E], w_up and w_gate [E, d, F], w_down [E, F, d],
    and with a dense residual dense_w_up, dense_w_gate [d, Fd] and
    dense_w_down [Fd, d]; on a rank (``tp``) its blocks of the expert
    and dense weights (the router whole)."""
    mo = cfg.moe
    E, K = mo.num_experts, mo.top_k
    d = x.shape[-1]
    # the unsharded call keeps route's three arguments
    r = route(p["router"], x, cfg) if tp is None else route(p["router"], x,
                                                            cfg, tp)
    Gl, Tl, _ = r.experts.shape
    G, C = r.groups, r.capacity
    split = tp is not None and (tp.layout.experts is not None
                                or tp.layout.mlp_split)
    xt = x.reshape(Gl * Tl, d)
    weights = r.weights
    if split:       # replicated inputs of the split products: Megatron's "f"
        xt, weights = tp.copy(xt), tp.copy(weights)
    keep, experts, El = r.keep, r.experts, E
    if tp is not None and tp.layout.experts is not None:
        e0, El = tp.layout.experts[0], p["w_up"].shape[0]  # this rank's only
        keep = keep & (experts >= e0) & (experts < e0 + El)
        experts = experts - e0
    # flat slot (e, g, c) of each (token, pick) in the [El, G * C] buffer;
    # a dropped pick goes to the spare row El * G * C
    flat = (experts * G + r.group) * C + r.slot
    flat = torch.where(keep, flat, El * G * C).reshape(-1)
    xin = x.new_zeros((El * G * C + 1, d))
    xin[flat] = xt.repeat_interleave(K, dim=0)
    xe = xin[:-1].view(El, G * C, d)
    h = activation(cfg.mlp_act)(torch.bmm(xe, p["w_gate"])) \
        * torch.bmm(xe, p["w_up"])
    out_e = torch.cat([torch.bmm(h, p["w_down"]).view(El * G * C, d),
                       x.new_zeros((1, d))])
    comb = torch.where(keep, weights, 0.0).to(x.dtype).float()
    out = (out_e[flat].view(Gl * Tl, K, d).float() * comb.view(-1, K, 1)).sum(1)
    if tp is not None:
        out = tp.reduce(out, split)
    out = out.to(x.dtype).view(x.shape)

    aux = None
    if want_aux:
        D, _ = _data(tp)
        picked = torch.zeros_like(r.probs).scatter_(-1, r.experts, 1.0)
        if D == 1:
            frac_tokens = picked.mean(dim=(0, 1))
            frac_probs = r.probs.mean(dim=(0, 1))
        else:       # the whole batch's means: the sums over every shard
            n = float(Gl * Tl * D)
            frac_tokens = tp.group.all_reduce_sum(
                picked.sum(dim=(0, 1)).detach(), "data") / n
            frac_probs = tp.reduce(r.probs.sum(dim=(0, 1)), True, "data") / n
        aux = E * torch.sum(frac_tokens * frac_probs) * mo.aux_loss_weight
    if mo.dense_residual_d_ff:
        dense = {"w_up": p["dense_w_up"], "w_gate": p["dense_w_gate"],
                 "w_down": p["dense_w_down"]}
        xd = x if tp is None else tp.copy(x, tp.layout.dense_split)
        res = mlp_forward(dense, xd, cfg.mlp_act, True)
        if tp is not None:
            res = tp.reduce(res, tp.layout.dense_split)
        out = out + res
    return out, aux
