"""Gradient compression for the data-parallel all-reduce: int8 with error
feedback (the reference's ``distributed/compression.py``).

The explicit-collective training step
(``training.train_loop.make_manual_dp_train_step``) owns its all-reduce,
so it can compress it.  Per gradient leaf, in the reference's order of
operations:

    g32      = g + e                     # fp32, with the carried residual
    amax     = all_reduce_max(max |g32|)
    scale    = amax / 127   (1 where amax == 0)
    q        = clip(round(g32 / scale), -127, 127)
    e'       = g32 - q * scale           # local error feedback, rounded once
    q_sum    = all_reduce_sum(int32(q))
    g_hat    = q_sum * scale / world

Every rank dequantizes with one scale, so ``g_hat`` is the same on every
rank; ``e'`` is the rank's own.  Error feedback makes the compression
unbiased in the limit (the residual re-enters the next step), the trick
of the 1-bit Adam / EF-SGD lineage.

Bytes on the wire: the sum travels as int32, 4 bytes an element (and one
fp32 scale a leaf), as the reference's ``psum`` of ``q.astype(int32)``.
That is twice a bf16 all-reduce's payload and the same as an fp32 one's;
the reference's docstring says "4x fewer bytes" and its
``compression_ratio`` returns 0.5, the figure this module's
``compression_ratio`` keeps.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import pieces


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q int8, scale fp32 scalar), ``x ~ q *
    scale``; the scale is 1 for an all-zero ``x``."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(grads: Mapping[str, torch.Tensor],
                          err: Dict[str, torch.Tensor],
                          group: Optional[dist.ProcessGroup] = None,
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """Int8 all-reduce with error feedback over ``group`` (the reference's
    ``compressed_psum``): returns (averaged gradients, fp32, by name;
    ``err``), ``err`` (fp32, by name, each rank's own) overwritten in
    place with the new residual.

    The scale comes from the whole leaf; the leaf is then quantized and
    reduced in pieces of at most ``optimizer.PIECE`` elements, so the
    fp32 and int32 temporaries stay one piece big (the bits are those of
    one piece: every step is elementwise or exact).  The collectives run
    on the tensors' device, whatever the backend (gloo takes CUDA
    tensors in ``all_reduce``)."""
    world = dist.get_world_size(group)
    out: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        e = err[name]
        amax = torch.stack([torch.max(torch.abs(gp.float() + ep))
                            for gp, ep in zip(pieces(g), pieces(e))]).max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        g_hat = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        for gp, ep, hp in zip(pieces(g), pieces(e), pieces(g_hat)):
            g32 = gp.float() + ep
            q = torch.clamp(torch.round(g32 / scale), -127, 127)
            # the residual exact (q * scale is exact in fp64, and so is
            # the difference), rounded once: the bits of the jitted
            # reference, whose XLA fuses it into a multiply-add
            ep.copy_(q.double().mul_(scale.double()).neg_().add_(g32))
            q_sum = q.to(torch.int32)
            dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
            torch.div(q_sum.float() * scale, world, out=hp)
        out[name] = g_hat
    return out, err


def init_error_feedback(params: Mapping[str, torch.Tensor],
                        ) -> Dict[str, torch.Tensor]:
    """Zero fp32 residuals, by parameter name, on the parameters' device."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def payload_bytes(leaves: Iterable[Tuple[int, int]], compress: bool) -> int:
    """Bytes a rank puts into a step's gradient all-reduce, for leaves of
    (elements, bytes an element): the gradients in their own dtype, or,
    compressed, 4 bytes an element (the int32 sum) and one fp32 scale a
    leaf (the max)."""
    if compress:
        return sum(4 * n + 4 for n, _ in leaves)
    return sum(n * size for n, size in leaves)


def compression_ratio(params: Mapping[str, torch.Tensor]) -> float:
    """The reference's figure, int8 against bf16 (scales amortized): 0.5.
    The int32 sum actually sends 4 bytes an element."""
    return 0.5
