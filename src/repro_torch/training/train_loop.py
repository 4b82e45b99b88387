"""Train steps (the reference's ``training/train_loop.py``), with autograd
in place of ``jax.value_and_grad`` and the update in place:

* ``make_train_step``: the reference's SPMD step on one device;
* ``make_manual_dp_train_step``: its explicit-collective data-parallel
  step over a ``torch.distributed`` process group: each rank's slice of
  the global batch, then an all-reduce of the gradients, averaged or
  int8-compressed with error feedback (``distributed/compression.py``);
* ``make_tp_train_step``: the program the reference's partitioner makes
  of ``make_train_step`` under ``RULES_DEFAULT`` or ``RULES_FSDP`` on a
  ("data", "model") or ("pod", "data", "model") mesh: a rank's model
  blocks (``tensor_parallel.shard_model``; under FSDP split over
  ``data`` too, gathered a layer at a time in each microbatch, as the
  reference re-gathers FSDP weights per microbatch) and its moments'
  blocks (``shard_opt_state``), its rows of each microbatch, the loss
  and token counts of the global batch, the gradients summed over
  ``data``, the norm over the whole tree.

The reference's ``act_spec`` (a GSPMD sharding constraint on the saved
residual stream) changes nothing on one device; under tensor
parallelism it is ``forward``'s ``act_spec``: the residual saved at each
remat group's boundary is the rank's ``d / model`` columns.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import compression as comp
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state,
                                            sharded_global_norm)

Batch = Mapping[str, torch.Tensor]


def check_trainable(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a decoder the port implements
    (``transformer.check_supported``): every family that serves also
    trains, as the reference trains every registered arch."""
    tf.check_supported(cfg)


def make_loss_fn(cfg: ArchConfig, *, attn_chunk: int = 1024,
                 remat: bool = True, remat_group: int = 4,
                 loss_chunk: int = 512) -> Callable:
    """(model, batch) -> (loss, {"ce", "aux", "tokens"}) for ``cfg``:
    ``batch`` holds "tokens" and "labels" [B, S] (an audio model's [B, S,
    codebooks]), optionally "loss_mask" [B, S] and a vision model's
    "image_embeds" [B, P, e]."""
    check_trainable(cfg)

    def loss_fn(model: tf.Transformer, batch: Batch):
        return tf.loss_fn(model, batch, attn_chunk=attn_chunk, remat=remat,
                          remat_group=remat_group, loss_chunk=loss_chunk)
    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    attn_chunk: int = 1024, remat: bool = True,
                    remat_group: int = 4, loss_chunk: int = 512,
                    accum_steps: int = 1) -> Callable:
    """Train step: (model, opt_state, batch) -> (model, opt_state,
    metrics), the model's parameters and the state updated in place.

    ``accum_steps > 1`` splits the batch into that many microbatches
    (every entry, image embeddings too, along its first dim), one
    backward each, and scales the summed
    gradients, loss, ce and aux by 1/accum_steps (tokens stay summed), as
    the reference's scan does: activation memory scales 1/accum.  Metrics
    are fp32 scalars on the device: loss, ce, aux, tokens, lr, grad_norm.
    """
    loss_fn = make_loss_fn(cfg, attn_chunk=attn_chunk, remat=remat,
                           remat_group=remat_group, loss_chunk=loss_chunk)

    def train_step(model: tf.Transformer, opt_state: Dict[str, object],
                   batch: Batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum_steps <= 1:
            loss, aux = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum_steps
            loss, aux = 0.0, {"ce": 0.0, "aux": 0.0, "tokens": 0.0}
            for i in range(accum_steps):
                l, a = loss_fn(model, {k: v[i * mb:(i + 1) * mb]
                                       for k, v in batch.items()})
                l.backward()
                loss = loss + l.detach()
                aux = {k: aux[k] + a[k].detach() for k in aux}
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for p in params.values():
                    p.grad.mul_(inv)
            loss = loss * inv
            aux = {"ce": aux["ce"] * inv, "aux": aux["aux"] * inv,
                   "tokens": aux["tokens"]}
        grads = {n: p.grad for n, p in params.items()}
        _, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **{k: v.detach() for k, v in aux.items()},
                   **om}
        return model, opt_state, metrics

    return train_step


def tp_rows(B: int, i: int, accum: int, data: int, shard: int) -> slice:
    """Shard ``shard`` of ``data``'s rows of microbatch ``i`` of ``accum``
    over a global batch of ``B``: the reference's microbatch is global
    rows [i mb, (i+1) mb) (mb = B / accum), split over ``data`` as its
    batch sharding splits them."""
    if B % accum or (B // accum) % data:
        raise ValueError(f"a batch of {B} rows does not split into {accum} "
                         f"microbatches over {data} data shards")
    mb = B // accum
    n = mb // data
    return slice(i * mb + shard * n, i * mb + (shard + 1) * n)


def make_tp_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                       attn_chunk: int = 1024, remat: bool = True,
                       remat_group: int = 4, act_spec: bool = False,
                       loss_chunk: int = 512, accum_steps: int = 1,
                       ) -> Callable:
    """The tensor-parallel train step of a rank: (model, opt_state,
    batch, tp) -> (model, opt_state, metrics), the rank's parameter and
    moment blocks updated in place.

    ``model`` is the rank's ``shard_model`` (trainable), ``opt_state``
    its moments' blocks (``init_opt_state`` of its parameters, or
    ``shard_opt_state``), ``tp`` its ``TPGroup`` (with the ``data``
    axis's group where the mesh has one) or a ``MetaTPGroup``, and
    ``batch`` the GLOBAL batch on every rank: microbatch i is the
    reference's (global rows [i mb, (i+1) mb)), of which this data shard
    runs its ``tp_rows``.  Each microbatch's loss is the global one
    (``loss_fn``'s ``tp``: token counts summed over ``data``; an MoE
    layer's groups and aux loss over the whole microbatch), its
    backward the rank's share; the gradients are summed over
    microbatches and scaled by 1/accum_steps as the reference's scan,
    summed over ``data`` (an FSDP block's by its gather's backward, a
    reduce-scatter; the rest all-reduced), and clipped by the whole
    tree's norm (``sharded_global_norm``: each block's squares summed
    over the axes that split it, replicated parameters counted once).
    ``act_spec`` as ``forward``'s.  Metrics as ``make_train_step``'s,
    the same on every rank."""
    check_trainable(cfg)
    kw = dict(attn_chunk=attn_chunk, remat=remat, remat_group=remat_group,
              loss_chunk=loss_chunk, act_spec=act_spec)

    def train_step(model: tf.Transformer, opt_state: Dict[str, object],
                   batch: Batch, tp):
        for p in model.parameters():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        loss, aux = 0.0, {"ce": 0.0, "aux": 0.0, "tokens": 0.0}
        for i in range(accum_steps):
            rows = tp_rows(B, i, accum_steps, tp.data_size, tp.data_rank)
            l, a = tp_microbatch(model, {k: v[rows] for k, v in batch.items()},
                                 tp, **kw)
            loss = loss + l
            aux = {k: aux[k] + a[k] for k in aux}
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            loss = loss * inv
            aux = {"ce": aux["ce"] * inv, "aux": aux["aux"] * inv,
                   "tokens": aux["tokens"]}
        opt_state, om = tp_update(model, opt_state, opt_cfg, tp, accum_steps)
        return model, opt_state, {"loss": loss, **aux, **om}

    return train_step


def tp_microbatch(model: tf.Transformer, rows: Batch, tp, **kw):
    """One microbatch of the tensor-parallel step: ``loss_fn`` of this
    data shard's ``rows`` with ``tp`` and its backward, the gradients
    added to the parameters' ``.grad``.  Returns the global loss and
    {"ce", "aux", "tokens"}, detached."""
    loss, aux = tf.loss_fn(model, rows, tp=tp, **kw)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def tp_update(model: tf.Transformer, opt_state: Dict[str, object],
              opt_cfg: OptConfig, tp, accum_steps: int = 1):
    """The tensor-parallel step's end: the summed gradients scaled by
    1/accum_steps and all-reduced over ``data`` where ``data`` does not
    split the parameter (an FSDP block's gradient arrives summed over
    ``data`` from its gather's backward), the whole tree's norm
    (``sharded_global_norm``) and AdamW on the rank's blocks.  Returns
    (opt_state, {"lr", "grad_norm"})."""
    params = dict(model.named_parameters())
    lay = model.tp_layout
    with torch.no_grad():
        for n, p in params.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if accum_steps > 1:
                p.grad.mul_(1.0 / accum_steps)
            if tp.data_size > 1 and lay.data_dim(n) is None:
                tp.all_reduce_sum(p.grad, "data")
    grads = {n: p.grad for n, p in params.items()}
    axes = {n: [a for a, d in (("model", lay.model_dim(n)),
                               ("data", lay.data_dim(n))) if d is not None]
            for n in params}
    norm = sharded_global_norm(grads, axes, tp.all_reduce_sum)
    _, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                    grad_norm=norm)
    return opt_state, om


def make_manual_dp_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                              compress: bool = False,
                              group: Optional[dist.ProcessGroup] = None,
                              attn_chunk: int = 1024,
                              remat: bool = True) -> Callable:
    """Pure data-parallel train step with an explicit all-reduce over
    ``group`` (the reference's ``make_manual_dp_train_step``): (model,
    opt_state, err, batch) -> (model, opt_state, err, {"loss", "lr",
    "grad_norm"}), the parameters, moments and ``err`` updated in place.

    Every rank holds the same parameters.  ``batch`` is the global
    batch; rank r trains on rows [r B/W, (r+1) B/W) of every entry, as
    the reference's ``in_specs`` ``P(axis)`` gives them (a batch W does
    not divide is refused).  The loss is ``make_loss_fn``'s defaults
    (loss chunk 512, remat groups of 4).  The gradients are averaged (an
    all-reduce SUM then / W, in their own dtype, as ``pmean``) or, with
    ``compress``, go through ``compressed_all_reduce`` (fp32 out; ``err``
    the rank's fp32 residuals, ``compression.init_error_feedback``;
    without ``compress`` it passes through).  The loss is averaged over
    the ranks; ``adamw_update`` takes the bf16 or fp32 gradients alike,
    computing in fp32 as the reference does."""
    loss_fn = make_loss_fn(cfg, attn_chunk=attn_chunk, remat=remat)

    def step(model: tf.Transformer, opt_state: Dict[str, object],
             err: Dict[str, torch.Tensor], batch: Batch):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        B = next(iter(batch.values())).shape[0]
        if B % world:
            raise ValueError(f"a batch of {B} rows does not shard over "
                             f"{world} ranks")
        b = B // world
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, _ = loss_fn(model, {k: v[rank * b:(rank + 1) * b]
                                  for k, v in batch.items()})
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if compress:
            grads, err = comp.compressed_all_reduce(grads, err, group)
        else:
            for g in grads.values():
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                g.div_(world)
        loss = loss.detach()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / world
        _, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        return model, opt_state, err, {"loss": loss, **om}

    return step


def init_training(cfg: ArchConfig, opt_cfg: OptConfig,
                  generator: torch.Generator, device: DeviceLike = "cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  ) -> Tuple[tf.Transformer, Dict[str, object]]:
    """A trainable ``init_params`` model (weights drawn from
    ``generator``, which must live on ``device``) and its zero
    optimizer state."""
    check_trainable(cfg)
    model = tf.init_params(cfg, generator, device=device,
                           dtype=dtype).set_trainable()
    return model, init_opt_state(dict(model.named_parameters()), opt_cfg)
