"""Dry run of every (arch x shape x mesh) cell on H100 meshes: does the
cell fit one card's memory under its sharding rules, and what bounds it
(the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell with XLA and reads
``memory_analysis()`` and its HLO.  The port has no compiler to ask, so
each cell is planned from shapes and traced on meta tensors
(``op_cost``; nothing is allocated or launched):

  * argument bytes a card are EXACT: the ``sharding.spec_for`` block of
    every parameter, AdamW moment (bf16 past 100e9 parameters, the
    reference's ``default_opt_cfg``), cache and batch tensor under the
    cell's rules, as the reference's ``input_specs`` shards them;
  * temporaries a card are an ESTIMATE: the ``op_cost`` peak, less the
    arguments, of one card's batch shard (the global batch over
    ``data`` x ``pod``), traced at ``model`` = 1 and divided by the
    ``model`` size; a train step's gradients, whole in that trace, count
    as the card's block of them, sharded as its parameters.  The port
    has no tensor-parallel program to trace;
  * FLOPs and bytes are global, traced at the global batch;
  * collectives: the data-parallel gradient all-reduce of a train step
    (``roofline.py``), at datasheet link bandwidths.

A training cell runs the reference's step: ``make_loss_fn`` (remat in
groups of ``remat_group`` = 1, attention chunks of 1024) over ``accum``
microbatches (16 past 100e9 parameters, else 4; a card runs min(accum,
its rows) microbatches), then ``adamw_update``.  Every microbatch does
the same work, so a trace runs one (from live gradients when there are
more) and counts it that many times.  A prefill cell halves its batch
until it fits 80 GB, recorded as ``wave_batch`` / ``num_waves``.

Results are cached as JSON under experiments/dryrun_h100/<mesh>/, so
the sweep resumes.  Meta traces take CPU time that grows with the
shape's chunk count (minutes for a full-width train_4k or prefill_32k
cell).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPE_SUITES, ShapeSuite, get_shape
from repro_torch.core.budget import H100
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (make_production_mesh, mesh_chip_count,
                                     mesh_name)
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_loop import make_loss_fn

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_h100")

ASSIGNED_ARCHS = (
    "gemma2-27b", "minicpm3-4b", "granite-20b", "nemotron-4-15b",
    "granite-moe-3b-a800m", "arctic-480b", "rwkv6-3b", "zamba2-2.7b",
    "internvl2-1b", "musicgen-large",
)

TEMP_NOTE = ("estimate: the op_cost peak less the arguments of one card's "
             "batch shard traced at model = 1, divided by the model size; "
             "gradients as the card's block of them")
ACT_SKIP = ("act_mode sets or drops act_spec (activation sharding inside "
            "the layers), which waits for tensor parallelism")

# (shape, dtype, spec) of one argument tensor
Leaf = Tuple[Tuple[int, ...], torch.dtype, shd.Spec]


# ---------------------------------------------------------------------------
# Sharding-rule selection per cell
# ---------------------------------------------------------------------------


def rules_for(cfg: ArchConfig, suite: ShapeSuite, mesh,
              override: Optional[str] = None,
              hbm_bytes: float = H100.hbm_bytes) -> shd.Rules:
    """The reference's rule choice, with its "does not fit under TP"
    threshold at half of ``hbm_bytes`` (40e9 on an H100; the reference's
    8e9 is half a v5e)."""
    if override:
        return getattr(shd, f"RULES_{override.upper()}")
    model_size = shd._sizes(mesh).get("model", 1)
    if suite.entry == "train_step":
        return shd.RULES_FSDP                      # 2-D weight sharding
    if suite.name == "long_500k":
        return shd.RULES_FSDP_LONG
    tp_bytes = cfg.param_count() * 2 / model_size
    needs_fsdp = tp_bytes > hbm_bytes / 2
    kv_shardable = (cfg.num_kv_heads > 0
                    and cfg.num_kv_heads % model_size == 0)
    long_ctx = not kv_shardable
    if needs_fsdp:
        return shd.RULES_FSDP_LONG if long_ctx else shd.RULES_FSDP
    return shd.RULES_LONG_CONTEXT if long_ctx else shd.RULES_DEFAULT


def default_opt_cfg(cfg: ArchConfig) -> OptConfig:
    """bf16 moments for very large models, as the reference's."""
    return OptConfig(moment_dtype="bfloat16" if cfg.param_count() > 100e9
                     else "float32")


# ---------------------------------------------------------------------------
# Input specs and the bytes a card holds
# ---------------------------------------------------------------------------


def batch_spec(mesh, rules: shd.Rules, ndim: int, batch: int) -> shd.Spec:
    """[batch, ...] over the rules' batch axes, trailing axes dropped
    until the batch divides (long_500k has B = 1): the reference's
    ``_batch_first``."""
    sizes = shd._sizes(mesh)
    axes = tuple(a for a in shd._entry_axes(rules["batch"]) if a in sizes)
    while axes and batch % math.prod(sizes[a] for a in axes):
        axes = axes[:-1]
    return (axes if len(axes) > 1 else axes[0],) if axes else ()


def input_specs(cfg: ArchConfig, suite: ShapeSuite, mesh, rules: shd.Rules,
                *, opt_cfg: Optional[OptConfig] = None,
                kv_quant: bool = False) -> Dict[str, Dict[str, Leaf]]:
    """Every entry-point input as (shape, dtype, spec), by group:
    "params", and "opt_state" + "batch" (train), "inputs" (prefill and
    serve), "cache" (serve), as the reference's ``input_specs``."""
    B, S = suite.global_batch, suite.seq_len
    pshapes = tf.param_shapes(cfg)
    pspecs = shd.tree_shardings(tf.param_axes(cfg), pshapes, mesh, rules)
    out = {"params": {n: (s, torch.bfloat16, pspecs[n])
                      for n, s in pshapes.items()}}
    fe = cfg.frontend
    nc = tf.codebooks(cfg)
    vlm = fe is not None and fe.kind == "vit_stub"
    bsh = lambda shape, dt: (shape, dt, batch_spec(mesh, rules, len(shape), B))

    if suite.entry in ("train_step", "prefill"):
        tok = (B, S, nc) if nc else (B, S - fe.num_prefix_embeddings) \
            if vlm else (B, S)
        group = {"tokens": bsh(tok, torch.int32)}
        if suite.entry == "train_step":
            group["labels"] = bsh(tok, torch.int32)
        if vlm:
            group["image_embeds"] = bsh((B, fe.num_prefix_embeddings,
                                         fe.embed_dim), torch.bfloat16)
        if suite.entry == "prefill":
            out["inputs"] = group
            return out
        opt_cfg = opt_cfg or default_opt_cfg(cfg)
        mdt = (torch.bfloat16 if opt_cfg.moment_dtype == "bfloat16"
               else torch.float32)
        out["opt_state"] = {f"{k}.{n}": (s, mdt, pspecs[n])
                            for k in ("m", "v") for n, s in pshapes.items()}
        out["opt_state"]["step"] = ((), torch.int32, ())
        out["batch"] = group
        return out

    cshapes = tf.cache_shapes(cfg, B, S, kv_quant=kv_quant)
    cspecs = shd.tree_shardings(tf.cache_axes(cfg, kv_quant),
                                {n: s for n, (s, _) in cshapes.items()},
                                mesh, rules)
    out["cache"] = {n: (s, dt, cspecs[n]) for n, (s, dt) in cshapes.items()}
    out["inputs"] = {"token": bsh((B, nc) if nc else (B,), torch.int32),
                     "pos": bsh((B,), torch.int32)}
    return out


def local_shape(shape, spec: shd.Spec, mesh) -> Tuple[int, ...]:
    """The block of ``shape`` a card holds under ``spec``."""
    sizes = shd._sizes(mesh)
    dims = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in shd._entry_axes(entry))
        dims[d] //= n
    return tuple(dims)


def local_bytes(group: Mapping[str, Leaf], mesh) -> int:
    """Bytes a card holds of a group of inputs."""
    return sum(math.prod(local_shape(s, spec, mesh)) * dt.itemsize
               for s, dt, spec in group.values())


def argument_bytes(specs: Mapping[str, Mapping[str, Leaf]], mesh
                   ) -> Dict[str, int]:
    """Bytes a card holds, by input group."""
    return {g: local_bytes(group, mesh) for g, group in specs.items()}


def dp_collectives(specs, mesh) -> Dict[str, float]:
    """Bytes a card all-reduces a training step, by the axes crossed: its
    bf16 gradient block over ``pod`` x ``data``, uncompressed
    (``compression.payload_bytes``)."""
    sizes = shd._sizes(mesh)
    axes = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    if not axes:
        return {}
    blocks = [(math.prod(local_shape(s, spec, mesh)), dt.itemsize)
              for s, dt, spec in specs["params"].values()]
    return {"+".join(axes): float(compression.payload_bytes(blocks, False))}


# ---------------------------------------------------------------------------
# Meta traces
# ---------------------------------------------------------------------------


def _meta_inputs(group: Mapping[str, Leaf], batch: int) -> Dict[str, Any]:
    """Meta tensors of a batch-first group at ``batch`` rows."""
    return {n: torch.empty((batch,) + tuple(s[1:]), dtype=dt, device="meta")
            for n, (s, dt, _) in group.items()}


def _trace(fn, args) -> Dict[str, float]:
    """op_cost of fn(*args), with the traced arguments' bytes."""
    counter = op_cost.OpCounter()
    counter.track(args)
    held, known = counter.live, {}
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            known[id(t.untyped_storage())] = 0
    with counter:
        out = fn(*args)
    for t in tree_flatten(out)[0]:     # new storages returned
        if isinstance(t, torch.Tensor):
            known.setdefault(id(t.untyped_storage()),
                             t.untyped_storage().nbytes())
    ret = sum(known.values())
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak_bytes": counter.peak, "args_bytes": held,
            "out_bytes": float(ret)}


def _train_trace(cfg: ArchConfig, opt_cfg: OptConfig, batch: Dict[str, Any],
                 accum: int, kw: Dict[str, int]) -> Dict[str, float]:
    """The train step on ``batch``: min(accum, rows) microbatches of
    loss and backward, then AdamW.  Every microbatch does the same work,
    so one is traced and counted that many times; past the first, the
    gradients are live from its start, so with more than one the traced
    microbatch starts from live gradients (its peak is the step's)."""
    model = op_cost.meta_model(cfg, trainable=True)
    params = dict(model.named_parameters())
    state = init_opt_state(params, opt_cfg)
    loss_fn = make_loss_fn(cfg, **kw)
    B = next(iter(batch.values())).shape[0]
    mb = max(B // accum, 1)
    n = B // mb
    counter = op_cost.OpCounter()
    counter.track((model, state, batch))
    held = counter.live
    with counter:
        if n > 1:
            for p in params.values():
                p.grad = torch.zeros_like(p)
        loss, _ = loss_fn(model, {k: v[:mb] for k, v in batch.items()})
        loss.backward()
        del loss
        f_mb, b_mb = counter.flops, counter.bytes
        adamw_update(params, {k: p.grad for k, p in params.items()}, state,
                     opt_cfg)
    return {"flops": counter.flops + (n - 1) * f_mb,
            "bytes": counter.bytes + (n - 1) * b_mb,
            "peak_bytes": counter.peak, "args_bytes": held, "out_bytes": 0.0,
            "microbatches": n}


def trace_cell(cfg: ArchConfig, suite: ShapeSuite, specs, batch: int, *,
               opt_cfg: OptConfig, accum: int, kv_quant: bool,
               attn_chunk: int, loss_chunk: int, remat_group: int,
               ) -> Dict[str, float]:
    """The cell's entry point traced on meta tensors at ``batch`` rows,
    the whole model on one card (``model`` = 1)."""
    if suite.entry == "train_step":
        return _train_trace(cfg, opt_cfg, _meta_inputs(specs["batch"], batch),
                            accum, dict(attn_chunk=attn_chunk, remat=True,
                                        remat_group=remat_group,
                                        loss_chunk=loss_chunk))
    model = op_cost.meta_model(cfg)
    inputs = _meta_inputs(specs["inputs"], batch)
    with torch.no_grad():
        if suite.entry == "prefill":
            return _trace(lambda m, i: tf.prefill(m, i, attn_chunk=attn_chunk),
                          (model, inputs))
        cache = {n: torch.empty(s, dtype=dt, device="meta") for n, (s, dt) in
                 tf.cache_shapes(cfg, batch, suite.seq_len,
                                 kv_quant=kv_quant).items()}
        return _trace(lambda m, c, i: tf.serve_step(m, c, i,
                                                    kv_quant=kv_quant),
                      (model, cache, inputs))


def temp_bytes(card: Mapping[str, float], specs, args: Mapping[str, int],
               model_size: int) -> float:
    """A card's temporaries (an estimate): the trace's peak less its
    arguments, over ``model_size``; a train step's gradients, which the
    trace holds whole, count as a card's block of them (sharded as its
    parameters, bf16 as they are) instead."""
    extra = card["peak_bytes"] - card["args_bytes"]
    if "opt_state" not in specs:
        return max(extra, 0.0) / model_size
    whole = sum(math.prod(s) * dt.itemsize
                for s, dt, _ in specs["params"].values())
    return max(extra - whole, 0.0) / model_size + args["params"]


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def apply_variant(cfg: ArchConfig, variant: Mapping[str, Any]) -> ArchConfig:
    """The hillclimb knobs that change the config, as the reference's
    ``lower_cell`` applies them: ``moe_group`` and ``split_cache``."""
    if variant.get("moe_group") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=variant["moe_group"]))
    if variant.get("split_cache") is False:
        cfg = dataclasses.replace(cfg, sliding_window=None,
                                  local_global_pattern=False)
    return cfg


def dry_run_cell(arch: str, shape: str, *, multi_pod: bool = False,
                 rules_override: Optional[str] = None,
                 variant: Optional[Dict[str, Any]] = None,
                 verbose: bool = True, mesh=None,
                 cfg: Optional[ArchConfig] = None,
                 suite: Optional[ShapeSuite] = None,
                 attn_chunk: int = 1024, loss_chunk: int = 512,
                 remat_group: int = 1) -> Dict[str, Any]:
    """One cell's plan (the counterpart of the reference's
    ``compile_cell``): the reference's keys, ``fits_80gb`` for
    ``fits_16gb``.  ``mesh`` (a ``MeshAxes``), ``cfg`` and ``suite``
    override the production mesh, the registered config and shape
    (tests, ``chip_smoke.py``'s prediction of its own runs); ``variant``
    takes the hillclimb knobs (``accum``, ``moe_group``, ``split_cache``,
    ``kv_quant``, ``rules``, ``moment_bf16``; ``act_mode`` is refused as
    skipped)."""
    variant = dict(variant or {})
    cfg = apply_variant(cfg or get_arch(arch), variant)
    suite = suite or get_shape(shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mname = mesh_name(multi_pod)
    else:
        mname = "h100x" + "x".join(str(s) for s in mesh.shape)
    rules_override = variant.get("rules") or rules_override
    res: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mname,
                           "rules": rules_override or "auto",
                           "variant": variant}
    skip = suite.skip_reason(cfg) or (ACT_SKIP if "act_mode" in variant
                                      else None)
    if skip:
        res["status"] = "skipped"
        res["skip_reason"] = skip
        return res
    chips = mesh_chip_count(mesh)
    model_size = shd._sizes(mesh).get("model", 1)
    opt_cfg = (OptConfig(moment_dtype="bfloat16") if variant.get("moment_bf16")
               else default_opt_cfg(cfg))
    accum = variant.get("accum", 16 if cfg.param_count() > 100e9 else 4)
    kv_quant = bool(variant.get("kv_quant"))
    kw = dict(opt_cfg=opt_cfg, accum=accum, kv_quant=kv_quant,
              attn_chunk=attn_chunk, loss_chunk=loss_chunk,
              remat_group=remat_group)
    try:
        eff, waves = suite, 1
        while True:
            rules = rules_for(cfg, eff, mesh, rules_override)
            specs = input_specs(cfg, eff, mesh, rules, opt_cfg=opt_cfg,
                                kv_quant=kv_quant)
            args = argument_bytes(specs, mesh)
            group = specs["batch" if eff.entry == "train_step" else "inputs"]
            first = next(iter(group.values()))
            b = local_shape(first[0], first[2], mesh)[0]
            t0 = time.time()
            card = trace_cell(cfg, eff, specs, b, **kw)
            t_card = time.time() - t0
            temp = temp_bytes(card, specs, args, model_size)
            peak = sum(args.values()) + temp
            if (peak < H100.hbm_bytes or eff.entry != "prefill"
                    or eff.global_batch <= 1):
                break
            waves *= 2
            eff = dataclasses.replace(eff, global_batch=eff.global_batch // 2)
        t0 = time.time()
        glob = card if b == eff.global_batch else trace_cell(
            cfg, eff, specs, eff.global_batch, **kw)
        t_glob = time.time() - t0
        coll = dp_collectives(specs, mesh) if eff.entry == "train_step" \
            else {}
        report = rl.build_report(
            arch=arch, shape=shape, mesh_name=mname, chips=chips,
            cost={"flops": glob["flops"] * waves, "bytes": glob["bytes"] * waves},
            model_flops=rl.model_flops_for(cfg, suite.entry, suite.seq_len,
                                           suite.global_batch),
            coll_by_axis=coll, peak_memory=peak,
            tp_collectives=rl.NO_TP if model_size > 1 else "")
        arg_total = sum(args.values())
        alias = (args["params"] + args.get("opt_state", 0)
                 if eff.entry == "train_step" else args.get("cache", 0))
        res.update({
            "status": "ok",
            "wave_batch": eff.global_batch,
            "num_waves": waves,
            "card_batch": b,
            "rules_used": [k for k in ("DEFAULT", "LONG_CONTEXT", "FSDP",
                                       "FSDP_LONG")
                           if getattr(shd, f"RULES_{k}") == rules][0],
            "microbatches": card.get("microbatches", 1),
            "t_lower_s": t_card,           # the card-shard trace
            "t_compile_s": t_glob,         # the global trace
            "memory": {
                "argument_bytes": arg_total,
                "argument_bytes_by_group": args,
                "output_bytes": card["out_bytes"] / model_size,
                "temp_bytes": temp,
                "alias_bytes": alias,
                "peak_bytes": peak,
                "fits_80gb": peak < H100.hbm_bytes,
                "temp_is": TEMP_NOTE,
            },
            "roofline": report.row(),
        })
        if verbose:
            print(f"[{mname}] {arch} × {shape}: OK (traces {t_card:.1f}s + "
                  f"{t_glob:.1f}s, peak {peak / 1e9:.2f} GB/card, "
                  f"bottleneck={report.bottleneck})", flush=True)
    except Exception as e:  # noqa: BLE001 — failures are cell bugs, recorded
        res["status"] = "failed"
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{mname}] {arch} × {shape}: FAILED {res['error']}",
                  flush=True)
    return res


# ---------------------------------------------------------------------------
# Sweep driver (resumable)
# ---------------------------------------------------------------------------


def cell_path(out_dir: str, arch: str, shape: str, mname: str) -> str:
    return os.path.join(out_dir, mname, f"{arch}__{shape}.json")


def run_sweep(archs, shapes, *, multi_pod: bool, out_dir: str,
              force: bool = False, rules_override: Optional[str] = None):
    mname = mesh_name(multi_pod)
    os.makedirs(os.path.join(out_dir, mname), exist_ok=True)
    for arch in archs:
        for shape in shapes:
            path = cell_path(out_dir, arch, shape, mname)
            if os.path.exists(path) and not force:
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[{mname}] {arch} × {shape}: cached "
                          f"({prev['status']})")
                    continue
            res = dry_run_cell(arch, shape, multi_pod=multi_pod,
                               rules_override=rules_override)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(res, f, indent=1, default=str)
            os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--rules", default=None,
                    help="override rule set (default/fsdp/long_context/fsdp_long)")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPE_SUITES]
    meshes = []
    if args.both_meshes or (not args.multi_pod and not args.single_pod):
        meshes = [False, True] if args.all or args.both_meshes else [False]
    if args.single_pod:
        meshes.append(False)
    if args.multi_pod:
        meshes.append(True)
    for mp in meshes:
        run_sweep(archs, shapes, multi_pod=mp, out_dir=args.out,
                  force=args.force, rules_override=args.rules)


if __name__ == "__main__":
    main()
