#!/usr/bin/env python
"""Where granite-moe-3b-a800m's training step holds its card memory, at
the shape ``chip_smoke.py``'s phase 8 trains it, beside the dry run's
prediction at that shape.  It found what made the step peak 10.3 GB
above its meta trace: phase 8's recorder of each MoE layer's routing
kept the gates with their autograd graph, and with it the recompute's
activations (PERF.md, Findings).

Usage (an NVIDIA card; no kernel is built):
        python3 tools/moe_memory.py
"""

from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _live_at_peak(snap: dict, base: int) -> tuple:
    """From a memory-history snapshot: (the peak of allocated bytes over
    the recorded trace, ``base`` held when recording began included;
    the allocations live at that peak made during the trace, as (bytes,
    frames))."""
    trace = snap["device_traces"][0]
    cur, peak, at = base, base, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            cur += ev["size"]
        elif ev["action"] == "free_completed":
            cur -= ev["size"]
        if cur > peak:
            peak, at = cur, i
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    return peak, list(live.values())


def _site(frames: list) -> str:
    """Where an allocation was made: the innermost frames in the port
    (file:line function), else the innermost frame."""
    mine = [f"{Path(f['filename']).name}:{f['line']} {f['name']}" for f in frames
            if "repro_torch" in f["filename"]]
    if mine:
        return " < ".join(mine[:3])
    return (f"{frames[0]['filename']}:{frames[0]['line']} {frames[0]['name']}"
            if frames else "(no frames)")


def main() -> None:
    """Where granite-moe-3b's phase-8 training holds its memory: the
    family_train step (full depth, bf16, the moments launch/train picks,
    phase 8's TRAIN_BATCH x TRAIN_SEQ tokens, attention chunks of 256,
    loss chunks of 128, remat), one step to warm; then one step each with ``moe.route``
    wrapped as phase 8's recorder once was (each layer's gates kept with
    their graph) and as it is (kept detached), each step's
    ``max_memory_allocated``; then one step with no recorder under
    ``torch.cuda.memory._record_memory_history``: its peak, the
    allocations live at it grouped by the port's frames that made them
    (largest first), beside the dry run's prediction at the same shape;
    then all of it as one JSON line."""
    cs.need_card()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import moment_dtype
    from repro_torch.models import moe
    from repro_torch.training import (OptConfig, init_training,
                                      make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card_line()
    arch = "granite-moe-3b-a800m"
    cfg = get_arch(arch)
    moments = moment_dtype(cfg, torch.device("cuda"))
    opt = OptConfig(warmup_steps=1, total_steps=cs.FAMILY_TRAIN_STEPS,
                    moment_dtype=moments)
    model, state = init_training(cfg, opt,
                                 torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    step = make_train_step(cfg, opt, attn_chunk=min(256, cs.TRAIN_SEQ),
                           loss_chunk=128)
    model, state, _ = step(model, state, batch)
    real = moe.route
    peaks = {}
    for how in ("gates kept with their graph", "gates kept detached"):
        routes = []

        def record(router, x, c, *tp):
            r = real(router, x, c, *tp)
            routes.append((r.experts, r.weights if "graph" in how
                           else r.weights.detach(), r.slot))
            return r
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moe.route = record
        try:
            model, state, _ = step(model, state, batch)
        finally:
            moe.route = real
        torch.cuda.synchronize()
        peaks[how] = (torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_allocated())
        del routes
        gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    model, state, _ = step(model, state, batch)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_meas = torch.cuda.max_memory_allocated()
    peak, live = _live_at_peak(snap, base)
    groups = {}
    for size, frames in live:
        key = _site(frames)
        n, b = groups.get(key, (0, 0))
        groups[key] = (n + 1, b + size)
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])
    d = dryrun.dry_run_cell(
        arch, "phase8", mesh=MeshAxes(("data", "model"), (1, 1)), cfg=cfg,
        suite=ShapeSuite("phase8", "train_step", cs.TRAIN_SEQ, cs.TRAIN_BATCH),
        attn_chunk=min(256, cs.TRAIN_SEQ), loss_chunk=128, remat_group=4,
        variant={"accum": 1, "moment_bf16": moments == "bfloat16"},
        verbose=False)
    for how, (pk, after) in peaks.items():
        cs.phase("memory", f"{arch} ({cfg.num_layers} layers, {moments} "
                 f"moments, {cs.TRAIN_BATCH} x {cs.TRAIN_SEQ} tokens), a step "
                 f"with each MoE layer's routing recorded, {how}: peak "
                 f"{pk / 1e9:.3f} GB (max_memory_allocated), {after / 1e9:.3f} "
                 f"GB held after the step with the records alive; on {smi}")
    cs.phase("memory", f"{arch}, a step with no recorder: held at its start "
             f"{base / 1e9:.3f} GB (weights, moments, the last step's "
             f"gradients), peak {peak_meas / 1e9:.3f} GB (max_memory_allocated; "
             f"the trace's own {peak / 1e9:.3f}), allocated during the step and "
             f"live at the peak {sum(s for s, _ in live) / 1e9:.3f} GB in "
             f"{len(live)} blocks; the dry run's peak "
             f"{d['memory']['peak_bytes'] / 1e9:.3f} GB (arguments "
             f"{d['memory']['argument_bytes'] / 1e9:.3f}); on {smi}")
    for key, (n, b) in top[:12]:
        cs.phase("memory", f"  {b / 1e9:8.3f} GB in {n:5d} blocks  {key}")
    print(smi)
    print(json.dumps({
        "recorded_steps": {k: list(v) for k, v in peaks.items()},
        "base": base, "peak": peak_meas, "trace_peak": peak,
        "dry_run": d["memory"], "groups": [[k, n, b] for k, (n, b) in top]}))


if __name__ == "__main__":
    main()
