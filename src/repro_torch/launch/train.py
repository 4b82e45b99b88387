"""Training entry point: token stream -> train step -> checkpoints, on one
card (the reference's ``launch/train.py``).

Trains a preset of any registered arch (every family the port serves)
from random weights (a seeded ``torch.Generator`` on the device; nothing
is downloaded) on the synthetic ``TokenStream`` (an audio model's
codebook tokens, a vision model's fp32 image embeddings beside its
tokens), logs loss, learning rate, gradient norm and
tokens/s, checkpoints every ``--ckpt-every`` steps and at the end, and
resumes from the newest checkpoint in ``--ckpt-dir`` exactly: the
weights, the optimizer state and the data cursor, restored into the
live tensors in place.

The AdamW moments are fp32 unless bf16 weights, bf16 gradients and fp32
moments (12 bytes a parameter) would take more than 85% of the card's
memory; then they are bf16 (8 bytes a parameter).  So ``--preset full``
of Llama-3-8B (8.03 B parameters: 96 GB with fp32 moments) trains on
one 80 GB card with bf16 moments: 64 GB of state and a few GB of
activations.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --preset 100m --steps 300 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --preset full \\
      --steps 4 --batch 2 --seq 512 --warmup 1 --repeat-batch
  PYTHONPATH=src python -m repro_torch.launch.train --preset smoke \\
      --arch zamba2-2.7b --steps 4 --device cpu      # on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models.transformer import param_shapes
from repro_torch.training import (OptConfig, init_training, latest_step,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)


def preset_config(cfg: ArchConfig, preset: str) -> ArchConfig:
    """Scale an arch down to a runnable-size preset preserving its family
    (the reference's presets): ``full`` as is, ``100m`` 10 layers at
    d_model 640, ``smoke`` the arch's ``reduced()``."""
    if preset == "full":
        return cfg
    if preset == "100m":
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m", num_layers=10,
            d_model=640, num_heads=8, num_kv_heads=min(cfg.num_kv_heads, 8) or 0,
            head_dim=80 if cfg.attn_kind == "gqa" else None,
            d_ff=2560, vocab_size=32_000)
    if preset == "smoke":
        return cfg.reduced()
    raise KeyError(preset)


def param_count(cfg: ArchConfig) -> int:
    """The parameters the port builds for ``cfg`` (``param_shapes``):
    every family's own, zamba2's shared block and LoRA deltas and an
    audio model's per-codebook embeddings included."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def moment_dtype(cfg: ArchConfig, device: torch.device) -> str:
    """The AdamW moments' dtype: fp32, or bf16 on a card where bf16
    weights and gradients with fp32 moments would take more than 85% of
    its memory."""
    if device.type != "cuda":
        return "float32"
    n = param_count(cfg)
    total = torch.cuda.get_device_properties(device).total_memory
    return "float32" if n * (2 + 2 + 8) <= 0.85 * total else "bfloat16"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", default="100m",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warm-up steps (default: max(steps // 20, 5))")
    ap.add_argument("--repeat-batch", action="store_true",
                    help="train every step on one batch, the stream's "
                    "batch at the cursor (a check that the loss falls)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train per the arguments; returns the logged history (one dict a
    logged step: step, loss, lr, grad_norm, ms a step since the previous
    logged step, tokens/s since the start)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = preset_config(get_arch(args.arch), args.preset)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    moments = moment_dtype(cfg, dev)
    print(f"# arch={cfg.name} params={param_count(cfg) / 1e6:.1f}M "
          f"moments={moments} device={card}")
    warmup = max(args.steps // 20, 5) if args.warmup is None else args.warmup
    opt = OptConfig(lr=args.lr, warmup_steps=warmup, total_steps=args.steps,
                    moment_dtype=moments)
    data = TokenStream(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=0))
    model, opt_state = init_training(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)

    start, saved = 0, None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start, state = restore_checkpoint(      # into model, opt_state
            args.ckpt_dir, {"params": model, "opt": opt_state,
                            "data": data.cursor()})
        data.restore(state["data"])
        saved = start
        print(f"# resumed from step {start}")

    step_fn = make_train_step(cfg, opt, attn_chunk=min(256, args.seq),
                              loss_chunk=128, accum_steps=args.accum)
    history = []
    batch = None
    t0 = t_log = time.perf_counter()
    last = start
    for step in range(start, args.steps):
        if batch is None or not args.repeat_batch:
            cursor = data.cursor()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.next_batch().items()}
            if args.repeat_batch:       # the cursor stays: a resume repeats it
                data.restore(cursor)
        model, opt_state, m = step_fn(model, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            row = {"step": step + 1, "loss": float(m["loss"]),
                   "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"])}
            now = time.perf_counter()       # the float()s waited for the step
            row["ms"] = 1e3 * (now - t_log) / (step + 1 - last)
            row["tokens_per_s"] = (args.batch * args.seq * (step + 1 - start)
                                   / max(now - t0, 1e-9))
            t_log, last = now, step + 1
            print(f"step {row['step']:5d} loss {row['loss']:.4f} "
                  f"lr {row['lr']:.2e} gnorm {row['grad_norm']:.3f} "
                  f"ms {row['ms']:.1f} tok/s {row['tokens_per_s']:,.0f}")
            history.append(row)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            saved = step + 1
            save_checkpoint(args.ckpt_dir, saved,
                            {"params": model, "opt": opt_state,
                             "data": data.cursor()})
    # the last step, unless it is saved already (a second commit of one
    # step cannot rename over the first)
    if args.ckpt_dir and saved != args.steps:
        save_checkpoint(args.ckpt_dir, args.steps,
                        {"params": model, "opt": opt_state,
                         "data": data.cursor()})
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    print("# done")
    return history


if __name__ == "__main__":
    main()
