"""Offline chunk-KV builder: prefill every datastore chunk once with the
port's own ``transformer.prefill``, page its per-layer K/V (chunk-local
RoPE), and write one ``.npz`` artifact that ``ChunkKVStore.load`` reads,
in the reference's format (``tools/build_chunk_kv.py`` writes the same).

    PYTHONPATH=src python -m repro_torch.launch.build_chunk_kv \\
        --out experiments/chunk_kv.npz --docs 64 --page-size 4 --seed 3

The model is the arch's reduced preset with random fp32 weights drawn
from ``--seed`` (a ``torch.Generator``; the reference draws its own from
``jax.random``, so the two artifacts hold the same tokens and page
geometry but different K/V).  Chunk tokens are a pure function of
``(seed, doc_id)``.  ``--clusters N`` attaches the doc -> cluster map
``doc % N`` so lookahead prefetch can resolve predicted clusters to
chunk pages.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.chunk_kv import build_chunk_kv
from repro_torch.models import transformer as tf


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--arch", default="llama3-8b",
                    help="arch name (reduced preset is used)")
    ap.add_argument("--docs", type=int, default=64,
                    help="build chunks for doc ids [0, N)")
    ap.add_argument("--page-size", type=int, default=4,
                    help="KV page size in tokens (must match the serve "
                         "slab's page_size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=24)
    ap.add_argument("--clusters", type=int, default=0,
                    help="attach doc->cluster map over this many IVF "
                         "clusters (0 = unmapped)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = tf.init_params(cfg, gen, device=dev, dtype=torch.float32)
    cluster_of = ((lambda d: d % args.clusters) if args.clusters > 0
                  else None)
    store = build_chunk_kv(model, range(args.docs),
                           page_size=args.page_size, seed=args.seed,
                           min_len=args.min_len, max_len=args.max_len,
                           cluster_of=cluster_of)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    store.save(args.out)
    print(f"chunk-KV store: {len(store)} docs, {store.total_pages()} pages "
          f"of {args.page_size} tokens -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
