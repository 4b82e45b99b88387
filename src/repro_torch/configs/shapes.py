"""Input-shape suites assigned to every architecture.

Each cell of the (arch × shape) matrix lowers a specific entry point:
  train_4k    -> train_step      (seq 4096, global batch 256)
  prefill_32k -> prefill         (seq 32768, global batch 32)
  decode_32k  -> serve_step      (1 new token, KV len 32768, batch 128)
  long_500k   -> serve_step      (1 new token, KV len 524288, batch 1;
                                  sub-quadratic archs only)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    entry: str          # "train_step" | "prefill" | "serve_step"
    seq_len: int
    global_batch: int

    def skip_reason(self, cfg: ArchConfig) -> Optional[str]:
        if self.name == "long_500k" and not cfg.subquadratic:
            return "skip:full-attn (long_500k requires sub-quadratic attention)"
        return None


TRAIN_4K = ShapeSuite("train_4k", "train_step", 4_096, 256)
PREFILL_32K = ShapeSuite("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSuite("decode_32k", "serve_step", 32_768, 128)
LONG_500K = ShapeSuite("long_500k", "serve_step", 524_288, 1)

SHAPE_SUITES: Tuple[ShapeSuite, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeSuite:
    for s in SHAPE_SUITES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape suite {name!r}; available: "
                   f"{[s.name for s in SHAPE_SUITES]}")
