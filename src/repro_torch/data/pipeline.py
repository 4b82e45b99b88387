"""Deterministic synthetic token stream with exact-resume semantics: the
reference's ``data/pipeline.py``, numpy only.

Token batches are a pure function of (seed, step), so resuming from a
checkpoint cursor reproduces the byte-identical stream, and the same
seed gives the reference's batches: an audio model's codebook tokens
and labels [B, S, codebooks], a vision model's "image_embeds" [B, P, e]
(fp32 normal draws after the tokens'), from the reference's draws in
its order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    # markovian synthetic text: makes loss curves meaningful (learnable)
    order: int = 2


class TokenStream:
    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.step = 0
        rng = np.random.default_rng(data.seed ^ 0xC0FFEE)
        v = cfg.vocab_size
        # sparse-ish transition structure for learnability
        self._trans = rng.integers(0, v, size=(min(v, 4096), 8))

    # -- exact resume ---------------------------------------------------------
    def cursor(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.data.seed}

    def restore(self, cursor: Dict[str, int]) -> None:
        if cursor["seed"] != self.data.seed:
            raise ValueError(f"seed mismatch on resume: cursor "
                             f"{cursor['seed']}, stream {self.data.seed}")
        self.step = cursor["step"]

    # -- batches ---------------------------------------------------------------
    def _gen(self, step: int) -> Dict[str, np.ndarray]:
        d = self.data
        v = self.cfg.vocab_size
        fe = self.cfg.frontend
        rng = np.random.default_rng((d.seed << 20) ^ step)
        B, S = d.global_batch, d.seq_len
        nc = (fe.num_codebooks if fe is not None and fe.kind == "encodec_stub"
              else 0)
        shape = (B, S + 1, nc) if nc else (B, S + 1)
        toks = rng.integers(0, min(v, 4096), size=shape)
        # markov smoothing: next token drawn from cur's transition row
        pick = rng.integers(0, 8, size=shape)
        if nc:
            for c in range(nc):
                toks[:, 1:, c] = self._trans[toks[:, :-1, c] % len(self._trans),
                                             pick[:, 1:, c]]
        else:
            toks[:, 1:] = self._trans[toks[:, :-1] % len(self._trans),
                                      pick[:, 1:]]
        toks = toks.astype(np.int32) % v
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if fe is not None and fe.kind == "vit_stub":
            batch["image_embeds"] = rng.standard_normal(
                (B, fe.num_prefix_embeddings, fe.embed_dim)).astype(np.float32)
        return batch

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self._gen(self.step)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
