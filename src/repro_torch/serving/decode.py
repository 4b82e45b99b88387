"""The engine decode plumbing: one reusable decode hook for serve drivers,
tests and benchmarks.

``DecodeRunner`` runs a wave's real decode steps while its lookahead copy
is in flight: it leases a block table over a shared KV page slab
(``acquire_paged``), runs ``transformer.serve_step_paged`` per step —
which writes the new K/V through the block table and attends with the
``flash_decode_paged`` kernel — advances the lease (``append_paged``,
the ``kv.append`` trace edge), and returns one ``DecodeEvent`` per
member.  The lease is released in ``finally`` so a raising step cannot
leak slab pages or pool bytes.  Decode starts from token 0 with no
prefill, greedily.

Only the paged path is ported.  ``attach`` takes the engines and a
clock (the reference takes a server): the clock brackets the steps, so
a driver injects ``SystemClock`` for real measurement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.sampler import sample


@dataclass(frozen=True)
class DecodeEvent:
    """What the decode hook observed for one request in one round:
    ``tokens`` real steps run in ``seconds`` of measured wall clock."""

    request_id: int
    tokens: int
    seconds: float

    def window(self, gen_tokens: int) -> float:
        """Seconds for a ``gen_tokens``-step window at the observed rate."""
        if self.tokens <= 0:
            return 0.0
        return float(self.seconds) * (gen_tokens / self.tokens)


def supports_paged_decode(cfg: ArchConfig) -> bool:
    """True iff the arch can decode through block-table KV (plain
    global-causal GQA attention)."""
    try:
        tf.check_supported(cfg)
    except ValueError:
        return False
    return True


class DecodeRunner:
    """Reusable ``decode_hook(replica, records, gen_tokens, rnd)``:
    per-wave paged KV lease + real model decode steps.

    Construct with the model, then ``attach(engines, clock)`` to build
    one pool-backed ``KVCacheManager`` per replica engine.  ``records``
    are any objects with ``request_id`` and ``tenant``."""

    def __init__(self, model: tf.Transformer, *, max_len: int = 128,
                 max_steps: int = 32, page_size: int = 16,
                 slab_seqs: int = 16, kv_dtype: torch.dtype = torch.bfloat16):
        """``slab_seqs`` sizes the paged KV slab: page slots for that many
        concurrent ``max_len`` sequences, stored in ``kv_dtype`` (bf16,
        as the reference's slab, whatever the weights' dtype)."""
        if not supports_paged_decode(model.cfg):
            raise ValueError(f"arch {model.cfg.name!r} cannot decode paged")
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.max_steps = max_steps
        self.page_size = page_size
        self.slab_seqs = slab_seqs
        self.kv_dtype = kv_dtype
        self.clock = None                      # attach() sets it
        self._kv: Dict[int, KVCacheManager] = {}
        # per-request generated tokens, per round
        self.generated: Dict[int, List[Tuple[int, ...]]] = {}
        self.stats = {"paged_waves": 0, "paged_appends": 0}

    def attach(self, engines: Sequence, clock) -> "DecodeRunner":
        """One KV manager (with its page slab) per replica engine, each
        charged to that engine's pool; ``clock.perf()`` times the steps."""
        self.clock = clock
        blocks = -(-self.max_len // self.page_size)
        for r, eng in enumerate(engines):
            kv = KVCacheManager(self.cfg, self.kv_dtype, pool=eng.pool,
                                device=self.model.device)
            kv.init_paged(num_pages=self.slab_seqs * blocks,
                          page_size=self.page_size)
            self._kv[r] = kv
        return self

    def __call__(self, replica: int, records, gen_tokens: Sequence[int],
                 rnd: int) -> List[DecodeEvent]:
        """Decode this wave for real: ``min(max(gen_tokens), max_steps)``
        tokens for the whole batch on leased KV, measured on the clock.
        Returns one ``DecodeEvent`` per member."""
        if self.clock is None:
            raise RuntimeError("DecodeRunner.attach(engines, clock) before "
                               "decoding")
        n = len(records)
        steps = min(max(gen_tokens, default=0), self.max_steps)
        toks, per_step = self._run_paged(self._kv[replica], n, steps,
                                         records[0].tenant)
        for j, r in enumerate(records):
            self.generated.setdefault(r.request_id, []).append(
                tuple(int(t[j]) for t in toks))
        return [DecodeEvent(request_id=r.request_id,
                            tokens=min(g, steps) if g else 0,
                            seconds=per_step * (min(g, steps) if g else 0))
                for r, g in zip(records, gen_tokens)]

    def _run_paged(self, kv: KVCacheManager, n: int, steps: int, tenant: str):
        """acquire_paged -> (serve_step_paged + append_paged) per step ->
        release_paged.  ``PoolExhausted`` from the acquire propagates.
        Tokens stay on the device between steps; the one host sync is the
        final read of the generated tokens."""
        self.stats["paged_waves"] += 1
        lease = kv.acquire_paged(n, self.max_len, tenant=tenant)
        dev = self.model.device
        try:
            bt, lens = lease.device_tables(dev)
            tok = torch.zeros((n,), dtype=torch.int32, device=dev)
            out: List[torch.Tensor] = []
            t0 = self.clock.perf()
            for _ in range(steps):
                logits, _, _ = tf.serve_step_paged(
                    self.model, kv.slab.k, kv.slab.v, bt, lens, {"token": tok})
                kv.append_paged(lease)
                lens += 1
                self.stats["paged_appends"] += 1
                tok = sample(logits)
                out.append(tok)
            toks = torch.stack(out).cpu().tolist() if out else []
            per_step = (self.clock.perf() - t0) / max(steps, 1)
        finally:
            kv.release_paged(lease)
        return toks, per_step
