"""The engine decode plumbing behind ``on_generate``: one reusable decode
hook for serve drivers, tests and benchmarks.

``DecodeRunner`` is the real-decode hook the serving front-end wires as
each runtime's ``on_generate``: at every round frontier it runs a wave's
real decode steps while its lookahead copy is in flight, and returns
one ``DecodeEvent`` per member, whose measured seconds drive the event
clock.  Decode starts from token 0 with no prefill, greedily.

By default (``EngineConfig.paged_decode=True``) the wave's KV is a block
table over a shared KV page slab (``acquire_paged``); each step runs
``transformer.serve_step_paged`` — which writes the new K/V through the
block table and attends with the ``flash_decode_paged`` kernel — and
advances the lease (``append_paged``, the ``kv.append`` trace edge).
``paged_decode=False`` takes the dense path: one ``[B, max_len]`` bucket
(``acquire``), and ``transformer.serve_step`` per step, which attends
with the ``flash_decode`` kernel.  Both paths release in ``finally``, so
a raising step cannot leak slab pages or pool bytes, and tenant-tag the
lease.  ``PoolExhausted`` from either acquire propagates: the
``RetrievalRuntime`` sheds and parks on it.

Chunk-KV splicing (``EngineConfig.chunk_kv`` with a ``chunk_store``, on
the paged path): each row's documents from its previous retrieval round
(at most ``chunk_kv_docs``) are loaded and pinned from precomputed pages
(``ChunkKVCache.acquire_rows``) and spliced into the fresh lease ahead of
its own pages (``splice_paged``); the wave then decodes through
``transformer.serve_step_paged_spliced`` (the ``flash_decode_spliced``
kernel), and the pins go back to warm residency in the same ``finally``
that frees the lease.

``attach(server)`` adopts the server's wall clock (launch drivers inject
``SystemClock``; the library default is the deterministic event clock)
and the first engine's ``paged_decode`` and chunk-KV settings, and builds
one KV manager per replica engine, and one ``ChunkKVCache`` beside it
when splicing is on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.chunk_kv import ChunkKVStore
from repro_torch.models import transformer as tf
from repro_torch.serving.chunk_kv import ChunkKVCache
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.runtime import DecodeEvent
from repro_torch.serving.sampler import sample


def supports_paged_decode(cfg: ArchConfig) -> bool:
    """True iff the arch can decode through block-table KV: plain
    global-causal GQA attention (the ``init_paged`` /
    ``serve_step_paged`` restriction), the reference's rule —
    sliding-window, split-cache, MLA and SSM families stay dense."""
    return (tf.family_kind(cfg) == "attn" and cfg.has_attention
            and cfg.attn_kind == "gqa" and not cfg.local_global_pattern
            and not cfg.sliding_window)


class DecodeRunner:
    """Reusable ``decode_hook(replica, records, gen_tokens, rnd)``:
    per-wave KV lease + real model decode steps, paged by default.

    Construct with the model, pass as the server's ``decode_hook``, then
    ``attach(server)`` to build one pool-backed ``KVCacheManager`` per
    replica engine and take the path from the engine's
    ``paged_decode``.  ``records`` are any objects with ``request_id``
    and ``tenant`` (and ``result.doc_ids`` when chunk-KV splicing is on)."""

    def __init__(self, model: tf.Transformer, *, max_len: int = 128,
                 max_steps: int = 32, page_size: int = 16,
                 slab_seqs: int = 16, kv_dtype: torch.dtype = torch.bfloat16,
                 chunk_store: Optional[ChunkKVStore] = None):
        """``slab_seqs`` sizes the paged KV slab: page slots for that many
        concurrent ``max_len`` sequences (chunk residency shares it).  KV
        (slab or dense buckets) is stored in ``kv_dtype`` (bf16, as the
        reference's, whatever the weights' dtype).  ``chunk_store`` is
        the offline-built chunk-KV corpus (``data.chunk_kv``): when given
        and the engine enables ``chunk_kv``, each wave's previous-round
        documents are spliced in from precomputed pages."""
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.max_steps = max_steps
        self.page_size = page_size
        self.slab_seqs = slab_seqs
        self.kv_dtype = kv_dtype
        self.chunk_store = chunk_store
        self.chunk_docs = 0                    # attach() takes the engine's
        self.paged = True                      # attach() takes the engine's
        self.clock = None                      # attach() adopts server.wall
        self._kv: Dict[int, KVCacheManager] = {}
        self._chunk: Dict[int, ChunkKVCache] = {}
        # per-request generated tokens, per round
        self.generated: Dict[int, List[Tuple[int, ...]]] = {}
        self.stats = {"paged_waves": 0, "dense_waves": 0,
                      "paged_appends": 0, "dense_steps": 0,
                      "spliced_waves": 0}

    def attach(self, server) -> "DecodeRunner":
        """Bind to a constructed ``TeleRAGServer`` (or anything with its
        ``wall`` and ``engines``): paged when the first engine's
        ``paged_decode`` asks for it and ``supports_paged_decode`` holds
        for the arch, else dense; one KV manager per replica engine (paged mode
        also allocates its slab), each charged to that engine's pool, and
        ``server.wall.perf()`` to time the steps.  With the engine's
        ``chunk_kv`` on, a paged path and a ``chunk_store``, each replica
        also gets a ``ChunkKVCache`` over its slab, set as the engine's
        ``chunk_kv`` too (its spill chain and lookahead prefetch reach
        chunk residency through it)."""
        self.clock = server.wall
        eng0 = server.engines[0]
        # paged where the engine asks for it and the arch can, as the
        # reference's attach ANDs the two
        self.paged = (bool(eng0.cfg.paged_decode)
                      and supports_paged_decode(self.cfg))
        want_chunk = (self.paged and eng0.cfg.chunk_kv
                      and self.chunk_store is not None)
        self.chunk_docs = eng0.cfg.chunk_kv_docs
        blocks = -(-self.max_len // self.page_size)
        for r, eng in enumerate(server.engines):
            kv = KVCacheManager(self.cfg, self.kv_dtype, pool=eng.pool,
                                device=self.model.device)
            if self.paged:
                kv.init_paged(num_pages=self.slab_seqs * blocks,
                              page_size=self.page_size)
            self._kv[r] = kv
            if want_chunk:
                self._chunk[r] = eng.chunk_kv = ChunkKVCache(
                    kv, self.chunk_store)
        return self

    def kv(self, replica: int = 0) -> KVCacheManager:
        """The replica's KV manager (``attach`` must have run)."""
        return self._kv[replica]

    def chunk(self, replica: int = 0) -> Optional[ChunkKVCache]:
        """The replica's chunk-KV residency cache (None when splicing is
        off on this runner)."""
        return self._chunk.get(replica)

    def __call__(self, replica: int, records, gen_tokens: Sequence[int],
                 rnd: int) -> List[DecodeEvent]:
        """Decode this wave for real: ``min(max(gen_tokens), max_steps)``
        tokens for the whole batch on leased KV, measured on the clock.
        Returns one ``DecodeEvent`` per member."""
        if self.clock is None:
            raise RuntimeError("DecodeRunner.attach(server) before serving")
        n = len(records)
        steps = min(max(gen_tokens, default=0), self.max_steps)
        kv, tenant = self._kv[replica], records[0].tenant
        if self.paged:
            chunk = self._chunk.get(replica)
            row_docs = None
            if chunk is not None:
                # each row's context: the docs its previous retrieval
                # round returned (round 0 has none yet)
                row_docs = [[int(d) for d in r.result.doc_ids[-1]]
                            [:self.chunk_docs] if r.result.doc_ids else []
                            for r in records]
            toks, per_step = self._run_paged(kv, n, steps, tenant,
                                             chunk=chunk, row_docs=row_docs)
        else:
            toks, per_step = self._run_dense(kv, n, steps, tenant)
        for j, r in enumerate(records):
            self.generated.setdefault(r.request_id, []).append(
                tuple(int(t[j]) for t in toks))
        return [DecodeEvent(request_id=r.request_id,
                            tokens=min(g, steps) if g else 0,
                            seconds=per_step * (min(g, steps) if g else 0))
                for r, g in zip(records, gen_tokens)]

    def _run_paged(self, kv: KVCacheManager, n: int, steps: int, tenant: str,
                   *, chunk: Optional[ChunkKVCache] = None,
                   row_docs: Optional[List[List[int]]] = None):
        """acquire_paged -> (serve_step_paged + append_paged) per step ->
        release_paged.  ``PoolExhausted`` from the acquire propagates.
        Tokens stay on the device between steps; the one host sync is the
        final read of the generated tokens.

        With a chunk cache and per-row doc ids, the docs' precomputed
        pages are loaded, pinned and spliced into the fresh lease before
        the first step, and every step runs ``serve_step_paged_spliced``;
        the pins go back to warm residency after the lease is released,
        in the same ``finally``."""
        self.stats["paged_waves"] += 1
        lease = kv.acquire_paged(n, self.max_len, tenant=tenant)
        dev = self.model.device
        pinned: List[int] = []
        try:
            if chunk is not None and row_docs and any(row_docs):
                row_chunks, pinned, _ = chunk.acquire_rows(row_docs,
                                                           tenant=tenant)
                if kv.splice_paged(lease, row_chunks):
                    self.stats["spliced_waves"] += 1
            if lease.spliced_pages:
                bt, lens, dl, vd = lease.device_splice_tables(dev)
                step = lambda tok: tf.serve_step_paged_spliced(
                    self.model, kv.slab.k, kv.slab.v, bt, lens, dl, vd,
                    {"token": tok})
            else:
                bt, lens = lease.device_tables(dev)
                step = lambda tok: tf.serve_step_paged(
                    self.model, kv.slab.k, kv.slab.v, bt, lens,
                    {"token": tok})
            tok = torch.zeros((n,), dtype=torch.int32, device=dev)
            out: List[torch.Tensor] = []
            t0 = self.clock.perf()
            for _ in range(steps):
                logits, _, _ = step(tok)
                kv.append_paged(lease)
                lens += 1
                self.stats["paged_appends"] += 1
                tok = sample(logits)
                out.append(tok)
            toks = torch.stack(out).cpu().tolist() if out else []
            per_step = (self.clock.perf() - t0) / max(steps, 1)
        finally:
            kv.release_paged(lease)
            if chunk is not None:
                chunk.release_rows(pinned)
        return toks, per_step

    def _run_dense(self, kv: KVCacheManager, n: int, steps: int, tenant: str):
        """One fresh dense [n, max_len] bucket: acquire (zeroed) ->
        serve_step per step at position t -> release.  ``PoolExhausted``
        from the acquire propagates.  Tokens and positions stay on the
        device between steps, as on the paged path."""
        self.stats["dense_waves"] += 1
        lease = kv.acquire(n, self.max_len, fresh=True, tenant=tenant)
        dev = self.model.device
        try:
            tok = torch.zeros((n,), dtype=torch.int32, device=dev)
            pos = torch.zeros((n,), dtype=torch.int32, device=dev)
            out: List[torch.Tensor] = []
            t0 = self.clock.perf()
            for _ in range(steps):
                logits, lease.cache = tf.serve_step(
                    self.model, lease.cache, {"token": tok, "pos": pos})
                pos += 1
                self.stats["dense_steps"] += 1
                tok = sample(logits)
                out.append(tok)
            toks = torch.stack(out).cpu().tolist() if out else []
            per_step = (self.clock.perf() - t0) / max(steps, 1)
        finally:
            kv.release(lease)
        return toks, per_step
