"""Device residency manager for precomputed chunk-KV pages.

The port's copy of the reference's ``serving/chunk_kv.py``.
``ChunkKVCache`` sits beside ``KVCacheManager`` over the *same* KV page
slab and the *same* ``DevicePagePool``: loading a chunk pops page slots
from the slab free list, writes the chunk's precomputed K/V into them
host-to-device (``slab.k[:, slots]``, cast to the slab dtype, in place),
and charges the bytes to the pool under owner ``"chunk_kv"``
(tenant-attributed, so telemetry can say whose chunks sit in HBM).

Residency is **refcounted**.  A wave that splices a chunk pins it for
the lease's lifetime (``pin`` = ``pool.retain``: the pool lease's
refcount guards the bytes, and pinned residency is protected from
spill); releasing the wave's ``PagedCacheLease`` unpins the chunk back
to *warm* residency — the pages stay loaded for the next wave that
wants the same document, they are not freed.  Only ``evict`` (LRU,
pressure-driven via ``evict_cold``, or teardown via ``drain``) returns
pages to the slab and bytes to the pool, and only at pin count zero —
evicting a pinned chunk would yank pages out from under a live block
table.

Misses (document not in the offline store, or no room even after
spilling cold residency) return None and the caller falls back to
ordinary prefill; ``backfill`` optionally prefills the chunk once and
inserts it into the store so the next wave hits.

Every transition emits a ``ChunkKVEvent`` (``chunk.load`` /
``chunk.pin`` / ``chunk.unpin`` / ``chunk.evict``) on the pool's
recorder lane; the invariant checker conserves pages per (replica,
doc), rejects pin-before-load (the splice-before-land race) and
evict-while-pinned, and requires drained traces to end with zero
residency.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.data.chunk_kv import ChunkKV, ChunkKVStore, build_chunk
from repro_torch.memory.pool import PageLease
from repro_torch.obs.recorder import ChunkKVEvent
from repro_torch.serving.kv_cache import KVCacheManager


@dataclass
class ChunkResidency:
    """One document's chunk-KV pages on device: the slab page slots
    holding its K/V, the live token count, the pool lease charging the
    bytes (owner ``"chunk_kv"``), and the pin count (>0 = spliced into
    at least one live block table; protected from eviction)."""

    doc_id: int
    slots: Tuple[int, ...]
    length: int
    lease: Optional[PageLease] = None
    pins: int = 0
    last_used: int = 0


@dataclass
class ChunkKVStats:
    """Chunk-KV effectiveness counters (telemetry / bench report)."""

    hits: int = 0                      # docs spliced from resident pages
    misses: int = 0                    # docs that fell back to prefill
    loads: int = 0                     # H2D chunk loads (incl. prefetch)
    evictions: int = 0
    spliced_pages: int = 0             # pages attached by block-table edit
    prefetched_pages: int = 0          # pages landed by lookahead prefetch
    prefill_tokens_avoided: int = 0    # chunk tokens NOT re-prefilled
    backfills: int = 0                 # miss-path prefills inserted to store

    def as_dict(self) -> Dict[str, float]:
        """Counters plus the derived ``hit_rate`` (hits over hits+misses;
        0.0 before any splice attempt) — the telemetry/report payload."""
        d = dict(vars(self))
        total = self.hits + self.misses
        d["hit_rate"] = self.hits / total if total else 0.0
        return d


class ChunkKVCache:
    """Refcounted device residency for one replica's chunk-KV pages,
    sharing the replica's KV page slab and ``DevicePagePool``."""

    def __init__(self, kv: KVCacheManager,
                 store: Optional[ChunkKVStore] = None):
        slab = kv.slab
        if slab is None:
            raise RuntimeError("ChunkKVCache needs a paged KVCacheManager: "
                               "call init_paged() first")
        if store is not None and store.page_size != slab.page_size:
            raise ValueError(
                f"store page_size {store.page_size} != slab page_size "
                f"{slab.page_size}: chunk pages must match slab geometry")
        self.kv = kv
        self.store = store if store is not None else ChunkKVStore(
            page_size=slab.page_size)
        self.resident: Dict[int, ChunkResidency] = {}
        self.stats = ChunkKVStats()
        self._clock = 0                # LRU tick (per-replica, monotone)

    # -- tracing -------------------------------------------------------------
    def _emit(self, kind: str, doc_id: int, pages: int, nbytes: int,
              pinned: int, tenant: str) -> None:
        pool = self.kv.pool
        rec = pool.recorder if pool is not None else None
        if rec is not None:
            rec.emit(ChunkKVEvent(t=rec.now, kind=kind,
                                  replica=pool.replica_id, tenant=tenant,
                                  doc_id=doc_id, pages=pages, nbytes=nbytes,
                                  pinned=pinned))

    # -- residency -----------------------------------------------------------
    def load(self, doc_id: int, *, tenant: str = "shared",
             prefetch: bool = False) -> Optional[ChunkResidency]:
        """Land one document's chunk-KV pages on device (no-op if
        already resident).  Returns None on a store miss or when
        neither the slab free list nor the pool can fit the pages even
        after evicting cold residency — the caller falls back to
        prefill.  ``prefetch=True`` attributes the load to lookahead
        (counted separately; residency is identical)."""
        doc_id = int(doc_id)
        res = self.resident.get(doc_id)
        if res is not None:
            self._clock += 1
            res.last_used = self._clock
            return res
        chunk = self.store.get(doc_id)
        if chunk is None:
            return None
        slab = self.kv.slab
        npg = chunk.num_pages
        if len(slab.free) < npg:
            self.evict_cold(npg - len(slab.free))
        if len(slab.free) < npg:
            return None
        nbytes = npg * self.kv.paged_page_nbytes()
        lease = None
        pool = self.kv.pool
        if pool is not None:
            lease = pool.lease_bytes(nbytes, "chunk_kv",
                                     tag=("chunk", doc_id), tenant=tenant)
            if lease is None:
                need = -(-nbytes // pool.page_nbytes)
                self.evict_cold(pages_hint=need)
                lease = pool.lease_bytes(nbytes, "chunk_kv",
                                         tag=("chunk", doc_id), tenant=tenant)
            if lease is None:
                return None
        slots = tuple(slab.free.pop() for _ in range(npg))
        idx = torch.tensor(slots, device=slab.k.device)
        slab.k[:, idx] = torch.from_numpy(chunk.k).to(slab.k.device,
                                                      slab.k.dtype)
        slab.v[:, idx] = torch.from_numpy(chunk.v).to(slab.v.device,
                                                      slab.v.dtype)
        self._clock += 1
        res = ChunkResidency(doc_id=doc_id, slots=slots, length=chunk.length,
                             lease=lease, last_used=self._clock)
        self.resident[doc_id] = res
        self.stats.loads += 1
        if prefetch:
            self.stats.prefetched_pages += npg
        self._emit("chunk.load", doc_id, npg, nbytes, 0, tenant)
        return res

    def pin(self, doc_id: int) -> ChunkResidency:
        """Pin resident pages for a lease's lifetime (``pool.retain`` —
        no pool event; the bytes were charged at load).  Pinned
        residency is never evicted/spilled."""
        res = self.resident.get(int(doc_id))
        if res is None:
            raise KeyError(f"chunk {doc_id} not resident: load before pin")
        res.pins += 1
        self._clock += 1
        res.last_used = self._clock
        if res.lease is not None and self.kv.pool is not None:
            self.kv.pool.retain(res.lease)
        self._emit("chunk.pin", res.doc_id, len(res.slots), 0, res.pins,
                   res.lease.tenant if res.lease else "shared")
        return res

    def unpin(self, doc_id: int) -> None:
        """Release one pin back to *warm* residency (pages stay loaded;
        the paired ``pool.release`` only decrements the refcount — bytes
        return to the pool at evict, not here)."""
        res = self.resident.get(int(doc_id))
        if res is None or res.pins <= 0:
            raise ValueError(f"chunk {doc_id} is not pinned")
        res.pins -= 1
        if res.lease is not None and self.kv.pool is not None:
            self.kv.pool.release(res.lease)
        self._emit("chunk.unpin", res.doc_id, len(res.slots), 0, res.pins,
                   res.lease.tenant if res.lease else "shared")

    def evict(self, doc_id: int) -> int:
        """Return one cold (unpinned) chunk's pages to the slab and its
        bytes to the pool; returns pages freed."""
        res = self.resident.get(int(doc_id))
        if res is None:
            return 0
        if res.pins > 0:
            raise ValueError(f"chunk {doc_id} is pinned ({res.pins}); "
                             "evicting would orphan a live block table")
        del self.resident[res.doc_id]
        self.kv.slab.free.extend(int(s) for s in res.slots)
        nbytes = 0
        tenant = "shared"
        if res.lease is not None and self.kv.pool is not None:
            nbytes, tenant = res.lease.nbytes, res.lease.tenant
            self.kv.pool.release(res.lease)
        self.stats.evictions += 1
        self._emit("chunk.evict", res.doc_id, len(res.slots), nbytes, 0,
                   tenant)
        return len(res.slots)

    def evict_cold(self, pages_hint: int = 0) -> int:
        """Evict unpinned residency, LRU-first, until ``pages_hint``
        slab pages are freed (0 = evict all cold).  The engine's spill
        chain calls this under pool pressure — pinned chunks are
        protected exactly like in-flight prefetch pages."""
        freed = 0
        cold = sorted((r for r in self.resident.values() if r.pins == 0),
                      key=lambda r: r.last_used)
        for res in cold:
            if pages_hint and freed >= pages_hint:
                break
            freed += self.evict(res.doc_id)
        return freed

    def drain(self) -> int:
        """Teardown: evict everything (all pins must be released)."""
        pinned = [d for d, r in self.resident.items() if r.pins > 0]
        if pinned:
            raise RuntimeError(f"drain with pinned chunks: {pinned}")
        return self.evict_cold(0)

    # -- splice front door ---------------------------------------------------
    def acquire_rows(self, row_docs: Sequence[Sequence[int]], *,
                     tenant: str = "shared",
                     ) -> Tuple[List[List[Tuple[Tuple[int, ...], int]]],
                                List[int], List[List[int]]]:
        """Resolve each row's retrieved doc ids to spliceable pages:
        load + pin every hit, count every miss.  Returns ``(row_chunks,
        pinned, row_misses)`` — ``row_chunks`` feeds
        ``KVCacheManager.splice_paged`` directly, ``pinned`` is the doc
        list to ``unpin`` when the lease is released, ``row_misses``
        lists each row's fallback docs (prefill path / ``backfill``)."""
        row_chunks: List[List[Tuple[Tuple[int, ...], int]]] = []
        pinned: List[int] = []
        row_misses: List[List[int]] = []
        for docs in row_docs:
            chunks: List[Tuple[Tuple[int, ...], int]] = []
            misses: List[int] = []
            for d in docs:
                res = self.load(int(d), tenant=tenant)
                if res is None:
                    self.stats.misses += 1
                    misses.append(int(d))
                    continue
                self.pin(res.doc_id)
                pinned.append(res.doc_id)
                chunks.append((res.slots, res.length))
                self.stats.hits += 1
                self.stats.spliced_pages += len(res.slots)
                self.stats.prefill_tokens_avoided += res.length
            row_chunks.append(chunks)
            row_misses.append(misses)
        return row_chunks, pinned, row_misses

    def release_rows(self, pinned: Sequence[int]) -> None:
        """Unpin every chunk a released lease had spliced (back to warm
        residency — the mirror of ``acquire_rows``)."""
        for d in pinned:
            self.unpin(d)

    def backfill(self, doc_id: int, model, *, seed: Optional[int] = None,
                 min_len: int = 8, max_len: int = 24) -> Optional[ChunkKV]:
        """Miss path: prefill the chunk once NOW with ``model`` (a
        ``models.transformer.Transformer``) and insert it into the (host)
        store so the next wave hits.  Returns the built chunk (None if it
        was already in the store)."""
        doc_id = int(doc_id)
        if doc_id in self.store:
            return None
        chunk = build_chunk(model, doc_id,
                            page_size=self.store.page_size,
                            seed=self.store.seed if seed is None else seed,
                            min_len=min_len, max_len=max_len)
        self.store.add(doc_id, chunk)
        self.stats.backfills += 1
        return chunk

    # -- lookahead prefetch --------------------------------------------------
    def prefetch_clusters(self, clusters: Sequence[int], *,
                          tenant: str = "shared",
                          budget_pages: int = 0) -> int:
        """Lookahead integration: land the predicted clusters' chunk
        pages H2D during generation so the next round's splice hits
        warm residency.  ``budget_pages`` caps the burst (0 = no cap);
        returns pages landed.  Loads are cold (unpinned) — the same
        slack/demotion rules that drop a prefetch ticket simply skip
        this call, and pool pressure can evict them again."""
        landed = 0
        for c in clusters:
            for d in self.store.docs_in_cluster(int(c)):
                if d in self.resident:
                    continue
                if budget_pages and landed >= budget_pages:
                    return landed
                res = self.load(d, tenant=tenant, prefetch=True)
                if res is None:
                    return landed      # out of room — stop the burst
                landed += len(res.slots)
        return landed

    # -- introspection -------------------------------------------------------
    def resident_pages(self) -> int:
        """Slab pages held by chunk residency (warm + pinned)."""
        return sum(len(r.slots) for r in self.resident.values())

    def pinned_pages(self) -> int:
        """Slab pages held by chunks currently spliced into a live
        block table (protected from spill/evict)."""
        return sum(len(r.slots) for r in self.resident.values() if r.pins)
