"""KV cache manager for the serving engine.

Dense mode (``acquire``/``release``) allocates one decode cache per
(batch, max_len) bucket and recycles it across requests (stale K/V
entries are masked by per-sequence ``pos``; ``fresh=True`` zeroes it,
and a recurrent family's bucket, whose state no mask hides, is zeroed
whenever it is recycled).  A
recycled bucket keeps its pool lease (the bytes stay resident) until
``drop``/``drop_all``; ``acquire`` of a new bucket spills the manager's
own recycled buckets before raising ``PoolExhausted``.  A lease is
tenant-tagged, and a recycled bucket is re-attributed to whichever
tenant reuses it.

Paged mode (``init_paged``/``acquire_paged``) leases block tables over
one shared KV page slab: a ``PagedCacheLease`` is a [batch, max_blocks]
table of slab page slots plus per-sequence lengths — exactly the
operands ``kernels.ops.flash_decode_paged`` gathers through in place
(PagedAttention-style), so decode attention reads leased pages with no
contiguous copy and no [B, max_len] over-allocation.

When constructed over a ``DevicePagePool`` the manager is not a memory
island: every live lease charges its exact tensor bytes to the replica's
``MemoryLedger`` (category ``"kv"``, tenant-tagged) and takes page slots
out of the same pool the prefetch buffer draws from; an acquire the
slab or the pool cannot fit raises ``PoolExhausted``.

``splice_paged`` attaches precomputed chunk-KV pages (held by a
``serving.chunk_kv.ChunkKVCache``) to a fresh paged lease by block-table
edit, ahead of the lease's own pages, and records on the lease the
per-page RoPE offset and live-token count that
``transformer.serve_step_paged_spliced`` attends with.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.memory.pool import DevicePagePool, PageLease, PoolExhausted
from repro_torch.models import transformer as tf
from repro_torch.obs.recorder import KVEvent


@dataclass
class CacheLease:
    """One leased dense decode cache: the ``init_cache`` tensors plus the
    bucket shape, exact byte footprint, (pool-backed) page lease, and the
    tenant whose requests the decode state serves (``"shared"`` = the
    untenanted sentinel)."""

    cache: Dict[str, torch.Tensor]
    batch: int
    max_len: int
    nbytes: int = 0
    page_lease: Optional[PageLease] = None
    tenant: str = "shared"


class KVCacheManager:
    """Decode-cache allocator, dense (one cache per (batch, max_len)
    bucket, recycled across requests) or paged (block-table leases over
    one slab), whose leases are charged to the shared ``DevicePagePool``
    (category ``"kv"``) when a pool is given."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16, *,
                 pool: Optional[DevicePagePool] = None,
                 device: DeviceLike = "cuda",
                 kv_heads: Optional[int] = None):
        """``pool=None`` keeps the manager a standalone allocator (no
        ledger accounting, no admission pressure); the slab lives on
        ``device``.  ``kv_heads``: the KV heads one rank of a
        tensor-parallel group holds (``tensor_parallel.local_kv_heads``:
        KVH / model, or all of them where they do not split), so the slab
        and ``nbytes`` are that rank's; default all of them."""
        self.cfg = cfg
        self.kv_heads = kv_heads or cfg.num_kv_heads
        self.dtype = dtype
        self.pool = pool
        self.device = resolve_device(device)
        self._nbytes_memo: Dict[Tuple[int, int], int] = {}
        self._pool_buckets: Dict[Tuple[int, int],
                                 Tuple[Dict[str, torch.Tensor],
                                       Optional[PageLease]]] = {}
        self.slab: Optional["KVPageSlab"] = None   # init_paged() creates it

    def _record(self, kind: str, batch: int, max_len: int, nbytes: int,
                tenant: str, *, lease_id: int = -1, pages: int = 0,
                length: int = 0, recycled: bool = False) -> None:
        """Trace through the pool's recorder lane (KV state belongs to the
        pool's replica).  Paged lease edges carry ``lease_id``/``pages``
        and appends the post-write ``length``, so the invariant checker
        can conserve pages per lease and order acquire -> append ->
        release; dense edges carry ``recycled`` (acquire reused a
        released bucket), and ``kv.drop`` marks a recycled bucket's
        bytes returning to the pool, so bucket recycling stays
        conservation-exact too."""
        rec = self.pool.recorder if self.pool is not None else None
        if rec is not None:
            rec.emit(KVEvent(t=rec.now, kind=kind,
                             replica=self.pool.replica_id, tenant=tenant,
                             batch=batch, max_len=max_len, nbytes=nbytes,
                             lease_id=lease_id, pages=pages, length=length,
                             recycled=recycled))

    def acquire(self, batch: int, max_len: int, *, fresh: bool = False,
                tenant: str = "shared") -> CacheLease:
        """Lease a dense decode cache for ``batch`` sequences of
        ``max_len``: the recycled bucket when one is parked, else a fresh
        pool-backed allocation (raises ``PoolExhausted`` when the pool
        cannot fit it, after spilling this manager's recycled buckets).
        ``fresh=True`` zeroes a recycled cache, and a recycled RWKV6 or
        zamba2 cache is zeroed always, as the reference's: recurrent
        state must not leak across requests.  The bucket's pool lease
        carries ``tenant``, so the ledger's ``tenant:<name>`` bytes include
        KV; a recycled bucket is re-attributed to whoever reuses it."""
        key = (batch, max_len)
        nbytes = self.nbytes(batch, max_len)
        cache, page_lease = self._pool_buckets.pop(key, (None, None))
        recycled = cache is not None
        if cache is None:
            if self.pool is not None:
                page_lease = self.pool.lease_bytes(nbytes, "kv", tag=key,
                                                   tenant=tenant)
                if page_lease is None and self._pool_buckets:
                    # spill our own recycled buckets before giving up
                    self.drop_all()
                    page_lease = self.pool.lease_bytes(nbytes, "kv", tag=key,
                                                       tenant=tenant)
                if page_lease is None:
                    raise PoolExhausted(
                        f"kv cache {key} needs {nbytes} bytes; pool has "
                        f"{self.pool.reservable_pages()} reservable pages "
                        f"of {self.pool.page_nbytes} bytes",
                        bytes_needed=nbytes)
            try:
                cache = tf.init_cache(self.cfg, batch, max_len, self.dtype,
                                      device=self.device)
            except BaseException:
                # a failed allocation hands its pool pages back, or every
                # out-of-memory here would shrink the pool for good
                if page_lease is not None and self.pool is not None:
                    self.pool.release(page_lease)
                raise
        else:
            if (page_lease is not None and self.pool is not None
                    and page_lease.tenant != tenant):
                # the recycled bytes now serve another tenant
                self.pool.reattribute(page_lease, tenant)
            if fresh or tf.family_kind(self.cfg) != "attn":
                for t in cache.values():
                    t.zero_()
        self._record("kv.acquire", batch, max_len, nbytes, tenant,
                     recycled=recycled)
        return CacheLease(cache=cache, batch=batch, max_len=max_len,
                          nbytes=nbytes, page_lease=page_lease, tenant=tenant)

    def release(self, lease: CacheLease) -> None:
        """Park the bucket for recycling (its pool lease stays live: the
        bytes remain resident until ``drop``/``drop_all``).  When a
        same-shaped bucket is already parked, the incoming bucket's bytes
        go straight back to the pool (``kv.release`` then ``kv.drop``),
        or its pool lease would leak."""
        self._record("kv.release", lease.batch, lease.max_len, lease.nbytes,
                     lease.tenant)
        key = (lease.batch, lease.max_len)
        if key in self._pool_buckets:
            freed = lease.nbytes
            if lease.page_lease is not None and self.pool is not None:
                freed = lease.page_lease.nbytes
                self.pool.release(lease.page_lease)
            self._record("kv.drop", lease.batch, lease.max_len, freed,
                         lease.tenant)
            return
        self._pool_buckets[key] = (lease.cache, lease.page_lease)

    def drop(self, batch: int, max_len: int) -> int:
        """Free one recycled bucket back to the pool (``kv.drop``);
        returns its bytes (0 when none is parked)."""
        cache, page_lease = self._pool_buckets.pop((batch, max_len),
                                                   (None, None))
        if cache is None:
            return 0
        freed = self.nbytes(batch, max_len)
        tenant = "shared"
        if page_lease is not None and self.pool is not None:
            tenant = page_lease.tenant
            freed = page_lease.nbytes
            self.pool.release(page_lease)
        self._record("kv.drop", batch, max_len, freed, tenant)
        return freed

    def drop_all(self) -> int:
        """Free every recycled bucket (replica teardown, pressure spill)."""
        return sum(self.drop(batch, max_len)
                   for batch, max_len in list(self._pool_buckets))

    def nbytes(self, batch: int, max_len: int) -> int:
        """Exact tensor bytes of one dense (batch, max_len) bucket: the sum
        over the tensors ``init_cache`` makes (GQA k/v, gemma2's rings and
        global caches, MLA's latent cache, RWKV6's and zamba2's states
        and zamba2's shared-block K/V), the ledger's ``"kv"`` charge
        to the byte, as the reference's; drivers size the pool with it.
        Memoised per (batch, max_len)."""
        key = (batch, max_len)
        if key not in self._nbytes_memo:
            self._nbytes_memo[key] = sum(
                math.prod(shape) * torch.empty((), dtype=dt).element_size()
                for shape, dt in tf.cache_shapes(
                    self.cfg, batch, max_len, self.dtype,
                    kv_heads=self.kv_heads).values())
        return self._nbytes_memo[key]

    def init_paged(self, num_pages: int, page_size: int = 16) -> "KVPageSlab":
        """Allocate the manager's KV page slab: ``num_pages`` page slots
        of ``page_size`` tokens each, all layers stacked —
        k/v [L, num_pages, page_size, KVH, Dh].  GQA attention archs only."""
        if self.cfg.attn_kind != "gqa" or self.cfg.ssm is not None:
            raise ValueError("paged KV supports plain GQA attention caches "
                             f"only (attn_kind {self.cfg.attn_kind!r})")
        L = self.cfg.num_layers
        KVH, Dh = self.kv_heads, self.cfg.resolved_head_dim
        shape = (L, num_pages, page_size, KVH, Dh)
        self.slab = KVPageSlab(
            k=torch.zeros(shape, dtype=self.dtype, device=self.device),
            v=torch.zeros(shape, dtype=self.dtype, device=self.device),
            page_size=page_size, free=list(range(num_pages)))
        return self.slab

    def paged_page_nbytes(self) -> int:
        """Exact bytes of one KV page slot (k+v, all layers)."""
        slab = self._require_slab()
        L, _, ps, KVH, Dh = slab.k.shape
        return 2 * L * ps * KVH * Dh * slab.k.element_size()

    def acquire_paged(self, batch: int, max_len: int, *,
                      tenant: str = "shared") -> "PagedCacheLease":
        """Lease a block-table decode cache: ceil(max_len/page_size) slab
        pages per sequence, as a [batch, max_blocks] block table.  Bytes
        are charged to the pool ledger (category ``"kv"``, tenant-tagged);
        raises ``PoolExhausted`` when the slab's free list or the pool
        cannot cover it."""
        slab = self._require_slab()
        ps = slab.page_size
        max_blocks = -(-max_len // ps)
        need = batch * max_blocks
        if len(slab.free) < need:
            raise PoolExhausted(
                f"kv page slab exhausted: need {need} pages for "
                f"({batch}, {max_len}), {len(slab.free)} free")
        nbytes = need * self.paged_page_nbytes()
        page_lease = None
        if self.pool is not None:
            page_lease = self.pool.lease_bytes(nbytes, "kv",
                                               tag=(batch, max_len),
                                               tenant=tenant)
            if page_lease is None:
                raise PoolExhausted(
                    f"paged kv cache ({batch}, {max_len}) needs {nbytes} "
                    f"bytes; pool has {self.pool.reservable_pages()} "
                    f"reservable pages of {self.pool.page_nbytes} bytes",
                    bytes_needed=nbytes)
        slots = [slab.free.pop() for _ in range(need)]
        bt = np.asarray(slots, np.int32).reshape(batch, max_blocks)
        lease_id = next(_LEASE_IDS)
        self._record("kv.acquire", batch, max_len, nbytes, tenant,
                     lease_id=lease_id, pages=need)
        return PagedCacheLease(block_table=bt,
                               lengths=np.zeros(batch, np.int32),
                               batch=batch, max_len=max_len, nbytes=nbytes,
                               page_lease=page_lease, tenant=tenant,
                               lease_id=lease_id, owned_slots=tuple(slots))

    def append_paged(self, lease: "PagedCacheLease") -> None:
        """Advance the lease by one decode step — the accounting half of
        the write that ``transformer.serve_step_paged`` makes through the
        block table: bounds check, length advance, and the ``kv.append``
        trace edge."""
        if int(lease.lengths.max(initial=0)) >= lease.max_len:
            raise ValueError(f"paged lease full at max_len={lease.max_len}")
        lease.lengths += 1
        self._record("kv.append", lease.batch, lease.max_len, 0,
                     lease.tenant, lease_id=lease.lease_id,
                     pages=lease.block_table.size,
                     length=int(lease.lengths.max(initial=0)))

    def splice_paged(self, lease: "PagedCacheLease",
                     row_chunks: List[List[Tuple[Tuple[int, ...], int]]],
                     ) -> int:
        """Attach precomputed chunk-KV pages to a fresh paged lease by
        **block-table edit** (TurboRAG-style reuse; no copy).

        ``row_chunks[i]`` lists row ``i``'s chunks as ``(slots, length)``
        pairs: slab page slots already holding the chunk's K/V (written
        by ``ChunkKVCache.load``) and the chunk's token count.  Chunks
        splice at page boundaries, in order, AHEAD of the lease's own
        (fresh) pages: row ``i``'s table becomes ``[chunk pages..., fresh
        pages..., -1 padding]``, its length starts at the end of its
        spliced region (generation resumes at the next page boundary),
        and the lease's ``max_len`` grows by the widest spliced region so
        the append bounds check keeps holding.

        Per-page metadata for ``serve_step_paged_spliced`` lands on the
        lease: ``page_delta[i, blk]``, the RoPE rotation offset (the
        chunk's first layout position: its K was rotated chunk-locally,
        and rotations compose), and ``page_valid[i, blk]``, the live
        tokens on the page (< page_size only on a chunk's partial last
        page, 0 on -1 columns).

        The spliced slots are NOT added to ``owned_slots``: ownership
        (and the pool's ``chunk_kv`` byte charge) stays with the chunk
        residency, which the caller pins for the lease's lifetime.
        Emits ``kv.splice`` (pages = spliced page count, length = the
        post-splice max length).  Returns the spliced page count (0 =
        nothing to splice; the lease is untouched)."""
        slab = self._require_slab()
        ps = slab.page_size
        if len(row_chunks) != lease.batch:
            raise ValueError(f"row_chunks has {len(row_chunks)} rows for a "
                             f"batch-{lease.batch} lease")
        if int(lease.lengths.max(initial=0)) > 0:
            raise ValueError("splice_paged must run on a fresh lease "
                             "(before any append)")
        n_blocks = [sum(len(slots) for slots, _ in row) for row in row_chunks]
        total = sum(n_blocks)
        if total == 0:
            return 0
        lead = max(n_blocks)
        B, MB = lease.block_table.shape
        bt = np.full((B, lead + MB), -1, np.int32)
        delta = np.zeros((B, lead + MB), np.int32)
        valid = np.full((B, lead + MB), ps, np.int32)
        for i, row in enumerate(row_chunks):
            b0 = 0
            for slots, length in row:
                npg = len(slots)
                if length <= 0 or npg != -(-length // ps):
                    raise ValueError(
                        f"chunk of {length} tokens needs "
                        f"{-(-max(length, 1) // ps)} pages, got {npg}")
                bt[i, b0:b0 + npg] = slots
                # stored K is rotated at chunk-local positions p*ps + off;
                # its layout position is (b0 + p)*ps + off, so the page's
                # rotation offset is the constant b0*ps
                delta[i, b0:b0 + npg] = b0 * ps
                valid[i, b0 + npg - 1] = length - (npg - 1) * ps
                b0 += npg
            bt[i, b0:b0 + MB] = lease.block_table[i]
        valid[bt < 0] = 0                  # padding columns attend nothing
        lease.block_table = bt
        lease.lengths = np.asarray([n * ps for n in n_blocks], np.int32)
        lease.page_delta = delta
        lease.page_valid = valid
        lease.spliced_pages = total
        lease.max_len = lead * ps + lease.max_len
        self._record("kv.splice", lease.batch, lease.max_len,
                     total * self.paged_page_nbytes(), lease.tenant,
                     lease_id=lease.lease_id, pages=total,
                     length=int(lease.lengths.max(initial=0)))
        return total

    def release_paged(self, lease: "PagedCacheLease") -> int:
        """Return the lease's **owned** slab pages to the free list and
        release its pool bytes; returns bytes freed.  Spliced chunk-KV
        pages in its table are not owned: they stay with the
        ``ChunkKVCache`` residency (the splicer unpins them)."""
        slab = self._require_slab()
        slab.free.extend(int(s) for s in lease.owned_slots)
        pages = len(lease.owned_slots)
        lease.owned_slots = ()
        lease.block_table = np.full_like(lease.block_table, -1)
        self._record("kv.release", lease.batch, lease.max_len,
                     lease.nbytes, lease.tenant, lease_id=lease.lease_id,
                     pages=pages)
        if lease.page_lease is not None and self.pool is not None:
            self.pool.release(lease.page_lease)
            lease.page_lease = None
        return lease.nbytes

    def _require_slab(self) -> "KVPageSlab":
        if self.slab is None:
            raise RuntimeError("call init_paged(num_pages) before using "
                               "the paged KV API")
        return self.slab


# paged lease ids are process-global (not per manager): the invariant
# checker keys page conservation on (replica, lease_id), and one replica
# may host several managers
_LEASE_IDS = itertools.count()


@dataclass
class KVPageSlab:
    """The manager-owned paged KV tensors (all layers stacked) plus the
    host-side free list of page slots.  ``k[l]`` / ``v[l]`` are exactly
    the ``[NP, page_size, KVH, Dh]`` operands ``flash_decode_paged``
    reads in place."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int
    free: List[int] = field(default_factory=list)

    @property
    def num_pages(self) -> int:
        """Total KV page slots in the slab (free + leased)."""
        return self.k.shape[1]


@dataclass
class PagedCacheLease:
    """One leased block-table decode cache: ``block_table`` [B, MB] int32
    (slab page slot per sequence block, -1 after release) and ``lengths``
    [B] int32 (tokens written so far), plus byte/tenant accounting and,
    after ``splice_paged``, the per-page splice tables."""

    block_table: np.ndarray
    lengths: np.ndarray
    batch: int
    max_len: int
    nbytes: int = 0
    page_lease: Optional[PageLease] = None
    tenant: str = "shared"
    lease_id: int = -1                 # globally unique (trace correlation)
    # slab slots this lease allocated (and will free): spliced chunk-KV
    # pages appear in block_table but never here
    owned_slots: Tuple[int, ...] = ()
    # splice metadata (None until splice_paged ran): per-block RoPE
    # rotation offset and live-token count for serve_step_paged_spliced
    page_delta: Optional[np.ndarray] = None
    page_valid: Optional[np.ndarray] = None
    spliced_pages: int = 0

    def device_tables(self, device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block_table, lengths) as int32 tensors on ``device`` — copies,
        never views of the host arrays (the decode loop advances its
        device lengths itself)."""
        return (torch.tensor(self.block_table, device=device),
                torch.tensor(self.lengths, device=device))

    def device_splice_tables(self, device: DeviceLike,
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
        """(block_table, lengths, page_delta, page_valid) as int32 tensors
        on ``device``, the ``serve_step_paged_spliced`` operands — copies,
        as ``device_tables`` makes.  Requires a prior ``splice_paged``."""
        if self.page_delta is None or self.page_valid is None:
            raise RuntimeError("lease has no splice tables: call "
                               "KVCacheManager.splice_paged first")
        return (torch.tensor(self.block_table, device=device),
                torch.tensor(self.lengths, device=device),
                torch.tensor(self.page_delta, device=device),
                torch.tensor(self.page_valid, device=device))
