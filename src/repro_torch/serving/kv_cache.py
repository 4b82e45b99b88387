"""Paged KV cache manager for the serving engine.

Block-table leases over one shared KV page slab: a ``PagedCacheLease``
is a [batch, max_blocks] table of slab page slots plus per-sequence
lengths — exactly the operands ``kernels.ops.flash_decode_paged``
gathers through in place (PagedAttention-style), so decode attention
reads leased pages with no contiguous copy and no [B, max_len]
over-allocation.

When constructed over a ``DevicePagePool`` the manager is not a memory
island: every live lease charges its exact tensor bytes to the replica's
``MemoryLedger`` (category ``"kv"``, tenant-tagged) and takes page slots
out of the same pool the prefetch buffer draws from; an ``acquire_paged``
the slab or the pool cannot fit raises ``PoolExhausted``.

Only the paged part of the reference manager is ported; the dense
per-bucket caches and chunk-KV splicing come later.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.memory.pool import DevicePagePool, PageLease, PoolExhausted
from repro_torch.obs.recorder import KVEvent


class KVCacheManager:
    """Paged decode-cache allocator whose leases are charged to the shared
    ``DevicePagePool`` (category ``"kv"``) when a pool is given."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16, *,
                 pool: Optional[DevicePagePool] = None,
                 device: DeviceLike = "cuda"):
        """``pool=None`` keeps the manager a standalone allocator (no
        ledger accounting, no admission pressure); the slab lives on
        ``device``."""
        self.cfg = cfg
        self.dtype = dtype
        self.pool = pool
        self.device = resolve_device(device)
        self.slab: Optional["KVPageSlab"] = None   # init_paged() creates it

    def _record(self, kind: str, batch: int, max_len: int, nbytes: int,
                tenant: str, *, lease_id: int = -1, pages: int = 0,
                length: int = 0) -> None:
        """Trace through the pool's recorder lane (KV state belongs to the
        pool's replica): lease edges carry ``lease_id``/``pages`` and
        appends the post-write ``length``, so the invariant checker can
        conserve pages per lease and order acquire -> append -> release."""
        rec = self.pool.recorder if self.pool is not None else None
        if rec is not None:
            rec.emit(KVEvent(t=rec.now, kind=kind,
                             replica=self.pool.replica_id, tenant=tenant,
                             batch=batch, max_len=max_len, nbytes=nbytes,
                             lease_id=lease_id, pages=pages, length=length))

    def nbytes(self, batch: int, max_len: int) -> int:
        """Exact tensor bytes of one dense (batch, max_len) decode cache
        (k and v [L, B, S, KVH, Dh]) — what the reference's ledger charges
        for a dense bucket; drivers size the pool with it."""
        cfg = self.cfg
        per = torch.tensor([], dtype=self.dtype).element_size()
        return (2 * cfg.num_layers * batch * max_len * cfg.num_kv_heads
                * cfg.resolved_head_dim * per)

    def init_paged(self, num_pages: int, page_size: int = 16) -> "KVPageSlab":
        """Allocate the manager's KV page slab: ``num_pages`` page slots
        of ``page_size`` tokens each, all layers stacked —
        k/v [L, num_pages, page_size, KVH, Dh].  GQA attention archs only."""
        if self.cfg.attn_kind != "gqa" or self.cfg.ssm is not None:
            raise ValueError("paged KV supports plain GQA attention caches "
                             f"only (attn_kind {self.cfg.attn_kind!r})")
        L = self.cfg.num_layers
        KVH, Dh = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
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

    def release_paged(self, lease: "PagedCacheLease") -> int:
        """Return the lease's slab pages to the free list and release its
        pool bytes; returns bytes freed."""
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
    [B] int32 (tokens written so far), plus byte/tenant accounting."""

    block_table: np.ndarray
    lengths: np.ndarray
    batch: int
    max_len: int
    nbytes: int = 0
    page_lease: Optional[PageLease] = None
    tenant: str = "shared"
    lease_id: int = -1                 # globally unique (trace correlation)
    owned_slots: Tuple[int, ...] = ()

    def device_tables(self, device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block_table, lengths) as int32 tensors on ``device`` — copies,
        never views of the host arrays (the decode loop advances its
        device lengths itself)."""
        return (torch.tensor(self.block_table, device=device),
                torch.tensor(self.lengths, device=device))
