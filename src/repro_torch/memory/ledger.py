"""Byte-accurate device-memory ledger (one per replica).

Every byte of HBM a replica spends is charged to a named category —
``"prefetch"`` (cluster pages in the shared slab), ``"kv"`` (decode
cache leases), ``"weights"`` (resident model parameters), or any tag a
caller invents — and credited back when the holder releases it.  The
ledger is pure accounting: it never allocates, so it can also track
state the ``DevicePagePool`` does not own (weights live outside the
slab but still compete for the same HBM).

Charges may additionally carry a **tenant**: the pool mirrors each
lease's tenant here, so multi-tenant serving can read byte-accurate
per-tenant residency (``tenant_bytes``) next to the per-category view.
The sentinel tenant ``"shared"`` (untenanted holders: KV buckets,
direct callers) is not tracked per-tenant — only real tenants appear
in ``snapshot()`` under ``tenant:<name>`` keys.

The scheduler reads ``occupancy()`` to route micro-batches away from
memory-loaded replicas, and the serve drivers print ``snapshot()`` as
telemetry.  Charges are exact byte counts (a KV lease is charged its
tensor bytes, not its page-rounded slab footprint), which is what makes
``KVCacheManager.nbytes`` testable against the ledger to the byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class MemoryLedger:
    """Per-replica byte accounting across memory categories (and,
    when the pool is multi-tenant, across tenants).  All quantities
    are exact bytes."""

    capacity_bytes: Optional[int] = None     # None => unbounded (no occupancy)
    charges: Dict[str, int] = field(default_factory=dict)
    tenant_charges: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0

    def charge(self, category: str, nbytes: int, *,
               tenant: Optional[str] = None) -> None:
        """Add ``nbytes`` to ``category`` (and to ``tenant``'s total
        when given and not the ``"shared"`` sentinel); updates the peak."""
        if nbytes < 0:
            raise ValueError(f"negative charge: {nbytes}")
        self.charges[category] = self.charges.get(category, 0) + int(nbytes)
        if tenant is not None and tenant != "shared":
            self.tenant_charges[tenant] = (self.tenant_charges.get(tenant, 0)
                                           + int(nbytes))
        self.peak_bytes = max(self.peak_bytes, self.total_bytes())

    def credit(self, category: str, nbytes: int, *,
               tenant: Optional[str] = None) -> None:
        """Return ``nbytes`` previously charged to ``category`` (and to
        ``tenant`` when given); over-crediting raises."""
        held = self.charges.get(category, 0)
        if nbytes > held:
            raise ValueError(
                f"credit {nbytes} exceeds {category} charge {held}")
        self.charges[category] = held - int(nbytes)
        if tenant is not None and tenant != "shared":
            t_held = self.tenant_charges.get(tenant, 0)
            if nbytes > t_held:
                raise ValueError(f"credit {nbytes} exceeds tenant "
                                 f"{tenant!r} charge {t_held}")
            self.tenant_charges[tenant] = t_held - int(nbytes)

    def bytes_of(self, category: str) -> int:
        """Current bytes charged to ``category``."""
        return self.charges.get(category, 0)

    def tenant_bytes(self, tenant: str) -> int:
        """Current bytes attributed to ``tenant`` across all categories
        (0 for unknown tenants and for the ``"shared"`` sentinel)."""
        return self.tenant_charges.get(tenant, 0)

    def total_bytes(self) -> int:
        """Sum of all category charges (bytes)."""
        return sum(self.charges.values())

    def occupancy(self) -> float:
        """Fraction of capacity in use (0.0 when capacity is unknown)."""
        if not self.capacity_bytes:
            return 0.0
        return min(1.0, self.total_bytes() / self.capacity_bytes)

    def snapshot(self) -> Dict[str, int]:
        """Telemetry view: per-category bytes + totals (stable keys);
        per-tenant bytes appear as ``tenant:<name>`` keys when any
        tenant has ever been charged."""
        out = {k: v for k, v in sorted(self.charges.items())}
        for t, v in sorted(self.tenant_charges.items()):
            out[f"tenant:{t}"] = v
        out["total"] = self.total_bytes()
        out["peak"] = self.peak_bytes
        if self.capacity_bytes:
            out["capacity"] = int(self.capacity_bytes)
        return out
