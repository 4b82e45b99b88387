"""Offline chunk-KV builder: precompute per-chunk KV pages once, reuse
them at serve time by block-table splice (TurboRAG, arXiv:2410.07590).

The port's copy of the reference's ``data/chunk_kv.py``: the same token
streams, page geometry and ``.npz`` artifact (a store saved by either
package loads in the other), with chunks prefilled by the port's own
``models.transformer.prefill``.

Every datastore chunk (document) is run through ``transformer.prefill``
**alone**, so its K is roped at chunk-local positions ``0..C-1`` —
position-independent at build time.  The resulting per-layer K/V is cut
into fixed-size pages (the serving slab's page geometry) and keyed by
doc id; at serve time ``ChunkKVCache`` lands pages H2D into the KV page
slab and ``KVCacheManager.splice_paged`` attaches them to a wave's
lease by block-table edit, with ``serve_step_paged_spliced`` applying
the per-page RoPE rotation offset (reordered RoPE — rotations compose,
so one constant rotation per page reindexes the chunk to its layout
position).

Chunk token streams are synthetic but deterministic — a pure function
of ``(seed, doc_id)`` like the training pipeline's batches — so the
store built offline and a miss's prefill fallback at serve time agree
byte-for-byte, and the parity suite can re-prefill the exact same
tokens as an oracle.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np



def chunk_tokens(doc_id: int, vocab_size: int, *, seed: int = 0,
                 min_len: int = 8, max_len: int = 24) -> np.ndarray:
    """Deterministic ragged token stream for one chunk: a pure function
    of ``(seed, doc_id)`` (lengths deliberately ragged against any page
    size so partially-filled last pages are the common case)."""
    rng = np.random.default_rng(
        (np.uint64(seed) << np.uint64(20)) ^ np.uint64(doc_id * 2654435761))
    length = int(rng.integers(min_len, max_len + 1))
    return rng.integers(0, vocab_size, size=length).astype(np.int32)


@dataclass
class ChunkKV:
    """One chunk's precomputed KV: per-layer pages ``[L, n_pages,
    page_size, KVH, Dh]`` (chunk-local RoPE; the tail of the last page
    is zero padding masked at attention time), the live token count,
    and the IVF cluster the chunk belongs to (-1 = unmapped)."""

    k: np.ndarray
    v: np.ndarray
    length: int
    cluster: int = -1

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


@dataclass
class ChunkKVStore:
    """Host-side chunk-KV corpus: doc id -> precomputed pages, plus the
    page geometry they were cut to and the doc->cluster map lookahead
    prefetch walks (predicted clusters -> their docs' pages)."""

    page_size: int
    chunks: Dict[int, ChunkKV] = field(default_factory=dict)
    seed: int = 0

    def __contains__(self, doc_id: int) -> bool:
        return int(doc_id) in self.chunks

    def __len__(self) -> int:
        return len(self.chunks)

    def get(self, doc_id: int) -> Optional[ChunkKV]:
        return self.chunks.get(int(doc_id))

    def add(self, doc_id: int, chunk: ChunkKV) -> None:
        self.chunks[int(doc_id)] = chunk

    def num_pages(self, doc_id: int) -> int:
        c = self.chunks.get(int(doc_id))
        return 0 if c is None else c.num_pages

    def total_pages(self) -> int:
        return sum(c.num_pages for c in self.chunks.values())

    def docs_in_cluster(self, cluster: int) -> List[int]:
        return sorted(d for d, c in self.chunks.items()
                      if c.cluster == int(cluster))

    # -- persistence (the CLI's artifact format) ----------------------------
    def save(self, path: str) -> None:
        """One ``.npz``: per-doc k/v arrays plus a JSON meta record."""
        arrays: Dict[str, np.ndarray] = {}
        meta = {"page_size": self.page_size, "seed": self.seed, "docs": {}}
        for d, c in sorted(self.chunks.items()):
            arrays[f"k_{d}"] = c.k
            arrays[f"v_{d}"] = c.v
            meta["docs"][str(d)] = {"length": c.length, "cluster": c.cluster}
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ChunkKVStore":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            store = cls(page_size=int(meta["page_size"]),
                        seed=int(meta.get("seed", 0)))
            for d, m in meta["docs"].items():
                store.add(int(d), ChunkKV(k=z[f"k_{d}"], v=z[f"v_{d}"],
                                          length=int(m["length"]),
                                          cluster=int(m["cluster"])))
        return store


def pages_from_cache(cache_k: np.ndarray, cache_v: np.ndarray, length: int,
                     page_size: int) -> "tuple[np.ndarray, np.ndarray]":
    """Cut a dense single-sequence cache ``[L, S, KVH, Dh]`` into pages
    ``[L, n_pages, page_size, KVH, Dh]`` (zero-padded last page)."""
    L, S, KVH, Dh = cache_k.shape
    if length > S:
        raise ValueError(f"length {length} exceeds cache extent {S}")
    npg = -(-length // page_size)
    padded = npg * page_size
    out = []
    for a in (cache_k, cache_v):
        buf = np.zeros((L, padded, KVH, Dh), a.dtype)
        buf[:, :length] = a[:, :length]
        out.append(buf.reshape(L, npg, page_size, KVH, Dh))
    return out[0], out[1]


def build_chunk(model, doc_id: int, *, page_size: int, seed: int = 0,
                min_len: int = 8, max_len: int = 24, cluster: int = -1,
                dtype=np.float32) -> ChunkKV:
    """Prefill ONE chunk at chunk-local positions with ``model`` (a
    ``models.transformer.Transformer``, on its own device) and page its
    KV — also the serve-time miss fallback (``ChunkKVCache`` backfill)."""
    import torch

    from repro_torch.models import transformer as tf

    toks = chunk_tokens(doc_id, model.cfg.vocab_size, seed=seed,
                        min_len=min_len, max_len=max_len)
    _, cache = tf.prefill(model, {"tokens": torch.as_tensor(
        toks[None], device=model.device)})
    k = cache["k"][:, 0].float().cpu().numpy().astype(dtype)  # [L, S, KVH, Dh]
    v = cache["v"][:, 0].float().cpu().numpy().astype(dtype)
    kp, vp = pages_from_cache(k, v, len(toks), page_size)
    return ChunkKV(k=kp, v=vp, length=len(toks), cluster=int(cluster))


def build_chunk_kv(model, doc_ids: Iterable[int], *,
                   page_size: int, seed: int = 0, min_len: int = 8,
                   max_len: int = 24,
                   cluster_of: Optional[Callable[[int], int]] = None,
                   dtype=np.float32) -> ChunkKVStore:
    """The offline builder: one prefill per chunk, paged and keyed by
    doc id.  ``cluster_of`` maps a doc to its IVF cluster (how
    lookahead's predicted clusters resolve to prefetchable chunk
    pages); None leaves chunks unmapped."""
    store = ChunkKVStore(page_size=page_size, seed=seed)
    for d in doc_ids:
        d = int(d)
        store.add(d, build_chunk(
            model, d, page_size=page_size, seed=seed, min_len=min_len,
            max_len=max_len,
            cluster=-1 if cluster_of is None else int(cluster_of(d)),
            dtype=dtype))
    return store


def cluster_map_from_assignments(assignments: Sequence[int],
                                 ) -> Callable[[int], int]:
    """``cluster_of`` from an IVF assignment vector (doc id -> cluster),
    -1 for out-of-range ids."""
    arr = np.asarray(assignments)

    def cluster_of(doc_id: int) -> int:
        return int(arr[doc_id]) if 0 <= doc_id < len(arr) else -1

    return cluster_of
