"""The PyTorch port's retrieval stack against the JAX package's, on the CPU.

The same seeded datastore goes through both packages' ``build_ivf``,
page pool, prefetch buffer, transfer engine and hybrid search; the
results must agree: centroids within 1e-5 (fp32 products summed in
another order), equal assignments, equal leases, ledger snapshots and
byte counts, and equal doc ids and hit/miss partitions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore
from repro.core import hybrid_search as jhs
from repro.core.prefetch_buffer import PrefetchBuffer as JBuffer
from repro.core.transfer import TransferEngine as JTransfer
from repro_torch.core import datastore as tds
from repro_torch.core import hybrid_search as ths
from repro_torch.core import ivf as tivf
from repro_torch.core.prefetch_buffer import PrefetchBuffer as TBuffer
from repro_torch.core.transfer import TransferEngine as TTransfer
from repro_torch.obs.recorder import FlightRecorder as TRecorder

DIM, N, NC, PS = 32, 3000, 16, 32


@pytest.fixture(scope="module")
def stores():
    return (jcore.synthetic_datastore(N, dim=DIM, seed=3),
            tds.synthetic_datastore(N, dim=DIM, seed=3))


@pytest.fixture(scope="module")
def indexes(stores):
    js, ts = stores
    ji = jcore.build_ivf(js, NC, page_size=PS, kmeans_iters=4, seed=1,
                         train_sample=2000)
    ti = tivf.build_ivf(ts, NC, page_size=PS, kmeans_iters=4, seed=1,
                        train_sample=2000, device="cpu")
    return ji, ti


def _queries(store, n, seed):
    rng = np.random.default_rng(seed)
    q = store.embeddings[rng.choice(store.num_vectors, n)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_synthetic_datastore_is_the_same(stores):
    np.testing.assert_array_equal(stores[0].embeddings, stores[1].embeddings)


def test_build_ivf_matches(indexes):
    ji, ti = indexes
    np.testing.assert_allclose(ti.centroids, ji.centroids, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ti.assignments, ji.assignments)
    for name in ("pages", "page_ids", "page_cluster", "cluster_first_page",
                 "cluster_num_pages", "cluster_sizes"):
        np.testing.assert_array_equal(getattr(ti.paged, name),
                                      getattr(ji.paged, name))


def test_kmeans_update_uses_index_add_not_one_hot():
    """Empty clusters keep their centroid; others become unit means."""
    pts = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    cent = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    new = tivf._update(pts, cent, torch.tensor([0, 1, 0]))
    np.testing.assert_allclose(new[0].numpy(), [2 / 5 ** 0.5, 1 / 5 ** 0.5],
                               rtol=1e-6)
    np.testing.assert_allclose(new[2].numpy(), [-1.0, 0.0])


def test_probe_matches(indexes, stores):
    ji, ti = indexes
    q = _queries(stores[0], 6, 0)
    np.testing.assert_array_equal(tivf.probe(q, ti, 5), jcore.probe(q, ji, 5))


def _lease_view(pool):
    return sorted((l.owner, l.slots, l.nbytes, l.tag, l.refcount, l.tenant)
                  for l in pool.leases.values())


def _slab(pool):
    pages, ids, cl = pool.device_view()
    as_np = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)
                       else np.asarray(t, np.float32))
    return as_np(pages), np.asarray(ids), np.asarray(cl)


def test_pool_leases_ledger_and_bytes_match(indexes):
    """The same load/evict/refetch/flush sequence leaves both pools with
    the same leases, ledger, byte counts and slab contents."""
    ji, ti = indexes
    jb, tb = JBuffer(ji.paged, 40), TBuffer(ti.paged, 40, device="cpu")
    jt, tt = JTransfer(jb, 32e9), TTransfer(tb, 32e9)
    for buf_ops in ([("submit", [0, 3, 5])], [("evict", [3])],
                    [("submit", [7, 3, 5, 9])], [("evict", [0, 9])],
                    [("flush", None)], [("submit", list(range(NC)))]):
        for op, arg in buf_ops:
            for eng, buf in ((jt, jb), (tt, tb)):
                if op == "submit":
                    eng.submit(arg)
                elif op == "evict":
                    buf.evict_clusters(arg)
                else:
                    buf.flush_invalidations()
        assert _lease_view(tb.pool) == _lease_view(jb.pool)
        assert tb.pool.ledger.snapshot() == jb.pool.ledger.snapshot()
        assert (tb.stats.bytes_h2d, tb.stats.pages_h2d, tb.stats.rounds) == \
            (jb.stats.bytes_h2d, jb.stats.pages_h2d, jb.stats.rounds)
        assert tb.resident == jb.resident
        np.testing.assert_array_equal(tb.slot_cluster, jb.slot_cluster)
        for a, b in zip(_slab(tb.pool), _slab(jb.pool)):
            np.testing.assert_array_equal(a, b)
    assert [e.nbytes for e in tt.events] == [e.nbytes for e in jt.events]
    assert [(e.start_t, e.end_t) for e in tt.events] == \
        [(e.start_t, e.end_t) for e in jt.events]
    assert tb.pool.pages.dtype == torch.bfloat16


def test_port_pool_slab_is_three_device_tensors(indexes):
    _, ti = indexes
    buf = TBuffer(ti.paged, 8, device="cpu")
    pages, ids, cl = buf.device_view()
    assert pages.shape == (8, PS, DIM) and pages.dtype == torch.bfloat16
    assert ids.dtype == torch.int32 and cl.dtype == torch.int32
    assert buf.pool.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_hybrid_retrieve_fused_matches(indexes, stores, mode):
    ji, ti = indexes
    jb, tb = JBuffer(ji.paged, 48), TBuffer(ti.paged, 48, device="cpu")
    for buf in (jb, tb):
        buf.load_clusters([1, 2, 4, 6, 8, 11, 13])
        buf.evict_clusters([4])                 # a queued invalidation
    q = _queries(stores[0], 5, 1)
    probed = jcore.probe(q, ji, 6)
    want = jhs.hybrid_retrieve(jb, q, probed, k=4, kernel_mode=mode,
                               fused=True, centroids=ji.centroids)
    got = ths.hybrid_retrieve(tb, q, probed, k=4, fused=True,
                              centroids=ti.device_centroids)
    np.testing.assert_array_equal(got.doc_ids, np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=1e-5,
                               atol=1e-5)
    assert got.hit_clusters == want.hit_clusters
    assert got.missed_clusters == want.missed_clusters
    assert got.nprobe == want.nprobe


def test_unfused_retrieval_raises_not_implemented(indexes, stores):
    _, ti = indexes
    tb = TBuffer(ti.paged, 8, device="cpu")
    q = _queries(stores[1], 2, 2)
    with pytest.raises(NotImplementedError, match="ivf_topk"):
        ths.hybrid_retrieve(tb, q, tivf.probe(q, ti, 3), k=2, fused=False,
                            centroids=ti.device_centroids)


def test_merge_topk_matches():
    rng = np.random.default_rng(4)
    ds, hs = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    di, hi = rng.permutation(12)[:12].reshape(3, 4), 100 + np.arange(12).reshape(3, 4)
    ws, wi = jhs.merge_topk(*(np.asarray(a, dt) for a, dt in
                              ((ds, np.float32), (di, np.int32),
                               (hs, np.float32), (hi, np.int32))), 3)
    gs, gi = ths.merge_topk(torch.tensor(ds, dtype=torch.float32),
                            torch.tensor(di, dtype=torch.int32),
                            torch.tensor(hs, dtype=torch.float32),
                            torch.tensor(hi, dtype=torch.int32), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def test_transfer_events_carry_no_cuda_event_on_cpu(indexes):
    _, ti = indexes
    buf = TBuffer(ti.paged, 16, device="cpu")
    rec = TRecorder()
    eng = TTransfer(buf, 32e9)
    eng.recorder = rec
    ev = eng.submit([0, 1])
    assert ev.cuda_event is None and ev.nbytes == buf.stats.bytes_h2d
    assert [e.kind for e in rec.events] == ["transfer.issue", "transfer.land"]
