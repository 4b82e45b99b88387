"""The port's chunk-KV path against the JAX package's, on the CPU.

Layered as the subsystem is:

* **Data**: ``chunk_tokens`` equal; ``pages_from_cache`` and
  ``build_chunk`` pages from the same weights (the reference's
  ``init_params`` through ``from_jax_params``) within fp32 rtol=1e-4; a
  ``.npz`` store saved by either package loads in the other, and the
  port's ``python -m repro_torch.launch.build_chunk_kv`` artifact loads in
  the reference.
* **Kernel**: ``flash_decode_spliced_ref`` (and ``ops.flash_decode_spliced``
  on CPU tensors) against the reference's oracle on ragged multi-chunk
  tables with -1 padding, RoPE fractions 0.5 and 1.0 (fp32 within 1e-5;
  bf16 pages within 1e-4, the two frameworks' cos/sin may round the
  rotated K to another bf16 neighbour).
* **Manager and model**: ``splice_paged``'s tables equal, and
  ``serve_step_paged_spliced`` logits over the same slab (fp32 within
  rtol=atol=1e-4; bf16 within 3e-2 of the logits' scale, as
  ``tests/test_kernels.py:77`` allows).
* **Residency**: the same ``ChunkKVCache`` operations on both packages
  give the same results, stats, slab free lists, ledger bytes and
  recorder streams, and the port's stream passes the reference's
  ``check_recorder(drained=True, must_drain=("kv", "chunk_kv"))``.
* **Serve**: a ``TeleRAGServer`` with ``chunk_kv=True`` on the event
  clock: equal doc ids, round telemetry and recorder streams, the
  ``chunk_kv`` telemetry within 1e-6, equal spliced waves, hits and
  prefetched pages.  Decode logits are not compared across the two
  servers and greedy tokens never are (ROADMAP queue 3).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core as jcore
from repro.analysis import check_recorder
from repro.configs import get_arch as jget_arch
from repro.core.budget import H100 as JH100
from repro.data import chunk_kv as jck
from repro.kernels import ref as jref
from repro.memory.pool import DevicePagePool as JPool
from repro.models import transformer as jtf
from repro.obs.recorder import FlightRecorder as JRecorder
from repro.serving import api as japi
from repro.serving import decode as jdecode
from repro.serving.chunk_kv import ChunkKVCache as JCache
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.kv_cache import KVCacheManager as JManager
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import datastore as tds
from repro_torch.core import ivf as tivf
from repro_torch.data import chunk_kv as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import build_chunk_kv as tbuild
from repro_torch.memory.pool import DevicePagePool as TPool
from repro_torch.models import transformer as ttf
from repro_torch.obs.recorder import FlightRecorder as TRecorder
from repro_torch.serving import api as tapi
from repro_torch.serving.chunk_kv import ChunkKVCache as TCache
from repro_torch.serving.decode import DecodeRunner
from repro_torch.serving.engine import EngineConfig as TConfig
from repro_torch.serving.kv_cache import KVCacheManager as TManager
from tests.test_torch_api import _close, _stream
from tests.test_torch_cuda import _spliced_inputs as _spliced_case

PS = 4
BF16_SCALE_TOL = 3e-2
# the reference's oracle, compiled once per shape instead of op by op
JORACLE = jax.jit(jref.flash_decode_spliced_ref,
                  static_argnames=("rope_fraction", "rope_theta"))


def _configs(layers=2):
    return (dataclasses.replace(jget_arch("llama3-8b").reduced(),
                                num_layers=layers),
            dataclasses.replace(tget_arch("llama3-8b").reduced(),
                                num_layers=layers))


@pytest.fixture(scope="module")
def fp32():
    """(reference cfg, params, port cfg, model) over the same fp32
    weights."""
    jc, tc = _configs()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return SimpleNamespace(jc=jc, params=params, tc=tc, model=model)


@pytest.fixture(scope="module")
def world():
    js = jcore.synthetic_datastore(3000, dim=32, seed=3)
    ts = tds.synthetic_datastore(3000, dim=32, seed=3)
    ji = jcore.build_ivf(js, 16, page_size=32, kmeans_iters=4, seed=1,
                         train_sample=2000)
    ti = tivf.build_ivf(ts, 16, page_size=32, kmeans_iters=4, seed=1,
                        train_sample=2000, device="cpu")
    rng = np.random.default_rng(0)
    q = js.embeddings[rng.choice(js.num_vectors, 8)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return SimpleNamespace(ji=ji, ti=ti, q=q)


# ---------------------------------------------------------------------------
# Data layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("doc_id,vocab,seed,lo,hi", [
    (0, 64, 0, 8, 24), (7, 512, 3, 8, 24), (123456, 128256, 0, 8, 24),
    (5, 512, 11, 6, 6), (2**20 + 3, 512, 7, 1, 40)])
def test_chunk_tokens_match_reference(doc_id, vocab, seed, lo, hi):
    a = jck.chunk_tokens(doc_id, vocab, seed=seed, min_len=lo, max_len=hi)
    b = tck.chunk_tokens(doc_id, vocab, seed=seed, min_len=lo, max_len=hi)
    assert b.dtype == a.dtype == np.int32
    np.testing.assert_array_equal(b, a)


def test_pages_from_cache_matches_reference():
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 19, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 19, 3, 8)).astype(np.float32)
    for length, ps in ((19, 4), (13, 4), (8, 8), (1, 5)):
        for a, b in zip(jck.pages_from_cache(k, v, length, ps),
                        tck.pages_from_cache(k, v, length, ps)):
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        tck.pages_from_cache(k, v, 20, 4)


@pytest.mark.parametrize("doc_id,seed", [(5, 2), (31, 3)])
def test_build_chunk_matches_reference(fp32, doc_id, seed):
    """One chunk prefilled alone at chunk-local positions and paged:
    the port's pages against the reference's from the same weights."""
    want = jck.build_chunk(fp32.params, fp32.jc, doc_id, page_size=PS,
                           seed=seed, cluster=doc_id % 3)
    got = tck.build_chunk(fp32.model, doc_id, page_size=PS, seed=seed,
                          cluster=doc_id % 3)
    assert (got.length, got.cluster, got.num_pages) == \
        (want.length, want.cluster, want.num_pages)
    assert got.k.dtype == want.k.dtype == np.float32
    np.testing.assert_allclose(got.k, want.k, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.v, want.v, rtol=1e-4, atol=1e-4)
    # the dead tail of the last page is zero padding in both
    tail = got.num_pages * PS - got.length
    if tail:
        assert not got.k[:, -1, PS - tail:].any()


def test_store_npz_loads_across_packages(fp32, tmp_path):
    """A store saved by either package loads in the other: the same
    docs, page size, seed, lengths, clusters and pages."""
    port = tck.build_chunk_kv(fp32.model, [5, 9, 14], page_size=PS, seed=2,
                              cluster_of=lambda d: d % 3)
    ref = jck.build_chunk_kv(fp32.params, fp32.jc, [3, 9], page_size=PS,
                             seed=2, cluster_of=lambda d: d % 2)
    for store, loader, name in ((port, jck.ChunkKVStore, "port.npz"),
                                (ref, tck.ChunkKVStore, "ref.npz")):
        path = str(tmp_path / name)
        store.save(path)
        loaded = loader.load(path)
        assert (loaded.page_size, loaded.seed, len(loaded)) == \
            (store.page_size, store.seed, len(store))
        assert loaded.total_pages() == store.total_pages()
        for d, c in store.chunks.items():
            got = loaded.get(d)
            assert (got.length, got.cluster) == (c.length, c.cluster)
            np.testing.assert_array_equal(got.k, c.k)
            np.testing.assert_array_equal(got.v, c.v)
    assert tck.ChunkKVStore.load(str(tmp_path / "ref.npz")).docs_in_cluster(1) \
        == [3, 9]


def test_builder_cli_artifact_loads_in_reference(tmp_path):
    """``python -m repro_torch.launch.build_chunk_kv`` (here on the CPU)
    writes a store the reference loads: docs [0, N), the flags' page
    size, seed and cluster map, each doc's tokens per ``chunk_tokens``,
    and the pages of the port's own prefill with the CLI's weights."""
    out = tmp_path / "sub" / "chunks.npz"
    assert tbuild.main(["--out", str(out), "--docs", "3", "--page-size",
                        "4", "--seed", "3", "--clusters", "2", "--min-len",
                        "5", "--max-len", "9", "--device", "cpu"]) == 0
    store = jck.ChunkKVStore.load(str(out))
    assert store.page_size == 4 and store.seed == 3 and len(store) == 3
    _, tc = _configs(layers=4)
    model = ttf.init_params(tget_arch("llama3-8b").reduced(),
                            torch.Generator().manual_seed(3), device="cpu",
                            dtype=torch.float32)
    for d in range(3):
        c = store.get(d)
        toks = jck.chunk_tokens(d, tc.vocab_size, seed=3, min_len=5,
                                max_len=9)
        assert c.length == len(toks) and c.cluster == d % 2
        assert c.k.shape == (tc.num_layers, -(-len(toks) // 4), 4,
                             tc.num_kv_heads, tc.resolved_head_dim)
        want = tck.build_chunk(model, d, page_size=4, seed=3, min_len=5,
                               max_len=9)
        np.testing.assert_array_equal(c.k, want.k)
        np.testing.assert_array_equal(c.v, want.v)


# ---------------------------------------------------------------------------
# The spliced-decode plain version
# ---------------------------------------------------------------------------


SPLICED_CASES = {
    "all fresh": (1, 3, 2, 2, 16, 4, [[], [], []], 3),
    "several chunks, ragged leads": (3, 4, 2, 4, 32, 4,
                                     [[5, 3, 9], [4], [], [1]], 2),
    "page size 16, Dh 128, offsets in the hundreds": (
        5, 2, 2, 2, 128, 16, [[24] * 12 + [9], [17, 33, 2]], 2),
}


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("name", list(SPLICED_CASES))
def test_spliced_ref_matches_reference_oracle(name, fraction):
    q, kp, vp, bt, lens, delta, valid = _spliced_case(*SPLICED_CASES[name])
    kw = dict(rope_fraction=fraction, rope_theta=500_000.0)
    want = np.asarray(JORACLE(
        *(jnp.asarray(x) for x in (q, kp, vp, bt, lens, delta, valid)), **kw))
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens, delta, valid)]
    got = tref.flash_decode_spliced_ref(*args, **kw)
    assert got.dtype == torch.float32 and not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the public entry point takes the plain version on CPU tensors
    np.testing.assert_array_equal(tops.flash_decode_spliced(*args, **kw).numpy(),
                                  got.numpy())
    if name == "all fresh":
        np.testing.assert_allclose(
            tref.flash_decode_paged_ref(*args[:5]).numpy(), got.numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_spliced_ref_bf16_pages_match_reference_oracle(fraction):
    """bf16 pages: both round the rotated K back to bf16 before the fp32
    product."""
    q, kp, vp, bt, lens, delta, valid = _spliced_case(
        *SPLICED_CASES["several chunks, ragged leads"])
    kw = dict(rope_fraction=fraction, rope_theta=500_000.0)
    want = np.asarray(JORACLE(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16),
        *(jnp.asarray(x) for x in (bt, lens, delta, valid)), **kw))
    got = tref.flash_decode_spliced_ref(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(),
        *(torch.from_numpy(x) for x in (bt, lens, delta, valid)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_spliced_ref_dead_slots_are_never_used():
    """Poisoning every dead slot (a partial page's tail, the page a -1
    column would read) leaves the output bit for bit."""
    q, kp, vp, bt, lens, delta, valid = _spliced_case(
        *SPLICED_CASES["several chunks, ragged leads"])
    args = lambda k, v: [torch.from_numpy(x) for x in
                         (q, k, v, bt, lens, delta, valid)]
    base = tref.flash_decode_spliced_ref(*args(kp, vp))
    k2, v2 = kp.copy(), vp.copy()
    for b in range(bt.shape[0]):
        for blk in range(bt.shape[1]):
            page = max(int(bt[b, blk]), 0)
            if bt[b, blk] >= 0:
                k2[page, valid[b, blk]:] = 1e4
                v2[page, valid[b, blk]:] = -1e4
    np.testing.assert_array_equal(
        tref.flash_decode_spliced_ref(*args(k2, v2)).numpy(), base.numpy())


# ---------------------------------------------------------------------------
# splice_paged and the spliced decode step
# ---------------------------------------------------------------------------

ROW_CHUNKS = [[((20, 21), 7), ((22,), 2)], [], [((23, 24, 25), 9)]]


def _twin_managers(jc, tc, num_pages=40):
    jm = JManager(jc, dtype=jnp.float32)
    tm = TManager(tc, torch.float32, device="cpu")
    jm.init_paged(num_pages=num_pages, page_size=PS)
    tm.init_paged(num_pages=num_pages, page_size=PS)
    return jm, tm


def test_splice_paged_tables_match_reference(fp32):
    """The same fresh lease and the same chunk rows: equal block table,
    lengths, page_delta, page_valid, max_len and ownership."""
    jm, tm = _twin_managers(fp32.jc, fp32.tc)
    for m in (jm, tm):                     # chunk slots, as a load pops them
        m.slab.free = [s for s in m.slab.free if s not in range(20, 26)]
    jl, tl = jm.acquire_paged(3, 12), tm.acquire_paged(3, 12)
    np.testing.assert_array_equal(tl.block_table, jl.block_table)
    assert tm.splice_paged(tl, ROW_CHUNKS) == jm.splice_paged(jl, ROW_CHUNKS) == 6
    for name in ("block_table", "lengths", "page_delta", "page_valid"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name),
                                      err_msg=name)
    assert (tl.max_len, tl.spliced_pages, tl.owned_slots) == \
        (jl.max_len, jl.spliced_pages, jl.owned_slots)
    assert (tl.page_valid[tl.block_table < 0] == 0).all()
    bt, lens, dl, vd = tl.device_splice_tables("cpu")
    assert all(t.dtype == torch.int32 for t in (bt, lens, dl, vd))
    lens += 1                              # a copy: the lease keeps its own
    assert list(tl.lengths) == [12, 0, 12]
    free = set(tm.slab.free) | set(tl.owned_slots)
    tm.release_paged(tl)
    jm.release_paged(jl)
    assert set(tm.slab.free) == free and not free & set(range(20, 26))


def test_splice_paged_rejects_what_the_reference_rejects(fp32):
    jm, tm = _twin_managers(fp32.jc, fp32.tc, num_pages=16)
    for m in (jm, tm):
        lease = m.acquire_paged(2, 8)
        with pytest.raises(ValueError):            # row count mismatch
            m.splice_paged(lease, [[]])
        with pytest.raises(ValueError):            # page count vs length
            m.splice_paged(lease, [[((1, 2), 3)], []])
        assert m.splice_paged(lease, [[], []]) == 0
        assert lease.spliced_pages == 0 and lease.page_delta is None
        lease.lengths += 1
        with pytest.raises(ValueError):            # not fresh anymore
            m.splice_paged(lease, [[((1,), 4)], []])
        m.release_paged(lease)
    with pytest.raises(RuntimeError):
        tm.acquire_paged(1, 4).device_splice_tables("cpu")


def _slab_and_tables(tc, dtype, seed=0):
    """A random fp32 slab [L, NP, PS, KVH, Dh] and a spliced 3-row lease
    over it (ROW_CHUNKS ahead of 3 fresh pages a row)."""
    rng = np.random.default_rng(seed)
    tm = TManager(tc, dtype, device="cpu")
    tm.init_paged(num_pages=40, page_size=PS)
    tm.slab.free = [s for s in tm.slab.free if s not in range(20, 26)]
    lease = tm.acquire_paged(3, 12)
    tm.splice_paged(lease, ROW_CHUNKS)
    shape = tuple(tm.slab.k.shape)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return k, v, lease


def _spliced_steps(fp32, jparams, model, jdt, tdt, steps=3):
    """Three spliced decode steps of both packages over the same slab and
    the same fed tokens; returns the logits of each step, both sides."""
    k, v, lease = _slab_and_tables(fp32.tc, tdt)
    toks = np.random.default_rng(1).integers(
        0, fp32.tc.vocab_size, (steps, 3)).astype(np.int32)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    tk = torch.from_numpy(k).to(tdt)
    tv = torch.from_numpy(v).to(tdt)
    bt, dl, vd = lease.block_table, lease.page_delta, lease.page_valid
    out = []
    for s in range(steps):
        lens = lease.lengths + s
        jl, jk, jv = jtf.serve_step_paged_spliced(
            jparams, jk, jv, jnp.asarray(bt), jnp.asarray(lens),
            jnp.asarray(dl), jnp.asarray(vd), {"token": jnp.asarray(toks[s])},
            fp32.jc, kernel_mode="ref")
        tl, tk, tv = ttf.serve_step_paged_spliced(
            model, tk, tv, *(torch.from_numpy(np.asarray(x)) for x in
                             (bt, lens, dl, vd)),
            {"token": torch.from_numpy(toks[s])})
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return out, (np.asarray(jk, np.float32), tk.float().numpy())


def test_serve_step_paged_spliced_matches_reference_fp32(fp32):
    steps, (jk, tk) = _spliced_steps(fp32, fp32.params, fp32.model,
                                     jnp.float32, torch.float32)
    for s, (want, got) in enumerate(steps):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {s}")
    np.testing.assert_allclose(tk, jk, rtol=1e-4, atol=1e-4)


def test_serve_step_paged_spliced_matches_reference_bf16(fp32):
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), fp32.params)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, fp32.params),
                                fp32.tc, device="cpu", dtype=torch.bfloat16)
    steps, _ = _spliced_steps(fp32, jparams, model, jnp.bfloat16,
                              torch.bfloat16)
    for s, (want, got) in enumerate(steps):
        err = np.abs(got - want).max()
        assert err <= BF16_SCALE_TOL * np.abs(want).max(), f"step {s}: {err}"


def test_spliced_step_on_a_fresh_table_is_the_paged_step(fp32):
    """delta 0 and valid ps everywhere: ``serve_step_paged``'s logits."""
    rng = np.random.default_rng(3)
    tc, model = fp32.tc, fp32.model
    shape = (tc.num_layers, 12, PS, tc.num_kv_heads, tc.resolved_head_dim)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bt = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    lens = torch.tensor([9, 20], dtype=torch.int32)
    tok = torch.tensor([3, 4], dtype=torch.int32)
    want, _, _ = ttf.serve_step_paged(model, k.clone(), v.clone(), bt, lens,
                                      {"token": tok})
    got, _, _ = ttf.serve_step_paged_spliced(
        model, k.clone(), v.clone(), bt, lens, torch.zeros_like(bt),
        torch.full_like(bt, PS), {"token": tok})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# ChunkKVCache residency, both packages side by side
# ---------------------------------------------------------------------------


def _twin_caches(world, fp32, *, slab_pages=32, pool_pages=128,
                 docs=(1, 2, 3), lens=(5, 8, 9), cluster_of=None):
    """The reference's and the port's ChunkKVCache over equal pools,
    managers and stores (both hold the pages of the port's builder)."""
    chunks = {d: tck.build_chunk(fp32.model, d, page_size=PS, min_len=ln,
                                 max_len=ln, cluster=-1 if cluster_of is None
                                 else cluster_of(d))
              for d, ln in zip(docs, lens)}
    out = []
    for Pool, Rec, Mgr, Cache, ck, index, dt in (
            (JPool, JRecorder, JManager, JCache, jck, world.ji, jnp.float32),
            (TPool, TRecorder, TManager, TCache, tck, world.ti,
             torch.float32)):
        if Pool is TPool:
            pool = Pool(index.paged, pool_pages, torch.float32, device="cpu")
            mgr = Mgr(fp32.tc, dt, pool=pool, device="cpu")
        else:
            pool = Pool(index.paged, pool_pages, jnp.float32)
            mgr = Mgr(fp32.jc, dtype=dt, pool=pool)
        pool.recorder = Rec()
        pool.replica_id = 0
        mgr.init_paged(num_pages=slab_pages, page_size=PS)
        store = ck.ChunkKVStore(page_size=PS)
        for d, c in chunks.items():
            store.add(d, ck.ChunkKV(k=c.k, v=c.v, length=c.length,
                                    cluster=c.cluster))
        out.append(SimpleNamespace(pool=pool, mgr=mgr, cache=Cache(mgr, store)))
    return out


def _state(t):
    """What must agree between the twins after every operation."""
    c = t.cache
    return (dict(vars(c.stats)), sorted((d, r.slots, r.length, r.pins)
                                        for d, r in c.resident.items()),
            list(t.mgr.slab.free), t.pool.ledger.bytes_of("chunk_kv"),
            c.resident_pages(), c.pinned_pages())


def _same_streams(j, t):
    kinds = lambda s: [e["kind"] for e in s]
    js, ts = _stream(j.pool.recorder), _stream(t.pool.recorder)
    assert kinds(ts) == kinds(js)
    assert ts == js


def _apply(twins, op):
    """Run ``op`` on both caches; equal results (exceptions included)
    and equal state after."""
    results = []
    for tw in twins:
        try:
            r = op(tw)
            results.append(("ok", None if r is None else
                            getattr(r, "slots", r)))
        except (KeyError, ValueError, RuntimeError) as e:
            results.append((type(e).__name__, None))
    assert results[1] == results[0]
    assert _state(twins[1]) == _state(twins[0])
    return results[1]


def test_residency_lifecycle_matches_reference(world, fp32):
    """Load, idempotent reload, pins, protected evict and drain, unpins,
    pin-before-load, evict, store miss; then acquire_rows/release_rows,
    backfill and drain: the same on both packages, and the port's
    stream passes the reference's checker with kv and chunk_kv drained."""
    twins = _twin_caches(world, fp32)
    _apply(twins, lambda t: t.cache.load(1, tenant="acme"))
    j, t = twins
    np.testing.assert_array_equal(
        t.mgr.slab.k[:, list(t.cache.resident[1].slots)].numpy(),
        np.asarray(j.mgr.slab.k[:, np.asarray(j.cache.resident[1].slots)]))
    for op in (lambda t: t.cache.load(1, tenant="acme"),
               lambda t: t.cache.pin(1), lambda t: t.cache.pin(1),
               lambda t: t.cache.evict(1), lambda t: t.cache.drain(),
               lambda t: t.cache.unpin(1), lambda t: t.cache.unpin(1),
               lambda t: t.cache.unpin(1), lambda t: t.cache.pin(99),
               lambda t: t.cache.evict(1), lambda t: t.cache.load(77)):
        _apply(twins, op)
    rows = [tw.cache.acquire_rows([[1, 99], [2]], tenant="acme")
            for tw in twins]
    assert rows[1] == rows[0] and rows[1][2] == [[99], []]
    assert _state(t) == _state(j)
    _apply(twins, lambda tw: tw.cache.release_rows(rows[0][1]))
    # miss-path backfill: prefill once now, hit after (the port's pages
    # from its own prefill, within fp32 rounding of the reference's)
    jb = j.cache.backfill(99, fp32.params, fp32.jc, min_len=6, max_len=6)
    tb = t.cache.backfill(99, fp32.model, min_len=6, max_len=6)
    np.testing.assert_allclose(tb.k, jb.k, rtol=1e-4, atol=1e-4)
    assert t.cache.backfill(99, fp32.model) is None
    assert j.cache.backfill(99, fp32.params, fp32.jc) is None
    _apply(twins, lambda t: t.cache.acquire_rows([[99, 3]])[0])
    _apply(twins, lambda t: t.cache.release_rows([99, 3]))
    _apply(twins, lambda t: t.cache.drain())
    assert t.pool.ledger.bytes_of("chunk_kv") == 0
    assert t.cache.stats.as_dict() == j.cache.stats.as_dict()
    _same_streams(j, t)
    rep = check_recorder(t.pool.recorder, drained=True,
                         must_drain=("kv", "chunk_kv"))
    assert rep.ok, rep.summary()
    assert rep.stats["chunk_loads"] == j.cache.stats.loads > 0


def test_evict_cold_is_lru_and_skips_pinned_as_the_reference(world, fp32):
    twins = _twin_caches(world, fp32)
    for op in (lambda t: t.cache.load(1), lambda t: t.cache.load(2),
               lambda t: t.cache.load(3), lambda t: t.cache.load(1),
               lambda t: t.cache.pin(2),
               lambda t: t.cache.evict_cold(pages_hint=1),
               lambda t: t.cache.unpin(2), lambda t: t.cache.drain()):
        _apply(twins, op)
    j, t = twins
    assert not t.cache.resident and t.cache.stats.evictions == 3
    _same_streams(j, t)
    assert check_recorder(t.pool.recorder, drained=True,
                          must_drain=("chunk_kv",)).ok


def test_pool_pressure_evicts_cold_as_the_reference(world, fp32):
    """The pool, not the slab, is the limit: a load spills cold residency
    first and only then misses; a slab too small stops a prefetch burst;
    prefetch_clusters honours its page budget."""
    twins = _twin_caches(world, fp32, pool_pages=8)   # one 2-KV-page chunk
    for op in (lambda t: t.cache.load(1), lambda t: t.cache.load(2),
               lambda t: t.cache.pin(2), lambda t: t.cache.load(3),
               lambda t: t.cache.unpin(2), lambda t: t.cache.drain()):
        _apply(twins, op)
    j, t = twins
    assert t.cache.stats.evictions == j.cache.stats.evictions == 2
    assert t.pool.ledger.bytes_of("chunk_kv") == 0
    _same_streams(j, t)
    twins = _twin_caches(world, fp32, cluster_of=lambda d: d % 2)
    for op in (lambda t: t.cache.prefetch_clusters([1], budget_pages=2),
               lambda t: t.cache.prefetch_clusters([0]),
               lambda t: t.cache.drain()):
        _apply(twins, op)
    assert twins[1].cache.stats.prefetched_pages == 4
    twins = _twin_caches(world, fp32, slab_pages=1, cluster_of=lambda d: d % 2)
    assert _apply(twins, lambda t: t.cache.prefetch_clusters([1])) == ("ok", 0)
    with pytest.raises(ValueError):
        TCache(twins[1].mgr, tck.ChunkKVStore(page_size=8))


# ---------------------------------------------------------------------------
# The server with chunk-KV splicing
# ---------------------------------------------------------------------------

CFG = dict(nprobe=4, top_k=3, buffer_pages=40, lookahead_rank=8, chips=1,
           cache_enabled=True, seed=5, pool_pages=40 + 4096,
           paged_decode=True)
RUNNER = dict(max_len=32, max_steps=4, page_size=PS, slab_seqs=24)


def _docs(resp):
    return [[d.tolist() for d in r.doc_ids] for r in resp]


def test_chunk_kv_server_matches_reference(world, fp32, tmp_path):
    """Both servers on the event clock with a chunk store built from the
    docs a chunk-less run retrieves (the port's builder, loaded by the
    reference from its .npz): the same doc ids (also the chunk-less
    run's), round telemetry, timelines and recorder streams; the
    ``chunk_kv`` telemetry within 1e-6; equal spliced waves, hits and
    prefetched pages; every doc hits; everything drains to zero."""
    reqs = lambda api: [api.RagRequest(q=world.q[i], pipeline="irg")
                        for i in range(4)]
    base = DecodeRunner(fp32.model, **RUNNER)
    srv0 = tapi.TeleRAGServer(world.ti, TConfig(**CFG), 1, fp32.tc,
                              micro_batch=2, include_tail=True,
                              decode_hook=base, continuous=True)
    base.attach(srv0)
    resp0 = srv0.serve(reqs(tapi))
    docs = sorted({d for rows in _docs(resp0) for row in rows for d in row})
    store = tck.build_chunk_kv(
        fp32.model, docs, page_size=PS, seed=3, min_len=6, max_len=9,
        cluster_of=tck.cluster_map_from_assignments(world.ti.assignments))
    path = str(tmp_path / "store.npz")
    store.save(path)

    jrun = jdecode.DecodeRunner(fp32.params, fp32.jc,
                                chunk_store=jck.ChunkKVStore.load(path),
                                **RUNNER)
    trun = DecodeRunner(fp32.model, chunk_store=tck.ChunkKVStore.load(path),
                        **RUNNER)
    ref = japi.TeleRAGServer(
        world.ji, JConfig(kernel_mode="ref", hw=JH100, chunk_kv=True, **CFG),
        1, fp32.jc, micro_batch=2, include_tail=True, decode_hook=jrun,
        continuous=True)
    port = tapi.TeleRAGServer(world.ti, TConfig(chunk_kv=True, **CFG), 1,
                              fp32.tc, micro_batch=2, include_tail=True,
                              decode_hook=trun, continuous=True)
    jrun.attach(ref)
    trun.attach(port)
    assert port.engines[0].chunk_kv is trun.chunk(0) is not None
    jresp, tresp = ref.serve(reqs(japi)), port.serve(reqs(tapi))

    assert _docs(tresp) == _docs(jresp) == _docs(resp0)
    for a, b in zip(jresp, tresp):
        assert b.state.value == a.state.value == "complete"
        _close(dataclasses.asdict(a)["rounds"], dataclasses.asdict(b)["rounds"],
               f"request {a.request_id} rounds")
    jt, tt = ref.telemetry(), port.telemetry()
    _close(jt.replicas[0].chunk_kv, tt.replicas[0].chunk_kv, "chunk_kv")
    ck = tt.replicas[0].chunk_kv
    assert ck["hit_rate"] == 1.0 and ck["hits"] > 0
    assert ck["prefetched_pages"] > 0 and ck["spliced_pages"] > 0
    assert trun.stats == {k: jrun.stats[k] for k in trun.stats}
    assert trun.stats["spliced_waves"] > 0
    assert _stream(port.recorder) == _stream(ref.recorder)

    for runner, srv in ((jrun, ref), (trun, port)):
        runner.chunk(0).drain()
        runner.kv(0).drop_all()
        assert srv.engines[0].ledger.bytes_of("kv") == 0
        assert srv.engines[0].ledger.bytes_of("chunk_kv") == 0
    rep = check_recorder(port.recorder, drained=True,
                         must_drain=("kv", "chunk_kv"))
    assert rep.ok, rep.summary()
    kinds = {e.kind for e in port.recorder.events}
    assert {"kv.splice", "chunk.load", "chunk.pin", "chunk.unpin",
            "chunk.evict"} <= kinds
