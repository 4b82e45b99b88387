"""The port's dense KV buckets (``KVCacheManager.acquire`` / ``release`` /
``drop`` / ``drop_all``) against the JAX package's, on the CPU.

Both managers run one sequence of leases over pools of the same
geometry: fresh buckets, recycling (re-attributed to another tenant),
a second bucket of a parked shape going straight back, the spill of the
manager's own recycled buckets before ``PoolExhausted``, and teardown.
After every step the pool occupancy, the ledger's kv and per-tenant
bytes, the outcome and the recorder streams must be equal (byte counts
are exact integers, so equality is exact).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore
from repro.configs import get_arch as jget_arch
from repro.memory.pool import DevicePagePool as JPool
from repro.memory.pool import PoolExhausted as JExhausted
from repro.obs.recorder import FlightRecorder as JRecorder
from repro.serving.kv_cache import KVCacheManager as JKV
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import datastore as tds
from repro_torch.core import ivf as tivf
from repro_torch.memory.pool import DevicePagePool as TPool
from repro_torch.memory.pool import PoolExhausted as TExhausted
from repro_torch.obs.recorder import FlightRecorder as TRecorder
from repro_torch.serving.kv_cache import KVCacheManager as TKV

TENANTS = ("shared", "a", "b")


@pytest.fixture(scope="module")
def paged():
    js = jcore.synthetic_datastore(600, dim=32, seed=3)
    ts = tds.synthetic_datastore(600, dim=32, seed=3)
    ji = jcore.build_ivf(js, 4, page_size=32, kmeans_iters=2, seed=1,
                         train_sample=600)
    ti = tivf.build_ivf(ts, 4, page_size=32, kmeans_iters=2, seed=1,
                        train_sample=600, device="cpu")
    return ji.paged, ti.paged


def _managers(paged, num_pages):
    jpaged, tpaged = paged
    jpool, tpool = JPool(jpaged, num_pages), TPool(tpaged, num_pages,
                                                   device="cpu")
    for pool, rec in ((jpool, JRecorder()), (tpool, TRecorder())):
        pool.recorder, pool.replica_id = rec, 0
    return (JKV(jget_arch("llama3-8b").reduced(), pool=jpool),
            TKV(tget_arch("llama3-8b").reduced(), pool=tpool, device="cpu"))


def _state(kv):
    pool = kv.pool
    return (pool.free_pages(), pool.used_pages, pool.ledger.bytes_of("kv"),
            tuple(pool.ledger.tenant_bytes(t) for t in TENANTS),
            tuple(pool.tenant_bytes(t, "kv") for t in TENANTS),
            [dataclasses.asdict(e) for e in pool.recorder.events])


def test_dense_buckets_match_reference(paged):
    jkv, tkv = _managers(paged, 1)
    big, small = tkv.nbytes(2, 32), tkv.nbytes(1, 32)
    assert (big, small) == (jkv.nbytes(2, 32), jkv.nbytes(1, 32))
    page = tkv.pool.page_nbytes
    assert page == jkv.pool.page_nbytes
    # room for one big bucket and one small one, not for a second big one
    pages = -(-big // page) + -(-small // page) + 2
    jkv, tkv = _managers(paged, pages)
    leases = {}

    def step(name, op):
        """Run ``op`` on both managers; equal outcome and state after."""
        out = []
        for side, kv, exhausted in (("j", jkv, JExhausted),
                                    ("t", tkv, TExhausted)):
            try:
                out.append(("ok", op(side, kv)))
            except exhausted:
                out.append(("PoolExhausted", None))
        assert out[0][0] == out[1][0], name
        assert _state(tkv) == _state(jkv), name
        return out[0][0]

    def acquire(key, batch, max_len, tenant, **kw):
        def op(side, kv):
            lease = kv.acquire(batch, max_len, tenant=tenant, **kw)
            leases[side, key] = lease
            return lease.nbytes
        return op

    def release(key):
        return lambda side, kv: kv.release(leases[side, key])

    assert step("fresh big", acquire("A", 2, 32, "a")) == "ok"
    assert step("fresh small", acquire("B", 1, 32, "b")) == "ok"
    step("park big", release("A"))
    assert step("recycle big for b",
                acquire("C", 2, 32, "b", fresh=True)) == "ok"
    assert tkv.pool.ledger.tenant_bytes("a") == 0          # re-attributed
    step("park recycled", release("C"))
    step("park small", release("B"))
    assert step("second big", acquire("D", 2, 32, "a")) == "ok"   # recycled
    # a new shape the pool cannot fit until the parked small bucket spills
    assert step("spill then fit", acquire("E", 1, 16, "shared")) == "ok"
    assert not tkv._pool_buckets and not jkv._pool_buckets
    step("park E", release("E"))
    # one more big bucket: spilling E is not enough
    assert step("exhausted", acquire("F", 2, 32, "b")) == "PoolExhausted"
    step("park D", release("D"))
    assert step("small for b", acquire("G", 1, 16, "b")) == "ok"
    assert step("another small", acquire("H", 1, 16, "a")) == "ok"
    step("park G", release("G"))
    step("same shape already parked", release("H"))
    step("drop missing", lambda side, kv: kv.drop(3, 8))
    step("drop big", lambda side, kv: kv.drop(2, 32))
    step("drop_all", lambda side, kv: kv.drop_all())
    assert tkv.pool.ledger.bytes_of("kv") == 0
    assert tkv.pool.free_pages() == pages
    kv = [(e.kind, e.batch, e.max_len, e.recycled)
          for e in tkv.pool.recorder.events if e.kind.startswith("kv.")]
    assert kv == [
        ("kv.acquire", 2, 32, False), ("kv.acquire", 1, 32, False),
        ("kv.release", 2, 32, False), ("kv.acquire", 2, 32, True),
        ("kv.release", 2, 32, False), ("kv.release", 1, 32, False),
        ("kv.acquire", 2, 32, True),
        ("kv.drop", 1, 32, False), ("kv.acquire", 1, 16, False),  # spill
        ("kv.release", 1, 16, False),
        ("kv.drop", 1, 16, False),                   # spilled, still short
        ("kv.release", 2, 32, False), ("kv.acquire", 1, 16, False),
        ("kv.acquire", 1, 16, False), ("kv.release", 1, 16, False),
        ("kv.release", 1, 16, False), ("kv.drop", 1, 16, False),
        ("kv.drop", 2, 32, False), ("kv.drop", 1, 16, False)]


def test_dense_bucket_is_the_init_cache_layout(paged):
    _, tkv = _managers(paged, 400)
    lease = tkv.acquire(3, 16, tenant="a")
    cfg = tkv.cfg
    shape = (cfg.num_layers, 3, 16, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert sorted(lease.cache) == ["k", "v"]
    assert all(t.shape == shape and t.dtype == torch.bfloat16
               for t in lease.cache.values())
    assert lease.nbytes == sum(t.numel() * t.element_size()
                               for t in lease.cache.values())
    lease.cache["k"].fill_(1.0)
    tkv.release(lease)
    again = tkv.acquire(3, 16, tenant="a")
    assert again.cache["k"] is lease.cache["k"]          # recycled, unzeroed
    assert float(again.cache["k"].abs().max()) == 1.0
    tkv.release(again)
    fresh = tkv.acquire(3, 16, tenant="a", fresh=True)
    assert float(np.abs(fresh.cache["k"].float().numpy()).max()) == 0.0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_nbytes_is_the_init_cache_bytes_for_every_arch(kv_quant):
    """``KVCacheManager.nbytes`` (the ledger's "kv" charge) is the bytes
    of the tensors ``init_cache`` makes and the reference's ``nbytes``,
    for every registered config (gemma2's rings and global layers, MLA's
    latents, musicgen's codebooks), and ``cache_shapes`` with
    ``kv_quant`` (int8 K/V and bf16 scales) the reference's
    ``init_cache(kv_quant=True)``, byte for byte."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jtf
    from repro_torch.configs import list_archs
    from repro_torch.models import transformer as ttf
    for name in list_archs():
        jc, tc = jget_arch(name).reduced(), tget_arch(name).reduced()
        for B, S in ((2, 32), (3, 5), (1, 16)):
            want = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(
                jax.eval_shape(lambda: jtf.init_cache(
                    jc, B, S, jnp.bfloat16, kv_quant=kv_quant))))
            got = sum(t.numel() * t.element_size() for t in ttf.init_cache(
                tc, B, S, torch.bfloat16, device="cpu",
                kv_quant=kv_quant).values())
            assert got == want, (name, B, S)
            if not kv_quant:
                assert TKV(tc, device="cpu").nbytes(B, S) == want == \
                    JKV(jc).nbytes(B, S), (name, B, S)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_recycled_recurrent_bucket_is_zeroed_as_the_reference(arch):
    """A released RWKV6 or zamba2 bucket comes back zeroed without
    ``fresh=True``, as the reference's does for every family but the
    attention one (recurrent state must not leak across requests; a
    Llama bucket comes back as it was, above): the port reuses its
    tensors, zeroed, and both managers hand out equal caches."""
    import jax.numpy as jnp
    jkv = JKV(jget_arch(arch).reduced())
    tkv = TKV(tget_arch(arch).reduced(), device="cpu")
    jl, tl = jkv.acquire(2, 8), tkv.acquire(2, 8)
    assert sorted(jl.cache) == sorted(tl.cache)
    for t in tl.cache.values():
        t.fill_(1.0)
    jl.cache = {n: jnp.ones_like(a) for n, a in jl.cache.items()}
    jkv.release(jl)
    tkv.release(tl)
    j2, t2 = jkv.acquire(2, 8), tkv.acquire(2, 8)
    for name, t in t2.cache.items():
        assert t is tl.cache[name], name                 # recycled
        assert not t.any(), name
        assert not np.asarray(j2.cache[name]).any(), name


@pytest.mark.parametrize("arch,want", [("rwkv6-3b", 85_196_800),
                                       ("zamba2-2.7b", 337_102_848)])
def test_recurrent_nbytes_at_full_width_is_the_reference(arch, want):
    """The serve's bucket (batch 4, 128 tokens, bf16) of the full
    configs, to the byte as the reference's ``nbytes``: rwkv6-3b's wkv
    [32, 4, 40, 64, 64] fp32 and two [32, 4, 2560] bf16 shifts; zamba2's
    shared K/V [9, 4, 128, 32, 80] bf16, conv [9, 6, 4, 3, 5248] bf16 and
    SSD state [9, 6, 4, 80, 64, 64] fp32."""
    got = TKV(tget_arch(arch), device="cpu").nbytes(4, 128)
    assert got == JKV(jget_arch(arch)).nbytes(4, 128) == want
