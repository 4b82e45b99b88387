"""The port's serving front-end against the JAX package's, on the CPU.

The same ``RagRequest``s go through the reference ``TeleRAGServer``
(``kernel_mode="ref"``) and the port's (every tensor on the CPU), both on
the deterministic event clock with the H100 timing profile and no decode
hook, at a tiny size.  Doc ids must be equal, round telemetry and the
``ServerTelemetry`` snapshot equal within 1e-6, the flight-recorder
streams equal, and the port's stream must replay clean through the
reference's invariant checker and, to the same report, through the
port's own (``repro_torch.analysis``).  Cases: all six pipelines under both
dispatch disciplines, two replicas with the cache-aware scheduler,
open-loop arrivals with SLO deadlines and tenants, unfused retrieval,
and the deprecated shims.  The port's paged ``DecodeRunner`` is checked
on the port alone (the reference's paged decode varies from run to run
on the CPU); its dense path (``paged_decode=False``) against the
reference's dense runner, and its logits against the port's paged path.
"""

import dataclasses
import math
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core as jcore
import repro.serving.decode as jdecode
from repro.analysis import check_recorder
from repro.configs import get_arch as jget_arch
from repro.core.budget import H100 as JH100
from repro.models import transformer as jtf
from repro.core.schedulers import TeleRAGScheduler as JScheduler
from repro.serving import api as japi
from repro.serving import pipelines as jpipe
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.engine import TeleRAGEngine as JEngine
from repro.serving.trace import make_traces as jmake_traces
from repro_torch.analysis import check_recorder as tcheck_recorder
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import datastore as tds
from repro_torch.core import ivf as tivf
from repro_torch.core.schedulers import TeleRAGScheduler as TScheduler
from repro_torch.models import transformer as ttf
from repro_torch.serving import api as tapi
from repro_torch.serving import decode as tdecode
from repro_torch.serving import pipelines as tpipe
from repro_torch.serving.decode import DecodeRunner
from repro_torch.serving.engine import EngineConfig as TConfig
from repro_torch.serving.engine import TeleRAGEngine as TEngine
from repro_torch.serving.runtime import RequestState
from repro_torch.serving.trace import make_traces as tmake_traces

PIPELINES = ("hyde", "subq", "iter", "irg", "flare", "self_rag")
CFG = dict(nprobe=4, top_k=3, buffer_pages=40, lookahead_rank=8, chips=1,
           cache_enabled=True, seed=5)
TOL = 1e-6


@pytest.fixture(scope="module")
def world():
    js = jcore.synthetic_datastore(3000, dim=32, seed=3)
    ts = tds.synthetic_datastore(3000, dim=32, seed=3)
    ji = jcore.build_ivf(js, 16, page_size=32, kmeans_iters=4, seed=1,
                         train_sample=2000)
    ti = tivf.build_ivf(ts, 16, page_size=32, kmeans_iters=4, seed=1,
                        train_sample=2000, device="cpu")
    rng = np.random.default_rng(0)
    q = js.embeddings[rng.choice(js.num_vectors, 12)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return SimpleNamespace(ji=ji, ti=ti, q=q)


def _servers(w, replicas=1, *, cfg=None, scheduler=False, **kw):
    cfg = dict(CFG, **(cfg or {}))
    ref = japi.TeleRAGServer(
        w.ji, JConfig(kernel_mode="ref", hw=JH100, **cfg), replicas,
        jget_arch("llama3-8b"),
        scheduler=JScheduler() if scheduler else None, **kw)
    port = tapi.TeleRAGServer(
        w.ti, TConfig(**cfg), replicas, tget_arch("llama3-8b"),
        scheduler=TScheduler() if scheduler else None, **kw)
    return ref, port


def _requests(module, w, n, **fields):
    """``n`` requests of ``module``'s ``RagRequest``; each field is a
    value or a per-request list."""
    return [module.RagRequest(q=w.q[i], **{
        k: (v[i] if isinstance(v, list) else v) for k, v in fields.items()})
        for i in range(n)]


def _close(a, b, path="telemetry"):
    """Recursive equality of two dataclass-dict trees, floats within TOL."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert (math.isinf(a) and a == b) or abs(a - b) <= TOL, \
            f"{path}: {a} vs {b}"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _stream(recorder):
    """The recorder's events as dicts, paged KV lease ids renumbered by
    first appearance (both packages draw them from a process-wide
    counter)."""
    ids = {}
    out = []
    for e in recorder.events:
        d = dataclasses.asdict(e)
        if d.get("lease_id", -1) != -1:
            d["lease_id"] = ids.setdefault(d["lease_id"], len(ids))
        out.append(d)
    return out


def _replay(recorder):
    """The stream through the reference's invariant checker and the
    port's: equal reports, no violation; returns the reference's."""
    rep, trep = check_recorder(recorder), tcheck_recorder(recorder)
    assert (trep.summary(), trep.stats, trep.outstanding,
            [vars(v) for v in trep.violations]) == \
        (rep.summary(), rep.stats, rep.outstanding,
         [vars(v) for v in rep.violations])
    assert not rep.violations, [v.render() for v in rep.violations]
    return rep


def _assert_same(ref, port, jresp, tresp):
    assert len(tresp) == len(jresp) > 0
    for a, b in zip(jresp, tresp):
        assert (b.request_id, b.pipeline, b.replica, b.tenant) == \
            (a.request_id, a.pipeline, a.replica, a.tenant)
        assert b.state.value == a.state.value == "complete"
        assert [d.tolist() for d in b.doc_ids] == [d.tolist() for d in a.doc_ids]
        _close(dataclasses.asdict(a)["rounds"], dataclasses.asdict(b)["rounds"],
               f"request {a.request_id} rounds")
        _close([dataclasses.asdict(s) for s in a.timeline],
               [dataclasses.asdict(s) for s in b.timeline],
               f"request {a.request_id} timeline")
        for f in ("arrival_t", "admit_t", "complete_t"):
            assert abs(getattr(a, f) - getattr(b, f)) <= TOL, f
        assert (b.deadline_missed, b.deadline_missed_in_queue,
                b.demoted_rounds) == (a.deadline_missed,
                                      a.deadline_missed_in_queue,
                                      a.demoted_rounds)
    _close(dataclasses.asdict(ref.telemetry()),
           dataclasses.asdict(port.telemetry()))
    assert [dataclasses.asdict(d) for d in port.wave_log] == \
        [dataclasses.asdict(d) for d in ref.wave_log]
    assert _stream(port.recorder) == _stream(ref.recorder)
    assert _replay(port.recorder).checked_events > 0
    assert port.telemetry().summary() == ref.telemetry().summary()


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["static", "continuous"])
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_server_matches_reference(world, pipeline, continuous):
    ref, port = _servers(world, micro_batch=3, continuous=continuous)
    jresp = ref.serve(_requests(japi, world, 8, pipeline=pipeline))
    tresp = port.serve(_requests(tapi, world, 8, pipeline=pipeline))
    _assert_same(ref, port, jresp, tresp)
    assert sum(rt.hits for r in tresp for rt in r.rounds) > 0   # device hits


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["static", "continuous"])
def test_two_replicas_route_alike(world, continuous):
    """The cache-aware scheduler reads live residency and occupancy: both
    servers must route every micro-batch to the same replica, over two
    drains (the second sees the first's caches)."""
    ref, port = _servers(world, 2, scheduler=True, micro_batch=2,
                         continuous=continuous)
    for pipeline in ("iter", "hyde"):
        jresp = ref.serve(_requests(japi, world, 8, pipeline=pipeline))
        tresp = port.serve(_requests(tapi, world, 8, pipeline=pipeline))
        assert {r.replica for r in tresp} == {0, 1}
        _assert_same(ref, port, jresp, tresp)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["static", "continuous"])
def test_open_loop_arrivals_with_deadlines_and_tenants(world, continuous):
    """Staggered arrivals in a batching window, two tenants with pool
    shares, priorities and SLO deadlines some requests miss: queue and
    service times, miss verdicts and per-tenant telemetry agree."""
    n = 10
    fields = dict(pipeline=["irg", "flare"] * 5,
                  arrival_t=[0.0, 0.0, 0.05, 0.1, 0.1, 0.3, 0.32, 0.6, 0.61,
                             0.9],
                  deadline_s=[None, 0.5, 2.0, 0.2, None, 1.0, 0.05, 3.0,
                              None, 0.4],
                  priority=[0, 1, 0, 0, 1, 0, 0, 1, 0, 0],
                  tenant=["a", "b"] * 5)
    ref, port = _servers(world, cfg=dict(tenant_shares={"a": (8, None),
                                                        "b": (4, 24)}),
                         micro_batch=2, batch_window_s=0.05,
                         continuous=continuous)
    jresp = ref.serve(_requests(japi, world, n, **fields))
    tresp = port.serve(_requests(tapi, world, n, **fields))
    _assert_same(ref, port, jresp, tresp)
    tel = port.telemetry()
    assert {t.tenant for t in tel.tenants} == {"a", "b"}
    assert tel.deadline_missed > 0
    assert tapi.summarize_latency(tresp) == japi.summarize_latency(jresp)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["static", "continuous"])
def test_unfused_retrieval_server_matches_reference(world, continuous):
    ref, port = _servers(world, cfg=dict(fused_retrieval=False),
                         micro_batch=3, continuous=continuous)
    jresp = ref.serve(_requests(japi, world, 8, pipeline="iter"))
    tresp = port.serve(_requests(tapi, world, 8, pipeline="iter"))
    _assert_same(ref, port, jresp, tresp)


def test_deprecated_shims_warn_and_match_reference(world):
    traces_j = jmake_traces("iter", 6, seed=4)
    traces_t = tmake_traces("iter", 6, seed=4)
    q = world.q[:6]
    with pytest.warns(DeprecationWarning):
        jorch = jpipe.MultiReplicaOrchestrator(
            world.ji, JConfig(kernel_mode="ref", hw=JH100, **CFG), 2,
            jget_arch("llama3-8b")).run_global_batch(q, traces_j,
                                                     micro_batch=2)
    with pytest.warns(DeprecationWarning):
        torch_orch = tpipe.MultiReplicaOrchestrator(
            world.ti, TConfig(**CFG), 2, tget_arch("llama3-8b"))
        tgot = torch_orch.run_global_batch(q, traces_t, micro_batch=2)
    assert tgot.assignments == jorch.assignments
    for a, b in zip(jorch.all_results(), tgot.all_results()):
        assert [d.tolist() for d in b.doc_ids] == [d.tolist() for d in a.doc_ids]
        _close([dataclasses.asdict(r) for r in a.rounds],
               [dataclasses.asdict(r) for r in b.rounds])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jex = jpipe.PipelineExecutor(JEngine(
            world.ji, JConfig(kernel_mode="ref", hw=JH100, **CFG)))
        tex = tpipe.PipelineExecutor(TEngine(world.ti, TConfig(**CFG)))
    for a, b in zip(jex.execute_batch(q, traces_j),
                    tex.execute_batch(q, traces_t)):
        assert [d.tolist() for d in b.doc_ids] == [d.tolist() for d in a.doc_ids]
        _close([dataclasses.asdict(r) for r in a.rounds],
               [dataclasses.asdict(r) for r in b.rounds])


def _decode_server(w, **engine):
    cfg = tget_arch("llama3-8b").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    runner = DecodeRunner(model, max_len=32, max_steps=4, page_size=4,
                          slab_seqs=8)
    srv = tapi.TeleRAGServer(
        w.ti, TConfig(**dict(CFG, pool_pages=40 + 64, **engine)), 1, cfg,
        micro_batch=2, include_tail=True, decode_hook=runner,
        continuous=True)
    return srv, runner


def test_decode_runner_events_reach_the_runtime(world):
    """A port-only run with the ``DecodeRunner`` as decode hook: every
    wave's decode events land on the recorder as ``decode`` steps, each
    round's generation window is the observed per-step time scaled to
    its tokens, and the leases all return to the pool."""
    srv, runner = _decode_server(world)
    runner.attach(srv)
    assert runner.clock is srv.wall
    resp = srv.serve(_requests(tapi, world, 4, pipeline="irg"))
    assert all(r.state is RequestState.COMPLETE for r in resp)
    steps = [e for e in srv.recorder.events if e.kind == "decode"]
    assert runner.stats["paged_waves"] > 0 and steps
    assert {e.request_id for e in steps} == {r.request_id for r in resp}
    assert sum(e.tokens for e in steps) > 0
    by_wave = {}
    for e in steps:
        by_wave.setdefault((e.wave_id, e.request_id), e)
    for r in resp:
        for rt in r.rounds:
            ev = by_wave[(rt.wave_id, r.request_id)]
            if ev.tokens > 0:
                assert rt.t_llm_window == pytest.approx(
                    ev.seconds * rt.gen_tokens / ev.tokens, rel=1e-9)
    assert all(len(v) > 0 for v in runner.generated.values())
    assert not [l for l in srv.engines[0].pool.leases.values()
                if l.owner == "kv"]
    _replay(srv.recorder)


def test_decode_runner_serves_dense_decode(world):
    """Dense decode is served, not refused: with ``paged_decode=False``
    the runner takes the dense path, allocates no page slab, and serves
    every wave through a dense bucket that goes back to the pool."""
    srv, runner = _decode_server(world, paged_decode=False)
    runner.attach(srv)
    assert not runner.paged and runner._kv[0].slab is None
    resp = srv.serve(_requests(tapi, world, 4, pipeline="irg"))
    assert all(r.state is RequestState.COMPLETE for r in resp)
    assert runner.stats["dense_waves"] > 0 and runner.stats["dense_steps"] > 0
    assert runner.stats["paged_waves"] == runner.stats["paged_appends"] == 0
    kv = [e for e in srv.recorder.events if e.kind.startswith("kv.")]
    assert kv and all(e.lease_id == -1 for e in kv)
    runner._kv[0].drop_all()
    assert not [l for l in srv.engines[0].pool.leases.values()
                if l.owner == "kv"]
    _replay(srv.recorder)


def _decode_servers(w, **engine):
    """The reference's and the port's servers, each with its own
    ``DecodeRunner`` over the same fp32 weights (the reference's
    ``init_params``), on the deterministic event clock."""
    jc, tc = jget_arch("llama3-8b").reduced(), tget_arch("llama3-8b").reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    runner = dict(max_len=32, max_steps=4, page_size=4, slab_seqs=8)
    cfg = dict(CFG, pool_pages=40 + 64, **engine)
    jrun = jdecode.DecodeRunner(params, jc, **runner)
    trun = DecodeRunner(model, **runner)
    ref = japi.TeleRAGServer(w.ji, JConfig(kernel_mode="ref", hw=JH100, **cfg),
                             1, jc, micro_batch=2, include_tail=True,
                             decode_hook=jrun, continuous=True)
    port = tapi.TeleRAGServer(w.ti, TConfig(**cfg), 1, tc, micro_batch=2,
                              include_tail=True, decode_hook=trun,
                              continuous=True)
    jrun.attach(ref)
    trun.attach(port)
    return ref, port, jrun, trun


@pytest.mark.parametrize("pipeline", ["irg", "flare"])
def test_dense_decode_server_matches_reference(world, pipeline):
    """``paged_decode=False`` end to end against the reference's server:
    the same doc ids, telemetry within 1e-6, the same recorder stream
    (dense bucket recycling, spills and pressure parks included; a clean
    ``check_recorder`` replay is part of ``_assert_same``) and the same
    greedy tokens from the two dense runners.  The reference's dense
    runner is one jitted step with nothing overlapped, and gives the
    same tokens from run to run, so it is the yardstick itself (its
    paged runner is not: ROADMAP queue 3)."""
    ref, port, jrun, trun = _decode_servers(world, paged_decode=False)
    assert not jrun.paged and not trun.paged
    jresp = ref.serve(_requests(japi, world, 6, pipeline=pipeline))
    tresp = port.serve(_requests(tapi, world, 6, pipeline=pipeline))
    _assert_same(ref, port, jresp, tresp)
    assert trun.stats == {k: jrun.stats[k] for k in trun.stats}
    assert trun.stats["dense_waves"] > 0
    assert trun.generated == jrun.generated
    assert any(e.kind == "kv.acquire" and e.recycled
               for e in port.recorder.events)


def test_dense_decode_logits_match_paged_decode(world, monkeypatch):
    """The port's dense and paged decode paths on the same requests give
    the same logits step by step, within 1e-4 in fp32.  The sampler is
    replaced by a fixed token pattern, so both paths see the same tokens
    whatever their logits (no greedy-token equality is asked)."""
    cfg = tget_arch("llama3-8b").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    logits = {}

    def run(paged):
        seen = logits.setdefault(paged, [])

        def fixed(lg):
            seen.append(lg.clone())
            return (torch.arange(lg.shape[0], dtype=torch.int32) * 7
                    + len(seen)) % cfg.vocab_size
        monkeypatch.setattr(tdecode, "sample", fixed)
        runner = DecodeRunner(model, max_len=32, max_steps=4, page_size=4,
                              slab_seqs=8, kv_dtype=torch.float32)
        srv = tapi.TeleRAGServer(
            world.ti, TConfig(**dict(CFG, pool_pages=40 + 512,
                                     paged_decode=paged)), 1, cfg,
            micro_batch=2, include_tail=True, decode_hook=runner,
            continuous=True)
        runner.attach(srv)
        srv.serve(_requests(tapi, world, 6, pipeline="irg"))
        return runner

    paged, dense = run(True), run(False)
    assert paged.stats["paged_waves"] == dense.stats["dense_waves"] > 0
    assert dense.generated == paged.generated
    assert len(logits[True]) == len(logits[False]) > 0
    for step, (a, b) in enumerate(zip(logits[True], logits[False])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {step}")
