"""The port's serving round loop against the JAX package's engine, on the CPU.

``run_rounds`` (a hand-written round loop: lookahead dispatch, decode
while the copy is in flight, rewrite, hybrid retrieval, end of batch)
drives the reference engine + decode runner and the
port's, fp32 weights from the reference's ``init_params``, tiny config.
Doc ids, hits and misses, bytes moved, ledger bytes and the flight-
recorder stream must be equal, and the port's stream must replay clean
through the reference's invariant checker.  Every decode step's logits
must agree within 1e-4 with the reference model's on the same tokens,
and the greedy tokens must be equal wherever the reference's top-2
margin exceeds that tolerance.
"""

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional, Sequence

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
from repro.obs.clock import EventClock as JClock
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.engine import TeleRAGEngine as JEngine
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import budget as tbudget
from repro_torch.core import datastore as tds
from repro_torch.core.embedder import synthetic_rewrite
from repro_torch.core import ivf as tivf
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
import repro_torch.serving.decode as tdecode
from repro_torch.obs.clock import EventClock as TClock
from repro_torch.serving.engine import EngineConfig as TConfig
from repro_torch.serving.engine import TeleRAGEngine as TEngine
from repro_torch.serving.runtime import round_plan
from repro_torch.serving.trace import RequestTrace, make_traces

LOGIT_TOL = 1e-4
CFG = dict(nprobe=6, top_k=3, buffer_pages=48, pool_pages=48 + 128,
           lookahead_rank=12, cache_enabled=True, chips=1)
RUNNER = dict(max_len=32, max_steps=8, page_size=4, slab_seqs=8)


@dataclass
class Request:
    """One request's state across the rounds of ``run_rounds``."""

    request_id: int
    q: np.ndarray                       # [d] prompt embedding
    trace: RequestTrace
    tenant: str = "shared"
    cur_q: Optional[np.ndarray] = None  # query the next round's lookahead uses
    doc_ids: List[np.ndarray] = field(default_factory=list)
    hits: int = 0
    misses: int = 0

    def __post_init__(self):
        if self.cur_q is None:
            self.cur_q = self.q


@dataclass
class RoundStats:
    """What one round of ``run_rounds`` did."""

    batch: int
    gen_steps: int
    hits: int
    misses: int
    bytes_planned: int


def run_rounds(engine, runner, requests: Sequence[Request],
               rng: np.random.Generator, *, batch: int) -> List[RoundStats]:
    """Serve ``requests`` in micro-batches of ``batch`` through
    ``engine`` and the decode hook ``runner`` (duck-typed, so the same
    loop drives the reference package's engine and the port's).
    Fills each request's ``doc_ids``/``hits``/``misses``; returns one
    ``RoundStats`` per round."""
    stats: List[RoundStats] = []
    for b0 in range(0, len(requests), batch):
        members = list(requests[b0:b0 + batch])
        plans = [round_plan(m.trace) for m in members]
        for rnd in range(max(len(p) for p in plans)):
            act = [j for j in range(len(members)) if rnd < len(plans[j])]
            q_in = np.stack([members[j].cur_q for j in act])
            gen = [plans[j][rnd][0] for j in act]
            nbytes, _, _ = engine.lookahead_ex(q_in, gen)
            evs = runner(0, [members[j] for j in act], gen, rnd)
            rows, owners = [], []
            for k, j in enumerate(act):
                sigma = members[j].trace.rewrite_sigma
                for _ in range(plans[j][rnd][1]):
                    rows.append(synthetic_rewrite(q_in[k][None, :], sigma, rng)[0]
                                if sigma > 0 else q_in[k])
                    owners.append(j)
            q_out = np.stack(rows)
            res = engine.retrieve(q_out)
            hits = misses = 0
            for r, j in enumerate(owners):
                m = members[j]
                m.doc_ids.append(np.asarray(res.doc_ids[r]))
                m.hits += len(res.hit_clusters[r])
                m.misses += len(res.missed_clusters[r])
                hits += len(res.hit_clusters[r])
                misses += len(res.missed_clusters[r])
            for j in act:
                members[j].cur_q = q_out[owners.index(j)]
            stats.append(RoundStats(
                batch=len(act), gen_steps=max((e.tokens for e in evs), default=0),
                hits=hits, misses=misses, bytes_planned=int(nbytes)))
        engine.end_batch()
    return stats


def make_requests(store, n: int, pipeline: str, seed: int) -> List[Request]:
    """``n`` prompt embeddings near datastore vectors, with seeded traces."""
    q = tserve.make_queries(store, n, seed)
    traces = make_traces(pipeline, n, seed=seed)
    return [Request(request_id=i, q=q[i], trace=traces[i]) for i in range(n)]


def _record_logits(monkeypatch, module, sink):
    orig = module.sample

    def spy(logits, *a, **kw):
        sink.append(np.array(logits.numpy() if isinstance(logits, torch.Tensor)
                             else logits, np.float32, copy=True))
        return orig(logits, *a, **kw)

    monkeypatch.setattr(module, "sample", spy)


@pytest.fixture(scope="module")
def world():
    store_j = jcore.synthetic_datastore(4000, dim=32, seed=5)
    store_t = tds.synthetic_datastore(4000, dim=32, seed=5)
    ji = jcore.build_ivf(store_j, 24, page_size=32, kmeans_iters=4, seed=0)
    ti = tivf.build_ivf(store_t, 24, page_size=32, kmeans_iters=4, seed=0,
                        device="cpu")
    jc, tc = jget_arch("llama3-8b").reduced(), tget_arch("llama3-8b").reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return SimpleNamespace(store=store_t, ji=ji, ti=ti, jc=jc, tc=tc,
                           params=params, model=model)


def _stream(recorder):
    """The recorder's events as dicts, paged KV lease ids renumbered by
    first appearance: both packages draw them from a process-wide
    counter, which earlier tests in the same process have advanced."""
    ids = {}
    out = []
    for e in recorder.events:
        d = dataclasses.asdict(e)
        if d.get("lease_id", -1) != -1:
            d["lease_id"] = ids.setdefault(d["lease_id"], len(ids))
        out.append(d)
    return out


def _waves(runner, logits):
    """The port's decode hook, noting which recorded steps each wave
    made: [(first, end), ...] into ``logits``."""
    spans = []

    def hook(*args):
        first = len(logits)
        out = runner(*args)
        spans.append((first, len(logits)))
        return out
    return hook, spans


def _replay_reference(w, mode, logits, spans):
    """The reference model's logits for every step of the port's decode
    waves, one step at a time, fed the port's greedy tokens.

    Each wave starts from token 0 at length 0 on a fresh lease, and
    attention reads only the positions the wave wrote, so a zero slab
    and any block table of distinct pages give the same logits.  The
    reference's own ``DecodeRunner`` overlaps its steps with the
    engine's pending device work and, on the CPU, gives different logits
    from run to run in one process (ROADMAP, queue 3), so it is not the
    yardstick here."""
    cfg = w.jc
    ps, MB = RUNNER["page_size"], -(-RUNNER["max_len"] // RUNNER["page_size"])
    step = jax.jit(lambda k, v, bt, lens, tok: jtf.serve_step_paged(
        w.params, k, v, bt, lens, {"token": tok}, cfg, kernel_mode=mode))
    out = []
    for first, end in spans:
        n = logits[first].shape[0]
        shape = (cfg.num_layers, n * MB, ps, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        k = v = jnp.zeros(shape, jnp.bfloat16)     # the runners' slab dtype
        bt = np.arange(n * MB, dtype=np.int32).reshape(n, MB)
        tok = np.zeros(n, np.int32)
        for s in range(first, end):
            lens = np.full(n, s - first, np.int32)
            lg, k, v = step(k, v, jnp.asarray(bt), jnp.asarray(lens),
                            jnp.asarray(tok))
            out.append(np.array(lg, np.float32, copy=True))
            tok = logits[s].argmax(-1).astype(np.int32)
    return out


def _run_reference(w, mode):
    eng = JEngine(w.ji, JConfig(kernel_mode=mode, hw=JH100, **CFG), w.jc)
    runner = jdecode.DecodeRunner(w.params, w.jc, paged=True, **RUNNER)
    runner.attach(SimpleNamespace(wall=JClock(eng.recorder), engines=[eng]))
    reqs = make_requests(w.store, 8, "irg", seed=2)
    rounds = run_rounds(eng, runner, reqs, np.random.default_rng(9), batch=4)
    return eng, runner, reqs, rounds


def _run_port(w, monkeypatch, logits):
    eng = TEngine(w.ti, TConfig(**CFG), w.tc)
    runner = tdecode.DecodeRunner(w.model, **RUNNER).attach(
        SimpleNamespace(wall=TClock(eng.recorder), engines=[eng]))
    _record_logits(monkeypatch, tdecode, logits)
    hook, spans = _waves(runner, logits)
    reqs = make_requests(w.store, 8, "irg", seed=2)
    rounds = run_rounds(eng, hook, reqs, np.random.default_rng(9), batch=4)
    return eng, runner, reqs, rounds, spans


@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_round_loop_matches_reference_engine(world, mode, monkeypatch):
    tl = []
    jeng, jrun, jreqs, jrounds = _run_reference(world, mode)
    teng, trun, treqs, trounds, spans = _run_port(world, monkeypatch, tl)

    for a, b in zip(jreqs, treqs):
        assert [d.tolist() for d in b.doc_ids] == [d.tolist() for d in a.doc_ids]
        assert (b.hits, b.misses) == (a.hits, a.misses)
    assert sum(r.hits for r in trounds) > 0                 # device hits
    assert [(r.hits, r.misses, r.bytes_planned, r.gen_steps) for r in trounds] \
        == [(r.hits, r.misses, r.bytes_planned, r.gen_steps) for r in jrounds]
    assert (teng.buffer.stats.bytes_h2d, teng.buffer.stats.pages_h2d,
            teng.buffer.stats.rounds) == (jeng.buffer.stats.bytes_h2d,
                                          jeng.buffer.stats.pages_h2d,
                                          jeng.buffer.stats.rounds)
    assert teng.ledger.snapshot() == jeng.ledger.snapshot()
    assert trun.stats == {k: jrun.stats[k] for k in trun.stats}

    # decode: every step's logits within tolerance of the reference
    # model's on the same tokens, and equal greedy tokens wherever the
    # reference's top-2 margin is wider than that tolerance
    jl = _replay_reference(world, mode, tl, spans)
    assert len(tl) == len(jl) == sum(r.gen_steps for r in trounds) > 0
    for step, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(b, a, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_TOL
        np.testing.assert_array_equal(b.argmax(-1)[sure], a.argmax(-1)[sure])

    # the port's trace: clean replay, and the same stream as the reference
    rep = check_recorder(teng.recorder)
    assert not rep.violations, [v.render() for v in rep.violations]
    assert _stream(teng.recorder) == _stream(jeng.recorder)


def test_engine_defaults_to_the_h100_profile_and_charges_weights(world):
    assert TConfig().hw == tbudget.H100
    eng = TEngine(world.ti, TConfig(**CFG), world.tc)
    assert eng.ledger.capacity_bytes == int(tbudget.H100.hbm_bytes)
    assert eng.ledger.snapshot()["weights"] == world.tc.param_count() * 2
    assert eng.pool.device == torch.device("cpu")


def test_full_llama3_8b_weights_fit_the_h100_ledger():
    arch = tget_arch("llama3-8b")
    assert 15e9 < arch.param_count() * 2 < 17e9       # ~16 GB in bf16
    assert arch.param_count() * 2 < tbudget.H100.hbm_bytes


def test_driver_runs_end_to_end_on_cpu_at_tiny_size():
    out = tserve.main(["--device", "cpu", "--reduced", "--vectors", "3000",
                       "--dim", "32", "--clusters", "16", "--train-sample",
                       "2000", "--page-size", "32", "--nprobe", "4",
                       "--buffer-pages", "64", "--requests", "4", "--batch",
                       "2", "--max-steps", "4", "--quiet"])
    assert out["requests"] == 4 and out["device"] == "cpu"
    assert out["decode"] == "paged"
    assert out["rounds_with_hits"] >= 1
    assert out["decode_tokens"] > 0
    assert all(rows and all(len(row) == 3 and min(row) >= 0 for row in rows)
               for rows in out["doc_ids"].values())
    assert out["retrieval_gap"] < 1e-2       # bf16 device pages vs fp32 host


def test_driver_runs_dense_decode_end_to_end_on_cpu_at_tiny_size():
    out = tserve.main(["--device", "cpu", "--reduced", "--vectors", "3000",
                       "--dim", "32", "--clusters", "16", "--train-sample",
                       "2000", "--page-size", "32", "--nprobe", "4",
                       "--buffer-pages", "64", "--requests", "4", "--batch",
                       "2", "--max-steps", "4", "--dense-decode", "--quiet"])
    assert out["decode"] == "dense" and out["retrieval"] == "fused"
    assert out["requests"] == 4 and out["decode_tokens"] > 0
    assert out["rounds_with_hits"] >= 1
    assert all(rows and all(len(row) == 3 and min(row) >= 0 for row in rows)
               for rows in out["doc_ids"].values())
    assert out["retrieval_gap"] < 1e-2       # bf16 device pages vs fp32 host
