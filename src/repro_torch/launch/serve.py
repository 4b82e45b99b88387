"""Serving driver: lookahead-prefetch retrieval + real paged decode on the
card, at the full width of the arch (random weights from a seeded
``torch.Generator``; nothing is downloaded).

It builds a synthetic datastore and its IVF index on the device, the
engine (page pool, prefetch buffer, transfer engine, H100 timing
profile) and a ``DecodeRunner`` over the model, then serves
``--requests`` requests from ``make_traces(--pipeline)`` in micro-batches
of ``--batch``.  Each round of a micro-batch:

  1. ``engine.lookahead_ex(q_in, gen_tokens)`` probes, plans and
     dispatches the async host-to-device copy of the predicted clusters;
  2. the ``DecodeRunner`` decodes the round's tokens while that copy is
     in flight;
  3. ``synthetic_rewrite`` turns q_in into q_out;
  4. ``engine.retrieve(q_out)`` runs the fused device search over
     resident pages (after a device-side wait on the copy), the host
     search over misses, and the merge.

``engine.end_batch()`` closes each micro-batch.

    PYTHONPATH=src python -m repro_torch.launch.serve --pipeline irg \\
        --requests 8 --batch 4
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.datastore import synthetic_datastore
from repro_torch.core.embedder import synthetic_rewrite
from repro_torch.core.hybrid_search import host_search
from repro_torch.core.ivf import build_ivf, probe
from repro_torch.models import transformer as tf
from repro_torch.obs.clock import SystemClock
from repro_torch.serving.decode import DecodeRunner
from repro_torch.serving.engine import EngineConfig, TeleRAGEngine
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.trace import RequestTrace, make_traces


@dataclass
class Request:
    """One request's state across its rounds (what the driver reports)."""

    request_id: int
    q: np.ndarray                       # [d] prompt embedding
    trace: RequestTrace
    tenant: str = "shared"
    cur_q: Optional[np.ndarray] = None  # query the next round's lookahead uses
    doc_ids: List[np.ndarray] = field(default_factory=list)
    queries: List[np.ndarray] = field(default_factory=list)  # q_out per row
    hits: int = 0
    misses: int = 0

    def __post_init__(self):
        if self.cur_q is None:
            self.cur_q = self.q


def round_plan(trace: RequestTrace) -> List[Tuple[int, int]]:
    """[(gen_tokens_before_retrieval, num_queries), ...] per round."""
    plan: List[Tuple[int, int]] = []
    acc = 0
    for s in trace.stages:
        if s.kind == "retrieve":
            plan.append((acc, s.num_queries))
            acc = 0
        else:
            acc += s.gen_tokens
    return plan


@dataclass
class RoundStats:
    """Host-clock milliseconds of one round's phases (the decode and the
    retrieval end in a device sync; the lookahead is dispatch only)."""

    batch: int
    gen_steps: int
    lookahead_ms: float
    decode_ms: float
    retrieve_ms: float
    hits: int
    misses: int
    bytes_planned: int


def run_rounds(engine, runner, requests: Sequence[Request],
               rng: np.random.Generator, *, batch: int,
               clock=None) -> List[RoundStats]:
    """Serve ``requests`` in micro-batches of ``batch`` through
    ``engine`` and the decode hook ``runner`` (duck-typed, so the same
    loop drives the reference package's engine in the parity tests).
    Fills each request's ``doc_ids``/``hits``/``misses``; returns one
    ``RoundStats`` per round."""
    clock = clock or SystemClock()
    stats: List[RoundStats] = []
    for b0 in range(0, len(requests), batch):
        members = list(requests[b0:b0 + batch])
        plans = [round_plan(m.trace) for m in members]
        for rnd in range(max(len(p) for p in plans)):
            act = [j for j in range(len(members)) if rnd < len(plans[j])]
            q_in = np.stack([members[j].cur_q for j in act])
            gen = [plans[j][rnd][0] for j in act]
            t0 = clock.perf()
            nbytes, _, _ = engine.lookahead_ex(q_in, gen)
            t1 = clock.perf()
            evs = runner(0, [members[j] for j in act], gen, rnd)
            t2 = clock.perf()
            rows, owners = [], []
            for k, j in enumerate(act):
                sigma = members[j].trace.rewrite_sigma
                for _ in range(plans[j][rnd][1]):
                    rows.append(synthetic_rewrite(q_in[k][None, :], sigma, rng)[0]
                                if sigma > 0 else q_in[k])
                    owners.append(j)
            q_out = np.stack(rows)
            res = engine.retrieve(q_out)
            t3 = clock.perf()
            hits = misses = 0
            for r, j in enumerate(owners):
                m = members[j]
                m.doc_ids.append(np.asarray(res.doc_ids[r]))
                m.queries.append(q_out[r])
                m.hits += len(res.hit_clusters[r])
                m.misses += len(res.missed_clusters[r])
                hits += len(res.hit_clusters[r])
                misses += len(res.missed_clusters[r])
            for j in act:
                members[j].cur_q = q_out[owners.index(j)]
            stats.append(RoundStats(
                batch=len(act), gen_steps=max((e.tokens for e in evs), default=0),
                lookahead_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                retrieve_ms=(t3 - t2) * 1e3, hits=hits, misses=misses,
                bytes_planned=int(nbytes)))
        engine.end_batch()
    return stats


def retrieval_gap(store, index, requests: Sequence[Request], nprobe: int,
                  k: int) -> float:
    """Hold every retrieved row against an exact fp32 host search over
    the same ``nprobe`` probed clusters.  Returns the largest gap between
    the returned docs' exact scores and the exact top-k scores, sorted:
    0 up to the rounding of the bf16 device pages (a near-tied doc may
    swap in).  Raises on a padding id or a duplicate."""
    gap = 0.0
    for r in requests:
        for q, ids in zip(r.queries, r.doc_ids):
            if (ids < 0).any() or len(set(ids.tolist())) != len(ids):
                raise AssertionError(f"request {r.request_id}: doc ids {ids}")
            want, _ = host_search(index.paged, probe(q, index, nprobe)[0], q, k)
            got = np.sort(store.embeddings[ids] @ q)[::-1]
            gap = max(gap, float(np.abs(got - want).max()))
    return gap


def make_requests(store, n: int, pipeline: str, seed: int) -> List[Request]:
    """``n`` prompt embeddings near datastore vectors, with seeded traces."""
    rng = np.random.default_rng(seed + 1)
    q = store.embeddings[rng.choice(store.num_vectors, n)]
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    traces = make_traces(pipeline, n, seed=seed)
    return [Request(request_id=i, q=q[i], trace=traces[i]) for i in range(n)]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (width is never cut)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config (CPU runs)")
    ap.add_argument("--pipeline", default="irg")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--vectors", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--clusters", type=int, default=1024)
    ap.add_argument("--train-sample", type=int, default=131_072)
    ap.add_argument("--kmeans-iters", type=int, default=10)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--buffer-pages", type=int, default=4096)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-steps", type=int, default=32)
    ap.add_argument("--kv-page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quiet", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Build and serve per the arguments; prints a report and returns a
    summary dict (``chip_smoke.py`` reads it)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # the probe's ranking and the fused kernel's own centroid scores must
    # agree on the nprobe cut: keep fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say = (lambda *a: None) if args.quiet else print
    clock = SystemClock()

    t0 = clock.perf()
    store = synthetic_datastore(args.vectors, dim=args.dim, seed=args.seed)
    index = build_ivf(store, args.clusters, page_size=args.page_size,
                      kmeans_iters=args.kmeans_iters, seed=args.seed,
                      train_sample=args.train_sample, device=dev)
    t_index = clock.perf() - t0
    say(f"# datastore {args.vectors} x {args.dim}, {args.clusters} clusters, "
        f"{index.paged.total_pages} pages of {args.page_size} "
        f"({t_index:.1f} s)")

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.layers is not None and args.layers != arch.num_layers:
        say(f"# cut: {args.arch} depth {arch.num_layers} -> {args.layers} "
            "layers (width unchanged)")
        arch = dataclasses.replace(arch, num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = tf.init_params(arch, gen, device=dev)

    kv_bytes = KVCacheManager(arch, device=dev).nbytes(args.batch, args.max_len)
    page_bytes = index.paged.page_nbytes()
    engine = TeleRAGEngine(index, EngineConfig(
        nprobe=args.nprobe, top_k=args.top_k, buffer_pages=args.buffer_pages,
        pool_pages=args.buffer_pages + -(-kv_bytes // page_bytes),
        lookahead_rank=min(2 * args.nprobe, args.clusters),
        cache_enabled=True, chips=1), arch, wall_clock=clock)
    engine.calibrate_tcc()
    runner = DecodeRunner(model, max_len=args.max_len,
                          max_steps=args.max_steps,
                          page_size=args.kv_page_size,
                          slab_seqs=max(2 * args.batch, 8)).attach([engine],
                                                                   clock)

    requests = make_requests(store, args.requests, args.pipeline, args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = clock.perf()
    rounds = run_rounds(engine, runner, requests,
                        np.random.default_rng(args.seed + 2),
                        batch=args.batch, clock=clock)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = clock.perf() - t0

    gap = retrieval_gap(store, index, requests, args.nprobe, args.top_k)
    copy_ms = [s.elapsed_time(e) for s, e, _ in engine.buffer.copies]
    copy_bytes = [nb for _, _, nb in engine.buffer.copies]
    tokens = sum(r.gen_steps * r.batch for r in rounds)
    decode_s = sum(r.decode_ms for r in rounds if r.gen_steps) / 1e3
    steps = sum(r.gen_steps for r in rounds)
    for r in requests:
        say(f"req {r.request_id:3d} [{r.trace.pipeline}] rounds={len(r.doc_ids)} "
            f"hit_rate={r.hits / max(r.hits + r.misses, 1):.0%} "
            f"docs={[int(d[0]) for d in r.doc_ids]}")
    tps = tokens / decode_s if decode_s > 0 else 0.0
    ret_ms = [r.retrieve_ms for r in rounds]
    look_ms = [r.lookahead_ms for r in rounds]
    say(f"# {card}: {len(requests)} requests, {len(rounds)} rounds in "
        f"{wall:.2f} s; decode {tokens} tokens in {decode_s:.3f} s "
        f"({tps:.1f} tok/s, {1e3 * decode_s / max(steps, 1):.2f} ms/step at "
        f"batch {args.batch}); retrieval {np.mean(ret_ms):.2f} ms/round "
        f"(max {max(ret_ms):.2f}); lookahead dispatch {np.mean(look_ms):.2f} "
        f"ms/round (max {max(look_ms):.2f}); h2d {sum(copy_bytes) / 1e6:.1f} MB in "
        f"{len(copy_ms)} copies ({sum(copy_ms):.2f} ms on the copy stream); "
        f"retrieval vs exact host search: max score gap {gap:.2e}")
    return {
        "device": card, "arch": arch.name, "layers": arch.num_layers,
        "requests": len(requests), "rounds": [dataclasses.asdict(r) for r in rounds],
        "doc_ids": {r.request_id: [d.tolist() for d in r.doc_ids] for r in requests},
        "hits": sum(r.hits for r in requests),
        "misses": sum(r.misses for r in requests),
        "rounds_with_hits": sum(1 for r in rounds if r.hits > 0),
        "decode_tokens": tokens, "decode_s": decode_s, "decode_steps": steps,
        "tokens_per_s": tps,
        "copy_ms": copy_ms, "copy_bytes": copy_bytes, "wall_s": wall,
        "index_s": t_index, "bytes_h2d": engine.buffer.stats.bytes_h2d,
        "retrieval_gap": gap,
    }


if __name__ == "__main__":
    main()
