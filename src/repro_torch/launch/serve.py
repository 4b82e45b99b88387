"""Serving driver: ``TeleRAGServer`` with lookahead-prefetch retrieval and
real decode on the card, at the full width of the arch (random
weights from a seeded ``torch.Generator``; nothing is downloaded).

Set-up (``build``): a synthetic datastore and its IVF index on the
device, the datastore's pages pinned in host memory, and the model.
Serving (``serve``): one ``TeleRAGServer`` over that build — the
engine (page pool, prefetch buffer, transfer engine, H100 timing
profile), a ``RetrievalRuntime`` and a ``DecodeRunner`` as its decode
hook — answers ``--requests`` typed ``RagRequest``s of ``--pipeline``.
At each round frontier the runtime dispatches the wave's lookahead copy,
the hook decodes the wave's tokens while that copy is in flight (its
measured seconds drive the event clock), and the engine runs hybrid
retrieval (fused by default; ``serve(setup, fused_retrieval=False)``
takes the unfused ``ivf_topk`` path).  Decode is paged by default
(``flash_decode_paged``); ``--dense-decode`` or ``serve(setup,
paged_decode=False)`` decodes over dense ``[B, max_len]`` buckets
(``flash_decode``).  ``serve(setup, chunk_store=store, chunk_kv=True)``
splices each wave's previously retrieved documents from a precomputed
chunk-KV store (``data.chunk_kv.build_chunk_kv``) and decodes those
waves with ``flash_decode_spliced``; the pool and the KV slab grow by
the store's pages, so every stored doc can be resident at once (there
is no CLI flag for it, as the reference has none).  Per-request
continuous batching is the default; ``--static-groups`` runs the legacy
group-granular discipline.  ``serve`` may run several times over one
``build``.

    PYTHONPATH=src python -m repro_torch.launch.serve --pipeline irg \\
        --requests 8 --batch 4 [--arch granite-moe-3b-a800m] [--layers N] \\
        [--dense-decode] [--trace-out trace.json]

``--arch`` takes any registered config but musicgen's codebooks, at
full width: the Llama-3 family, the MoE family, the plain-MLP and vision
configs decode paged; gemma2-27b (local/global layers over a split
cache), minicpm3-4b (MLA's latent cache), rwkv6-3b (RWKV6's shifts and
wkv state, no attention) and zamba2-2.7b (Mamba2 states and the shared
block's K/V) always decode dense, since
``DecodeRunner.attach`` ANDs the engine's ``paged_decode`` with
``supports_paged_decode``, as the reference's.  ``--layers N`` cuts the
depth and prints the cut.  ``--print-env`` prints the recommended
launch environment (``launch/env.py``) and exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.datastore import Datastore, synthetic_datastore
from repro_torch.core.hybrid_search import host_search
from repro_torch.core.ivf import IVFIndex, build_ivf, probe
from repro_torch.core.prefetch_buffer import host_pages
from repro_torch.data.chunk_kv import ChunkKVStore
from repro_torch.launch import env as launch_env
from repro_torch.models import transformer as tf
from repro_torch.obs.analyze import analyze
from repro_torch.obs.clock import SystemClock
from repro_torch.obs.export import write_jsonl, write_trace
from repro_torch.serving.api import (RagRequest, TeleRAGServer,
                                     summarize_latency)
from repro_torch.serving.decode import DecodeRunner
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.trace import make_traces


def retrieval_gap(index, searches: Sequence[Tuple[np.ndarray, np.ndarray]],
                  embeddings: np.ndarray, nprobe: int, k: int) -> float:
    """Hold every retrieved row ``(q_out, doc ids)`` against an exact fp32
    host search over the same ``nprobe`` probed clusters.  Returns the
    largest gap between the returned docs' exact scores and the exact
    top-k scores, sorted: 0 up to the rounding of the bf16 device pages
    (a near-tied doc may swap in).  Raises on a padding id or a
    duplicate."""
    gap = 0.0
    for q, ids in searches:
        if (ids < 0).any() or len(set(ids.tolist())) != len(ids):
            raise AssertionError(f"query row: doc ids {ids}")
        want, _ = host_search(index.paged, probe(q, index, nprobe)[0], q, k)
        got = np.sort(embeddings[ids] @ q)[::-1]
        gap = max(gap, float(np.abs(got - want).max()))
    return gap


def make_queries(store, n: int, seed: int) -> np.ndarray:
    """``n`` unit prompt embeddings near datastore vectors."""
    rng = np.random.default_rng(seed + 1)
    q = store.embeddings[rng.choice(store.num_vectors, n)]
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b",
                    help="a registered config at its full width: llama3-8b, "
                         "granite-moe-3b-a800m, arctic-480b, granite-20b, "
                         "nemotron-4-15b, internvl2-1b, gemma2-27b, "
                         "minicpm3-4b, rwkv6-3b and zamba2-2.7b (the last "
                         "four decode dense only; musicgen-large decodes "
                         "codebooks and is not served)")
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
    ap.add_argument("--static-groups", action="store_true",
                    help="legacy group-granular execution instead of "
                         "per-request continuous batching")
    ap.add_argument("--dense-decode", action="store_true",
                    help="decode on the dense [B, max_len] KV bucket path "
                         "instead of the paged block-table slab "
                         "(EngineConfig.paged_decode=False)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's flight-recorder stream as "
                         "Chrome/Perfetto trace-event JSON, and the "
                         "lossless JSONL stream beside it")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--print-env", action="store_true",
                    help="print the recommended launch environment "
                         "(tcmalloc preload) and exit")
    return ap.parse_args(argv)


@dataclass
class Setup:
    """What serving needs that outlives one server: the datastore, its
    index (pages pinned in host memory on a card), and the model."""

    args: argparse.Namespace
    device: torch.device
    card: str
    store: Datastore
    index: IVFIndex
    arch: ArchConfig
    model: tf.Transformer
    index_s: float


def build(args: argparse.Namespace) -> Setup:
    """Datastore, IVF index, pinned host pages and model per ``args``."""
    dev = resolve_device(args.device)
    # the host probe (lookahead, the exact-search check) and the fused
    # kernel's own centroid scores should agree on the nprobe cut: keep
    # fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say = (lambda *a: None) if args.quiet else print
    clock = SystemClock()
    if tf.codebooks(get_arch(args.arch)):
        # the DecodeRunner starts every wave from [n] tokens, as the
        # reference's does: no codebook model is served
        raise ValueError(f"arch {args.arch!r} decodes codebook tokens; the "
                         "server decodes [n] tokens only")

    t0 = clock.perf()
    store = synthetic_datastore(args.vectors, dim=args.dim, seed=args.seed)
    index = build_ivf(store, args.clusters, page_size=args.page_size,
                      kmeans_iters=args.kmeans_iters, seed=args.seed,
                      train_sample=args.train_sample, device=dev)
    # the pool's bf16 copy of the pages, pinned once (every server's
    # prefetch buffer over this index reuses it)
    host_pages(index.paged, torch.bfloat16, pin=dev.type == "cuda")
    index_s = clock.perf() - t0
    say(f"# datastore {args.vectors} x {args.dim}, {args.clusters} clusters, "
        f"{index.paged.total_pages} pages of {args.page_size} "
        f"({index_s:.1f} s)")

    arch, model = build_model(args, dev)
    return Setup(args=args, device=dev, card=card, store=store, index=index,
                 arch=arch, model=model, index_s=index_s)


def build_model(args: argparse.Namespace, dev: torch.device,
                ) -> Tuple[ArchConfig, tf.Transformer]:
    """``--arch`` (reduced with ``--reduced``, its depth cut to
    ``--layers``, the cut printed) and its random weights from
    ``--seed``."""
    say = (lambda *a: None) if args.quiet else print
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.layers is not None and args.layers != arch.num_layers:
        say(f"# cut: {args.arch} depth {arch.num_layers} -> {args.layers} "
            "layers (width unchanged)")
        arch = dataclasses.replace(arch, num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return arch, tf.init_params(arch, gen, device=dev)


class _PhaseLog:
    """Host-clock milliseconds of each lookahead dispatch, decode wave and
    retrieval, taken by wrapping the engine's two calls and the decode
    hook (the retrieval ends in a host read, so its time includes the
    device work; the dispatch is host work only).  Also keeps every
    retrieved row with its query for the exact-search check."""

    def __init__(self, clock):
        self.clock = clock
        self.lookahead: List[dict] = []
        self.decode: List[dict] = []
        self.retrieve: List[dict] = []
        self.searches: List[Tuple[np.ndarray, np.ndarray]] = []

    def wrap_engine(self, eng) -> None:
        look, ret = eng.lookahead_ex, eng.retrieve

        def lookahead_ex(*a, **kw):
            t0 = self.clock.perf()
            out = look(*a, **kw)
            self.lookahead.append({"ms": (self.clock.perf() - t0) * 1e3,
                                   "bytes": int(out[0])})
            return out

        def retrieve(q_out, *a, **kw):
            t0 = self.clock.perf()
            res = ret(q_out, *a, **kw)
            self.retrieve.append({
                "ms": (self.clock.perf() - t0) * 1e3, "rows": len(q_out),
                "hits": sum(len(h) for h in res.hit_clusters),
                "misses": sum(len(m) for m in res.missed_clusters)})
            self.searches.extend(zip(np.asarray(q_out), res.doc_ids))
            return res

        eng.lookahead_ex, eng.retrieve = lookahead_ex, retrieve

    def wrap_hook(self, hook):
        def timed(replica, records, gen_tokens, rnd):
            spliced = hook.stats["spliced_waves"]
            t0 = self.clock.perf()
            evs = hook(replica, records, gen_tokens, rnd)
            self.decode.append({"ms": (self.clock.perf() - t0) * 1e3,
                                "batch": len(records),
                                "steps": max((e.tokens for e in evs),
                                             default=0),
                                "spliced": hook.stats["spliced_waves"]
                                > spliced})
            return evs
        return timed


def serve(setup: Setup, *, chunk_store: Optional[ChunkKVStore] = None,
          replay: bool = False, **engine) -> Dict[str, object]:
    """Serve ``--requests`` requests through a fresh ``TeleRAGServer``
    over ``setup``; ``engine`` overrides ``EngineConfig`` fields (e.g.
    ``fused_retrieval=False``, ``paged_decode=False``, ``chunk_kv=True``
    or ``pool_pages``).  ``chunk_store`` goes to the ``DecodeRunner``;
    the pool (unless ``pool_pages`` is given) and the KV slab then also
    hold every page of it, and after serving the chunk residency and KV
    buckets are drained and the ledger read back.  ``replay=True`` runs
    the server on the deterministic event clock (decode adds no event
    time; the host-clock phase times below are still measured), so two
    serves that differ only in how they decode form the same waves and
    draw the same query rewrites.  Prints a report and returns a summary
    dict (``chip_smoke.py`` reads it; ``recorder`` is the server's
    flight recorder)."""
    args, dev, index = setup.args, setup.device, setup.index
    say = (lambda *a: None) if args.quiet else print
    clock = SystemClock()
    kvm = KVCacheManager(setup.arch, device=dev)
    kv_bytes = kvm.nbytes(args.batch, args.max_len)
    page_bytes = index.paged.page_nbytes()
    slab_seqs = max(2 * args.batch, 8)
    chunk_pages = chunk_store.total_pages() if chunk_store is not None else 0
    if chunk_pages:
        # one KV page (k+v, all layers) is nbytes(1, page size) bytes
        chunk_bytes = chunk_pages * kvm.nbytes(1, args.kv_page_size)
        kv_bytes += chunk_bytes
        slab_seqs += -(-chunk_pages // -(-args.max_len // args.kv_page_size))
    cfg = EngineConfig(**{**dict(
        nprobe=args.nprobe, top_k=args.top_k, buffer_pages=args.buffer_pages,
        pool_pages=args.buffer_pages + -(-kv_bytes // page_bytes),
        lookahead_rank=min(2 * args.nprobe, args.clusters),
        cache_enabled=True, chips=1, paged_decode=not args.dense_decode),
        **engine})
    runner = DecodeRunner(setup.model, max_len=args.max_len,
                          max_steps=args.max_steps,
                          page_size=args.kv_page_size,
                          slab_seqs=slab_seqs, chunk_store=chunk_store)
    log = _PhaseLog(clock)
    srv = TeleRAGServer(index, cfg, 1, setup.arch, micro_batch=args.batch,
                        include_tail=True, decode_hook=log.wrap_hook(runner),
                        continuous=not args.static_groups,
                        wall_clock=None if replay else clock)
    runner.attach(srv)
    eng = srv.engines[0]
    eng.calibrate_tcc()
    log.wrap_engine(eng)

    q = make_queries(setup.store, args.requests, args.seed)
    traces = make_traces(args.pipeline, args.requests, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = clock.perf()
    responses = srv.serve([RagRequest(q=q[i], trace=traces[i])
                           for i in range(args.requests)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = clock.perf() - t0

    gap = retrieval_gap(index, log.searches, setup.store.embeddings,
                        args.nprobe, args.top_k)
    copy_ms = [s.elapsed_time(e) for s, e, _ in eng.buffer.copies]
    copy_bytes = [nb for _, _, nb in eng.buffer.copies]
    tokens = sum(w["steps"] * w["batch"] for w in log.decode)
    decode_s = sum(w["ms"] for w in log.decode if w["steps"]) / 1e3
    steps = sum(w["steps"] for w in log.decode)
    tps = tokens / decode_s if decode_s > 0 else 0.0
    for r in responses:
        hit = sum(rt.hits for rt in r.rounds)
        mis = sum(rt.misses for rt in r.rounds)
        say(f"req {r.request_id:3d} [{r.pipeline}] rounds={len(r.rounds)} "
            f"hit_rate={hit / max(hit + mis, 1):.0%} "
            f"arrival->complete={r.latency_s * 1e3:7.1f}ms "
            f"docs={[int(d[0]) for d in r.doc_ids]}")
    ret_ms = [w["ms"] for w in log.retrieve] or [0.0]
    look_ms = [w["ms"] for w in log.lookahead] or [0.0]
    mode = "fused" if cfg.fused_retrieval else "unfused"
    decode = "paged" if runner.paged else "dense"
    say(f"# {setup.card}: {len(responses)} requests, {len(log.retrieve)} "
        f"retrievals ({mode}) in {wall:.2f} s; {decode} decode {tokens} "
        f"tokens in "
        f"{decode_s:.3f} s ({tps:.1f} tok/s, "
        f"{1e3 * decode_s / max(steps, 1):.2f} ms/step, {len(log.decode)} "
        f"waves); retrieval {np.mean(ret_ms):.2f} ms/round (max "
        f"{max(ret_ms):.2f}); lookahead dispatch {np.mean(look_ms):.2f} "
        f"ms/round (max {max(look_ms):.2f}); h2d {sum(copy_bytes) / 1e6:.1f} "
        f"MB in {len(copy_ms)} copies ({sum(copy_ms):.2f} ms on the copy "
        f"stream); retrieval vs exact host search: max score gap {gap:.2e}")
    say(f"# event-clock {summarize_latency(responses)}")
    telemetry = srv.telemetry()
    say(telemetry.summary())
    report = analyze(srv.recorder)
    say(report.summary())
    chunk = runner.chunk(0)
    spliced_steps = sum(w["steps"] for w in log.decode if w["spliced"])
    drained = {}
    if chunk is not None:
        say(f"# chunk-KV: {runner.stats['spliced_waves']} spliced waves "
            f"({spliced_steps} steps), {chunk.stats.as_dict()}")
        chunk.drain()
        runner.kv(0).drop_all()
        drained = {c: eng.ledger.bytes_of(c) for c in ("kv", "chunk_kv")}
    if args.trace_out:
        write_trace(srv.recorder, args.trace_out)
        jl = os.path.splitext(args.trace_out)[0] + ".jsonl"
        write_jsonl(srv.recorder, jl)
        say(f"# trace written to {args.trace_out} (+ {jl}; "
            f"{len(srv.recorder.events)} events)")
    return {
        "device": setup.card, "arch": setup.arch.name,
        "layers": setup.arch.num_layers, "retrieval": mode, "decode": decode,
        "continuous": not args.static_groups, "requests": len(responses),
        "lookahead": log.lookahead, "decode_waves": log.decode,
        "retrievals": log.retrieve,
        "doc_ids": {r.request_id: [d.tolist() for d in r.doc_ids]
                    for r in responses},
        "hits": sum(w["hits"] for w in log.retrieve),
        "misses": sum(w["misses"] for w in log.retrieve),
        "rounds_with_hits": sum(1 for w in log.retrieve if w["hits"] > 0),
        "decode_tokens": tokens, "decode_s": decode_s, "decode_steps": steps,
        "tokens_per_s": tps, "latency_s": [r.latency_s for r in responses],
        "copy_ms": copy_ms, "copy_bytes": copy_bytes, "wall_s": wall,
        "index_s": setup.index_s, "bytes_h2d": eng.buffer.stats.bytes_h2d,
        "retrieval_gap": gap, "pressure_stall_s": report.stall["pressure_s"],
        "spliced_waves": runner.stats["spliced_waves"],
        "spliced_steps": spliced_steps,
        "chunk_kv": dict(telemetry.replicas[0].chunk_kv),
        "ledger_after_drain": drained, "recorder": srv.recorder,
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Build and serve once per the arguments; returns ``serve``'s
    summary dict (``--print-env``: prints ``launch.env``'s snippet,
    builds nothing and returns {})."""
    args = parse_args(argv)
    if args.print_env:
        launch_env.print_env()
        return {}
    return serve(build(args))


if __name__ == "__main__":
    main()
