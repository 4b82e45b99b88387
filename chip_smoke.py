"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, one line each, every one fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every kernel from the sources in this checkout, one nvcc per
     source in parallel, with -Xptxas -v (registers, shared memory, spills);
  3. flash_decode_paged against its plain version at the serve shapes and
     at a small shape (G=1, Dh=32, ps=2, window>0), and flash_decode (the
     dense cache) at the serve shape, ragged positions, the long context
     and small shapes (window>0, G=1, MQA, S a multiple of no tile), all
     atol=rtol=2e-3 (fp32 output from bf16 K/V, sums in another order);
  4. probe_topk_fused and ivf_topk against their plain versions at the
     serve shapes and at a small shape: equal ids (and the same admitted
     clusters) and scores within rtol=1e-4 on tie-free data; and
     centroid_scores, through ops.centroid_probe (kernel + torch.topk),
     at the serve probe shape and at an odd one (Nc and d multiples of
     neither 32 nor 4, invalid centroids): equal top-k ids, scores
     within rtol=1e-4;
  5. timing: each kernel over many launches (CUDA events, after warm-up)
     beside its bound and its plain version; both decode kernels also at
     a long context (4k-8k tokens), where the K/V stream and not the
     launch sets their time; flash_decode and centroid_scores also
     beside the one library call that computes the same function
     (scaled_dot_product_attention, GQA, masked; q @ c.T + masked_fill);
  6. serving: repro_torch.launch.serve's TeleRAGServer at the full
     Llama-3-8B width over a 1M x 768 datastore, built once and served
     three times: fused retrieval with paged decode (flash_decode_paged
     and probe_topk_fused must launch), unfused retrieval (ivf_topk must
     launch, probe_topk_fused must not) and dense decode (flash_decode
     must make exactly its grid launches per call, once per layer, in
     every step; flash_decode_paged never); each serve's doc ids must
     match an exact host search and at least one round must hit the
     device.  Then one observation: one retrieval round fused against
     unfused, in alternating pairs.
centroid_scores is on no serve path (the engine's probe is a GEMM and
torch.topk, as the reference's is an einsum and lax.top_k), so its
launches come from the check phase alone; the kernels JSON lists each
kernel's launches by path (fused, unfused, dense) and in the checks.
The last three lines are the card line, the kernels JSON and
{"ok": true, "device": {...}}.  Exits non-zero without a card, and
outside the repository (it imports the port from ./src).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

# the serve phase's pool: 4096 prefetch pages + 342 pages' worth of the
# batch-4, 128-token KV lease (67,108,864 bytes / 196,608)
POOL_PAGES = 4438

# kernel 1's long-context timing case (B=4, KVH=8, G=4, Dh=128, ps=16)
LONG_LENGTHS = [8192, 6144, 5000, 4096]

# kernel 4's cases (B=4, KVH=8, G=4, Dh=128): the dense serve's bucket
# (S=128) full and ragged, and the long context (S=8192)
SERVE_POS = [127] * 4
RAGGED_POS = [127, 96, 40, 7]
LONG_POS = [8191, 6143, 4999, 4095]

# serving configuration driven in phase 6 (full Llama-3-8B width; built
# once, served fused, unfused and with dense decode)
SERVE_ARGS = ["--arch", "llama3-8b", "--pipeline", "irg", "--requests", "8",
              "--batch", "4", "--vectors", "1048576", "--dim", "768",
              "--clusters", "1024", "--train-sample", "131072",
              "--page-size", "128", "--nprobe", "64", "--top-k", "3",
              "--buffer-pages", "4096", "--max-len", "128",
              "--max-steps", "32", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- kernel 1: flash_decode_paged ---------------------------------------------


def decode_case(B, KVH, G, Dh, ps, MB, lengths, seed, dtype=torch.bfloat16):
    """Paged decode inputs on the card: a slab larger than needed,
    non-contiguous slots per row, -1 tails past each row's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NP = B * MB + 4
    q = torch.randn((B, KVH, G, Dh), generator=g, device="cuda").to(dtype)
    kp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NP, generator=g, device="cuda")[:B * MB].reshape(B, MB)
    bt = perm.to(torch.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // ps):] = -1
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens


def bound(nbytes: float, flops: float):
    """(least ms, what bounds it): bytes over the memory rate against
    fp32 flops over the fp32 rate (the kernels do fp32 math on CUDA cores)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def decode_work(q, kp, bt, lens, window):
    """(bytes, flops) this input needs: each live K/V row, q, the table
    and the lengths read once, the fp32 output written once."""
    B, KVH, G, Dh = q.shape
    ps = kp.shape[1]
    lens = lens.clamp(max=bt.shape[1] * ps)
    live = (lens.clamp(max=window) if window > 0 else lens).sum().item()
    nbytes = (2 * live * KVH * Dh * kp.element_size() + q.numel() * q.element_size()
              + bt.numel() * 4 + lens.numel() * 4 + q.numel() * 4)
    return nbytes, 4 * live * KVH * G * Dh


def check_decode(fd, ref, case, window, label):
    q, kp, vp, bt, lens = case
    out = fd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = ref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode_paged {label}: {e}")
    phase("check", f"flash_decode_paged {label}: shape {tuple(q.shape)} "
          f"ps={kp.shape[1]} window={window} max_abs_err={err:.3e} "
          "(atol=rtol=2e-3)")
    return err


# -- kernel 4: flash_decode (dense cache) -------------------------------------


def dense_case(B, S, KVH, G, Dh, pos, seed, dtype=torch.bfloat16,
               q_dtype=None):
    """Dense decode inputs on the card: q [B,KVH,G,Dh], k/v [B,S,KVH,Dh]
    and the new token's position per row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, KVH, G, Dh), generator=g, device="cuda")
    k = torch.randn((B, S, KVH, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KVH, Dh), generator=g, device="cuda").to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q.to(q_dtype or dtype), k, v, pos


def dense_work(case, window):
    """(bytes, flops) this input needs: each live K/V row, q and pos read
    once, the fp32 output written once."""
    q, k, _, pos = case
    B, KVH, G, Dh = q.shape
    S = k.shape[1]
    live = 0
    for p in pos.tolist():
        hi, lo = min(p + 1, S), (max(0, p + 1 - window) if window > 0 else 0)
        live += max(0, hi - lo)
    nbytes = (2 * live * KVH * Dh * k.element_size()
              + q.numel() * q.element_size() + pos.numel() * 4 + q.numel() * 4)
    return nbytes, 4 * live * KVH * G * Dh


def check_dense(fd, ref, case, window, label):
    out = fd.flash_decode(*case, window=window)
    want = ref.flash_decode_ref(*case, window)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode {label}: {e}")
    q, k, _, pos = case
    phase("check", f"flash_decode {label}: q {tuple(q.shape)} {q.dtype}, k/v "
          f"{tuple(k.shape)} {k.dtype}, pos {pos.tolist()} window={window} "
          f"max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def sdpa(case):
    """The one PyTorch call that computes flash_decode on ``case`` (no
    window): scaled_dot_product_attention over the cache with GQA and the
    position mask, bf16 in and out, the port never calls it."""
    import torch.nn.functional as F
    q, k, v, pos = case
    B, KVH, G, Dh = q.shape
    S = k.shape[1]
    qs = q.reshape(B, KVH * G, 1, Dh)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def time_dense(fd, ref, case, label, smi, iters):
    """Kernel 4 on ``case`` beside its bound, its plain version and the
    library call (device ms, CUDA events); the library's error against
    the plain version is printed, not checked."""
    ms = time_ms(lambda: fd.flash_decode(*case), iters)
    plain = time_ms(lambda: ref.flash_decode_ref(*case), max(iters // 10, 5))
    lib = sdpa(case)
    lib_ms = time_ms(lib, iters)
    q = case[0]
    lib_err = (lib().float().reshape(q.shape) - ref.flash_decode_ref(*case)
               ).abs().max().item()
    lo, by = bound(*dense_work(case, 0))
    phase("time", f"flash_decode {label}: {ms:.4f} ms, plain {plain:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms (bf16, max_abs_err {lib_err:.2e} vs plain), "
          f"bound {lo:.5f} ms ({by}) on {smi}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": lo, "bound_by": by,
            "library_ms": lib_ms}


# -- kernel 5: centroid_scores --------------------------------------------------


def centroid_case(B, d, Nc, invalid, seed):
    """Tie-free centroid-probe inputs on the card: gaussian queries and
    centroids, a share ``invalid`` of the centroids masked out."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    cent = torch.randn((Nc, d), generator=g, device="cuda")
    valid = torch.rand((Nc,), generator=g, device="cuda") >= invalid
    return q, cent, valid


def centroid_work(case):
    """(bytes, flops) this input needs: the queries, the valid flags and
    every valid centroid row read once, the [B, Nc] scores written once;
    2 * d flops per (query, valid centroid)."""
    q, cent, valid = case
    B, d = q.shape
    Nc, nv = cent.shape[0], int(valid.sum().item())
    return (q.numel() * 4 + Nc + nv * d * 4 + B * Nc * 4), 2 * B * nv * d


def check_centroid(ops, ref, case, nprobe, label):
    q, cent, valid = case
    gs, gi = ops.centroid_probe(cent, q, nprobe, valid=valid)
    ws, wi = torch.topk(ref.centroid_probe_ref(cent, q, valid), nprobe, dim=-1)
    torch.cuda.synchronize()
    if not torch.equal(gi, wi):
        fail(f"centroid_scores {label}: top-{nprobe} ids differ\n{gi}\n{wi}")
    try:
        torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"centroid_scores {label}: {e}")
    err = (gs - ws).abs().max().item()
    phase("check", f"centroid_scores {label}: B={q.shape[0]} d={q.shape[1]} "
          f"Nc={cent.shape[0]} ({int((~valid).sum())} invalid) nprobe={nprobe}:"
          f" top-k ids equal, max_abs_err={err:.3e} (rtol=1e-4)")
    return err


def time_centroid(cp, ref, case, smi, iters=200):
    """Kernel 5 beside its bound, its plain version and the library call
    (q @ c.T then masked_fill, full fp32; the port never calls it)."""
    q, cent, valid = case
    ms = time_ms(lambda: cp.centroid_scores(q, cent, valid), iters)
    plain = time_ms(lambda: ref.centroid_probe_ref(cent, q, valid), iters)
    lib = lambda: (q @ cent.T).masked_fill_(~valid[None, :], float("-inf"))
    lib_ms = time_ms(lib, iters)
    lo, by = bound(*centroid_work(case))
    phase("time", f"centroid_scores: {ms:.4f} ms, plain {plain:.4f} ms, "
          f"q @ c.T + masked_fill {lib_ms:.4f} ms, bound {lo:.5f} ms ({by}) "
          f"on {smi}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": lo, "bound_by": by,
            "library_ms": lib_ms}


# -- kernel 2: probe_topk_fused -----------------------------------------------


def retrieval_case(B, d, Nc, P, ps, seed):
    """Tie-free fused-retrieval inputs on the card: gaussian queries,
    centroids and bf16 pages, unique ids with one padded page tail, and a
    random slot->cluster map with unsearchable (-1) slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    cent = torch.randn((Nc, d), generator=g, device="cuda")
    valid = torch.rand((Nc,), generator=g, device="cuda") > 0.05
    pages = torch.randn((P, ps, d), generator=g, device="cuda").to(torch.bfloat16)
    pids = torch.randperm(P * ps, generator=g, device="cuda").to(torch.int32)
    pids = pids.reshape(P, ps)
    pids[0, ps // 2:] = -1
    pc = torch.randint(-1, Nc, (P,), generator=g, device="cuda",
                       dtype=torch.int32)
    return q, cent, valid, pages, pids, pc


def retrieval_work(ref, case, nprobe, k):
    """(bytes, flops) this input needs: queries, centroids, valid flags,
    the slot->cluster map, and the ids and vectors of every page some
    query admits, read once; each admitted (query, page) pair's dots."""
    q, cent, valid, pages, pids, pc = case
    B, d = q.shape
    P, ps = pids.shape
    s = ref.centroid_probe_ref(cent, q, valid)
    top_s, top_i = torch.topk(s, nprobe, dim=-1)
    lut = torch.zeros_like(s, dtype=torch.bool)
    lut.scatter_(1, top_i, torch.isfinite(top_s))
    adm = (pc >= 0)[None, :] & lut[:, pc.long().clamp(min=0)]     # [B, P]
    pages_any = adm.any(0).sum().item()
    pairs = adm.sum().item()
    nbytes = (q.numel() * 4 + cent.numel() * 4 + valid.numel() + P * 4
              + pages_any * ps * (d * pages.element_size() + 4) + B * k * 8)
    flops = 2 * B * cent.shape[0] * d + 2 * pairs * ps * d
    return nbytes, flops, pages_any


def check_retrieval(pt, ref, case, nprobe, k, label):
    out_s, out_i, out_adm = pt.probe_topk_fused(*case, nprobe=nprobe, k=k)
    want_s, want_i, want_adm = ref.probe_and_topk_ref(*case, nprobe, k)
    torch.cuda.synchronize()
    if not torch.equal(out_i, want_i):
        fail(f"probe_topk_fused {label}: ids differ\n{out_i}\n{want_i}")
    if not torch.equal(out_adm, want_adm):
        fail(f"probe_topk_fused {label}: admitted clusters differ")
    try:
        torch.testing.assert_close(out_s, want_s, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"probe_topk_fused {label}: {e}")
    fin = torch.isfinite(want_s)
    err = (out_s[fin] - want_s[fin]).abs().max().item() if fin.any() else 0.0
    q, cent, _, pages, _, _ = case
    phase("check", f"probe_topk_fused {label}: B={q.shape[0]} d={q.shape[1]} "
          f"Nc={cent.shape[0]} P={pages.shape[0]} ps={pages.shape[1]} "
          f"nprobe={nprobe} k={k}: ids and admitted clusters equal, "
          f"max_abs_err={err:.3e} (rtol=1e-4)")
    return err


# -- kernel 3: ivf_topk ---------------------------------------------------------


def ivf_case(B, d, P, ps, seed, admit=0.2, empty_row=False):
    """Tie-free unfused-retrieval inputs on the card: gaussian queries and
    bf16 pages, unique ids with one padded page tail, and a per-query
    page mask admitting about ``admit`` of the pages (none for query 0
    when ``empty_row``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    pages = torch.randn((P, ps, d), generator=g, device="cuda").to(torch.bfloat16)
    pids = torch.randperm(P * ps, generator=g, device="cuda").to(torch.int32)
    pids = pids.reshape(P, ps)
    pids[0, ps // 2:] = -1
    mask = torch.rand((B, P), generator=g, device="cuda") < admit
    if empty_row:
        mask[0] = False
    return pages, pids, mask, q


def ivf_work(case, k):
    """(bytes, flops, pages read) this input needs: queries and the mask,
    and the ids and vectors of every page some query admits, read once;
    the [B, k] outputs written once; each admitted (query, page) pair's
    dots."""
    pages, pids, mask, q = case
    B, d = q.shape
    P, ps = pids.shape
    pages_any = mask.any(0).sum().item()
    nbytes = (q.numel() * 4 + mask.numel()
              + pages_any * ps * (d * pages.element_size() + 4) + B * k * 8)
    return nbytes, 2 * mask.sum().item() * ps * d, pages_any


def check_ivf(it, ref, case, k, label):
    out_s, out_i = it.ivf_topk(*case, k)
    want_s, want_i = ref.ivf_topk_ref(*case, k)
    torch.cuda.synchronize()
    if not torch.equal(out_i, want_i):
        fail(f"ivf_topk {label}: ids differ\n{out_i}\n{want_i}")
    try:
        torch.testing.assert_close(out_s, want_s, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"ivf_topk {label}: {e}")
    fin = torch.isfinite(want_s)
    err = (out_s[fin] - want_s[fin]).abs().max().item() if fin.any() else 0.0
    pages, _, mask, q = case
    empty = int((~mask.any(1)).sum().item())
    phase("check", f"ivf_topk {label}: B={q.shape[0]} d={q.shape[1]} "
          f"P={pages.shape[0]} ps={pages.shape[1]} k={k}, "
          f"{mask.float().mean().item():.1%} of pages admitted, {empty} "
          f"query(ies) with none: ids equal, max_abs_err={err:.3e} "
          "(rtol=1e-4)")
    return err


# -- one retrieval round, fused against unfused -------------------------------


def retrieval_ab(serve, setup, reps=20):
    """Host-clock ms of one ``hybrid_retrieve`` call, fused against
    unfused, alternating which goes first, over one buffer state of the
    serve phase's pool in which every probed cluster of ``--batch``
    queries is resident (no host search runs).  Both must return the
    same doc ids and partition.  Returns the two lists of ms, the
    resident cluster count, and each path's kernel alone on that state
    (device ms, CUDA events) with the pages its mask admits."""
    from repro_torch.core.hybrid_search import hybrid_retrieve
    from repro_torch.core.ivf import probe
    from repro_torch.core.prefetch_buffer import PrefetchBuffer
    from repro_torch.kernels.ivf_topk import ivf_topk
    from repro_torch.kernels.probe_topk import probe_topk_fused

    args, index = setup.args, setup.index
    q = serve.make_queries(setup.store, args.batch, args.seed + 7)
    probed = probe(q, index, args.nprobe)
    buf = PrefetchBuffer(index.paged, POOL_PAGES, device=setup.device)
    buf.load_clusters(sorted(set(probed.ravel().tolist())))
    calls = {"fused": dict(fused=True, centroids=index.device_centroids),
             "unfused": dict(fused=False)}
    ms = {m: [] for m in calls}
    results = {}
    for rep in range(reps + 2):                   # 2 warm-up pairs
        for mode in (("fused", "unfused") if rep % 2 else ("unfused", "fused")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = hybrid_retrieve(buf, q, probed, k=args.top_k, **calls[mode])
            dt = (time.perf_counter() - t0) * 1e3
            if rep >= 2:
                ms[mode].append(dt)
            results[mode] = res
    a, b = results["fused"], results["unfused"]
    if not (np.array_equal(a.doc_ids, b.doc_ids)
            and a.hit_clusters == b.hit_clusters
            and a.missed_clusters == b.missed_clusters):
        fail("fused and unfused retrieval disagree over one buffer state")
    if any(a.missed_clusters):
        fail("retrieval A/B: a probed cluster is not resident")

    # each path's device search alone on this state
    dev, cents = setup.device, index.device_centroids
    qd = torch.as_tensor(q, dtype=torch.float32, device=dev)
    pages, page_ids, page_cluster = buf.device_view()
    valid = torch.ones((cents.shape[0],), dtype=torch.bool, device=dev)
    luts = np.zeros((len(q), cents.shape[0]), bool)
    for b, row in enumerate(probed):
        luts[b, row] = True
    pc = buf.slot_cluster
    mask = np.zeros((len(q), buf.num_pages), bool)
    mask[:, pc >= 0] = luts[:, pc[pc >= 0]]
    mask_d = torch.from_numpy(mask).to(dev)
    alone = {
        "probe_topk_fused": time_ms(lambda: probe_topk_fused(
            qd, cents, valid, pages, page_ids, page_cluster,
            nprobe=args.nprobe, k=args.top_k), iters=50),
        "ivf_topk": time_ms(lambda: ivf_topk(pages, page_ids, mask_d, qd,
                                             args.top_k), iters=50),
        "pages_read": int(mask.any(0).sum())}
    return ms["fused"], ms["unfused"], sum(map(len, a.hit_clusters)), alone


def check_dense_launches(fd, setup, summary, counts):
    """The dense serve's ``flash_decode`` grid launches, exactly: one call
    per layer in every decode step, each call the splits and, when S is
    split, their combine.  A wave holds 1..--batch rows over a
    ``[n, --max-len]`` bucket, so the grids per call are taken from the
    wrapper's own split rule at each of those sizes, and the check
    needs them to agree."""
    arch, args = setup.arch, setup.args
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {2 if fd._splits(n * arch.num_kv_heads, args.max_len, sms)[1] > 1
             else 1 for n in range(1, args.batch + 1)}
    steps = summary["decode_steps"]
    if summary["decode"] != "dense" or steps < 1 or len(grids) != 1:
        fail(f"dense serve: {summary['decode']} decode, {steps} steps, "
             f"grids per flash_decode call by wave size {sorted(grids)}")
    per_call = grids.pop()
    want = steps * arch.num_layers * per_call
    if counts["flash_decode"] != want:
        fail(f"dense serve: flash_decode made {counts['flash_decode']} grid "
             f"launches in {steps} steps, want {want} ({arch.num_layers} "
             f"layers x {per_call} grids a step)")
    phase("check", f"dense serve: flash_decode {want} grid launches = {steps} "
          f"steps x {arch.num_layers} layers x {per_call} grids a call")


def check_model(ttf, get_arch):
    """One reduced Llama-3 decode step (fp32) through the kernel on the
    card against the same step through the plain version on the CPU:
    the slab write and the logits, atol=rtol=2e-3."""
    cfg = get_arch("llama3-8b").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
    g = torch.Generator().manual_seed(6)
    B, ps, MB = 3, 4, 4
    NP = B * MB + 2
    shape = (cfg.num_layers, NP, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0, v0 = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    bt = torch.randperm(NP, generator=g)[:B * MB].reshape(B, MB).to(torch.int32)
    lens = torch.tensor([0, 3, 6], dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, dtype=torch.int32)
    want, wk, _ = ttf.serve_step_paged(model, k0.clone(), v0.clone(), bt, lens,
                                       {"token": tok})
    card = ttf.Transformer(cfg, {n: p.detach().cuda()
                                 for n, p in model.named_parameters()})
    got, gk, _ = ttf.serve_step_paged(card, k0.cuda(), v0.cuda(), bt.cuda(),
                                      lens.cuda(), {"token": tok.cuda()})
    torch.cuda.synchronize()
    try:
        torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"serve_step_paged on the card vs the CPU: {e}")
    err = (got.cpu() - want).abs().max().item()
    phase("check", f"serve_step_paged (reduced {cfg.name}, fp32) card vs CPU: "
          f"logits {tuple(got.shape)} max_abs_err={err:.3e} (atol=rtol=2e-3)")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py needs "
              "an NVIDIA card", flush=True)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import centroid_probe as cp
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ivf_topk as it
    from repro_torch.kernels import probe_topk as pt
    from repro_torch.launch import serve
    from repro_torch.models import transformer as ttf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1) card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{smi} | torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 2) build, one nvcc per source, all at once
    t0 = time.perf_counter()
    sources = _build.SOURCES
    logs = _build.build_all(sources, verbose=True, force=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                phase("build", f"{name}: {line.strip()}")
    phase("build", f"{len(sources)} kernels built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3) kernel 1 against its plain version
    serve_dec = decode_case(4, 8, 4, 128, 16, 8, [128, 97, 40, 7], seed=1)
    small_dec = decode_case(3, 2, 1, 32, 2, 5, [10, 3, 7], seed=2)
    err_dec = max(check_decode(fd, ref, serve_dec, 0, "serve shapes"),
                  check_decode(fd, ref, small_dec, 3, "small shape"))
    check_decode(fd, ref, decode_case(2, 2, 8, 64, 5, 4, [20, 13], seed=3,
                                      dtype=torch.float32), 0, "fp32 G=8 Dh=64")
    long_dec = decode_case(4, 8, 4, 128, 16, 512, LONG_LENGTHS, seed=7)
    err_dec = max(err_dec, check_decode(fd, ref, long_dec, 0, "long context"))

    # kernel 4 against its plain version
    serve_dense = dense_case(4, 128, 8, 4, 128, SERVE_POS, seed=11)
    ragged_dense = dense_case(4, 128, 8, 4, 128, RAGGED_POS, seed=12)
    long_dense = dense_case(4, 8192, 8, 4, 128, LONG_POS, seed=13)
    err_dense = max(
        check_dense(fd, ref, serve_dense, 0, "serve shape"),
        check_dense(fd, ref, ragged_dense, 0, "ragged positions"),
        check_dense(fd, ref, long_dense, 0, "long context"),
        check_dense(fd, ref, dense_case(3, 100, 2, 1, 32, [99, 50, 0], seed=14),
                    9, "window, G=1, S=100"),
        check_dense(fd, ref, dense_case(2, 300, 1, 8, 64, [299, 130], seed=15,
                                        dtype=torch.float32), 0, "MQA, fp32"),
        check_dense(fd, ref, dense_case(3, 77, 2, 3, 128, [76, 20, 64], seed=16,
                                        q_dtype=torch.float32), 25,
                    "fp32 q over bf16 K/V, window, S=77"),
        check_dense(fd, ref, dense_case(2, 1000, 4, 2, 64, [999, 500], seed=17),
                    700, "window across splits, S=1000"),
        check_dense(fd, ref, dense_case(3, 90, 2, 1, 64, [89, 30, 0], seed=18,
                                        dtype=torch.float32), 12,
                    "fp32 G=1, window, S=90"),
        check_dense(fd, ref, dense_case(4, 128, 8, 4, 128, [0] * 4, seed=19),
                    0, "pos 0"))

    # 4) kernel 2 against its plain version
    serve_ret = retrieval_case(4, 768, 1024, POOL_PAGES, 128, seed=4)
    small_ret = retrieval_case(3, 60, 24, 18, 8, seed=5)
    err_ret = max(check_retrieval(pt, ref, serve_ret, 64, 3, "serve shapes"),
                  check_retrieval(pt, ref, small_ret, 7, 5, "small shape"))

    # kernel 3 against its plain version, at the same pool
    serve_ivf = ivf_case(4, 768, POOL_PAGES, 128, seed=8)
    small_ivf = ivf_case(3, 60, 18, 8, seed=9, admit=0.5, empty_row=True)
    err_ivf = max(check_ivf(it, ref, serve_ivf, 3, "serve shapes"),
                  check_ivf(it, ref, small_ivf, 5, "small shape"))

    # kernel 5 against its plain version
    serve_cent = centroid_case(4, 768, 1024, 0.0, seed=20)
    err_cent = max(
        check_centroid(ops, ref, serve_cent, 64, "serve probe shape"),
        check_centroid(ops, ref, centroid_case(5, 30, 203, 0.15, seed=21), 9,
                       "odd shape"))

    check_model(ttf, get_arch)

    # 5) timing at the serve shapes
    q, kp, vp, bt, lens = serve_dec
    dec_ms = time_ms(lambda: fd.flash_decode_paged(q, kp, vp, bt, lens), 200)
    dec_plain = time_ms(lambda: ref.flash_decode_paged_ref(q, kp, vp, bt, lens), 50)
    dec_bound, dec_by = bound(*decode_work(q, kp, bt, lens, 0))
    phase("time", f"flash_decode_paged: {dec_ms:.4f} ms, plain {dec_plain:.4f} ms, "
          f"bound {dec_bound:.5f} ms ({dec_by}) on {smi}")
    q, kp, vp, bt, lens = long_dec
    long_ms = time_ms(lambda: fd.flash_decode_paged(q, kp, vp, bt, lens), 100)
    long_plain = time_ms(lambda: ref.flash_decode_paged_ref(q, kp, vp, bt, lens), 10)
    long_bound, long_by = bound(*decode_work(q, kp, bt, lens, 0))
    phase("time", f"flash_decode_paged at lengths {LONG_LENGTHS}: {long_ms:.4f} ms, "
          f"plain {long_plain:.4f} ms, bound {long_bound:.5f} ms ({long_by}) "
          f"on {smi}")
    del long_dec, q, kp, vp, bt, lens
    dense_t = time_dense(fd, ref, serve_dense, f"at pos {SERVE_POS}", smi, 200)
    dense_long = time_dense(fd, ref, long_dense, f"at pos {LONG_POS}", smi, 100)
    del serve_dense, ragged_dense, long_dense
    ret_ms = time_ms(lambda: pt.probe_topk_fused(*serve_ret, nprobe=64, k=3), 50)
    ret_plain = time_ms(lambda: ref.probe_and_topk_ref(*serve_ret, 64, 3), 10)
    nbytes, flops, pages_any = retrieval_work(ref, serve_ret, 64, 3)
    ret_bound, ret_by = bound(nbytes, flops)
    phase("time", f"probe_topk_fused: {ret_ms:.4f} ms, plain {ret_plain:.4f} ms, "
          f"bound {ret_bound:.5f} ms ({ret_by}; {pages_any} of "
          f"{serve_ret[3].shape[0]} pages admitted) on {smi}")
    ivf_ms = time_ms(lambda: it.ivf_topk(*serve_ivf, 3), 50)
    ivf_plain = time_ms(lambda: ref.ivf_topk_ref(*serve_ivf, 3), 10)
    nbytes, flops, ivf_pages = ivf_work(serve_ivf, 3)
    ivf_bound, ivf_by = bound(nbytes, flops)
    phase("time", f"ivf_topk: {ivf_ms:.4f} ms, plain {ivf_plain:.4f} ms, "
          f"bound {ivf_bound:.5f} ms ({ivf_by}; {ivf_pages} of "
          f"{serve_ivf[0].shape[0]} pages admitted) on {smi}")
    cent_t = time_centroid(cp, ref, serve_cent, smi)
    del serve_ret, serve_ivf, serve_cent
    torch.cuda.empty_cache()

    # 6) serving through the port's entry point: one build, two serves,
    #    each path's launch counts set to 0 just before it and read after
    counted = {"flash_decode_paged": fd.flash_decode_paged,
               "probe_topk_fused": pt.probe_topk_fused, "ivf_topk": it.ivf_topk,
               "flash_decode": fd.flash_decode,
               "centroid_scores": cp.centroid_scores}
    launches = {"check": {n: fn.launches for n, fn in counted.items()}}
    setup = serve.build(serve.parse_args(SERVE_ARGS))
    for path, engine in (("fused", {}), ("unfused", {"fused_retrieval": False}),
                         ("dense", {"paged_decode": False})):
        for fn in counted.values():
            fn.launches = 0
        summary = serve.serve(setup, **engine)
        launches[path] = {n: fn.launches for n, fn in counted.items()}
        phase("serve", json.dumps({"path": path, **{k: summary[k] for k in (
            "device", "arch", "layers", "retrieval", "decode", "continuous",
            "requests",
            "hits", "misses", "rounds_with_hits", "decode_tokens",
            "decode_steps", "decode_s", "tokens_per_s", "lookahead",
            "decode_waves", "retrievals", "latency_s", "copy_ms",
            "copy_bytes", "wall_s", "index_s", "bytes_h2d",
            "retrieval_gap", "pressure_stall_s")}}))
        for rid, rows in summary["doc_ids"].items():
            if not rows or any(len(row) != 3 or min(row) < 0 for row in rows):
                fail(f"{path} serve, request {rid}: doc ids per round {rows}, "
                     "want 3 each")
        if not summary["retrieval_gap"] < 1e-2:
            fail(f"{path} serve disagrees with the exact host search: score "
                 f"gap {summary['retrieval_gap']} (bf16 pages allow < 1e-2)")
        if summary["rounds_with_hits"] < 1:
            fail(f"{path} serve: no round had device hits")
        if path == "dense":
            check_dense_launches(fd, setup, summary, launches[path])
        phase("kernels", json.dumps({"path": path, **launches[path]}))
    want = {"fused": ("flash_decode_paged", "probe_topk_fused"),
            "unfused": ("flash_decode_paged", "ivf_topk"),
            "dense": ("flash_decode", "probe_topk_fused")}
    never = {"fused": ("flash_decode", "ivf_topk", "centroid_scores"),
             "unfused": ("flash_decode", "probe_topk_fused", "centroid_scores"),
             "dense": ("flash_decode_paged", "ivf_topk", "centroid_scores")}
    for path, names in want.items():
        if min(launches[path][n] for n in names) < 1:
            fail(f"a kernel of the {path} path never launched: {launches[path]}")
        if any(launches[path][n] for n in never[path]):
            fail(f"the {path} path launched one of {never[path]}: "
                 f"{launches[path]}")
    fused_ms, unfused_ms, hits, alone = retrieval_ab(serve, setup)
    q = lambda xs, p: float(np.percentile(xs, p))
    phase("time", f"one retrieval round, {hits} probed clusters all resident, "
          f"{len(fused_ms)} alternating pairs: fused median {q(fused_ms, 50):.3f} "
          f"ms (IQR {q(fused_ms, 25):.3f}-{q(fused_ms, 75):.3f}), unfused "
          f"median {q(unfused_ms, 50):.3f} ms (IQR {q(unfused_ms, 25):.3f}-"
          f"{q(unfused_ms, 75):.3f}); unfused faster in "
          f"{sum(u < f for f, u in zip(fused_ms, unfused_ms))} pairs; "
          f"same doc ids and partition; the kernels alone on that state "
          f"({alone['pages_read']} pages read): probe_topk_fused "
          f"{alone['probe_topk_fused']:.4f} ms, ivf_topk "
          f"{alone['ivf_topk']:.4f} ms; on {smi}")
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "flash_decode_paged", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
         "replaces": "src/repro/kernels/flash_decode.py:201",
         "launches": launches["fused"]["flash_decode_paged"],
         "launches_by_path": {p: c["flash_decode_paged"]
                              for p, c in launches.items()},
         "max_abs_err": err_dec,
         "ms": dec_ms, "plain_ms": dec_plain, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None,
         "long_context": {"lengths": LONG_LENGTHS, "ms": long_ms,
                          "plain_ms": long_plain, "bound_ms": long_bound,
                          "bound_by": long_by}},
        {"name": "probe_topk_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/probe_topk.cu",
         "replaces": "src/repro/kernels/probe_topk.py:172",
         "launches": launches["fused"]["probe_topk_fused"],
         "launches_by_path": {p: c["probe_topk_fused"]
                              for p, c in launches.items()},
         "max_abs_err": err_ret,
         "ms": ret_ms, "plain_ms": ret_plain, "bound_ms": ret_bound,
         "bound_by": ret_by, "library_ms": None},
        {"name": "ivf_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ivf_topk.cu",
         "replaces": "src/repro/kernels/ivf_topk.py:110",
         "launches": launches["unfused"]["ivf_topk"],
         "launches_by_path": {p: c["ivf_topk"] for p, c in launches.items()},
         "max_abs_err": err_ivf,
         "ms": ivf_ms, "plain_ms": ivf_plain, "bound_ms": ivf_bound,
         "bound_by": ivf_by, "library_ms": None},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88",
         "launches": launches["dense"]["flash_decode"],
         "launches_by_path": {p: c["flash_decode"] for p, c in launches.items()},
         "max_abs_err": err_dense, **dense_t, "pos": SERVE_POS,
         "long_context": {"pos": LONG_POS, **dense_long}},
        {"name": "centroid_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/centroid_scores.cu",
         "replaces": "src/repro/kernels/centroid_probe.py:42",
         "launches": launches["dense"]["centroid_scores"],
         "launches_by_path": {p: c["centroid_scores"]
                              for p, c in launches.items()},
         "max_abs_err": err_cent, **cent_t, "shape": [4, 768, 1024]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
