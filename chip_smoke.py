"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, one line each, every one fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every kernel from the sources in this checkout, one nvcc per
     source in parallel, with -Xptxas -v (registers, shared memory, spills);
  3. flash_decode_paged against its plain version at the serve shapes and
     at a small shape (G=1, Dh=32, ps=2, window>0), atol=rtol=2e-3 (fp32
     output from bf16 K/V, sums in another order);
  4. probe_topk_fused against its plain version at the serve shapes and at
     a small shape: equal ids and scores within rtol=1e-4 on tie-free data;
  5. timing: each kernel over many launches (CUDA events, after warm-up)
     beside its bound and its plain version; flash_decode_paged also at a
     long context (4k-8k tokens), where the K/V stream and not the launch
     sets its time;
  6. serving: repro_torch.launch.serve at the full Llama-3-8B width over a
     1M x 768 datastore; both kernels' launch counts must rise and at
     least one round must hit the device.
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

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

# kernel 1's long-context timing case (B=4, KVH=8, G=4, Dh=128, ps=16)
LONG_LENGTHS = [8192, 6144, 5000, 4096]

# serving configuration driven in phase 6 (full Llama-3-8B width)
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
    out_s, out_i = pt.probe_topk_fused(*case, nprobe=nprobe, k=k)
    want_s, want_i = ref.probe_and_topk_ref(*case, nprobe, k)
    torch.cuda.synchronize()
    if not torch.equal(out_i, want_i):
        fail(f"probe_topk_fused {label}: ids differ\n{out_i}\n{want_i}")
    try:
        torch.testing.assert_close(out_s, want_s, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"probe_topk_fused {label}: {e}")
    fin = torch.isfinite(want_s)
    err = (out_s[fin] - want_s[fin]).abs().max().item() if fin.any() else 0.0
    q, cent, _, pages, _, _ = case
    phase("check", f"probe_topk_fused {label}: B={q.shape[0]} d={q.shape[1]} "
          f"Nc={cent.shape[0]} P={pages.shape[0]} ps={pages.shape[1]} "
          f"nprobe={nprobe} k={k}: ids equal, max_abs_err={err:.3e} "
          "(rtol=1e-4)")
    return err


# -- the decode step as a whole -----------------------------------------------


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
    from repro_torch.kernels import flash_decode as fd
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
    logs = _build.build_all(["flash_decode_paged", "probe_topk"], verbose=True,
                            force=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                phase("build", f"{name}: {line.strip()}")
    phase("build", f"both kernels built for sm_90a in {time.perf_counter() - t0:.1f} s")

    # 3) kernel 1 against its plain version
    serve_dec = decode_case(4, 8, 4, 128, 16, 8, [128, 97, 40, 7], seed=1)
    small_dec = decode_case(3, 2, 1, 32, 2, 5, [10, 3, 7], seed=2)
    err_dec = max(check_decode(fd, ref, serve_dec, 0, "serve shapes"),
                  check_decode(fd, ref, small_dec, 3, "small shape"))
    check_decode(fd, ref, decode_case(2, 2, 8, 64, 5, 4, [20, 13], seed=3,
                                      dtype=torch.float32), 0, "fp32 G=8 Dh=64")
    long_dec = decode_case(4, 8, 4, 128, 16, 512, LONG_LENGTHS, seed=7)
    err_dec = max(err_dec, check_decode(fd, ref, long_dec, 0, "long context"))

    # 4) kernel 2 against its plain version
    # the serve phase's pool: 4096 prefetch pages + 342 pages' worth of
    # the batch-4, 128-token KV lease (67,108,864 bytes / 196,608)
    serve_ret = retrieval_case(4, 768, 1024, 4438, 128, seed=4)
    small_ret = retrieval_case(3, 60, 24, 18, 8, seed=5)
    err_ret = max(check_retrieval(pt, ref, serve_ret, 64, 3, "serve shapes"),
                  check_retrieval(pt, ref, small_ret, 7, 5, "small shape"))

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
    ret_ms = time_ms(lambda: pt.probe_topk_fused(*serve_ret, nprobe=64, k=3), 50)
    ret_plain = time_ms(lambda: ref.probe_and_topk_ref(*serve_ret, 64, 3), 10)
    nbytes, flops, pages_any = retrieval_work(ref, serve_ret, 64, 3)
    ret_bound, ret_by = bound(nbytes, flops)
    phase("time", f"probe_topk_fused: {ret_ms:.4f} ms, plain {ret_plain:.4f} ms, "
          f"bound {ret_bound:.5f} ms ({ret_by}; {pages_any} of "
          f"{serve_ret[3].shape[0]} pages admitted) on {smi}")
    del serve_ret
    torch.cuda.empty_cache()

    # 6) serving through the port's entry point
    fd.flash_decode_paged.launches = 0
    pt.probe_topk_fused.launches = 0
    summary = serve.main(SERVE_ARGS)
    launches = {"flash_decode_paged": fd.flash_decode_paged.launches,
                "probe_topk_fused": pt.probe_topk_fused.launches}
    phase("serve", json.dumps({k: summary[k] for k in (
        "device", "arch", "layers", "requests", "hits", "misses",
        "rounds_with_hits", "decode_tokens", "decode_steps", "decode_s",
        "tokens_per_s", "rounds", "copy_ms", "copy_bytes", "wall_s",
        "index_s", "bytes_h2d", "retrieval_gap")}))
    for rid, rows in summary["doc_ids"].items():
        if not rows or any(len(row) != 3 or min(row) < 0 for row in rows):
            fail(f"request {rid}: doc ids per round {rows}, want 3 each")
    if not summary["retrieval_gap"] < 1e-2:
        fail(f"retrieval disagrees with the exact host search: score gap "
             f"{summary['retrieval_gap']} (bf16 pages allow < 1e-2)")
    if summary["rounds_with_hits"] < 1:
        fail("no round had device hits")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path never launched: {launches}")
    phase("kernels", json.dumps(launches))
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "flash_decode_paged", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
         "replaces": "src/repro/kernels/flash_decode.py:201",
         "launches": launches["flash_decode_paged"], "max_abs_err": err_dec,
         "ms": dec_ms, "plain_ms": dec_plain, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None,
         "long_context": {"lengths": LONG_LENGTHS, "ms": long_ms,
                          "plain_ms": long_plain, "bound_ms": long_bound,
                          "bound_by": long_by}},
        {"name": "probe_topk_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/probe_topk.cu",
         "replaces": "src/repro/kernels/probe_topk.py:172",
         "launches": launches["probe_topk_fused"], "max_abs_err": err_ret,
         "ms": ret_ms, "plain_ms": ret_plain, "bound_ms": ret_bound,
         "bound_by": ret_by, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
