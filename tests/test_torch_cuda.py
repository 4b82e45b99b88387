"""The port's hand-written CUDA kernels against their plain versions, on a
card, and train steps (Llama-3 and one arch of each other family kind,
against the CPU's) and a checkpoint round trip there (training runs no
hand-written kernel); and, over an NCCL process group of one rank, the
data-parallel step against the train step (to the bit) and the sharded
search against kernel 3.  Every test is marked ``cuda`` and skips inside its body when
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
the JAX package, so it runs on a card host that has neither:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the decode kernels' fp32 output from bf16 K/V is summed in
another order than the plain version's (atol=rtol=2e-3; the spliced
kernel also rotates K with the card's sincosf where the plain version
uses torch.cos/sin); the retrieval
kernels must give equal ids (and kernel 2 the same admitted clusters)
and scores within rtol=1e-4 on tie-free data; the centroid scores
within rtol=1e-4 (fp32 dots summed in another order) and equal top-k
ids on tie-free data.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.kernels import centroid_probe as tcp
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ivf_topk as tivf
from repro_torch.kernels import probe_topk as tpt
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(B, KVH, G, Dh, ps, MB, seed):
    """Ragged block tables over a slab bigger than needed: non-contiguous
    slots, partial last blocks and -1 tails."""
    rng = np.random.default_rng(seed)
    NP = B * MB + 4
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    lengths = rng.integers(1, MB * ps + 1, B).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(lengths[b]) // ps):] = -1
    return q, kp, vp, bt, lengths


def _retrieval_inputs(B, d, Nc, P, ps, seed):
    """Tie-free gaussian data, a padded page tail, unsearchable slots and
    invalid centroids."""
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    pids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    pids[0, ps // 2:] = -1
    pc = rng.integers(-1, Nc, P).astype(np.int32)
    valid = rng.random(Nc) > 0.1
    return qs, cents, valid, pages, pids, pc


@pytest.mark.cuda
@pytest.mark.parametrize("B,KVH,G,Dh,ps,MB,window,q_dtype,kv_dtype", [
    (4, 8, 4, 128, 16, 8, 0, torch.bfloat16, torch.bfloat16),   # serve shapes
    (3, 2, 1, 32, 2, 5, 3, torch.bfloat16, torch.bfloat16),     # ps 2, window
    (2, 2, 8, 64, 5, 4, 0, torch.float32, torch.float32),
    (2, 1, 3, 128, 7, 3, 9, torch.float32, torch.bfloat16),
])
def test_flash_decode_paged_kernel_matches_plain(B, KVH, G, Dh, ps, MB, window,
                                                 q_dtype, kv_dtype):
    dev = _card()
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(B, KVH, G, Dh, ps, MB, 7))
    q, kp, vp = q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype)
    before = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = tref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("KVH,G,Dh,ps,MB,lengths,window,kv_dtype", [
    (8, 4, 128, 16, 128, [2048, 1536, 1024, 512], 0, torch.bfloat16),  # mid
    (2, 4, 128, 16, 512, [300, 64, 1000, 2], 0, torch.bfloat16),  # 8192 table
    (2, 4, 128, 16, 512, [1, 1, 1, 1], 0, torch.bfloat16),
    (2, 8, 64, 16, 128, [2048, 1000, 700, 65], 300, torch.bfloat16),
    (2, 3, 32, 48, 20, [960, 500, 47], 0, torch.bfloat16),   # ps 48
    (1, 2, 128, 48, 20, [960, 500, 47], 100, torch.float32),
])
def test_flash_decode_paged_kernel_edge_cases(KVH, G, Dh, ps, MB, lengths,
                                              window, kv_dtype):
    """Paged decode at a mid context, under an 8192-position table whose
    later splits hold no live position (lengths of 1 too), with a window
    across split boundaries, and at a page size that does not divide 64;
    -1 tails past each length.  One grid launch a call."""
    dev = _card()
    B = len(lengths)
    rng = np.random.default_rng(ps * MB + window)
    NP = B * MB + 4
    q = torch.from_numpy(rng.standard_normal((B, KVH, G, Dh)).astype(
        np.float32)).to(dev, torch.float32 if kv_dtype == torch.float32
                        else torch.bfloat16)
    kp, vp = (torch.from_numpy(rng.standard_normal((NP, ps, KVH, Dh)).astype(
        np.float32)).to(dev, kv_dtype) for _ in range(2))
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // ps):] = -1
    bt = torch.from_numpy(bt).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = tref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    again = tfd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    assert torch.equal(again, got)        # the counters were left at zero


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,KVH,G,Dh,pos,window,q_dtype,kv_dtype", [
    (4, 128, 8, 4, 128, [127] * 4, 0, torch.bfloat16, torch.bfloat16),  # serve
    (4, 128, 8, 4, 128, [127, 96, 40, 7], 0, torch.bfloat16, torch.bfloat16),
    (4, 8192, 8, 4, 128, [8191, 6143, 4999, 4095], 0, torch.bfloat16,
     torch.bfloat16),                                        # long context
    (3, 100, 2, 1, 32, [99, 50, 0], 9, torch.bfloat16, torch.bfloat16),
    (2, 300, 1, 8, 64, [299, 130], 0, torch.float32, torch.float32),  # MQA
    (3, 77, 2, 3, 128, [76, 20, 64], 25, torch.float32, torch.bfloat16),
    (2, 1000, 4, 2, 64, [999, 500], 700, torch.bfloat16, torch.bfloat16),
    (3, 100, 2, 1, 32, [99, 50, 0], 9, torch.float32, torch.float32),
    (2, 200, 1, 8, 128, [0, 199], 0, torch.bfloat16, torch.bfloat16),  # MQA
    (4, 128, 8, 4, 128, [0] * 4, 0, torch.bfloat16, torch.bfloat16),
    (4, 2048, 8, 4, 128, [2047, 1535, 1023, 511], 0, torch.bfloat16,
     torch.bfloat16),                                        # mid context
    (4, 8192, 2, 4, 128, [0, 1, 300, 64], 0, torch.bfloat16,
     torch.bfloat16),                              # later splits empty
    (3, 2048, 2, 5, 64, [2047, 900, 40], 333, torch.float32,
     torch.bfloat16),                              # window across splits
])
def test_flash_decode_kernel_matches_plain(B, S, KVH, G, Dh, pos, window,
                                           q_dtype, kv_dtype):
    """Dense decode: the serve, mid and long-context shapes, ragged
    positions, windows (one across split boundaries), G=1 (fp32 and
    bf16), MQA (fp32 and bf16), ``pos = 0``, a long cache whose later
    splits hold no live position, and S a multiple of no tile.  One grid
    launch a call, the splits' combine included."""
    dev = _card()
    rng = np.random.default_rng(S + B)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, dt) for shape, dt in (((B, KVH, G, Dh), q_dtype),
                                              ((B, S, KVH, Dh), kv_dtype),
                                              ((B, S, KVH, Dh), kv_dtype)))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(q, k, v, p, window=window)
    want = tref.flash_decode_ref(q, k, v, p, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,Nc,P,ps,nprobe,k", [
    (4, 64, 24, 18, 8, 7, 5), (6, 128, 32, 24, 4, 16, 8),
    (2, 60, 20, 9, 8, 20, 3), (9, 64, 40, 30, 16, 10, 4),
    (4, 768, 1024, 512, 128, 64, 3)])
def test_probe_topk_kernel_matches_plain(B, d, Nc, P, ps, nprobe, k):
    dev = _card()
    qs, cents, valid, pages, pids, pc = (
        torch.from_numpy(a).to(dev)
        for a in _retrieval_inputs(B, d, Nc, P, ps, B * 31 + Nc))
    pages = pages.to(torch.bfloat16)
    before = tpt.probe_topk_fused.launches
    gs, gi, gadm = tpt.probe_topk_fused(qs, cents, valid, pages, pids, pc,
                                        nprobe=nprobe, k=k)
    ws, wi, wadm = tref.probe_and_topk_ref(qs, cents, valid, pages, pids, pc,
                                           nprobe, k)
    torch.cuda.synchronize()
    assert tpt.probe_topk_fused.launches == before + 1
    assert torch.equal(gi, wi)
    assert gadm.dtype == torch.bool and torch.equal(gadm, wadm)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,P,ps,k,shared_mask", [
    (4, 768, 1024, 128, 3, False),     # serve widths, fewer pages
    (3, 60, 18, 8, 5, False),          # odd widths; query 0 admits nothing
    (5, 64, 30, 16, 4, True),          # one [P] mask for every query
    (9, 128, 40, 4, 8, False)])        # more queries than one group of 8
def test_ivf_topk_kernel_matches_plain(B, d, P, ps, k, shared_mask):
    dev = _card()
    rng = np.random.default_rng(B * 7 + P)
    pages = torch.from_numpy(rng.standard_normal((P, ps, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    ids[1, ps // 2:] = -1
    mask = rng.random(P if shared_mask else (B, P)) < 0.2
    if not shared_mask:
        mask[0] = False
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    before = tivf.ivf_topk.launches
    gs, gi = tivf.ivf_topk(pages, ids, mask, q, k)
    ws, wi = tref.ivf_topk_ref(pages, ids, mask, q, k)
    torch.cuda.synchronize()
    assert tivf.ivf_topk.launches == before + 1
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)
    if not shared_mask:
        assert (gi[0] == -1).all() and torch.isinf(gs[0]).all()


def _grids(fn, calls=5):
    """Grids a call of ``fn`` runs on the card, by the profiler over
    ``calls`` calls (after a first call that makes the wrapper's
    per-stream workspace).  The tracer now and then loses device events
    (all of one profile, or one of ten) but never adds any, so the most
    of three profiles counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))))
    return max(counts) / calls


def _stable_ids(scores, ids, k):
    """Ids of the top-k of masked scores [B, P * ps] by (score desc, flat
    position asc), the order the kernels break exact ties in (torch.topk
    keeps no order among ties)."""
    top_s, top_p = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_p = top_s[:, :k], top_p[:, :k]
    return torch.where(torch.isfinite(top_s), ids.reshape(-1)[top_p],
                       -1).to(torch.int32)


def _pool(P, ps, d, seed, *, ties=False, misalign=False):
    """bf16 gaussian pages with unique ids and a padded tail on page 1;
    ``ties`` duplicates rows across pages (and within page 2);
    ``misalign`` puts the slab 2 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, ps, d)).astype(np.float32)
    if ties:
        x[P - 1] = x[0]
        x[P // 2] = x[3 % P]
        x[2, ps - 1] = x[2, 0]
    ids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    ids[1, ps // 2:] = -1
    dev = torch.device("cuda")
    pages = torch.from_numpy(x).to(dev, torch.bfloat16)
    if misalign:
        buf = torch.empty(pages.numel() + 1, dtype=torch.bfloat16, device=dev)
        pages = buf[1:].view(P, ps, d).copy_(pages)
    return pages, torch.from_numpy(ids).to(dev), rng


def _masked_scores(pages, ids, mask, q):
    P, ps, d = pages.shape
    s = q @ pages.reshape(P * ps, d).float().T
    ok = mask.repeat_interleave(ps, dim=1) & (ids.reshape(-1) >= 0)[None]
    return s.masked_fill(~ok, float("-inf"))


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,d,P,ps,k", [
    ("all_dead", 4, 768, 64, 128, 3),
    ("one_live_page", 4, 768, 64, 128, 3),
    ("ps48", 4, 128, 30, 48, 5),
    ("ps7_d60", 3, 60, 40, 7, 4),          # unaligned rows: the direct path
    ("misaligned_slab", 4, 768, 40, 128, 3),   # the direct path at d = 768
    ("ties", 4, 256, 24, 16, 6),           # duplicated rows, across pages
    ("b9_serve_width", 9, 768, 120, 128, 3),   # two passes of queries
    ("two_windows", 3, 16, 70000, 2, 5),   # more pages than one bitmap
    ("k16_wide_merge", 4, 128, 200, 16, 16),   # 2112 candidates a query
    ("d1040", 2, 1040, 20, 8, 4),          # d past the register slices
])
def test_ivf_topk_kernel_edge_cases(case, B, d, P, ps, k):
    """The one-grid search and merge: every page dead, one live page,
    page sizes 48 and 7, d = 60, d = 1040 and a slab off a 16-byte
    boundary (the direct path), exact ties across pages (ids by flat
    position, as the Pallas kernel orders them), B = 9, a pool of two
    bitmap windows, and more candidates than the merge holds in
    registers; ids equal, scores within rtol=1e-4, exactly one grid a
    call, equal bits from a second call."""
    dev = _card()
    pages, ids, rng = _pool(P, ps, d, P + ps + d, ties=case == "ties",
                            misalign=case == "misaligned_slab")
    mask = torch.from_numpy(rng.random((B, P)) < 0.3).to(dev)
    if case == "all_dead":
        mask[:] = False
    elif case == "one_live_page":
        mask[:] = False
        mask[1:, 5] = True
    elif case == "ties":
        mask[:, [0, 2, 3 % P, P // 2, P - 1]] = True
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    before = tivf.ivf_topk.launches
    gs, gi = tivf.ivf_topk(pages, ids, mask, q, k)
    ws, wi = tref.ivf_topk_ref(pages, ids, mask, q, k)
    torch.cuda.synchronize()
    assert tivf.ivf_topk.launches == before + 1
    if case == "ties":
        wi = _stable_ids(_masked_scores(pages, ids, mask, q), ids, k)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)
    if case == "all_dead":
        assert (gi == -1).all() and torch.isinf(gs).all()
    again = tivf.ivf_topk(pages, ids, mask, q, k)
    assert torch.equal(again[0], gs) and torch.equal(again[1], gi)
    assert _grids(lambda: tivf.ivf_topk(pages, ids, mask, q, k)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,d,Nc,P,ps,nprobe,k", [
    ("all_dead", 4, 768, 256, 64, 128, 16, 3),
    ("one_live_page", 4, 768, 256, 64, 128, 16, 3),
    ("one_cluster", 4, 768, 256, 300, 128, 8, 3),   # every live page in one
    ("b9", 9, 768, 512, 200, 128, 32, 3),
    ("ps48", 4, 128, 64, 30, 48, 8, 5),
    ("ps7_d60", 3, 60, 48, 40, 7, 9, 4),
    ("ties", 4, 256, 32, 40, 16, 8, 6),
    ("nc2000", 3, 64, 2000, 60, 16, 100, 3),   # scores past the key registers
])
def test_probe_topk_kernel_edge_cases(case, B, d, Nc, P, ps, nprobe, k):
    """Probe and search in two grids: every page dead, one live page,
    every live page in one cluster (the load on a run of pages), B = 9,
    page sizes 48 and 7, d = 60, duplicated rows tied across pages, and
    Nc = 2000 (the threshold select reads the scores again each pass);
    ids and the admitted mask equal, scores within rtol=1e-4, exactly two
    grids a call, equal bits from a second call."""
    dev = _card()
    pages, ids, rng = _pool(P, ps, d, Nc + P + d, ties=case == "ties")
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    cents = torch.from_numpy(rng.standard_normal((Nc, d)).astype(
        np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(Nc) > 0.1).to(dev)
    pc = torch.from_numpy(rng.integers(-1, Nc, P).astype(np.int32)).to(dev)
    if case == "all_dead":
        pc[:] = -1
    elif case == "one_live_page":
        pc[:] = -1
        pc[7] = int(torch.argmax(torch.where(valid, q[0] @ cents.T,
                                             float("-inf"))))
    elif case == "one_cluster":
        c = int(torch.argmax(torch.where(valid, q[0] @ cents.T,
                                         float("-inf"))))
        pc[:] = -1
        pc[P // 3:P // 3 + 120] = c
    args = (q, cents, valid, pages, ids, pc)
    before = tpt.probe_topk_fused.launches
    gs, gi, gadm = tpt.probe_topk_fused(*args, nprobe=nprobe, k=k)
    ws, wi, wadm = tref.probe_and_topk_ref(*args, nprobe, k)
    torch.cuda.synchronize()
    assert tpt.probe_topk_fused.launches == before + 1
    assert torch.equal(gadm, wadm)
    if case == "ties":
        pm = (pc >= 0)[None, :] & wadm[:, pc.long().clamp(min=0)]
        wi = _stable_ids(_masked_scores(pages, ids, pm, q), ids, k)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)
    if case == "all_dead":
        assert (gi == -1).all()
    if case in ("one_live_page", "one_cluster"):
        assert (gi[0] >= 0).all()
    again = tpt.probe_topk_fused(*args, nprobe=nprobe, k=k)
    assert all(torch.equal(a, b) for a, b in zip(again, (gs, gi, gadm)))
    assert _grids(lambda: tpt.probe_topk_fused(*args, nprobe=nprobe,
                                               k=k)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,Nc,nprobe,invalid", [
    (4, 768, 1024, 64, 0.0),        # serve probe shape, all valid
    (1, 64, 96, 8, 0.2),            # Nc not a multiple of 32
    (3, 128, 128, 16, 0.2),
    (20, 2048, 70, 10, 0.1),        # two row segments
    (900, 30, 100, 10, 0.1),        # d = 30; queries staged in turns of 48
    (33, 768, 1024, 64, 0.1),       # groups of 8, 8, 8, 8 and 1
    (1, 12_288, 300, 16, 0.1),      # twelve row segments
    (4, 768, 1, 1, 0.0),            # Nc = 1
    (4, 768, 4096, 256, 0.05),      # the paper's scale
    (5, 770, 1000, 64, 0.1),        # d % 4: 4-byte loads
])
def test_centroid_scores_kernel_matches_plain(B, d, Nc, nprobe, invalid):
    dev = _card()
    rng = np.random.default_rng(Nc + d)
    cents = torch.from_numpy(rng.standard_normal((Nc, d)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    valid = (torch.from_numpy(rng.random(Nc) >= invalid).to(dev)
             if invalid else None)
    before = tcp.centroid_scores.launches
    got = tcp.centroid_scores(q, cents, valid)
    want = tref.centroid_probe_ref(cents, q, valid)
    gs, gi = tops.centroid_probe(cents, q, nprobe, valid=valid)
    torch.cuda.synchronize()
    assert tcp.centroid_scores.launches == before + 2
    assert got.shape == (B, Nc) and got.dtype == torch.float32
    if valid is not None:
        assert torch.isinf(got[:, ~valid]).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    ws, wi = torch.topk(want, nprobe, dim=-1)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(monkeypatch):
    dev = _card()
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(2, 2, 2, 48, 4, 3, 0))
    before = tfd.flash_decode_paged.launches
    with pytest.raises(ValueError, match="Dh"):          # Dh 48 not taken
        tfd.flash_decode_paged(q, kp, vp, bt, lens)
    with pytest.raises(ValueError, match="int32"):
        tfd.flash_decode_paged(q[..., :32].contiguous(), kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt.long(), lens)
    with pytest.raises(ValueError, match="q/kv"):       # bf16 q over fp32 K/V
        tfd.flash_decode_paged(q[..., :32].to(torch.bfloat16),
                               kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt, lens)
    assert tfd.flash_decode_paged.launches == before
    k, v = kp[:2], vp[:2]                         # a dense [B, S, KVH, Dh] cache
    before = tfd.flash_decode.launches
    with pytest.raises(ValueError, match="Dh"):
        tops.flash_decode(q, k, v, lens)
    q32, k32, v32 = (t[..., :32].contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="int32"):
        tops.flash_decode(q32, k32, v32, lens.long())
    with pytest.raises(ValueError, match="q/kv"):
        tops.flash_decode(q32.to(torch.bfloat16), k32, v32, lens)
    with pytest.raises(ValueError, match="q/kv"):        # fp16, no upcast
        tops.flash_decode(q32.half(), k32.half(), v32.half(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_decode(q32, k[..., :32], v32, lens)
    # the kernel cannot load: the error surfaces, no plain version runs
    monkeypatch.setattr(tfd, "_fns", {})
    def no_build(name):
        raise _build.KernelBuildError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(_build.KernelBuildError, match="flash_decode"):
        tops.flash_decode(q32, k32, v32, lens)
    assert tfd.flash_decode.launches == before
    pages = torch.zeros((3, 4, 8), dtype=torch.bfloat16, device=dev)
    ids = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    mask = torch.ones((2, 3), dtype=torch.bool, device=dev)
    qs = torch.zeros((2, 8), device=dev)
    before = tivf.ivf_topk.launches
    with pytest.raises(ValueError, match="bfloat16"):    # fp32 pages
        tivf.ivf_topk(pages.float(), ids, mask, qs, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tivf.ivf_topk(pages, ids, mask.t().contiguous().t(), qs, 1)
    assert tivf.ivf_topk.launches == before
    before = tcp.centroid_scores.launches
    with pytest.raises(ValueError, match="fp32"):
        tcp.centroid_scores(qs.to(torch.bfloat16), qs)
    with pytest.raises(ValueError, match="d <="):
        tcp.centroid_scores(torch.zeros((1, 20_000), device=dev),
                            torch.zeros((4, 20_000), device=dev))
    assert tcp.centroid_scores.launches == before


@pytest.mark.cuda
def test_serve_step_paged_on_card_matches_cpu():
    """A reduced Llama-3 decode step through the kernel on the card agrees
    with the same step through the plain version on the CPU (fp32)."""
    dev = _card()
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), num_kv_heads=2)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    B, ps, MB = 3, 4, 4
    NP = B * MB + 2
    shape = (cfg.num_layers, NP, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(NP)[:B * MB].reshape(B, MB)
                          .astype(np.int32))
    lens = torch.tensor([0, 3, 6], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(np.int32))
    want, wk, _ = ttf.serve_step_paged(model, k0.clone(), v0.clone(), bt, lens,
                                       {"token": tok})
    model_d = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                    for n, p in model.named_parameters()})
    before = tfd.flash_decode_paged.launches
    got, gk, _ = ttf.serve_step_paged(model_d, k0.to(dev), v0.to(dev),
                                      bt.to(dev), lens.to(dev),
                                      {"token": tok.to(dev)})
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + cfg.num_layers
    torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zeros", "random"])
def test_serve_step_on_card_matches_cpu(start):
    """A reduced Llama-3 dense decode step through kernel 4 on the card
    agrees with the same step through the plain version on the CPU (fp32),
    at ragged positions, from zeroed caches (as the serve's fresh buckets)
    and from a random starting cache (stale entries past pos masked)."""
    dev = _card()
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), num_kv_heads=2)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    B, S = 3, 40
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if start == "zeros":
        k0.zero_()
        v0.zero_()
    pos = torch.tensor([0, 17, 39], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(np.int32))
    want, wc = ttf.serve_step(model, {"k": k0.clone(), "v": v0.clone()},
                              {"token": tok, "pos": pos})
    model_d = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                    for n, p in model.named_parameters()})
    before = tfd.flash_decode.launches
    got, gc = ttf.serve_step(model_d, {"k": k0.to(dev), "v": v0.to(dev)},
                             {"token": tok.to(dev), "pos": pos.to(dev)})
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + cfg.num_layers
    torch.testing.assert_close(gc["k"].cpu(), wc["k"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gc["v"].cpu(), wc["v"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


def _spliced_inputs(seed, B, KVH, G, Dh, ps, chunks, fresh, tail=2):
    """Row b: chunks[b] (token counts) spliced at page boundaries with
    their layout offsets, then ``fresh`` fresh pages, then ``tail`` -1
    columns (valid 0); the new token somewhere on the fresh pages."""
    rng = np.random.default_rng(seed)
    MB = max(sum(-(-c // ps) for c in row) for row in chunks) + fresh + tail
    NP = B * MB + 3
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    perm = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    bt = np.full((B, MB), -1, np.int32)
    delta = np.zeros((B, MB), np.int32)
    valid = np.zeros((B, MB), np.int32)
    lengths = []
    for b, row in enumerate(chunks):
        b0 = 0
        for c in row:
            n = -(-c // ps)
            bt[b, b0:b0 + n] = perm[b, b0:b0 + n]
            delta[b, b0:b0 + n] = b0 * ps
            valid[b, b0:b0 + n] = ps
            valid[b, b0 + n - 1] = c - (n - 1) * ps
            b0 += n
        bt[b, b0:b0 + fresh] = perm[b, b0:b0 + fresh]
        valid[b, b0:b0 + fresh] = ps
        lengths.append(b0 * ps + 1 + int(rng.integers(0, fresh * ps)))
    return q, kp, vp, bt, np.asarray(lengths, np.int32), delta, valid


# (seed, B, KVH, G, Dh, ps, chunks, fresh pages, rope fraction)
SPLICED = {
    "all fresh": (1, 4, 8, 4, 128, 16, [[]] * 4, 8, 1.0),
    "one chunk a row": (2, 4, 8, 4, 128, 16, [[21], [9], [33], [16]], 8, 1.0),
    "several chunks, partial last pages": (
        3, 4, 8, 4, 128, 16, [[21, 9, 40], [3], [17, 17], [1]], 8, 1.0),
    "different leads, -1 tails": (4, 3, 2, 2, 64, 16, [[70], [], [5, 5, 5]],
                                  2, 1.0),
    "page size 48": (5, 3, 2, 8, 64, 48, [[50, 100], [7], [150]], 3, 1.0),
    "rope fraction 0.5": (6, 3, 2, 2, 32, 16, [[21, 9], [5, 5, 5], []], 3,
                          0.5),
    "dead tail across a 64-position chunk": (7, 2, 8, 4, 128, 16,
                                             [[65, 3], [129]], 4, 1.0),
    "mid context": (8, 4, 8, 4, 128, 16, [[24] * 20, [20] * 30, [], [9] * 60],
                    64, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(SPLICED))
def test_flash_decode_spliced_kernel_matches_plain(name, dtype):
    """The spliced kernel against its plain version on the same inputs:
    K rotated by each page's delta (theta 5e5), dead slots and -1 columns
    masked; one grid launch a call and equal bits from a second call."""
    dev = _card()
    *shape, frac = SPLICED[name]
    q, kp, vp, bt, lens, dl, vd = (torch.from_numpy(a).to(dev) for a in
                                   _spliced_inputs(*shape))
    kp, vp = kp.to(dtype), vp.to(dtype)
    q = q.to(dtype)
    kw = dict(rope_fraction=frac, rope_theta=500_000.0)
    before = tfd.flash_decode_spliced.launches
    got = tops.flash_decode_spliced(q, kp, vp, bt, lens, dl, vd, **kw)
    want = tref.flash_decode_spliced_ref(q, kp, vp, bt, lens, dl, vd, **kw)
    torch.cuda.synchronize()
    assert tfd.flash_decode_spliced.launches == before + 1
    assert got.dtype == torch.float32 and not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    again = tops.flash_decode_spliced(q, kp, vp, bt, lens, dl, vd, **kw)
    assert torch.equal(again, got)        # the counters were left at zero
    if name == "all fresh":
        assert torch.equal(tfd.flash_decode_paged(q, kp, vp, bt, lens), got)


@pytest.mark.cuda
def test_flash_decode_spliced_kernel_replays_in_a_cuda_graph():
    """Captured once and replayed, the kernel gives the eager call's bits
    (no host state between launches)."""
    dev = _card()
    *shape, frac = SPLICED["several chunks, partial last pages"]
    args = [torch.from_numpy(a).to(dev) for a in _spliced_inputs(*shape)]
    args[0] = args[0].to(torch.bfloat16)
    args[1], args[2] = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
    want = tfd.flash_decode_spliced(*args, rope_theta=500_000.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfd.flash_decode_spliced(*args, rope_theta=500_000.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tfd.flash_decode_spliced(*args, rope_theta=500_000.0)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_flash_decode_spliced_wrapper_raises_on_bad_tables():
    dev = _card()
    *shape, _ = SPLICED["rope fraction 0.5"]
    q, kp, vp, bt, lens, dl, vd = (torch.from_numpy(a).to(dev) for a in
                                   _spliced_inputs(*shape))
    before = tfd.flash_decode_spliced.launches
    with pytest.raises(ValueError, match="int32"):
        tfd.flash_decode_spliced(q, kp, vp, bt, lens, dl.long(), vd)
    with pytest.raises(ValueError, match="page_valid"):
        tfd.flash_decode_spliced(q, kp, vp, bt, lens, dl, vd[:, :-1])
    with pytest.raises(ValueError, match="page_delta"):
        tfd.flash_decode_spliced(q, kp, vp, bt, lens, dl.cpu(), vd)
    assert tfd.flash_decode_spliced.launches == before


@pytest.mark.cuda
def test_serve_step_paged_spliced_on_card_matches_cpu():
    """A reduced Llama-3 spliced decode step through the kernel on the
    card agrees with the same step through the plain version on the CPU
    (fp32): the slab write and the logits."""
    dev = _card()
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), num_kv_heads=2)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    q, _, _, bt, lens, dl, vd = _spliced_inputs(
        9, 3, cfg.num_kv_heads, 2, cfg.resolved_head_dim, 4,
        [[5, 3], [9], []], 2)
    rng = np.random.default_rng(9)
    NP = int(bt.max()) + 1
    shape = (cfg.num_layers, NP, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tables = [torch.from_numpy(a) for a in (bt, lens - 1, dl, vd)]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3).astype(np.int32))
    want, wk, _ = ttf.serve_step_paged_spliced(model, k0.clone(), v0.clone(),
                                               *tables, {"token": tok})
    model_d = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                    for n, p in model.named_parameters()})
    before = tfd.flash_decode_spliced.launches
    got, gk, _ = ttf.serve_step_paged_spliced(
        model_d, k0.to(dev), v0.to(dev), *(t.to(dev) for t in tables),
        {"token": tok.to(dev)})
    torch.cuda.synchronize()
    assert tfd.flash_decode_spliced.launches == before + cfg.num_layers
    torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["query", "centroids", "both"])
def test_centroid_scores_off_a_16_byte_boundary(what):
    """Tensors sliced off a 16-byte boundary take the 4-byte loads and
    give the plain version's top-k ids and scores."""
    dev = _card()
    B, d, Nc = 4, 768, 1024
    rng = np.random.default_rng(5)
    flat_q = torch.from_numpy(rng.standard_normal(B * d + 1).astype(np.float32)).to(dev)
    flat_c = torch.from_numpy(rng.standard_normal(Nc * d + 3).astype(np.float32)).to(dev)
    q = flat_q[1:].view(B, d) if what != "centroids" else flat_q[:-1].view(B, d)
    cents = flat_c[3:].view(Nc, d) if what != "query" else flat_c[:-3].view(Nc, d)
    valid = torch.from_numpy(rng.random(Nc) > 0.1).to(dev)
    assert (q.data_ptr() % 16 != 0) or (cents.data_ptr() % 16 != 0)
    got = tcp.centroid_scores(q, cents, valid)
    want = tref.centroid_probe_ref(cents, q, valid)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    gs, gi = tops.centroid_probe(cents, q, 64, valid=valid)
    assert torch.equal(gi, torch.topk(want, 64, dim=-1).indices)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d", [(4, 768), (33, 1024), (2, 3000)])
def test_centroid_scores_scalar_path_matches_vector_path(B, d, monkeypatch):
    """The 4-byte loads on aligned data (the plan told the inputs are
    unaligned) agree with the 16-byte loads: the same top-k ids, scores
    within rtol=1e-4 (another summation order)."""
    dev = _card()
    rng = np.random.default_rng(B + d)
    cents = torch.from_numpy(rng.standard_normal((1000, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
    vec = tcp.centroid_scores(q, cents)
    plan = tcp._plan
    monkeypatch.setattr(tcp, "_plan", lambda B, d, Nc, sms, aligned:
                        plan(B, d, Nc, sms, False))
    scalar = tcp.centroid_scores(q, cents)
    torch.testing.assert_close(scalar, vec, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.topk(scalar, 32, dim=-1).indices,
                       torch.topk(vec, 32, dim=-1).indices)
    assert not torch.equal(scalar, vec) or d < 128


# (seed, B, KVH, G, Dh, ps, rows, fresh pages, -1 tail columns, rope
# fraction): rows with fresh runs (-k: k fresh pages) among chunks
SPLICED_PATHS = {
    # 130 table columns at 32 rows: splits of two 64-position chunks
    "fresh and spliced chunks in one split": (
        11, 4, 8, 4, 128, 16, [[-4, 20, 20, -4, 9, -4, 40, -8],
                               [20] * 6 + [-8], [-12, 33, -4], [5, -4, 64, -4]],
        2, 100, 1.0),
    "long deltas": (12, 2, 4, 4, 128, 16, [[20] * 250, [-3, 40] * 60], 2, 2, 1.0),
    "Dh 64, rot 32, page size 48": (13, 3, 2, 4, 64, 48,
                                    [[50, -1, 100], [-1, 7], [-2, 150]], 3, 2,
                                    0.5),
}


def _path_inputs(seed, B, KVH, G, Dh, ps, rows, fresh, tail, dtype):
    """Spliced inputs on the card: row b holds ``rows[b]`` at page
    boundaries, a positive entry a chunk of that many tokens (its pages'
    delta the chunk's first layout position, valid its live tokens), a
    negative entry -k k fresh pages (delta 0, valid ps), then ``fresh``
    fresh pages holding the new token, then ``tail`` -1 columns."""
    rng = np.random.default_rng(seed)
    npages = lambda c: -c if c < 0 else -(-c // ps)
    MB = max(sum(map(npages, row)) for row in rows) + fresh + tail
    NP = B * MB + 3
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    perm = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    bt = np.full((B, MB), -1, np.int32)
    delta = np.zeros((B, MB), np.int32)
    valid = np.zeros((B, MB), np.int32)
    lengths = []
    for b, row in enumerate(rows):
        b0 = 0
        for c in row + [-fresh]:
            n = npages(c)
            bt[b, b0:b0 + n] = perm[b, b0:b0 + n]
            valid[b, b0:b0 + n] = ps
            if c > 0:
                delta[b, b0:b0 + n] = b0 * ps
                valid[b, b0 + n - 1] = c - (n - 1) * ps
            b0 += n
        lengths.append((b0 - fresh) * ps + 1 + int(rng.integers(0, fresh * ps)))
    t = [torch.from_numpy(x).cuda() for x in
         (q, kp, vp, bt, np.asarray(lengths, np.int32), delta, valid)]
    t[0], t[1], t[2] = t[0].to(dtype), t[1].to(dtype), t[2].to(dtype)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(SPLICED_PATHS))
def test_flash_decode_spliced_paths_give_the_same_bits(name, dtype,
                                                       monkeypatch):
    """The fresh chunks' unspliced code against the general code, partners
    by shuffle against reads from shared memory, the angle table against
    angles computed where they are used: every other plan gives the
    default plan's bits, which match the plain version."""
    dev = _card()
    *shape, frac = SPLICED_PATHS[name]
    args = _path_inputs(*shape, dtype)
    Dh, ps = args[0].shape[3], args[1].shape[1]
    rot = int(Dh * frac) // 2 * 2
    mode, _ = tfd.spliced_chunks(*args[3:], ps, rot)
    assert (mode == tfd.FRESH).any() and (mode == tfd.ROTATED).any()
    kw = dict(rope_fraction=frac, rope_theta=500_000.0)
    want = tfd.flash_decode_spliced(*args, **kw)
    torch.testing.assert_close(
        want, tref.flash_decode_spliced_ref(*args, **kw), atol=2e-3, rtol=2e-3)
    dist, runs, fresh = tfd._splice_plan(Dh, dtype == torch.bfloat16, rot)
    assert dist > 0 and runs > 0 and fresh == 1    # the default's fast paths
    for alt in ((dist, runs, 0), (0, runs, 1), (dist, 0, 1), (0, 0, 0)):
        monkeypatch.setattr(tfd, "_splice_plan", lambda *a, alt=alt: alt)
        assert torch.equal(tfd.flash_decode_spliced(*args, **kw), want), alt


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPLICED_PATHS))
def test_flash_decode_spliced_mixed_tables_replay_in_a_cuda_graph(name):
    """Fresh and spliced chunks side by side: equal bits from two calls,
    and the eager call's bits from every replay of a captured call."""
    dev = _card()
    *shape, frac = SPLICED_PATHS[name]
    args = _path_inputs(*shape, torch.bfloat16)
    kw = dict(rope_fraction=frac, rope_theta=500_000.0)
    want = tfd.flash_decode_spliced(*args, **kw)
    assert torch.equal(tfd.flash_decode_spliced(*args, **kw), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfd.flash_decode_spliced(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tfd.flash_decode_spliced(*args, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# Training on the card (no hand-written kernel: plain PyTorch on CUDA
# tensors, as the reference trains through jnp)
# ---------------------------------------------------------------------------


def _trainer(seed=0):
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.training import (OptConfig, init_training,
                                      make_train_step)
    cfg = get_arch("llama3-8b").reduced()
    opt = OptConfig(warmup_steps=1, total_steps=10)
    model, state = init_training(
        cfg, opt, torch.Generator(device="cuda").manual_seed(seed))
    data = TokenStream(cfg, DataConfig(global_batch=4, seq_len=32, seed=0))
    step = make_train_step(cfg, opt, attn_chunk=16, loss_chunk=8)
    return model, state, data, step


def _on_card(batch):
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@pytest.mark.cuda
def test_train_step_on_the_card_gives_finite_loss_and_gradients():
    """One smoke-preset step: a finite loss, and every parameter's
    gradient on the card, finite and of its parameter's shape; every
    weight matrix moved (the bf16 norm gains, at 1.0, do not: a 3e-4
    step is under half their bf16 ulp)."""
    _card()
    model, state, data, step = _trainer()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, state, m = step(model, state, _on_card(data.next_batch()))
    assert torch.isfinite(m["loss"]).item() and m["loss"].is_cuda
    assert torch.isfinite(m["grad_norm"]).item() and m["grad_norm"] > 0
    for n, p in model.named_parameters():
        assert p.grad is not None and p.grad.is_cuda, n
        assert p.grad.shape == p.shape and torch.isfinite(p.grad).all(), n
        assert n.endswith("norm") or not torch.equal(p.detach(),
                                                     before[n]), n
    assert state["step"].item() == 1 and state["step"].is_cuda


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """Save after a step, restore into a fresh model and state (in
    place): every tensor back on the card, equal to the bit; the next
    step from the restore equals the uninterrupted one to the bit."""
    from repro_torch.training import restore_checkpoint, save_checkpoint
    _card()
    model, state, data, step = _trainer(seed=1)
    model, state, _ = step(model, state, _on_card(data.next_batch()))
    save_checkpoint(str(tmp_path), 1, {"params": model, "opt": state,
                                       "data": data.cursor()})
    fresh, fresh_state, _, _ = _trainer(seed=2)
    n, back = restore_checkpoint(str(tmp_path), {
        "params": fresh, "opt": fresh_state, "data": {"step": 0, "seed": 0}})
    assert n == 1 and back["data"] == data.cursor()
    assert back["params"] is fresh and back["opt"] is fresh_state
    for (name, a), b in zip(model.named_parameters(),
                            back["params"].parameters()):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b), name
    for k in ("m", "v"):
        for name, t in state[k].items():
            assert torch.equal(back["opt"][k][name], t), (k, name)
    batch = _on_card(data.next_batch())
    model, state, m1 = step(model, state, batch)
    r_model, _, m2 = step(back["params"], back["opt"], batch)
    assert m1["loss"].item() == m2["loss"].item()
    for a, b in zip(model.parameters(), r_model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_main_on_the_card_checkpoints_and_resumes(tmp_path):
    """launch/train's ``main`` at the smoke preset on the card: finite
    losses, fp32 moments (they fit), a checkpoint; a rerun with more
    steps resumes from it."""
    from repro_torch.launch import train
    _card()
    args = ["--preset", "smoke", "--steps", "2", "--batch", "2", "--seq",
            "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    hist = train.main(args)
    assert [h["step"] for h in hist] == [1, 2]
    assert all(math.isfinite(h["loss"]) and h["ms"] > 0 for h in hist)
    cfg = train.preset_config(get_arch("llama3-8b"), "smoke")
    assert train.moment_dtype(cfg, torch.device("cuda")) == "float32"
    more = train.main(args[:3] + ["3"] + args[4:])
    assert [h["step"] for h in more] == [3]


# one arch of each family kind beside Llama-3 (whose step is above)
FAMILY_TRAIN = ["gemma2-27b", "minicpm3-4b", "granite-moe-3b-a800m",
                "musicgen-large", "internvl2-1b", "rwkv6-3b", "zamba2-2.7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_TRAIN)
def test_family_train_step_on_the_card_matches_cpu(arch):
    """One reduced fp32 step (remat) of each family on the card from the
    CPU model's weights, on a TokenStream batch (an image prefix,
    codebooks): the loss and grad norm within rtol 1e-4 of the CPU
    step's (fp32 sums in another order), every gradient on the card and
    finite."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_train_step)
    dev = _card()
    cfg = get_arch(arch).reduced()
    opt = OptConfig(warmup_steps=1, total_steps=10)
    weights = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu", dtype=torch.float32)
    batch = TokenStream(cfg, DataConfig(global_batch=2, seq_len=32,
                                        seed=0)).next_batch()
    step = make_train_step(cfg, opt, attn_chunk=16, loss_chunk=8)
    out = []
    for d in (torch.device("cpu"), dev):
        model = ttf.Transformer(cfg, {n: p.detach().clone().to(d) for n, p
                                      in weights.named_parameters()})
        model.set_trainable()
        state = init_opt_state(dict(model.named_parameters()), opt)
        model, state, m = step(model, state, {k: torch.from_numpy(v).to(d)
                                              for k, v in batch.items()})
        out.append((model, m))
    (_, c), (card, g) = out
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(g[k].item(), c[k].item(), rtol=1e-4,
                                   err_msg=k)
    for n, p in card.named_parameters():
        assert p.is_cuda and torch.isfinite(p.grad).all(), n


# the decode kernels at the new configs' G and past 8 in tiles:
# (KVH, G, Dh, rope fraction) of granite-moe, nemotron, internvl2 and
# granite-20b, a last tile of one row and the most rows (64)
G_TILES = {"granite-moe G=3": (8, 3, 64, 1.0), "nemotron G=6": (8, 6, 128, 0.5),
           "internvl2 G=7": (2, 7, 64, 1.0), "granite-20b G=48": (1, 48, 128, 1.0),
           "G=9": (2, 9, 32, 1.0), "G=64": (1, 64, 64, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(G_TILES))
def test_decode_kernels_at_each_configs_g_match_plain(name, dtype):
    """Kernels 1, 4 and the spliced kernel at each G of G_TILES against
    their plain versions (atol=rtol=2e-3): ragged block tables and dense
    positions (a window across splits at G > 8), spliced chunks; one grid
    launch a call, equal bits from a second call."""
    dev = _card()
    KVH, G, Dh, frac = G_TILES[name]
    window = 300 if G > 8 else 0
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(4, KVH, G, Dh, 16, 64, G))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = tref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert torch.equal(tfd.flash_decode_paged(q, kp, vp, bt, lens,
                                              window=window), got)

    rng = np.random.default_rng(G)
    S = 1000
    k, v = (torch.from_numpy(rng.standard_normal((4, S, KVH, Dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    pos = torch.tensor([999, 700, 64, 0], dtype=torch.int32, device=dev)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(q, k, v, pos, window=window)
    want = tref.flash_decode_ref(q, k, v, pos, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert torch.equal(tfd.flash_decode(q, k, v, pos, window=window), got)

    q, kp, vp, bt, lens, dl, vd = (torch.from_numpy(a).to(dev) for a in
                                   _spliced_inputs(G, 3, KVH, G, Dh, 16,
                                                   [[21, 9, 40], [5, 5], [33]], 4))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    kw = dict(rope_fraction=frac, rope_theta=500_000.0)
    before = tfd.flash_decode_spliced.launches
    got = tfd.flash_decode_spliced(q, kp, vp, bt, lens, dl, vd, **kw)
    want = tref.flash_decode_spliced_ref(q, kp, vp, bt, lens, dl, vd, **kw)
    torch.cuda.synchronize()
    assert tfd.flash_decode_spliced.launches == before + 1
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert torch.equal(tfd.flash_decode_spliced(q, kp, vp, bt, lens, dl, vd,
                                                **kw), got)


@pytest.mark.cuda
def test_g_past_64_is_refused():
    dev = _card()
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(2, 1, 65, 32, 4, 3, 0))
    before = tfd.flash_decode_paged.launches
    with pytest.raises(ValueError, match="G in 1..64"):
        tfd.flash_decode_paged(q, kp, vp, bt, lens)
    assert tfd.flash_decode_paged.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 48])
def test_moe_layer_on_the_card_matches_the_cpu(T):
    """granite-moe's routing (40 experts top-8) at a narrow width, fp32:
    the card selects and keeps the same experts as the CPU for a decode
    step's 4 rows (capacity 1) and a 48-token group, and its output is
    within 1e-4 of the scale (products in another order)."""
    from repro_torch.models import moe as tmoe
    dev = _card()
    cfg = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=128))
    d, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    g = torch.Generator().manual_seed(T)
    p = {"router": torch.randn(d, E, generator=g) / math.sqrt(d),
         "w_up": torch.randn(E, d, F, generator=g) / math.sqrt(E),
         "w_gate": torch.randn(E, d, F, generator=g) / math.sqrt(E),
         "w_down": torch.randn(E, F, d, generator=g) / math.sqrt(E)}
    x = torch.randn(T, d, generator=g)
    want, waux = tmoe.moe_forward(p, x, cfg)
    rw = tmoe.route(p["router"], x, cfg)
    pd = {k: t.to(dev) for k, t in p.items()}
    got, gaux = tmoe.moe_forward(pd, x.to(dev), cfg)
    rg = tmoe.route(pd["router"], x.to(dev), cfg)
    torch.cuda.synchronize()
    assert torch.equal(rg.experts.cpu(), rw.experts)
    assert torch.equal(rg.keep.cpu(), rw.keep)
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    assert abs(gaux.item() - waux.item()) <= 1e-5


@pytest.mark.cuda
def test_moe_serve_step_paged_on_card_matches_cpu():
    """A reduced granite-moe decode step (fp32) through the kernel on the
    card against the plain version on the CPU, as the Llama test."""
    dev = _card()
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    B, ps, MB = 3, 4, 4
    NP = B * MB + 2
    shape = (cfg.num_layers, NP, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(NP)[:B * MB].reshape(B, MB)
                          .astype(np.int32))
    lens = torch.tensor([0, 3, 6], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(np.int32))
    want, wk, _ = ttf.serve_step_paged(model, k0.clone(), v0.clone(), bt, lens,
                                       {"token": tok})
    model_d = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                    for n, p in model.named_parameters()})
    got, gk, _ = ttf.serve_step_paged(model_d, k0.to(dev), v0.to(dev),
                                      bt.to(dev), lens.to(dev),
                                      {"token": tok.to(dev)})
    torch.cuda.synchronize()
    torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


# -- gemma2 (softcap, ring, int8 K/V) and MLA on the card ---------------------


def _dense(B, S, KVH, G, Dh, pos, seed, dtype, q_dtype=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, KVH, G, Dh), generator=g) * 3
    k = torch.randn((B, S, KVH, Dh), generator=g) * 3
    v = torch.randn((B, S, KVH, Dh), generator=g)
    return (q.to(q_dtype or dtype), k.to(dtype), v.to(dtype),
            torch.tensor(pos, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,KVH,G,Dh,pos,window", [
    (4, 128, 16, 2, 128, [127, 96, 40, 0], 0),     # gemma2's global layer
    (4, 4096, 16, 2, 128, [4095, 3000, 64, 0], 0),
    (3, 300, 2, 12, 64, [299, 100, 5], 0),          # the tile path past G = 8
    (2, 100, 4, 1, 32, [99, 3], 9)])                # reduced gemma2, window
def test_flash_decode_softcap_matches_plain(dtype, B, S, KVH, G, Dh, pos,
                                            window):
    dev = _card()
    case = _dense(B, S, KVH, G, Dh, pos, 41, dtype)
    want = tref.flash_decode_ref(*case, window, 50.0)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(*(t.to(dev) for t in case), window=window,
                           softcap=50.0)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
    # the cap changes the result: uncapped is another function here
    plain = tref.flash_decode_ref(*case, window)
    assert (plain - want).abs().max() > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("W,pos", [(4096, [100, 4095, 9000, 0]),
                                   (8, [3, 7, 17, 30])])
def test_ring_through_flash_decode_is_the_windowed_full_cache(W, pos):
    """The ring of W slots (slot p % W holds the newest position of that
    residue) through kernel 4 at min(pos, W - 1), no window, against the
    plain version over the full cache with window W: below W - 1, at it
    and wrapped past 2W."""
    dev = _card()
    B, KVH, G, Dh = len(pos), 4, 2, 32 if W == 8 else 128
    S = max(pos) + 1
    q, k, v, p = _dense(B, S, KVH, G, Dh, pos, 43, torch.bfloat16)
    ring_k = torch.zeros((B, W, KVH, Dh), dtype=torch.bfloat16)
    ring_v = torch.zeros_like(ring_k)
    for b, pb in enumerate(pos):
        for t in range(max(0, pb - W + 1), pb + 1):
            ring_k[b, t % W], ring_v[b, t % W] = k[b, t], v[b, t]
    want = tref.flash_decode_ref(q, k, v, p, W, 50.0)
    got = tfd.flash_decode(q.to(dev), ring_k.to(dev), ring_v.to(dev),
                           torch.clamp(p, max=W - 1).to(dev), softcap=50.0)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,KVH,G,Dh,pos,window,cap", [
    (4, 128, 16, 2, 128, [127, 96, 40, 0], 0, 50.0),
    (4, 8192, 16, 2, 128, [8191, 6143, 4999, 0], 0, 50.0),
    (2, 100, 4, 1, 32, [99, 3], 0, 50.0),          # int8 rows of 32 bytes
    (3, 300, 2, 12, 64, [299, 100, 5], 20, 0.0)])
def test_flash_decode_quant_matches_plain(q_dtype, B, S, KVH, G, Dh, pos,
                                          window, cap):
    dev = _card()
    from repro_torch.models.attention import quantize_heads
    q, k, v, p = _dense(B, S, KVH, G, Dh, pos, 47, torch.float32, q_dtype)
    kq, ks = quantize_heads(k)
    vq, vs = quantize_heads(v)
    want = tref.flash_decode_quant_ref(q, kq, vq, ks, vs, p, window=window,
                                       softcap=cap)
    before = tfd.flash_decode_quant.launches
    got = tops.flash_decode_quant(*(t.to(dev) for t in (q, kq, vq, ks, vs, p)),
                                  window=window, softcap=cap)
    torch.cuda.synchronize()
    assert tfd.flash_decode_quant.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,R,Dr,pos", [
    (4, 128, 40, 256, 32, [127, 96, 40, 0]),       # minicpm3, serve
    (4, 8192, 40, 256, 32, [8191, 6143, 4999, 0]),  # long context
    (3, 77, 4, 32, 16, [76, 0, 31])])              # reduced
def test_mla_decode_matches_plain(dtype, B, S, H, R, Dr, pos):
    dev = _card()
    from repro_torch.kernels import mla_decode as tmla
    g = torch.Generator().manual_seed(53)
    q_abs = torch.randn((B, H, R), generator=g)
    q_pe = torch.randn((B, H, Dr), generator=g)
    ckv = torch.randn((B, S, R), generator=g).to(dtype)
    kpe = torch.randn((B, S, Dr), generator=g).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    scale = 1.0 / math.sqrt(96)
    want = tref.mla_decode_ref(q_abs, q_pe, ckv, kpe, p, scale)
    before = tmla.mla_decode.launches
    got = tops.mla_decode(*(t.to(dev) for t in (q_abs, q_pe, ckv, kpe, p)),
                          scale)
    torch.cuda.synchronize()
    assert tmla.mla_decode.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,Dr", [(256, 32), (32, 16)])
@pytest.mark.parametrize("H", [1, 16, 17, 40, 64])
@pytest.mark.parametrize("S,pos", [(1, [0, 0]), (31, [30, 0]), (33, [32, 7]),
                                   (128, [127, 0]), (8192, [8191, 0])])
def test_mla_decode_tile_edges_match_plain(dtype, R, Dr, H, S, pos):
    """The MLA kernel at every tile edge: 1, 16 and 17 heads (a tile, one
    past it), minicpm3's 40 (a half-padded last tile) and 64 (four full
    tiles); S of one position, a chunk less and more than 32, the serve
    bucket and the long context, with a row at pos 0; both (R, Dr) and
    both caches (bf16: split bf16 products on the tensor cores; fp32: the
    CUDA-core kernel)."""
    dev = _card()
    from repro_torch.kernels import mla_decode as tmla
    g = torch.Generator().manual_seed(59 + H + S)
    B = len(pos)
    q_abs = torch.randn((B, H, R), generator=g)
    q_pe = torch.randn((B, H, Dr), generator=g)
    ckv = torch.randn((B, S, R), generator=g).to(dtype)
    kpe = torch.randn((B, S, Dr), generator=g).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    scale = 1.0 / math.sqrt(96)
    want = tref.mla_decode_ref(q_abs, q_pe, ckv, kpe, p, scale)
    before = tmla.mla_decode.launches
    got = tmla.mla_decode(*(t.to(dev) for t in (q_abs, q_pe, ckv, kpe, p)),
                          scale)
    torch.cuda.synchronize()
    assert tmla.mla_decode.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_flash_decode_quant_dequantizes_every_int8_value_exactly():
    """The kernel's dequantizing, on every int8 value in [-127, 127] times
    every bf16 scale in [1e-8, 1e4], equals dequantize_ref bit for bit: at
    pos 0 over one position the softmax is 1, so the output is the
    dequantized V row itself (two rows of 128 values a scale)."""
    dev = _card()
    bits = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16)
    s = bits.view(torch.bfloat16)
    s = s[(s.float() >= 1e-8) & (s.float() <= 1e4)]
    B, KVH, Dh = len(s), 2, 128
    x = torch.cat([torch.arange(-127, 128), torch.zeros(1)]).to(torch.int8)
    v = x.reshape(1, 1, KVH, Dh).expand(B, 1, KVH, Dh).contiguous()
    k = torch.zeros_like(v)
    v_scale = s.reshape(B, 1, 1).expand(B, 1, KVH).contiguous()
    k_scale = torch.ones_like(v_scale)
    q = torch.zeros((B, KVH, 1, Dh), dtype=torch.bfloat16)
    pos = torch.zeros((B,), dtype=torch.int32)
    got = tfd.flash_decode_quant(*(t.to(dev) for t in (q, k, v, k_scale,
                                                       v_scale, pos)))
    want = tref.dequantize_ref(v, v_scale).float()[:, 0, :, None]
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_quant", [("gemma2-27b", False),
                                           ("gemma2-27b", True),
                                           ("minicpm3-4b", False),
                                           ("rwkv6-3b", False),
                                           ("zamba2-2.7b", False)])
def test_dense_family_serve_step_on_card_matches_cpu(arch, kv_quant):
    """The reduced gemma2 (4 layers, window 8: 12 steps wrap the rings),
    minicpm3, rwkv6 and zamba2, fp32, ``serve_step`` on the card against
    the CPU: logits within 2e-3 each step; one decode grid per layer per
    step (rings and global layers through flash_decode, or
    flash_decode_quant on the global layers; MLA through mla_decode),
    none for RWKV6 and one flash_decode grid per group for zamba2's
    shared attention."""
    dev = _card()
    from repro_torch.kernels import mla_decode as tmla
    cfg = get_arch(arch).reduced()
    cpu = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.float32)
    card = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                 for n, p in cpu.named_parameters()})
    B, S = 3, 16
    cc = ttf.init_cache(cfg, B, S, torch.float32, device="cpu",
                        kv_quant=kv_quant)
    gc = {n: t.to(dev) for n, t in cc.items()}
    g = torch.Generator().manual_seed(2)
    pos = torch.tensor([0, 2, 3], dtype=torch.int32)
    counted = (tfd.flash_decode, tfd.flash_decode_quant, tmla.mla_decode,
               tfd.flash_decode_paged)
    before = [f.launches for f in counted]
    steps = 12
    for t in range(steps):
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=g,
                            dtype=torch.int32)
        want, cc = ttf.serve_step(cpu, cc, {"token": tok, "pos": pos},
                                  kv_quant=kv_quant)
        got, gc = ttf.serve_step(card, gc, {"token": tok.to(dev),
                                            "pos": pos.to(dev)},
                                 kv_quant=kv_quant)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        pos = pos + 1
    made = [f.launches - b for f, b in zip(counted, before)]
    L = cfg.num_layers
    if arch == "rwkv6-3b":
        assert made == [0, 0, 0, 0]
    elif arch == "zamba2-2.7b":
        assert made == [steps * ttf.zamba2_groups(cfg)[0], 0, 0, 0]
    elif arch == "minicpm3-4b":
        assert made == [0, 0, steps * L, 0]
    elif kv_quant:
        assert made == [steps * L // 2, steps * L // 2, 0, 0]
    else:
        assert made == [steps * L, 0, 0, 0]


# -- zamba2's shared attention: kernel 4 at Dh = 80 ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,pos,window", [
    (128, [127, 96, 40, 0], 0),          # zamba2's serve bucket, ragged
    (1000, [999, 500, 63, 64], 300),     # a window across split boundaries
    (8192, [8191, 6143, 4999, 4095], 0)])  # the long context
def test_flash_decode_dh80_matches_plain(dtype, S, pos, window):
    """zamba2's shape (B 4, KVH 32, G 1, Dh 80: rows spread over 16 bf16
    or 32 fp32 lanes, the lanes past 80 idle) against the plain version
    within atol=rtol=2e-3 (fp32 sums in another order), one grid a
    call."""
    dev = _card()
    case = _dense(4, S, 32, 1, 80, pos, 80, dtype)
    want = tref.flash_decode_ref(*case, window)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(*(t.to(dev) for t in case), window=window)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_dh_outside_the_kernels_is_refused_on_the_card():
    """On a CUDA tensor the wrappers launch or raise: Dh = 48 is refused
    by every decode wrapper, and Dh = 80 by all but the dense bf16/fp32
    kernel (the int8 and paged kernels are not built for it); no plain
    version runs and nothing is counted."""
    dev = _card()
    counted = (tfd.flash_decode, tfd.flash_decode_quant, tfd.flash_decode_paged)
    before = [f.launches for f in counted]
    for Dh in (48, 80):
        q, k, v, pos = (t.to(dev) for t in _dense(2, 64, 2, 1, Dh, [63, 5],
                                                  7, torch.bfloat16))
        if Dh == 48:
            with pytest.raises(ValueError, match="Dh"):
                tfd.flash_decode(q, k, v, pos)
        ki, vi = k.to(torch.int8), v.to(torch.int8)
        sc = torch.ones(k.shape[:3], dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="Dh"):
            tfd.flash_decode_quant(q, ki, vi, sc, sc, pos)
        bt = torch.arange(2 * 4, dtype=torch.int32, device=dev).reshape(2, 4)
        with pytest.raises(ValueError, match="Dh"):
            tfd.flash_decode_paged(q, k.reshape(8, 16, 2, Dh),
                                   v.reshape(8, 16, 2, Dh), bt, pos + 1)
    assert [f.launches for f in counted] == before


@pytest.fixture
def nccl_world_of_one(tmp_path):
    """A default process group of one rank over NCCL (file:// store in a
    temporary directory), destroyed after the test."""
    _card()
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1, device_id=dev)
    yield dev
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-1b"])
def test_dp_step_over_one_nccl_rank_equals_the_train_step(nccl_world_of_one,
                                                          arch):
    """make_manual_dp_train_step over an NCCL world of 1 (an average over
    one rank is the identity) against make_train_step with the same
    arguments, 3 steps each from one seed's reduced bf16 weights: every
    parameter and moment equal to the bit, the losses equal."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.training import (OptConfig, init_training,
                                      make_manual_dp_train_step,
                                      make_train_step)
    dev = nccl_world_of_one
    cfg = get_arch(arch).reduced()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
        cfg, DataConfig(global_batch=4, seq_len=32, seed=3)).next_batch().items()}
    runs = []
    for dp in (False, True):
        model, state = init_training(cfg, opt, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        step = (make_manual_dp_train_step(cfg, opt, attn_chunk=16) if dp
                else make_train_step(cfg, opt, attn_chunk=16))
        losses = []
        for _ in range(3):
            if dp:
                model, state, _, m = step(model, state, {}, batch)
            else:
                model, state, m = step(model, state, batch)
            losses.append(m["loss"].item())
        runs.append((dict(model.named_parameters()), state, losses))
    (pa, sa, la), (pb, sb, lb) = runs
    assert la == lb
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(sa["m"][n], sb["m"][n]), n
        assert torch.equal(sa["v"][n], sb["v"][n]), n


@pytest.mark.cuda
def test_sharded_search_over_one_nccl_rank_equals_kernel_3(nccl_world_of_one):
    """sharded_device_search at W = 1 on the card: kernel 3 once (counted)
    and the merge of its own k candidates, the same ids and bits as
    ivf_topk alone."""
    from repro_torch.core.hybrid_search import page_shard, sharded_device_search
    dev = nccl_world_of_one
    rng = np.random.default_rng(12)
    pages = torch.from_numpy(rng.standard_normal((64, 128, 768)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ids = torch.arange(64 * 128, dtype=torch.int32, device=dev).reshape(64, 128)
    mask = torch.from_numpy(rng.random(64) < 0.7).to(dev)
    q = torch.from_numpy(rng.standard_normal((4, 768)).astype(np.float32)).to(dev)
    assert page_shard(64) == slice(0, 64)
    want_s, want_i = tivf.ivf_topk(pages, ids, mask, q, 3)
    before = tivf.ivf_topk.launches
    s, i = sharded_device_search(q, pages, ids, mask, k=3)
    torch.cuda.synchronize()
    assert tivf.ivf_topk.launches == before + 1
    assert torch.equal(i, want_i) and torch.equal(s, want_s)


@pytest.mark.cuda
def test_meta_branches_leave_the_card_results_bit_for_bit():
    """flash_decode, flash_decode_quant and mla_decode on the card, then
    on meta tensors under an ``op_cost`` counter (no launch, no count
    moved), then on the card again: the same bits as the call before
    the meta trace."""
    dev = _card()
    from repro_torch.kernels import mla_decode as tmla
    from repro_torch.launch import op_cost
    from repro_torch.models.attention import quantize_heads
    g = torch.Generator(device=dev).manual_seed(29)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    q = r(4, 16, 2, 128).bfloat16()
    k, v = r(4, 300, 16, 128).bfloat16(), r(4, 300, 16, 128).bfloat16()
    pos = torch.tensor([299, 128, 40, 0], dtype=torch.int32, device=dev)
    kq, ks = quantize_heads(k)
    vq, vs = quantize_heads(v)
    lat = (r(4, 40, 256), r(4, 40, 32), r(4, 300, 256).bfloat16(),
           r(4, 300, 32).bfloat16(), pos, 0.1)
    cases = [(tfd.flash_decode, (q, k, v, pos), {"softcap": 50.0}),
             (tfd.flash_decode_quant, (q, kq, vq, ks, vs, pos), {}),
             (tmla.mla_decode, lat, {})]
    for fn, args, kw in cases:
        before = fn(*args, **kw).clone()
        n = fn.launches
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        c = op_cost.op_cost(lambda *a: fn(*a, **kw), *meta)
        assert c["flops"] > 0 and fn.launches == n
        after = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        assert torch.equal(after, before), fn.__name__
