"""The retrieval kernels' work plan and arithmetic (``csrc/page_topk.cuh``,
``csrc/probe_topk.cu``), mirrored in plain PyTorch on the CPU.

The CUDA kernels run only on a card (``test_torch_cuda.py``).  Here
test-local mirrors of what they compute are held against the port's
plain versions and the JAX package's kernels in interpret mode:

* the page search: the live pages (some query of the pass admits them),
  cut into units of ``rows`` rows, each block's contiguous range of the
  live units (``_unit_ranges``) or any other partition in any order,
  each block with a running top-k per query keyed by (score desc, flat
  position ``page * ps + row`` asc), then the merge of the blocks' lists;
* the probe's threshold: the nprobe-th largest valid key by a radix
  select with 8-bit digits, against the closed form.

Tolerances as ``test_torch_kernels.py``: ids equal; scores within 1e-5
for fp32 pages and 2e-2 for bf16 (the JAX kernel rounds otherwise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import page_topk
from repro_torch.kernels import ref as tref

VALID_FLOOR = -1.0e29    # probe scores above this came from a valid centroid


def _unit_ranges(n_live, nch, blocks):
    """Each block's live units [u0, u1), as search_kernel splits a
    window's n_live live pages of nch units each."""
    U = n_live * nch
    return [(U * b // blocks, U * (b + 1) // blocks) for b in range(blocks)]


def _dots(q, rows):
    """q [B, d] . rows [n, d] in fp32, one row at a time the same way, so
    duplicated rows give bit-equal scores wherever they sit."""
    return (q[:, None, :] * rows.float()[None]).sum(-1)


def _better(a, b):
    """(score, ordinal) a ranks before b: score desc, ordinal asc."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _insert(lst, k, s, o):
    """The kernel's insert: keep the k best (score, ordinal), sorted."""
    if len(lst) == k and not _better((s, o), lst[-1]):
        return
    i = len(lst)
    while i > 0 and _better((s, o), lst[i - 1]):
        i -= 1
    lst.insert(i, (s, o))
    del lst[k:]


def _mirror_search(q, pages, ids, adm, k, rows, blocks, *, qpass=8,
                   window=page_topk.WINDOW, shuffle=None):
    """search_kernel's arithmetic in plain PyTorch: q [B, d] fp32, pages
    [P, ps, d], ids [P, ps], adm [B, P] bool (query b may search page p).
    Queries go in passes of ``qpass``; pages in windows of ``window``;
    a window's live units are split into ``blocks`` contiguous ranges
    in live order, or, with ``shuffle`` (a numpy Generator), dealt to
    the blocks at random and walked in a random order.  Returns
    (scores [B, k] fp32, ids [B, k] int32), (-inf, -1) where empty."""
    B, d = q.shape
    P, ps = ids.shape
    nch = -(-ps // rows)
    lists = [[[] for _ in range(B)] for _ in range(blocks)]
    for b0 in range(0, B, qpass):
        qs = range(b0, min(B, b0 + qpass))
        for w0 in range(0, P, window):
            live = [p for p in range(w0, min(P, w0 + window))
                    if adm[list(qs), p].any()]
            units = [(p, c) for p in live for c in range(nch)]
            if shuffle is None:
                parts = [units[u0:u1] for u0, u1 in
                         _unit_ranges(len(live), nch, blocks)]
            else:
                owner = shuffle.integers(0, blocks, len(units))
                parts = [[units[i] for i in shuffle.permutation(len(units))
                          if owner[i] == blk] for blk in range(blocks)]
            for blk, part in enumerate(parts):
                for p, c in part:
                    r0, r1 = c * rows, min(ps, (c + 1) * rows)
                    s = _dots(q, pages[p, r0:r1])              # [B, n]
                    for b in qs:
                        if not adm[b, p]:
                            continue
                        for r in range(r0, r1):
                            if ids[p, r] >= 0:
                                _insert(lists[blk][b], k,
                                        float(s[b, r - r0]), p * ps + r)
    out_s = torch.full((B, k), float("-inf"))
    out_i = torch.full((B, k), -1, dtype=torch.int32)
    flat = ids.reshape(-1)
    for b in range(B):
        merged = []
        for blk in range(blocks):
            for s, o in lists[blk][b]:
                _insert(merged, k, s, o)
        for j, (s, o) in enumerate(merged):
            out_s[b, j], out_i[b, j] = s, int(flat[o])
    return out_s, out_i


def _stable_topk(pages, ids, adm, q, k):
    """Top-k by (score desc, flat position asc) over every admitted row
    with id >= 0: the order the Pallas kernels break ties in."""
    P, ps, d = pages.shape
    s = _dots(q, pages.reshape(P * ps, d))
    ok = adm.repeat_interleave(ps, dim=1) & (ids.reshape(-1) >= 0)[None]
    s = s.masked_fill(~ok, float("-inf"))
    top_s, top_p = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_p = top_s[:, :k], top_p[:, :k]
    top_i = torch.where(torch.isfinite(top_s), ids.reshape(-1)[top_p], -1)
    return top_s, top_i.to(torch.int32)


def _search_inputs(B, P, ps, d, seed, *, ties=False, dead=0.3,
                   empty_query=True):
    """Gaussian pages and queries with unique ids; a per-query page mask
    admitting about 40% of pages, a share ``dead`` of pages that no query
    admits, query 0 admitting nothing (``empty_query``), a padded page
    tail; with ``ties``, rows duplicated across pages and
    within a page, so exact score ties decide the order."""
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    if ties:
        pages[P - 1] = pages[0]                       # across pages
        pages[P // 2] = pages[1]
        if ps > 1:
            pages[1, ps - 1] = pages[1, 0]            # within a page
    ids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    ids[2 % P, ps // 2:] = -1
    q = rng.standard_normal((B, d)).astype(np.float32)
    mask = rng.random((B, P)) < 0.4
    mask[:, rng.random(P) < dead] = False
    if ties:
        mask[:, [0, 1, P // 2, P - 1]] = True
    if empty_query and B > 1:
        mask[0] = False
    return pages, ids, mask, q


# (B, P, ps, d, k, rows, blocks, dtype, extra): rows and blocks as a
# card's plan could pick them; extra switches input features
_SEARCH_CASES = [
    (4, 12, 7, 60, 5, 3, 5, "float32", {}),                   # d 60, ps 7
    (5, 9, 48, 30, 4, 16, 4, "float32", {}),                  # ps 48, d 30
    (1, 10, 2, 64, 3, 2, 7, "bfloat16", {"empty_query": False}),   # ps 2
    (9, 8, 8, 32, 6, 3, 3, "float32", {}),                    # B 9: 2 passes
    (4, 10, 8, 32, 4, 4, 6, "float32", {"ties": True}),       # exact ties
    (3, 10, 8, 64, 5, 8, 4, "bfloat16", {"ties": True}),
    (3, 6, 4, 32, 14, 2, 5, "float32", {"dead": 0.5, "short": True}),
    (5, 16, 16, 128, 3, 16, 132, "bfloat16", {"dead": 0.9}),  # most pages dead
]


@pytest.mark.parametrize("partition", ["plan", "shuffled"])
@pytest.mark.parametrize("B,P,ps,d,k,rows,blocks,dtype,extra", _SEARCH_CASES)
def test_search_mirror_matches_refs(B, P, ps, d, k, rows, blocks, dtype,
                                    extra, partition):
    """Any partition of the live (page, row-chunk) units into blocks, in
    any order, with a running top-k per block and a merge, gives the plain
    version's ids on tie-free data and the JAX kernel's (interpret mode)
    ids always, ties across and within pages, -1 padding, dead pages, a
    query with no page and k beyond the live rows included."""
    extra = dict(extra)
    short = extra.pop("short", False)        # k beyond a query's live rows
    pages, ids, mask, q = _search_inputs(B, P, ps, d, B * 100 + P * ps + d,
                                         **extra)
    tdt = getattr(torch, dtype)
    tp, ti, tm, tq = (torch.from_numpy(pages).to(tdt), torch.from_numpy(ids),
                      torch.from_numpy(mask), torch.from_numpy(q))
    shuffle = None if partition == "plan" else np.random.default_rng(P + k)
    gs, gi = _mirror_search(tq, tp, ti, tm, k, rows, blocks, shuffle=shuffle)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ws, wi = jops.ivf_topk(jnp.asarray(pages, jdt), jnp.asarray(ids),
                           jnp.asarray(mask), jnp.asarray(q), k,
                           tile=max(ps * 2, 64), mode="kernel_interpret")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-5)
    ss, si = _stable_topk(tp, ti, tm, tq, k)
    np.testing.assert_array_equal(gi.numpy(), si.numpy())
    if not extra.get("ties"):
        rs, ri = tref.ivf_topk_ref(tp, ti, tm, tq, k)
        np.testing.assert_array_equal(gi.numpy(), ri.numpy())
        torch.testing.assert_close(gs, rs, rtol=1e-5, atol=1e-5)
    if extra.get("empty_query", True) and B > 1:
        assert (gi[0] == -1).all() and torch.isinf(gs[0]).all()
    if short:
        assert (((gi >= 0).sum(1) > 0) & (gi[:, -1] == -1)).any()


def test_search_mirror_windows_and_passes():
    """Windows of pages smaller than the pool and passes of fewer queries
    than B (what a pool beyond kWindow pages or B > kMaxPass take) give
    the same result as one window and one pass."""
    pages, ids, mask, q = _search_inputs(7, 13, 5, 32, 11)
    args = [torch.from_numpy(a) for a in (q, pages, ids, mask)]
    one = _mirror_search(*args, 4, 2, 3)
    many = _mirror_search(*args, 4, 2, 3, qpass=3, window=4)
    assert torch.equal(one[1], many[1]) and torch.equal(one[0], many[0])


@pytest.mark.parametrize("B,P,ps,d,k,aligned,live", [
    (4, 4438, 128, 768, 3, True, 0.216),     # chip_smoke's fused serve
    (4, 4438, 128, 768, 3, True, 0.583),     # its unfused serve
    (9, 40, 7, 60, 8, True, 0.5),            # d 60: the direct path
    (3, 30, 48, 128, 40, False, 1.0),        # unaligned slab: direct
    (2, 5, 2, 2048, 1, True, 0.4),           # d beyond the register slices
])
def test_plan_splits_live_units_evenly(B, P, ps, d, k, aligned, live):
    """``page_topk.plan`` on a 132-SM card: shared memory within the
    limit, a unit within STAGE_BYTES, the staged path exactly where the
    kernel takes it; and the blocks' ranges cover every live row once,
    each block within one unit of the others."""
    rows, stages, qpass, blocks = page_topk.plan(B, P, ps, d, k, 132, aligned)
    assert page_topk.smem_bytes(rows, stages, qpass, d, k) \
        <= page_topk.SMEM_LIMIT
    assert 1 <= rows <= min(ps, page_topk.MAX_ROWS)
    assert rows * d * 2 <= page_topk.STAGE_BYTES or rows == 1
    assert (stages > 0) == (aligned and d % 8 == 0 and d <= 1024)
    assert 1 <= qpass <= min(B, page_topk.MAX_PASS)
    nch = -(-ps // rows)
    assert 1 <= blocks <= min(132, P * nch)
    rng = np.random.default_rng(P)
    livep = np.flatnonzero(rng.random(P) < live)
    ranges = _unit_ranges(len(livep), nch, blocks)
    sizes = [u1 - u0 for u0, u1 in ranges]
    assert max(sizes) - min(sizes) <= 1
    seen = np.zeros((P, ps), int)
    for u0, u1 in ranges:
        for u in range(u0, u1):
            p, c = livep[u // nch], u % nch
            seen[p, c * rows:min(ps, (c + 1) * rows)] += 1
    want = np.zeros((P, ps), int)
    want[livep] = 1
    np.testing.assert_array_equal(seen, want)


def _order_key(s):
    """The kernels' order-preserving map of fp32 onto uint32."""
    u = np.asarray(s, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _select_key(s, nprobe):
    """probe_kernel's select_key: the nprobe-th largest valid key of row
    s by four 8-bit-digit histogram passes; 0 when fewer are valid."""
    valid = s > VALID_FLOOR
    keys = _order_key(s)
    prefix, high, need = 0, 0, nprobe
    for shift in (24, 16, 8, 0):
        sel = valid & ((keys & high) == prefix)
        hist = np.bincount(((keys[sel] >> shift) & 255).astype(np.int64),
                           minlength=256)
        suf = np.cumsum(hist[::-1])[::-1]      # keys with digit >= D
        if suf[0] < need:
            return 0
        digit = int(np.flatnonzero(suf >= need)[-1])
        need -= int(suf[digit + 1]) if digit < 255 else 0
        prefix |= digit << shift
        high |= 255 << shift
    return prefix


def _admit_mirror(scores, valid, nprobe):
    """probe_kernel's admitted mask from masked scores [B, Nc]."""
    s = np.where(valid[None, :], scores, np.float32(-1.0e30))
    return np.stack([(row > VALID_FLOOR) & (_order_key(row) >= _select_key(
        row, nprobe)) for row in s])


def _closed_form(scores, valid, nprobe):
    out = np.zeros(scores.shape, bool)
    for b, row in enumerate(scores):
        v = row[valid]
        cut = np.sort(v)[::-1][nprobe - 1] if len(v) >= nprobe else -np.inf
        out[b] = valid & (row >= cut)
    return out


def _centroid_scores(q, cents):
    """q . c row by row (identical centroids give identical scores)."""
    return (torch.from_numpy(q)[:, None, :] * torch.from_numpy(cents)[None]
            ).sum(-1).numpy()


@pytest.mark.parametrize("B,Nc,d,nprobe,invalid,tied", [
    (4, 1024, 64, 64, 0.0, False),      # the serve's Nc and nprobe
    (3, 50, 16, 7, 0.2, False),
    (3, 60, 16, 9, 0.1, True),          # duplicated centroids at the cut
    (2, 30, 8, 40, 0.1, False),         # nprobe beyond the valid count
    (2, 30, 8, 27, 0.1, False),         # nprobe at the valid count
    (2, 40, 8, 5, 0.0, "all"),          # every score of a row tied
])
def test_threshold_select_mirror(B, Nc, d, nprobe, invalid, tied):
    """The 8-bit radix select admits exactly the valid clusters scoring at
    least the nprobe-th largest valid score (all tied ones; every valid
    one when fewer than nprobe are valid)."""
    rng = np.random.default_rng(Nc + nprobe)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    if tied == "all":
        cents[:] = cents[0]
    valid = rng.random(Nc) >= invalid
    if tied is True:
        for b in range(B):
            row = _centroid_scores(q[b:b + 1], cents)[0]
            order = np.argsort(-np.where(valid, row, -np.inf), kind="stable")
            cents[order[nprobe]] = cents[order[nprobe - 1]]
            valid[order[nprobe]] = True
    s = _centroid_scores(q, cents)
    got = _admit_mirror(s, valid, nprobe)
    np.testing.assert_array_equal(got, _closed_form(s, valid, nprobe))
    if tied is True:
        assert (got.sum(1) > nprobe).any()     # a tie admitted beyond nprobe


def test_tied_centroids_follow_jax_fused_kernel():
    """With two centroids tied at a query's nprobe-th score, the mirror's
    admission (both) and search give the JAX fused kernel's ids in
    interpret mode, which admits every tied cluster too; a row of the
    second tied cluster's page is the query's best, so admitting one of
    the two would change the ids."""
    rng = np.random.default_rng(5)
    B, Nc, d, P, ps, nprobe, k = 2, 16, 32, 12, 8, 4, 3
    q = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    valid = np.ones(Nc, bool)
    order = np.argsort(-_centroid_scores(q[:1], cents)[0], kind="stable")
    keep, twin = int(order[nprobe - 1]), int(order[nprobe])
    cents[twin] = cents[keep]
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    ids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    pc = rng.integers(0, Nc, P).astype(np.int32)
    pc[3], pc[7] = keep, twin
    pages[7, 2] = 4.0 * q[0]
    s = _centroid_scores(q, cents)
    adm_c = _admit_mirror(s, valid, nprobe)
    assert adm_c[0, keep] and adm_c[0, twin]
    adm = torch.from_numpy(adm_c[:, pc])                     # [B, P]
    gs, gi = _mirror_search(torch.from_numpy(q), torch.from_numpy(pages),
                            torch.from_numpy(ids), adm, k, 3, 4)
    ws, wi = jops.probe_and_topk(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(pages),
        jnp.asarray(ids), jnp.asarray(pc), nprobe=nprobe, k=k,
        valid=jnp.asarray(valid), cent_tile=8, page_tile=2,
        mode="kernel_interpret")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    assert gi[0, 0] == ids[7, 2]
