"""The PyTorch port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held
against the reference's Pallas kernels (interpret mode) and jnp oracles
on the same numpy inputs, at rtol=atol=1e-5 in fp32 (the two frameworks
sum in other orders).  ``test_torch_cuda.py`` holds the hand-written CUDA
kernels against these plain versions on a card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import centroid_probe as tcp
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ivf_topk as tivf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import probe_topk as tpt
from repro_torch.kernels import ref as tref


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


@pytest.mark.parametrize("B,KVH,G,Dh,ps,MB,window", [
    (3, 2, 4, 32, 16, 5, 0),
    (3, 2, 4, 32, 16, 5, 20),
    (1, 1, 8, 64, 8, 3, 0),      # MQA
    (2, 4, 1, 64, 32, 2, 10),
    (3, 2, 1, 32, 2, 5, 3),      # page size 2, sliding window
])
@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_flash_decode_paged_plain_matches_jax(B, KVH, G, Dh, ps, MB, window,
                                               mode):
    q, kp, vp, bt, lens = _paged_inputs(B, KVH, G, Dh, ps, MB,
                                        B * 100 + ps + window)
    want = jops.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(bt),
                                   jnp.asarray(lens), window=window, mode=mode)
    got = tops.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp), torch.from_numpy(bt),
                                  torch.from_numpy(lens), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _retrieval_inputs(B, d, Nc, P, ps, seed):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    pids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    pids[0, ps // 2:] = -1                               # padded page tail
    pc = rng.integers(-1, Nc, P).astype(np.int32)        # -1 = unsearchable
    valid = rng.random(Nc) > 0.1
    return qs, cents, valid, pages, pids, pc


@pytest.mark.parametrize("B,d,Nc,P,ps,nprobe,k", [
    (4, 64, 24, 18, 8, 7, 5),
    (1, 32, 16, 6, 16, 3, 4),
    (6, 128, 32, 24, 4, 16, 8),
    (2, 60, 20, 9, 8, 40, 3),    # nprobe beyond Nc: every valid cluster
])
@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_probe_and_topk_plain_matches_jax(B, d, Nc, P, ps, nprobe, k, mode):
    """Tie-free gaussian inputs: equal ids, scores within 1e-5."""
    qs, cents, valid, pages, pids, pc = _retrieval_inputs(B, d, Nc, P, ps,
                                                          B * 31 + Nc)
    ws, wi = jops.probe_and_topk(
        jnp.asarray(qs), jnp.asarray(cents), jnp.asarray(pages),
        jnp.asarray(pids), jnp.asarray(pc), nprobe=nprobe, k=k,
        valid=jnp.asarray(valid), cent_tile=8, page_tile=2, mode=mode)
    gs, gi = tops.probe_and_topk(
        torch.from_numpy(qs), torch.from_numpy(cents), torch.from_numpy(pages),
        torch.from_numpy(pids), torch.from_numpy(pc), nprobe=nprobe, k=k,
        valid=torch.from_numpy(valid))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


def _ivf_inputs(P, ps, d, B, seed, shared_mask):
    """Tie-free gaussian pages and queries, unique ids with a padded page
    tail, a page mask admitting about 70% of pages; query 0 admits no
    page when the mask is per query."""
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    ids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    ids[1, ps // 2:] = -1                                # padded page tail
    q = rng.standard_normal((B, d)).astype(np.float32)
    if shared_mask:
        mask = rng.random(P) > 0.3
    else:
        mask = rng.random((B, P)) > 0.3
        mask[0] = False                                  # nothing admitted
    return pages, ids, mask, q


_IVF_SHAPES = [(12, 64, 128, 3, 5), (4, 32, 96, 1, 3), (16, 128, 256, 8, 16),
               (7, 16, 64, 2, 4),
               (18, 8, 60, 3, 5)]        # odd widths: no 16-byte rows


@pytest.mark.parametrize("P,ps,d,B,k,shared_mask", [
    (*shape, shared) for shape in _IVF_SHAPES for shared in (False, True)
    if not (shared and shape[3] == 1)])     # one query: 1-d is per-query
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_topk_plain_matches_jax_kernel(P, ps, d, B, k, shared_mask,
                                           dtype):
    """Port ``ops.ivf_topk`` on the CPU against the reference's Pallas
    kernel in interpret mode: ids equal, scores within 1e-5 (fp32 pages)
    or 2e-2 (bf16 pages, as tests/test_kernels.py), (-inf, -1) where a
    query admits fewer than k vectors."""
    pages, ids, mask, q = _ivf_inputs(P, ps, d, B, P * 1000 + B + d,
                                      shared_mask)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ws, wi = jops.ivf_topk(jnp.asarray(pages, jdt), jnp.asarray(ids),
                           jnp.asarray(mask), jnp.asarray(q), k,
                           tile=max(ps * 2, 64), mode="kernel_interpret")
    tdt = getattr(torch, dtype)
    gs, gi = tops.ivf_topk(torch.from_numpy(pages).to(tdt),
                           torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(q), k)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    assert gs.shape == gi.shape == (B, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-5)
    if not shared_mask:
        assert (gi[0] == -1).all() and torch.isinf(gs[0]).all()


@pytest.mark.parametrize("B,S,KVH,G,Dh,window", [
    (2, 24, 2, 4, 32, 0), (3, 16, 1, 2, 64, 5)])
def test_dense_flash_decode_ref_matches_jax(B, S, KVH, G, Dh, window):
    from repro.kernels import ref as jref
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    pos = rng.integers(0, S, B).astype(np.int32)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), window)
    got = tref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(pos), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


_DENSE_CASES = [(2, 256, 4, 3, 64, 0, None), (2, 256, 4, 3, 64, 50, None),
                (1, 128, 1, 8, 32, 0, None),              # MQA
                (3, 64, 2, 1, 128, 16, None),             # G=1, window
                (3, 100, 2, 1, 32, 9, [99, 50, 0]),       # S=100, pos 0
                (2, 77, 2, 3, 128, 0, [0, 76])]           # S=77, pos 0


@pytest.mark.parametrize("B,S,KVH,G,Dh,window,pos", _DENSE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax_kernel(B, S, KVH, G, Dh, window, pos,
                                               dtype):
    """Port ``ops.flash_decode`` on the CPU against the reference's Pallas
    kernel in interpret mode, on tests/test_kernels.py's shapes and
    tolerances: 1e-4 in fp32, 3e-2 in bf16 (inputs rounded to bf16 alike
    on both sides; the sums run in fp32 in other orders); and at S a
    multiple of no tile (the reference then runs one tile of S) with a
    row at ``pos = 0``."""
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, KVH, G, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)))
    pos = (rng.integers(1, S, B) if pos is None else np.array(pos)
           ).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jops.flash_decode(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             jnp.asarray(pos), window=window, tile=64,
                             mode="kernel_interpret")
    tdt = getattr(torch, dtype)
    got = tops.flash_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                            torch.from_numpy(pos), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_flash_decode_plain_matches_model_decode_attention():
    """The port's kernel semantics == the reference's jnp decode attention
    that its dense serve_step runs (tests/test_kernels.py's case), 1e-4."""
    from repro.models.attention import _decode_attention
    rng = np.random.default_rng(7)
    B, S, KVH, G, Dh = 2, 128, 4, 2, 64
    q = rng.standard_normal((B, 1, KVH, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    pos = np.array([60, 127], np.int32)
    want = _decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos=jnp.asarray(pos), window=None,
                             softcap_val=None, chunk=S)
    got = tops.flash_decode(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,S,sms", [(32, 128, 132), (32, 8192, 132),
                                        (1, 100, 132), (64, 1, 132),
                                        (3, 65, 8), (4096, 4096, 132),
                                        (0, 128, 132)])
def test_dense_kernel_splits_cover_the_cache(rows, S, sms):
    """The dense kernel's split of S: whole 64-position chunks, every
    position covered, no split wholly past S, and no more blocks than
    about four per SM unless one split per row already exceeds that."""
    split, nsplit = tfd._splits(rows, S, sms)
    assert split % 64 == 0 and nsplit >= 1
    assert (nsplit - 1) * split < S <= nsplit * split
    assert nsplit == 1 or rows * (nsplit - 1) < 4 * sms


def _live_range(S, window, *, pos=None, length=None):
    """Positions [lo, hi) a row attends to, as the CUDA kernels compute
    them (csrc/flash_decode.cu, csrc/flash_decode_paged.cu):
    the dense row at ``pos`` (``kp <= pos``) over S cache positions, or
    the paged row of ``length`` tokens (``kp < length``, clamped to the
    S = MB * ps table positions); ``window`` > 0 keeps the last
    ``window``."""
    if length is None:
        hi = min(pos + 1, S)
        return (max(0, pos + 1 - window) if window > 0 else 0), hi
    hi = min(max(length, 0), S)
    return (max(0, hi - window) if window > 0 else 0), hi


def _split_plan(lo, hi, split, nsplit):
    """For each of the ``nsplit`` split blocks of a row with live
    positions [lo, hi): the positions [s0, s1) it reads, or None where the
    block returns at once, as csrc/decode_attn.cuh ``decode_block``
    decides."""
    if hi <= lo:
        return [None] * nsplit
    first, last = lo // split, (hi - 1) // split
    return [(max(lo, sp * split), min(hi, (sp + 1) * split))
            if first <= sp <= last else None for sp in range(nsplit)]


# (layout, rows, S, sms, per-row pos (dense) or length (paged), window):
# S is the dense cache's or the table's MB * ps positions
_PLAN_CASES = [
    ("dense", 32, 128, 132, [127, 96, 40, 0], 0),         # the serve bucket
    ("dense", 8, 1000, 132, [999, 500, 64, 63], 700),     # window across splits
    ("dense", 2, 4096, 8, [4095, 10], 100),
    ("paged", 32, 8192, 132, [8192, 6144, 5000, 4096], 0),   # long table
    ("paged", 8, 8192, 132, [1, 300, 64, 0], 0),          # later splits empty
    ("paged", 4, 1000, 132, [1000, 999, 65, 1], 129),     # 8 * 125 positions
    ("paged", 3, 240, 132, [240, 7, 64], 16),             # ps 48 * 5 pages
]


@pytest.mark.parametrize("layout,rows,S,sms,at,window", _PLAN_CASES)
def test_split_plan_reads_each_live_position_once(layout, rows, S, sms, at,
                                                  window):
    """Both kernels' split plan: every position the plain version attends
    to (``kp <= pos`` or ``kp < length``, inside the window) falls in
    exactly one split block; no block reads another position; and the
    blocks that return at once are exactly the splits with no live
    position."""
    split, nsplit = tfd._splits(rows, S, sms)
    kp = np.arange(S)
    for x in at:
        if layout == "dense":
            lo, hi = _live_range(S, window, pos=x)
            live = kp <= x
            if window > 0:
                live &= kp > x - window
        else:
            lo, hi = _live_range(S, window, length=x)
            live = kp < x
            if window > 0:
                live &= kp >= x - window
        plan = _split_plan(lo, hi, split, nsplit)
        assert len(plan) == nsplit
        seen = np.zeros(S, int)
        for sp, rng in enumerate(plan):
            in_split = live[sp * split:(sp + 1) * split]
            if rng is None:
                assert not in_split.any()
                continue
            s0, s1 = rng
            assert sp * split <= s0 < s1 <= (sp + 1) * split
            seen[s0:s1] += 1
        np.testing.assert_array_equal(seen, live.astype(int))


def _split_combine(q, k, v, ranges, split, nsplit, follow_plan):
    """The kernels' arithmetic in plain PyTorch, one row at a time: q
    [B, KVH, G, Dh], k/v [B, T, KVH, Dh] (the block table gathered for
    the paged layout), ``ranges`` each row's live [lo, hi).  Each split
    folds 64-position chunks into an unnormalised (m, l, acc) with the
    scale applied after the dot, then the splits combine to one maximum.
    ``follow_plan``: only the positions ``_split_plan`` gives each block,
    chunks from its first live position, skipped blocks left out (as the
    kernels do); else every split walks all its positions with the dead
    ones at -inf, so splits and chunks that are all -inf enter the
    combine."""
    B, T, KVH, Dh = k.shape
    G = q.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    out = torch.zeros((B, KVH, G, Dh))
    for b, (lo, hi) in enumerate(ranges):
        kp = torch.arange(T)
        live = (kp >= lo) & (kp < hi)
        plan = _split_plan(lo, hi, split, nsplit)
        parts = []
        for sp in range(nsplit):
            if follow_plan and plan[sp] is None:
                continue
            s0, s1 = plan[sp] if follow_plan else (sp * split,
                                                   min(T, (sp + 1) * split))
            m = torch.full((KVH, G), -math.inf)
            l, acc = torch.zeros((KVH, G)), torch.zeros((KVH, G, Dh))
            for c0 in range(s0, s1, 64):
                c = slice(c0, min(c0 + 64, s1))
                s = torch.einsum("hgd,shd->hgs", q[b], k[b, c]) * scale
                s = s.masked_fill(~live[c], -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                dead = torch.isinf(m_new)[..., None]
                p = torch.where(dead, 0.0, torch.exp(s - m_new[..., None]))
                corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_new))
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("hgs,shd->hgd", p,
                                                           v[b, c])
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.where(torch.isinf(m), 0.0, torch.exp(m - mx))
             for m, _, _ in parts]
        l = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
        o = sum(pa * wi[..., None] for (_, _, pa), wi in zip(parts, w))
        out[b] = o / l.clamp(min=1e-20)[..., None]
    return out


@pytest.mark.parametrize("rows_sms,S,window,pos", [
    (132, 300, 0, [299, 130, 5]),
    (132, 1000, 150, [999, 600, 70]),       # window across split boundaries
    (1, 256, 0, [255, 0, 64]),              # one split a row
])
@pytest.mark.parametrize("follow_plan", [True, False],
                         ids=["plan", "all_splits"])
def test_dense_split_combine_matches_refs(rows_sms, S, window, pos,
                                          follow_plan):
    """The dense kernel's split-then-combine arithmetic (``_split_combine``
    over ``_splits``) equals ``flash_decode_ref`` and the JAX oracle on
    the same numpy inputs, fp32, atol=rtol=1e-5."""
    from repro.kernels import ref as jref
    B, KVH, G, Dh = len(pos), 2, 3, 32
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, KVH, G, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)))
    p = np.array(pos, np.int32)
    split, nsplit = tfd._splits(B * KVH, S, rows_sms)
    got = _split_combine(*map(torch.from_numpy, (q, k, v)),
                         [_live_range(S, window, pos=x) for x in pos],
                         split, nsplit, follow_plan)
    want = tref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, p)), window)
    jwant = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, p)), window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ps,MB,lengths,window", [
    (16, 64, [1024, 1, 300], 0),            # later splits empty, length 1
    (48, 6, [288, 100, 47], 0),             # ps does not divide 64
    (7, 40, [280, 150, 9], 90),             # window across splits
])
@pytest.mark.parametrize("follow_plan", [True, False],
                         ids=["plan", "all_splits"])
def test_paged_split_combine_matches_refs(ps, MB, lengths, window,
                                          follow_plan):
    """The paged kernel's split-then-combine arithmetic over the MB * ps
    table positions (-1 tails read as page 0) equals
    ``flash_decode_paged_ref`` and the JAX oracle, fp32,
    atol=rtol=1e-5."""
    from repro.kernels import ref as jref
    B, KVH, G, Dh = len(lengths), 2, 2, 32
    rng = np.random.default_rng(ps * MB + window)
    NP = B * MB + 3
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    kp, vp = (rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // ps):] = -1
    lens = np.array(lengths, np.int32)
    T = MB * ps
    split, nsplit = tfd._splits(B * KVH, T, 132)
    gather = np.maximum(bt, 0)
    k, v = (x[gather].reshape(B, T, KVH, Dh) for x in (kp, vp))
    got = _split_combine(*map(torch.from_numpy, (q, k, v)),
                         [_live_range(T, window, length=n)
                          for n in lengths], split, nsplit, follow_plan)
    args = (q, kp, vp, bt, lens)
    want = tref.flash_decode_paged_ref(*map(torch.from_numpy, args), window)
    jwant = jref.flash_decode_paged_ref(*map(jnp.asarray, args), window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Nc,d,B,nprobe", [
    (128, 128, 3, 16),
    (100, 30, 4, 10),           # Nc not a multiple of 32, d of 4
    (72, 768, 2, 5),            # the serve width
])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid"])
def test_centroid_probe_plain_matches_jax(Nc, d, B, nprobe, masked):
    """Port ``ops.centroid_probe`` on the CPU against the reference's
    ``ops.centroid_probe`` (its Pallas ``centroid_scores`` kernel in
    interpret mode, then ``lax.top_k``) and its ``centroid_probe_ref``.
    Tie-free gaussian data with nprobe below the valid count
    (``torch.topk`` and ``lax.top_k`` order ties differently): ids equal,
    scores within rtol=1e-5 as tests/test_kernels.py (fp32 dots summed in
    another order)."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(Nc + d + masked)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    valid = rng.random(Nc) > 0.2 if masked else np.ones(Nc, bool)
    assert valid.sum() > nprobe
    ws, wi = jops.centroid_probe(jnp.asarray(cents), jnp.asarray(q), nprobe,
                                 valid=jnp.asarray(valid),
                                 mode="kernel_interpret")
    gs, gi = tops.centroid_probe(torch.from_numpy(cents), torch.from_numpy(q),
                                 nprobe, valid=torch.from_numpy(valid)
                                 if masked else None)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    want = jref.centroid_probe_ref(jnp.asarray(cents), jnp.asarray(q),
                                   jnp.asarray(valid))
    full = tcp.centroid_scores(torch.from_numpy(q), torch.from_numpy(cents),
                               torch.from_numpy(valid))
    assert full.shape == (B, Nc) and full.dtype == torch.float32
    assert torch.isinf(full[:, ~torch.from_numpy(valid)]).all()
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    q, kp, vp, bt, lens = _paged_inputs(2, 2, 2, 32, 4, 3, 0)
    before = (tfd.flash_decode_paged.launches, tpt.probe_topk_fused.launches,
              tivf.ivf_topk.launches, tfd.flash_decode.launches,
              tcp.centroid_scores.launches)
    tops.flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, bt, lens)))
    tops.flash_decode(torch.from_numpy(q), torch.from_numpy(kp[:2]),
                      torch.from_numpy(vp[:2]), torch.from_numpy(lens))
    qs, cents, valid, pages, pids, pc = _retrieval_inputs(2, 16, 8, 4, 4, 0)
    tops.probe_and_topk(*map(torch.from_numpy, (qs, cents, pages, pids, pc)),
                        nprobe=3, k=2, valid=torch.from_numpy(valid))
    tops.ivf_topk(torch.from_numpy(pages), torch.from_numpy(pids),
                  torch.ones(4, dtype=torch.bool), torch.from_numpy(qs), 2)
    tops.centroid_probe(torch.from_numpy(cents), torch.from_numpy(qs), 3,
                        valid=torch.from_numpy(valid))
    assert (tfd.flash_decode_paged.launches, tpt.probe_topk_fused.launches,
            tivf.ivf_topk.launches, tfd.flash_decode.launches,
            tcp.centroid_scores.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    """Dispatch goes by device alone: a tensor on neither the CPU nor a
    card is refused, never quietly computed by the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.flash_decode_paged(
            torch.empty((1, 1, 1, 32), **meta), torch.empty((2, 4, 1, 32), **meta),
            torch.empty((2, 4, 1, 32), **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.flash_decode(
            torch.empty((1, 1, 1, 32), **meta), torch.empty((1, 8, 1, 32), **meta),
            torch.empty((1, 8, 1, 32), **meta),
            torch.empty((1,), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpt.probe_topk_fused(
            torch.empty((1, 8), **meta), torch.empty((4, 8), **meta),
            torch.empty((4,), dtype=torch.bool, **meta),
            torch.empty((2, 4, 8), **meta),
            torch.empty((2, 4), dtype=torch.int32, **meta),
            torch.empty((2,), dtype=torch.int32, **meta), nprobe=1, k=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tivf.ivf_topk(
            torch.empty((2, 4, 8), **meta),
            torch.empty((2, 4), dtype=torch.int32, **meta),
            torch.empty((1, 2), dtype=torch.bool, **meta),
            torch.empty((1, 8), **meta), 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.centroid_probe(torch.empty((4, 8), **meta),
                            torch.empty((1, 8), **meta), 2)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        tops.flash_decode_paged(torch.zeros(1, 2, 1, 32), torch.zeros(3, 4, 1, 32),
                                torch.zeros(3, 4, 1, 32),
                                torch.zeros(1, 2, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))
    pos = torch.zeros(2, dtype=torch.int32)
    for k in (torch.zeros(2, 5, 3, 32),          # KVH is 2, not 3
              torch.zeros(3, 5, 2, 32),          # B is 2, not 3
              torch.zeros(2, 0, 2, 32)):         # an empty cache
        with pytest.raises(ValueError):
            tops.flash_decode(torch.zeros(2, 2, 1, 32), k, k, pos)
    with pytest.raises(ValueError):              # pos [B] wanted
        tops.flash_decode(torch.zeros(2, 2, 1, 32), torch.zeros(2, 5, 2, 32),
                          torch.zeros(2, 5, 2, 32), pos[:1])
    with pytest.raises(ValueError):                  # d differs
        tops.centroid_probe(torch.zeros(4, 6), torch.zeros(1, 8), 2)
    with pytest.raises(ValueError):                  # valid is [Nc]
        tops.centroid_probe(torch.zeros(4, 8), torch.zeros(1, 8), 2,
                            valid=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):                  # valid is a mask
        tops.centroid_probe(torch.zeros(4, 8), torch.zeros(1, 8), 2,
                            valid=torch.ones(4))
    with pytest.raises(ValueError):
        tops.probe_and_topk(torch.zeros(1, 8), torch.zeros(4, 6),
                            torch.zeros(2, 4, 8),
                            torch.zeros(2, 4, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), nprobe=1, k=1)
    pages, ids, q = (torch.zeros(3, 4, 8), torch.zeros(3, 4, dtype=torch.int32),
                     torch.zeros(2, 8))
    for mask in (torch.ones(2, 4, dtype=torch.bool),      # P is 3, not 4
                 torch.ones(3, 3, dtype=torch.bool),      # B is 2, not 3
                 torch.ones(2, 3)):                       # not a mask dtype
        with pytest.raises(ValueError):
            tops.ivf_topk(pages, ids, mask, q, 1)
    with pytest.raises(ValueError):
        tops.ivf_topk(pages, ids, torch.ones(3, dtype=torch.bool), q, 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError):
        _build.nvcc_path()


def test_build_command_targets_sm90a_from_repo_sources():
    lib = _build.library_path("flash_decode_paged")
    assert lib.parent == _build.BUILD_DIR
    assert sorted(_build.SOURCES) == sorted(p.stem for p in
                                            _build.CSRC.glob("*.cu"))
    for name in _build.SOURCES:
        assert _build.library_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    with pytest.raises(_build.KernelBuildError):
        _build.library_path("no_such_kernel")


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A kernel source includes ``csrc/*.cuh``: editing a header must
    name a new library, so a stale build is never loaded."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("ivf_topk")
    header = tmp_path / "page_topk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("ivf_topk") != before
