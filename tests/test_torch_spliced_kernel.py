"""The spliced-decode kernel's plain version and its Python plans, on the
CPU, against the JAX package's oracle and against first principles.

* **Long deltas**: ``flash_decode_spliced_ref`` (the plain version the
  wrapper runs on CPU tensors) against the reference's
  ``ref.flash_decode_spliced_ref`` on rows of 20- and 40-token chunks
  that reach layout offsets of 8160, the last chunk's delta set to 8191,
  at page sizes 16 and 48 and rope fractions 1.0, 0.5 and 0.25.  fp32
  pages within rtol=atol=1e-5 (the two frameworks' float32 cos/sin of
  the same float32 angle); bf16 pages within rtol=atol=1e-4, as
  ``tests/test_torch_chunk_kv.py`` holds them: where the two cos/sin
  differ in the last bit, the rotated K may round to the other bf16
  neighbour.
* **The partner plan** ``_splice_plan``: for every (Dh, page dtype, rot)
  the lane distance the kernel shuffles over maps each rotated dim to its
  rotate-half partner in the same element slot, every dim of a row
  lies in exactly one (lane, slot), and where the plan reads partners from
  shared memory no xor distance would have given the pairs; the angle
  table's runs fit its 256 pairs.
* **The chunk classification** ``spliced_chunks`` against a position-by-
  position count from the oracle's own mask (live = slot < page_valid,
  causal = position < length): each position below a row's length lies
  in one chunk, fresh chunks are exactly those with every position live
  at delta 0, and the runs are the rotated positions' runs of one delta.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref as tref
from tests.test_torch_cuda import _spliced_inputs

JORACLE = jax.jit(jref.flash_decode_spliced_ref,
                  static_argnames=("rope_fraction", "rope_theta"))


def _long_rows(ps):
    """(chunk token counts, fresh pages) of one row whose last chunk
    starts at layout offset 8160: 20-token chunks on two 16-token pages,
    or 40-token chunks on one 48-token page."""
    return ([20] * 256, 2) if ps == 16 else ([40] * 171, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("ps", [16, 48])
def test_spliced_plain_matches_oracle_at_long_deltas(ps, fraction, dtype):
    chunks, fresh = _long_rows(ps)
    q, kp, vp, bt, lens, delta, valid = _spliced_inputs(
        ps + int(fraction * 8), 2, 2, 2, 64, ps, [chunks, chunks[:40]], fresh)
    delta[delta == delta.max()] = 8191
    assert delta.max() == 8191 and (delta > 4000).sum() > 0
    kw = dict(rope_fraction=fraction, rope_theta=500_000.0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(JORACLE(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        *(jnp.asarray(x) for x in (bt, lens, delta, valid)), **kw))
    got = tfd.flash_decode_spliced(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt),
        *(torch.from_numpy(x) for x in (bt, lens, delta, valid)), **kw)
    assert got.dtype == torch.float32 and not torch.isnan(got).any()
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_splice_plan_pairs_each_rotated_dim_with_its_partner(Dh, kv_bf16):
    V = 8 if kv_bf16 else 4                 # dims a lane holds (16 bytes)
    lanes = Dh // V
    slots = {(sub, e): sub * V + e for sub in range(lanes) for e in range(V)}
    assert sorted(slots.values()) == list(range(Dh))   # every dim once
    shuffled = 0
    for rot in range(0, Dh + 1, 2):
        half = rot // 2
        dist, runs, fresh = tfd._splice_plan(Dh, kv_bf16, rot)
        assert fresh == 1
        assert (runs == 0) == (rot == 0) and runs * half <= tfd._TAB
        partner = {i: i + half if i < half else i - half for i in range(rot)}
        if dist:
            shuffled += 1
            assert dist & (dist - 1) == 0 and dist < lanes
            for (sub, e), i in slots.items():
                if i < rot:
                    assert slots[(sub ^ dist, e)] == partner[i]
        elif rot:
            # no xor distance between lanes gives the rotate-half pairs
            for cand in (1 << k for k in range(lanes.bit_length() - 1)):
                assert any(slots[(sub ^ cand, e)] != partner[i]
                           for (sub, e), i in slots.items() if i < rot)
    assert shuffled >= 2                    # rot = Dh and Dh/2 shuffle


def _brute_chunks(bt, lens, delta, valid, ps, rot):
    """Chunk modes and runs counted position by position."""
    B, MB = bt.shape
    C = -(-MB * ps // 64)
    mode = np.full((B, C), -1)
    runs = np.zeros((B, C), int)
    for b in range(B):
        n = min(int(lens[b]), MB * ps)
        for c in range(C):
            if 64 * c >= n:
                continue
            prev, live_all, any_rot = None, True, False
            for t in range(64 * c, min(64 * c + 64, n)):
                live = t % ps < valid[b, t // ps]
                d = int(delta[b, t // ps]) if live else 0
                rotated = live and d != 0 and rot > 0
                live_all &= bool(live)
                any_rot |= rotated
                if rotated and prev != d:
                    runs[b, c] += 1
                prev = d if rotated else None
            mode[b, c] = tfd.ROTATED if any_rot else (
                tfd.FRESH if live_all else tfd.MASKED)
    return mode, runs


@pytest.mark.parametrize("ps,rows,fresh,rot", [
    (16, [[21, 9, 40], [3], [17, 17], []], 8, 128),
    (16, [[20] * 20, [1] * 9, [64, 64], [5]], 3, 64),
    (48, [[50, 100], [7], [150]], 3, 64),
    (5, [[3, 12, 7], [1] * 30], 4, 32),
    (2, [[1, 2, 3] * 12, [3, 1] * 20], 4, 128),
    (16, [[21, 9, 40], [17, 17]], 3, 0),
])
def test_spliced_chunks_match_a_position_count(ps, rows, fresh, rot):
    q, kp, vp, bt, lens, delta, valid = _spliced_inputs(
        ps + rot, len(rows), 1, 1, 128, ps, rows, fresh)
    mode, runs = tfd.spliced_chunks(*(torch.from_numpy(x) for x in
                                      (bt, lens, delta, valid)), ps, rot)
    want_mode, want_runs = _brute_chunks(bt, lens, delta, valid, ps, rot)
    np.testing.assert_array_equal(mode.numpy(), want_mode)
    np.testing.assert_array_equal(runs.numpy(), np.where(
        want_mode == tfd.ROTATED, want_runs, 0))
    # every position below a row's length lies in exactly one taken chunk
    for b in range(len(rows)):
        taken = np.flatnonzero(want_mode[b] >= 0)
        assert taken.tolist() == list(range(-(-int(lens[b]) // 64)))
    if rot:
        assert (mode == tfd.ROTATED).any()


def test_fresh_chunks_are_where_the_oracle_masks_nothing_and_rotates_nothing():
    """A chunk the plan calls fresh is one the plain version treats as
    the unspliced paged decode does: rows whose every chunk is fresh give
    ``flash_decode_paged_ref``'s output, a row with a rotated chunk does
    not."""
    q, kp, vp, bt, lens, delta, valid = _spliced_inputs(
        7, 3, 2, 2, 64, 16, [[], [21, 9], []], 6)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens, delta, valid)]
    mode, _ = tfd.spliced_chunks(*args[3:], 16, 64)
    fresh_rows = [b for b in range(3) if (mode[b][mode[b] >= 0] == tfd.FRESH).all()]
    assert fresh_rows == [0, 2]
    got = tref.flash_decode_spliced_ref(*args)
    paged = tref.flash_decode_paged_ref(*args[:5])
    for b in fresh_rows:
        torch.testing.assert_close(got[b], paged[b], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got[1], paged[1], rtol=1e-3, atol=1e-3)
