"""The MLA kernel's work plan (``kernels/mla_decode.py`` ``_plan``,
``csrc/mla_decode.cu``), mirrored in Python on the CPU: which positions
and heads each block of the grid reads, as the kernel decides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mla_decode as tmla


def _blocks(S, H, pos, split, nsplit, tiles, bf16):
    """For each block (b, tile, sp) of the grid that does not return at
    once: the positions [s0, s1) it reads, its chunks' live counts and
    its heads, as ``mla_tc_kernel`` (bf16: 16 heads a tile, chunks of 64)
    or ``mla_kernel`` (fp32: every head, chunks of 32) computes them."""
    chunk = 64 if bf16 else 32
    out = []
    for b, p in enumerate(pos):
        hi = min(p + 1, S)
        last = (hi - 1) // split
        for tile in range(tiles):
            heads = range(16 * tile, min(H, 16 * tile + 16)) if bf16 else range(H)
            for sp in range(nsplit):
                if sp > last:
                    continue
                s0, s1 = sp * split, min(hi, sp * split + split)
                nchunks = -(-(s1 - s0) // chunk)
                live = [min(chunk, s1 - (s0 + c * chunk)) for c in range(nchunks)]
                out.append((b, tile, s0, s1, live, heads))
    return out


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,S,H,sms,pos", [
    (4, 128, 40, 132, [127, 96, 40, 0]),            # minicpm3's serve bucket
    (4, 8192, 40, 132, [8191, 6143, 4999, 0]),      # the long context
    (1, 1, 1, 132, [0]),
    (2, 33, 17, 132, [32, 7]),                      # a head past a tile
    (3, 100000, 64, 132, [99999, 64, 63]),          # more splits than fit
    (1, 70000, 16, 132, [69999]),
    (64, 4096, 4, 132, list(range(0, 4096, 64))),   # more rows than SMs
    (5, 300, 40, 8, [299, 0, 1, 64, 65]),
])
def test_mla_plan_covers_each_live_position_and_head_once(bf16, B, S, H, sms,
                                                          pos):
    """Every (row, head, position <= pos) the plain version attends to
    falls in exactly one block; no block reads past its row's live
    positions or S; every split is a whole number of chunks, every chunk
    a live first position (its softmax max is finite); the splits' combine
    weights fit the block; about two blocks an SM unless one split a row
    already exceeds that."""
    split, nsplit, tiles = tmla._plan(B, S, H, sms, bf16)
    chunk = 64 if bf16 else 32
    assert split % chunk == 0 and nsplit >= 1
    assert not bf16 or nsplit <= tmla._MAX_SPLITS
    assert (nsplit - 1) * split < S <= nsplit * split
    assert tiles == (-(-H // 16) if bf16 else 1)
    assert nsplit == 1 or B * tiles * (nsplit - 1) < 2 * sms
    seen = np.zeros((B, H, S), int)
    for b, tile, s0, s1, live, heads in _blocks(S, H, pos, split, nsplit,
                                                tiles, bf16):
        assert 0 <= s0 < s1 <= min(pos[b] + 1, S)
        assert live and all(n >= 1 for n in live) and sum(live) == s1 - s0
        seen[b, heads.start:heads.stop, s0:s1] += 1
    for b, p in enumerate(pos):
        want = np.zeros((H, S), int)
        want[:, :min(p + 1, S)] = 1
        assert np.array_equal(seen[b], want)
    # the combine's (m, l, weight): 3 x 16 floats a split in the bf16
    # kernel's work space (26,624 bytes at the reduced (R, Dr) = (32, 16),
    # the smaller)
    assert not bf16 or nsplit * 16 * 12 <= 26624


def test_mla_plan_spreads_the_serve_shape_over_heads():
    """At minicpm3's serve shape the bf16 plan splits the 40 heads into
    three tiles as well as the 128 positions into two splits: 24 blocks,
    where the fp32 plan (every head in a block) makes 16 of 32 positions."""
    assert tmla._plan(4, 128, 40, 132, True) == (64, 2, 3)
    assert tmla._plan(4, 8192, 40, 132, True) == (384, 22, 3)
    assert tmla._plan(4, 128, 40, 132, False) == (32, 4, 1)
