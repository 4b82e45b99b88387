"""Kernel 5 (``centroid_scores``): its plain version against the JAX
package's Pallas kernel, and its launch plan, on the CPU.

* **Parity**: the port's ``centroid_scores`` on CPU tensors (the plain
  version) against the reference's Pallas ``centroid_scores`` in interpret
  mode at the paper's scale, Nc = 4096 centroids in tiles of 512, with a
  fifth of them masked, for B = 1 to 33 queries: scores within
  rtol=atol=1e-5 (fp32 dots summed in another order), -inf where masked,
  and the same top-64 set of ids (gaussian data; two scores inside the
  set may be near enough for the two summation orders to swap them).
* **The plan** ``_plan``: every centroid row lies in exactly one
  (block, warp, row) slot of the kernel's contiguous row shares, and no
  block is empty or takes more than 8 warps x 2 rows; every SM of an
  H100 has one block at Nc = 1024 and two at 4096; the staged queries
  fit 48 KB; the row
  segments cover d; 16-byte loads only where d % 4 == 0 and both
  pointers are aligned; and the kernel's group loop (exact groups of 8,
  4, 2 and 1, each at most the plan's group) takes every query of a
  staged chunk once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.centroid_probe import centroid_scores as jcentroid_scores
from repro_torch.kernels import centroid_probe as tcp

H100_SMS = 132


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 9, 16, 33])
def test_centroid_plain_matches_pallas_kernel_at_paper_scale(B):
    Nc, d = 4096, 48
    rng = np.random.default_rng(B)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    valid = rng.random(Nc) > 0.2
    want = np.asarray(jcentroid_scores(jnp.asarray(q), jnp.asarray(cents),
                                       jnp.asarray(valid), tile=512,
                                       interpret=True))
    got = tcp.centroid_scores(torch.from_numpy(q), torch.from_numpy(cents),
                              torch.from_numpy(valid))
    assert got.shape == (B, Nc) and got.dtype == torch.float32
    assert torch.isneginf(got[:, ~torch.from_numpy(valid)]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the top-64 sets (two scores inside them may be near enough to swap)
    np.testing.assert_array_equal(
        np.sort(torch.topk(got, 64, dim=-1).indices.numpy(), axis=-1),
        np.sort(np.argsort(-want, axis=-1, kind="stable")[:, :64], axis=-1))


def _groups(nq, group):
    """The kernel's group loop over nq staged queries: groups of ``group``
    while they fit, then one each of 4, 2 and 1 below it where they fit."""
    out, g = [], 0
    while g + group <= nq:
        out.append(group)
        g += group
    for size in (4, 2, 1):
        if size < group and g + size <= nq:
            out.append(size)
            g += size
    return out


@pytest.mark.parametrize("B,d,Nc,aligned", [
    (4, 768, 1024, True),          # the serve probe
    (4, 768, 4096, True),          # the paper's scale
    (33, 770, 1000, True),         # 4-byte loads: d % 4
    (4, 768, 1024, False),         # 4-byte loads: a pointer off 16 bytes
    (1, 12_288, 300, True),        # twelve row segments
    (5, 30, 203, True),
    (7, 768, 1, True),
    (900, 64, 7, True),            # queries staged in turns
])
def test_centroid_plan_covers_every_row_and_query_once(B, d, Nc, aligned):
    p = tcp._plan(B, d, Nc, H100_SMS, aligned)
    assert p.vec == (aligned and d % 4 == 0)
    assert p.seg == 32 * tcp._SLICES * (4 if p.vec else 1)
    assert 1 <= p.warps <= 8 and p.group in (1, 2, 4, 8)
    assert p.group <= B < 2 * p.group or p.group == 8
    assert 1 <= p.qb <= B and p.qb * p.seg * 4 <= tcp._QUERY_BYTES
    assert -(-d // p.seg) * p.seg >= d
    rows = []
    for blk in range(p.blocks):                  # the kernel's row shares
        lo, hi = blk * Nc // p.blocks, (blk + 1) * Nc // p.blocks
        rpw = -(-(hi - lo) // p.warps)
        assert 1 <= rpw <= tcp._ROWS                 # no empty block
        rows += [lo + w * rpw + r for w in range(p.warps)
                 for r in range(rpw) if lo + w * rpw + r < hi]
    assert sorted(rows) == list(range(Nc))
    for q0 in range(0, B, p.qb):
        nq = min(p.qb, B - q0)
        sizes = _groups(nq, p.group)
        assert sum(sizes) == nq and all(s <= p.group for s in sizes)


@pytest.mark.parametrize("Nc", [1024, 4096])
def test_centroid_plan_gives_every_sm_rows(Nc):
    p = tcp._plan(4, 768, Nc, H100_SMS, True)
    assert p.blocks % H100_SMS == 0 and p.vec and p.group == 4
    assert p.warps == 8 and p.blocks == (132 if Nc == 1024 else 264)
