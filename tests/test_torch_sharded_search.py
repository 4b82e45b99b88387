"""The port's datastore-sharded search (``sharded_device_search``, paper
§7) over 1, 2 and 4 gloo ranks against the reference's over as many CPU
devices, and against the reference's whole-slab oracle
(``repro.kernels.ref.ivf_topk_ref``).

One reference child (JAX with 4 host devices) and one spawn of 4 ranks
for the file, at once.  Each rank searches its ``page_shard`` of a bf16
slab (ids with -1 padding, a page mask) with ``ops.ivf_topk`` (its plain
version on the CPU) and merges the all-gathered candidates.  Cases: a
tie-free slab; ties across shards (pages copied into another shard under
other ids, the queries among their vectors; W = 2 and 4, where the
copies lie in two shards), which the merge must order as ``lax.top_k``
does, lower position first; and a mask that leaves
fewer than k vectors, all in one shard (the rest pads with -inf and -1).
The ids equal the reference's exactly, the scores within 1e-5, on every
rank.  ``page_shard`` refuses a page count the ranks do not divide, and
the search a [B, P] mask.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ivf_topk_ref  # noqa: E402

import torch_dist_ranks  # noqa: E402
import torch_dist_reference  # noqa: E402

P, PS, D, B, K = 48, 8, 32, 5, 4
WORLDS = (1, 2, 4)
CASES = ("tie_free", "cross_ties", "sparse")


def _case(case, rng):
    pages = rng.standard_normal((P, PS, D)).astype(np.float32)
    ids = np.arange(P * PS, dtype=np.int32).reshape(P, PS) + 1000
    ids[rng.random((P, PS)) < 0.1] = -1
    mask = rng.random(P) < 0.8
    queries = rng.standard_normal((B, D)).astype(np.float32)
    if case == "cross_ties":
        # pages 0-11 again as pages 24-35: another shard at W = 2 and 4
        pages[24:36] = pages[0:12]
        ids[0:12] = np.arange(12 * PS).reshape(12, PS) + 1000
        ids[24:36] = ids[0:12] + 100_000
        mask[0:12] = mask[24:36] = True
        queries = 3.0 * pages[[0, 3, 5, 7, 11], [1, 2, 3, 4, 5]]
    elif case == "sparse":
        mask[:] = False
        mask[30] = True
        ids[30] = np.arange(PS) + 7
        ids[30, 2:] = -1
    pages = torch.from_numpy(pages).bfloat16().float().numpy()
    return {f"{case}/pages": pages, f"{case}/page_ids": ids,
            f"{case}/page_mask": mask, f"{case}/queries": queries}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("search")
    rng = np.random.default_rng(21)
    arrays = {}
    for case in CASES:
        arrays.update(_case(case, rng))
    meta = {"cases": CASES, "worlds": WORLDS, "world": 4, "k": K}
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    ref = torch_dist_reference.start("search", d / "in.npz", d / "ref.npz")
    ranks = torch_dist_ranks.run("search", 4, d / "in.npz", d)
    return arrays, torch_dist_reference.wait(ref), ranks


# ties within one shard are the local search's to order (the plain
# version's torch.topk leaves them unspecified, ROADMAP queue 3): the
# cross-shard ties run where the copies lie in two shards
@pytest.mark.parametrize("case,W", [(c, W) for c in CASES for W in WORLDS
                                    if c != "cross_ties" or W > 1])
def test_sharded_search_matches_reference(runs, case, W):
    arrays, ref, ranks = runs
    want_s, want_i = ref[f"{case}/{W}/scores"], ref[f"{case}/{W}/ids"]
    oracle_s, oracle_i = ivf_topk_ref(
        jnp.asarray(arrays[f"{case}/pages"]).astype(jnp.bfloat16),
        jnp.asarray(arrays[f"{case}/page_ids"]),
        jnp.asarray(arrays[f"{case}/page_mask"]),
        jnp.asarray(arrays[f"{case}/queries"]), K)
    np.testing.assert_array_equal(want_i, np.asarray(oracle_i))
    for r in range(W):
        got_s, got_i = ranks[r][f"{case}/{W}/scores"], ranks[r][f"{case}/{W}/ids"]
        assert got_s.dtype == np.float32 and got_i.dtype == np.int32
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_s, np.asarray(oracle_s), rtol=0,
                                   atol=1e-5)
    if case == "cross_ties":      # each query's top two: its vector, twice
        assert np.all(want_s[:, 0] == want_s[:, 1])
        assert np.all(want_i[:, 1] == want_i[:, 0] + 100_000)
    if case == "sparse":
        assert (np.sort(want_i[:, :2], axis=1) == [7, 8]).all()
        assert (want_i[:, 2:] == -1).all()
        assert np.isinf(want_s[:, 2:]).all()


@pytest.mark.parametrize("W", WORLDS)
def test_page_count_and_mask_refused(runs, W):
    _, _, ranks = runs
    for r in range(W):
        assert bool(ranks[r][f"refused/{W}/pages"]) == (W > 1)
        assert bool(ranks[r][f"refused/{W}/mask"])
