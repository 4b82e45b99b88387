"""The port's ``distributed/`` package against the reference's, on the CPU.

* ``spec_for`` against the reference's on meshes made as
  ``tests/test_distributed.py`` makes them, Hypothesis over axes, shapes,
  meshes and the four rule sets; ``param_axes`` / ``cache_axes`` and
  ``param_shardings`` / ``cache_shardings`` against the reference's for
  the 11 reduced archs (``kv_quant`` off and on), leaf by mapped leaf.
* On 4 gloo ranks (one spawn for the file): every reduced arch's
  parameters and caches on a (2, 2) ``("data", "model")`` mesh under
  ``RULES_DEFAULT`` and a (2, 2) ``("pod", "data")`` mesh under
  ``RULES_FSDP``, where ``embed`` spans both axes data-major: each
  rank's block (``sharding.local_block``, and ``distribute_tensor`` where
  ``placements`` takes the spec) is the block the reference's spec puts
  at that rank's mesh position (computed from the spec: the reference's
  fake mesh of one repeated CPU device has no ``devices_indices_map``),
  and ``placements`` refuses exactly the specs whose multi-axis entry
  DTensor would split pod-major.
* ``compressed_all_reduce`` over 1, 2 and 4 gloo ranks against the
  reference's ``compressed_psum`` under ``jax.jit(jax.vmap(...,
  axis_name=...))`` (its psum and pmax over W "ranks" on one device):
  the averaged gradients and the new error feedback equal to the bit,
  and the same bits in pieces of 7 elements.
* ``quantize_int8`` / ``dequantize_int8`` to the bit; the fault-tolerance
  classes on the same inputs as the reference's, Hypothesis over
  ``elastic_slices`` as ``tests/test_property.py`` does.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro.distributed as jdist  # noqa: E402
from repro.configs import get_arch as jget_arch, list_archs  # noqa: E402
from repro.launch.mesh import _axis_type_kwargs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

import torch_dist_ranks  # noqa: E402

PATHS = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}
RULE_SETS = ("RULES_DEFAULT", "RULES_LONG_CONTEXT", "RULES_FSDP",
             "RULES_FSDP_LONG")
MESHES = [((2, 2), ("data", "model")), ((2, 2), ("pod", "data")),
          ((2, 2, 2), ("pod", "data", "model")), ((1,), ("data",)),
          ((4,), ("model",)), ((2, 4), ("data", "model")),
          ((3, 2), ("model", "pod"))]
# the 4-rank meshes: (shape, axis names, rule set)
RANK_MESHES = {"default": ((2, 2), ("data", "model"), "RULES_DEFAULT"),
               "fsdp": ((2, 2), ("pod", "data"), "RULES_FSDP")}
# the compressed all-reduce's leaves: an fp32 matrix, bf16 stacked
# weights, a large-valued row, and a leaf of zeros with zero residuals
CAR_DTYPES = {"a": "float32", "b": "bfloat16", "big": "float32",
              "z": "float32"}
CAR_SHAPES = {"a": (37, 5), "b": (3, 4, 6), "big": (11,), "z": (8,)}
WORLDS = (1, 2, 4)


def fake_mesh(shape, axes):
    """tests/test_distributed.py's abstract mesh over repeated devices."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * (n // len(jax.devices()) + 1))[:n]
    return Mesh(devs.reshape(shape), axes, **_axis_type_kwargs(len(axes)))


def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's spec tuple."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in p)


def _json_spec(spec) -> list:
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


# --- specs -----------------------------------------------------------------

LOGICAL = sorted(jdist.RULES_DEFAULT) + [None, "unknown"]


@given(mesh_i=st.integers(0, len(MESHES) - 1),
       rules=st.sampled_from(RULE_SETS),
       dims=st.lists(st.tuples(st.sampled_from(LOGICAL),
                               st.sampled_from([0, 1, 2, 3, 4, 6, 8, 12, 16])),
                     min_size=0, max_size=6))
@settings(max_examples=300, deadline=None)
def test_spec_for_matches_reference(mesh_i, rules, dims):
    shape, names = MESHES[mesh_i]
    axes = tuple(a for a, _ in dims)
    dims_ = tuple(d for _, d in dims)
    want = jdist.spec_for(axes, dims_, fake_mesh(shape, names),
                          getattr(jdist, rules))
    got = tsh.spec_for(axes, dims_, tsh.MeshAxes(names, shape),
                       getattr(tsh, rules))
    assert got == _spec(want)


def test_rule_sets_and_small_specs_match_reference():
    for name in RULE_SETS:
        assert getattr(tsh, name) == getattr(jdist, name)
    for shape, names in MESHES:
        mesh, port = fake_mesh(shape, names), tsh.MeshAxes(names, shape)
        assert tsh.replicated(port) == _spec(jdist.replicated(mesh).spec)
        for name in RULE_SETS:
            rules = getattr(tsh, name)
            assert tsh.data_sharding(port, rules=rules) == _spec(
                jdist.data_sharding(mesh, rules=getattr(jdist, name)).spec)


def _jax_leaf(tree, name):
    for key in PATHS[name]:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", list_archs())
def test_axes_and_shardings_match_reference(arch):
    """Every parameter's and cache tensor's axes, and its spec on every
    mesh under every rule set, equal the reference's at the leaf the
    port's name maps to (caches with kv_quant off and on)."""
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    jaxes = jtf.param_axes(jc)
    taxes = ttf.param_axes(tc)
    n_leaves = len(jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple)))
    assert n_leaves == len(taxes)
    for name, ax in taxes.items():
        assert _jax_leaf(jaxes, name) == ax, name
    for kq in (False, True):
        assert ttf.cache_axes(tc, kq) == jtf.cache_axes(jc, kq)
    cache_shape = {kq: jax.eval_shape(lambda kq=kq: jtf.init_cache(
        jc, 4, 16, kv_quant=kq)) for kq in (False, True)}
    for shape, names in MESHES[:3]:
        mesh, port = fake_mesh(shape, names), tsh.MeshAxes(names, shape)
        for rname in RULE_SETS:
            jr, tr = getattr(jdist, rname), getattr(tsh, rname)
            want = jdist.param_shardings(jc, mesh, jr)
            got = tsh.param_shardings(tc, port, tr)
            for name, spec in got.items():
                assert spec == _spec(_jax_leaf(want, name).spec), (rname, name)
            got = tsh.cache_shardings(tc, port, 4, 16, tr)
            want = jdist.cache_shardings(jc, mesh, 4, 16, jr)
            assert got == {n: _spec(s.spec) for n, s in want.items()}
            got = tsh.tree_shardings(ttf.cache_axes(tc, True), {
                n: s for n, (s, _) in ttf.cache_shapes(
                    tc, 4, 16, kv_quant=True).items()}, port, tr)
            want = jdist.tree_shardings(jtf.cache_axes(jc, True),
                                        cache_shape[True], mesh, jr)
            assert got == {n: _spec(s.spec) for n, s in want.items()}


# --- the 4-rank run --------------------------------------------------------


def _car_inputs():
    """Each world's per-rank gradients (bf16-exact where the leaf is bf16)
    and error feedback, seeded."""
    rng = np.random.default_rng(11)
    arrays = {}
    for W in WORLDS:
        for r in range(W):
            for n, shape in CAR_SHAPES.items():
                g = rng.standard_normal(shape).astype(np.float32)
                e = 0.01 * rng.standard_normal(shape).astype(np.float32)
                if n == "big":
                    g *= 1e4
                if n == "z":
                    g[:] = 0
                    e[:] = 0
                if CAR_DTYPES[n] == "bfloat16":
                    g = torch.from_numpy(g).bfloat16().float().numpy()
                arrays[f"car/{W}/{r}/g/{n}"] = g
                arrays[f"car/{W}/{r}/e/{n}"] = e
    return arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks for the file's multi-rank cases."""
    d = tmp_path_factory.mktemp("dist")
    meta = {"worlds": list(WORLDS), "dtypes": CAR_DTYPES,
            "meshes": {k: [list(s), list(n), r]
                       for k, (s, n, r) in RANK_MESHES.items()}}
    arrays = _car_inputs()
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    return arrays, torch_dist_ranks.run("distributed", 4, d / "in.npz", d)


def _reference_car(arrays, W):
    """The reference's compressed_psum over W ranks, as jax.vmap runs it."""
    def stacked(kind, n):
        return jnp.asarray(np.stack([arrays[f"car/{W}/{r}/{kind}/{n}"]
                                     for r in range(W)]))
    grads = {n: stacked("g", n).astype(jnp.dtype(dt))
             for n, dt in CAR_DTYPES.items()}
    err = {n: stacked("e", n) for n in CAR_DTYPES}
    fn = jax.jit(jax.vmap(lambda g, e: jdist.compressed_psum(g, e, "r"),
                          axis_name="r"))
    g_hat, e_new = fn(grads, err)
    return ({n: np.asarray(v) for n, v in g_hat.items()},
            {n: np.asarray(v) for n, v in e_new.items()})


@pytest.mark.parametrize("W", WORLDS)
def test_compressed_all_reduce_matches_reference_bits(ranks, W):
    arrays, results = ranks
    want_g, want_e = _reference_car(arrays, W)
    for r in range(W):
        for pieces in (0, 7):
            for n in CAR_DTYPES:
                g = results[r][f"car/{W}/{pieces}/g/{n}"]
                e = results[r][f"car/{W}/{pieces}/e/{n}"]
                assert g.dtype == e.dtype == np.float32
                np.testing.assert_array_equal(g, want_g[n][r], err_msg=n)
                np.testing.assert_array_equal(e, want_e[n][r], err_msg=n)
    assert not np.any(want_e["z"]) and not np.any(want_g["z"])


def _expected_block(spec, shape, names, sizes, coord):
    """[start, shape] of the block the reference's spec puts at mesh
    position ``coord``: a dim over several axes splits with the entry's
    first axis major (JAX's PartitionSpec)."""
    at = dict(zip(names, coord))
    size = dict(zip(names, sizes))
    start, extent = [0] * len(shape), list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        if not axes:
            continue
        block, n = 0, 1
        for a in axes:
            block, n = block * size[a] + at[a], n * size[a]
        extent[d] = shape[d] // n
        start[d] = block * extent[d]
    return [start, extent]


def _pod_major_only(spec, names, sizes):
    """Whether an entry of spec splits over several axes above 1 in
    another order than the mesh's (DTensor cannot place it)."""
    size = dict(zip(names, sizes))
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            split = [a for a in entry if size[a] > 1]
            if split != sorted(split, key=list(names).index):
                return True
    return False


@pytest.mark.parametrize("mesh_name", sorted(RANK_MESHES))
def test_each_rank_holds_the_reference_block(ranks, mesh_name):
    _, results = ranks
    sizes, names, rname = RANK_MESHES[mesh_name]
    mesh = fake_mesh(sizes, names)
    rules = getattr(jdist, rname)
    blocks = [json.loads(str(r["blocks"])) for r in results]
    seen = refused = 0
    for arch in list_archs():
        jc = jget_arch(arch).reduced()
        want = {"params": {n: _jax_leaf(jdist.param_shardings(jc, mesh, rules), n)
                           for n in ttf.param_shapes(tget_arch(arch).reduced())}}
        for kq in (False, True):
            shapes = jax.eval_shape(lambda kq=kq: jtf.init_cache(
                jc, 4, 16, kv_quant=kq))
            want[f"cache{int(kq)}"] = jdist.tree_shardings(
                jtf.cache_axes(jc, kq), shapes, mesh, rules)
        shapes = {"params": ttf.param_shapes(tget_arch(arch).reduced())}
        for kq in (False, True):
            shapes[f"cache{int(kq)}"] = {
                n: s for n, (s, _) in ttf.cache_shapes(
                    tget_arch(arch).reduced(), 4, 16, kv_quant=kq).items()}
        for tname, specs in want.items():
            for n, sharding in specs.items():
                spec = _spec(sharding.spec)
                shape = shapes[tname][n]
                no_dtensor = _pod_major_only(spec, names, sizes)
                for r, rb in enumerate(blocks):
                    rec = rb[f"{mesh_name}/{arch}/{tname}/{n}"]
                    assert rec["spec"] == _json_spec(spec), (arch, tname, n)
                    exp = _expected_block(spec, shape, names, sizes,
                                          divmod(r, 2))
                    assert rec["local"] == exp, (arch, tname, n, r)
                    if no_dtensor:
                        assert rec["dtensor"] == "refused", (arch, n)
                    else:
                        assert rec["dtensor"] == exp, (arch, tname, n, r)
                seen += 1
                refused += no_dtensor
    assert seen > 200
    if mesh_name == "fsdp":        # embed=("data", "pod") on a (pod, data) mesh
        assert refused > 50, refused
    else:
        assert refused == 0


def test_placements_and_blocks_on_an_abstract_mesh():
    """placements on a 3-axis mesh: each axis of an entry shards its dim,
    the rest replicate; a (data, pod) entry is refused, and local_block
    splits it data-major."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = tsh.MeshAxes(("pod", "data", "model"), (2, 2, 2))
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="local_block"):
        tsh.placements((None, ("data", "pod")), mesh)
    # one of the two axes of size 1: no reordering to express
    assert tsh.placements((("model", "pod"),),
                          tsh.MeshAxes(("pod", "model"), (1, 4))) == [
        Shard(0), Shard(0)]
    got = [tsh.local_block((None, ("data", "pod")), (3, 8), mesh,
                           (p, d, 0))[1] for p in (0, 1) for d in (0, 1)]
    assert got == [slice(0, 2), slice(4, 6), slice(2, 4), slice(6, 8)]


# --- int8 and fault tolerance ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "zeros", "wide", "halves"])
def test_quantize_int8_matches_reference_bits(dtype, case):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(257).astype(np.float32)
    if case == "zeros":
        x[:] = 0
    elif case == "wide":
        x *= np.logspace(-6, 6, x.size).astype(np.float32)
    elif case == "halves":     # values on .5 steps of the scale: round to even
        x = (np.arange(-127, 128) + 0.5).astype(np.float32)
        x[-1] = 127.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tq, ts = tcomp.quantize_int8(tx)
    jq, js = jdist.quantize_int8(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jdist.dequantize_int8(jq, js)))


def test_error_feedback_and_ratio_match_reference():
    params = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": torch.zeros(5)}
    e = tcomp.init_error_feedback(params)
    assert all(t.dtype == torch.float32 and not t.any() for t in e.values())
    assert {n: tuple(t.shape) for n, t in e.items()} == {"w": (3, 4), "b": (5,)}
    assert tcomp.compression_ratio(params) == jdist.compression_ratio(params)


@given(st.integers(1, 64), st.integers(1, 16), st.integers(0, 1000))
@settings(max_examples=50, deadline=None)
def test_elastic_slices_match_reference(batch, nodes, step):
    healthy = list(range(nodes))
    assert tft.elastic_slices(step, healthy, batch) == jdist.elastic_slices(
        step, healthy, batch)
    assert tft.elastic_slices(step, list(reversed(healthy)), batch) == \
        tft.elastic_slices(step, healthy, batch)


def test_fault_tolerance_classes_match_reference():
    hb_t, hb_j = tft.HeartbeatMonitor(deadline_s=2.0), \
        jdist.HeartbeatMonitor(deadline_s=2.0)
    for hb in (hb_t, hb_j):
        hb.beat(0, now=0.0)
        hb.beat(1, now=1.5)
        hb.beat(2, now=3.0)
    for now in (1.0, 2.5, 3.6, 10.0):
        assert hb_t.dead([0, 1, 2, 3], now=now) == hb_j.dead([0, 1, 2, 3],
                                                            now=now)
    sp_t, sp_j = tft.StragglerPolicy(), jdist.StragglerPolicy()
    for durs, now in (({0: 1.0, 1: 2.0, 2: None}, 5.0),
                      ({0: 1.0, 1: 2.0, 2: None}, 7.0),
                      ({0: None, 1: None}, 100.0),
                      ({0: 0.1, 1: None, 2: 0.2, 3: None}, 1.5)):
        assert sp_t.stragglers(durs, now) == sp_j.stragglers(durs, now)
    run_t, run_j = tft.ElasticRun(global_batch=30), jdist.ElasticRun(
        global_batch=30)
    for step, healthy in ((0, {0, 1, 2, 3}), (3, {0, 1, 2, 3}),
                          (5, {0, 1, 3}), (9, {1}), (12, {0, 1, 2, 3, 4})):
        assert run_t.resize(step, healthy) == run_j.resize(step, healthy)
    assert run_t.history == run_j.history
    assert run_t.members == run_j.members
