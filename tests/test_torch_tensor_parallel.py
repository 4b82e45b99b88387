"""The port's tensor-parallel serve steps (``distributed/tensor_parallel``)
over 1, 2 and 4 gloo ranks against the reference, on reduced configs of
the seven GQA/MQA/MoE archs.

One spawn of 4 ranks (``torch_dist_ranks``' ``tp_serve``) runs each
case's ``serve_step``, ``serve_step_paged`` and ``prefill`` on four
("data", "model") meshes: (1, 1), (1, 2), (1, 4) and (2, 2), each rank's
model from ``shard_model`` of the case's numpy weights and its cache and
slab blocks from ``shard_cache``.  The reference runs in one child a
config (``torch_dist_reference``, 4 host devices, the archs' compiles in
parallel): every step unsharded, and ``serve_step`` and ``prefill``
jitted under ``param_shardings`` / ``cache_shardings`` on the (1, 4) and
(2, 2) meshes, so that GSPMD partitions them as its dry run does.

Each rank's outputs are held against the reference's: on (1, 1) and
(1, 2), and for the paged step everywhere (the reference runs it
unsharded), the unsharded step's; on (1, 4) and (2, 2) the partitioned
program's.  On (2, 2) a rank runs its ``data`` shard's rows, and an MoE
config routes them as the reference's global program does, its
dispatch groups the whole batch's (the selected experts all-gathered
over ``data`` where a group spans the shards); ``"c05"``, one capacity
slot an expert a decode step, drops other tokens where a shard's rows
are taken for a group.  The rank's logits are its batch rows, its cache
and slab the ``local_block`` of the reference's.  Tolerances: fp32 logits,
caches and slabs within 1e-5 of the largest value (the scale).  bf16 is
held to the reference's fp32 step at the same place, within the
distance of the reference's own bf16 step from it plus 3e-2 of the
scale (``tests/test_kernels.py``'s bf16 tolerance): the reference's
bf16 steps on these random 4-layer models lie up to 4.3% of the scale
from its fp32 ones (the paged step), and its partitioned bf16 program
1.7% from its unsharded one, so bf16 against bf16 at 3e-2 would hold
the port to the two programs' rounding noise.

The cases cover every layout ``spec_for`` gives the seven: heads and KV
heads split (llama3-8b, nemotron-4-15b, musicgen-large's codebooks),
MQA with its one KV head whole (granite-20b), KV heads whole while the
query heads split (internvl2-1b's 2 KV heads over 4 ranks), experts
split (granite-moe-3b, arctic-480b with its dense residual), experts
whole and their MLP split (6 experts over 4 ranks), a vocabulary that
does not divide (514 over 4 ranks).  With no ``tp`` the steps give the
bytes they gave before tensor parallelism existed
(``tests/data/tp_none_digests.json``).

Every fp32 case also runs ``serve_step(kv_quant=True)`` over an int8
cache (``shard_cache`` splits its bf16 scales as ``cache_axes`` does)
against the reference's, partitioned under the dry run's ``kv_quant``
cache shardings on (1, 4) and (2, 2).  The reference rounds the scaled
q and the probabilities to bf16 over its dequantized bf16 cache, where
the port's kernel keeps them fp32 (``tests/test_torch_gemma2.py``), so
the unsharded port's int8 logits lie up to 1.3% of their scale from the
reference's on these random caches (held within the bf16 tolerance,
3e-2); a rank's logits are held within 1e-5 of the scale beyond that
known gap (the port's unsharded step from the reference's unsharded
one, plus the reference's partitioned program from its unsharded
one).  The cache's int8 values and bf16 scales are held the same way:
layer 0's (the embeddings' K/V) within one int8 step and the bf16
tolerance of the reference's, the later layers' (whose inputs carry the
reference's bf16 rounding) within the same known gap plus that.  Each
rank is also held tight to the port's own unsharded int8 step on the
same rows and block: logits and bf16 scales within 1e-5 of the scale,
int8 values within one rounding step at no more than 1e-3 of the
elements (arctic-480b's V, summed in another order, rounds one element
of 8192 the other way).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks  # noqa: E402
import torch_dist_reference  # noqa: E402
import torch_tp_cases as cases  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheManager  # noqa: E402

pytest.importorskip("jax")

CASES = ([(a, "", "float32") for a in cases.ARCHS]
         + [(a, "", "bfloat16") for a in ("llama3-8b", "granite-20b",
                                          "internvl2-1b")]
         + [("llama3-8b", "v514", "float32"),
            ("granite-moe-3b-a800m", "e6", "float32"),
            ("granite-moe-3b-a800m", "c05", "float32")])
MESHES = [["1x1", [1, 1]], ["1x2", [1, 2]], ["1x4", [1, 4]], ["2x2", [2, 2]]]
STEPS = ("dense", "paged", "prefill")
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    arrays = {}
    for arch, tw, _ in CASES:
        cfg = cases.config(arch, tw)
        if f"w/{arch}{tw}/final_norm" in arrays:
            continue
        arrays.update({f"w/{arch}{tw}/{k}": v
                       for k, v in cases.weights(cfg).items()})
        arrays.update({f"in/{arch}{tw}/{k}": v
                       for k, v in cases.inputs(cfg).items()})
    meta = {"cases": CASES, "meshes": MESHES}
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    handle = torch_dist_reference.start("tp_serve", d / "in.npz", d / "ref.npz",
                                        parts=cases.ARCHS)
    ranks = torch_dist_ranks.run("tp_serve", WORLD, d / "in.npz", d,
                                 timeout=600.0)
    return torch_dist_reference.wait(handle, timeout=600.0), ranks


def _want(mname, data, cfg, key, step, rank):
    """Where the reference's output for ``rank`` is: (its key prefix, the
    rank's logits rows in it)."""
    m = dict(MESHES)[mname][1]
    dc = rank // m
    if step == "paged" or mname in ("1x1", "1x2"):
        base, rows = f"whole/{key}", slice(dc * cases.B // data,
                                           (dc + 1) * cases.B // data)
        if step == "paged":
            rows = slice(None)
    else:
        base, rows = f"{mname}/{key}", slice(dc * cases.B // data,
                                             (dc + 1) * cases.B // data)
    return base, rows


def _close(got, want, tol, what, floor=0.0):
    """max |got - want| within ``tol`` of want's largest value, plus
    ``floor``."""
    scale = float(np.abs(want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor, \
        f"{what}: {err:.3e} > {tol} x {scale:.3e} + {floor:.3e}"


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("mname,shape", MESHES)
@pytest.mark.parametrize("arch,tw,dname", CASES)
def test_tp_step_matches_reference(runs, arch, tw, dname, mname, shape, step):
    ref, ranks = runs
    data, m = shape
    cfg = cases.config(arch, tw)
    key = f"{arch}{tw}/{dname}"
    mesh = sh.MeshAxes(("data", "model"), (data, m))
    for r in range(data * m):
        base, rows = _want(mname, data, cfg, key, step, r)
        # bf16: against the reference's fp32 step at the same place, within
        # its own bf16 step's distance from it plus 3e-2 of the scale
        exact = base.replace("/bfloat16", "/float32")
        bm, bc = mesh, (r // m, r % m)
        for out in ("logits", "k", "v"):
            got = ranks[r][f"{mname}/{key}/{step}/{out}"]
            want = ref[f"{exact}/{step}/{out}"]
            mine = ref[f"{base}/{step}/{out}"]
            if out == "logits":
                sl = rows
            else:
                axes = (tpm.SLAB_AXES if step == "paged"
                        else tf.cache_axes(cfg)[out])
                sl = sh.local_block(sh.spec_for(axes, want.shape, bm,
                                                sh.RULES_DEFAULT),
                                    want.shape, bm, bc)
            floor = float(np.abs(mine[sl] - want[sl]).max())
            _close(got, want[sl], TOL[dname], f"rank {r} {out}", floor)


@pytest.mark.parametrize("mname,shape", MESHES)
@pytest.mark.parametrize("arch,tw", [(a, tw) for a, tw, d in CASES
                                     if d == "float32"])
def test_tp_int8_step_matches_reference(runs, arch, tw, mname, shape):
    """``serve_step(kv_quant=True, tp=...)`` on each rank against the
    reference's int8 step (partitioned on (1, 4) and (2, 2), unsharded
    on the smaller meshes): the rank's logits rows, and its block of the
    int8 cache and of the bf16 scales."""
    ref, ranks = runs
    data, m = shape
    cfg = cases.config(arch, tw)
    key = f"{arch}{tw}/float32"
    mesh = sh.MeshAxes(("data", "model"), (data, m))
    axes = tf.cache_axes(cfg, kv_quant=True)
    whole, port = ref[f"whole/{key}/int8/logits"], \
        ranks[0][f"1x1/{key}/int8/logits"]
    _close(port, whole, TOL["bfloat16"], "the unsharded port")
    for r in range(data * m):
        base, rows = _want(mname, data, cfg, key, "int8", r)
        got = ranks[r][f"{mname}/{key}/int8/logits"]
        want = ref[f"{base}/int8/logits"][rows]
        floor = float(np.abs(port[rows] - whole[rows]).max()
                      + np.abs(whole[rows] - want).max())
        _close(got, want, TOL["float32"], f"rank {r} logits", floor)
        _close(got, port[rows], TOL["float32"],
               f"rank {r} logits against the unsharded port")
        for n in ("k", "v", "k_scale", "v_scale"):
            want = ref[f"{base}/int8/{n}"]
            sl = sh.local_block(sh.spec_for(axes[n], want.shape, mesh,
                                            sh.RULES_DEFAULT),
                                want.shape, mesh, (r // m, r % m))
            got, want = ranks[r][f"{mname}/{key}/int8/{n}"], want[sl]
            assert got.shape == want.shape, (n, got.shape)
            gap = float(np.abs(ranks[0][f"1x1/{key}/int8/{n}"][sl]
                               - ref[f"whole/{key}/int8/{n}"][sl]).max()
                        + np.abs(ref[f"whole/{key}/int8/{n}"][sl]
                                 - want).max())
            step = 1.0 if n in ("k", "v") else TOL["bfloat16"] * float(
                np.abs(want).max())
            assert np.abs(got[0] - want[0]).max() <= step, (r, n, "layer 0")
            assert np.abs(got - want).max() <= gap + step, (r, n)
            # tight, against the port's own unsharded int8 step: its
            # block of the bf16 scales within 1e-5 of their scale, of the
            # int8 values one rounding step at a few elements at most
            mine = ranks[0][f"1x1/{key}/int8/{n}"][sl]
            if n in ("k", "v"):
                diff = np.abs(got.astype(np.int16) - mine.astype(np.int16))
                assert diff.max() <= 1, (r, n, "unsharded port", diff.max())
                assert (diff != 0).mean() <= 1e-3, (r, n, (diff != 0).sum())
            else:
                _close(got, mine, TOL["float32"],
                       f"rank {r} {n} against the unsharded port")


def _calls(cfg, m: int, step: str) -> int:
    """The collectives a step makes on a rank of ``m``: per layer one
    all-reduce after ``wo`` where the heads split and one after the MLP
    or MoE where its hidden dim or experts split (arctic's dense
    residual one more), one embedding all-reduce and one logits
    all-gather where the vocabulary splits."""
    lay = tpm.tp_layout(cfg, sh.MeshAxes(("model",), (m,)), rank=0)
    per = (lay.heads is not None) + (lay.experts is not None or lay.mlp_split)
    per += lay.dense_split
    return cfg.num_layers * per + 2 * (lay.vocab is not None)


@pytest.mark.parametrize("mname,shape", MESHES)
@pytest.mark.parametrize("arch,tw,dname", CASES)
def test_tp_collectives_counted(runs, arch, tw, dname, mname, shape):
    _, ranks = runs
    cfg = cases.config(arch, tw)
    for step in ("dense", "prefill"):
        want = _calls(cfg, shape[1], step)
        got = [int(ranks[r][f"{mname}/{arch}{tw}/{dname}/{step}/calls"])
               for r in range(math.prod(shape))]
        assert got == [want] * len(got), (step, got, want)


@pytest.mark.parametrize("step", ["prefill", "paged"])
@pytest.mark.parametrize("arch,tw", [(a, tw) for a, tw, d in CASES
                                     if d == "float32"])
def test_gather_cache_is_whole(runs, arch, tw, step):
    """``gather_cache`` of each rank's prefill cache and paged slab block
    on the (1, 4) mesh is the reference's whole one (fp32)."""
    ref, ranks = runs
    src = "whole" if step == "paged" else "1x4"
    want = ref[f"{src}/{arch}{tw}/float32/{step}/k"]
    for r in range(WORLD):
        _close(ranks[r][f"1x4/{arch}{tw}/float32/{step}/gathered_k"], want,
               TOL["float32"], f"rank {r}")


def test_tp_none_is_the_parents_bits():
    """No ``tp``: every output of the three steps, fp32 and bf16, on all
    seven reduced archs has the bytes it had before tensor parallelism
    existed."""
    with open(cases.DIGESTS) as f:
        want = json.load(f)
    got = cases.digests()
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


@pytest.mark.parametrize("arch", ["gemma2-27b", "minicpm3-4b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_families_left_are_refused(arch):
    cfg = get_arch(arch).reduced()
    mesh = sh.MeshAxes(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="no tensor-parallel program"):
        tpm.check_tp_supported(cfg, mesh)
    with pytest.raises(ValueError, match="no tensor-parallel program"):
        tpm.shard_model(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu"), cfg, mesh, rank=0,
                        device="cpu")


@pytest.mark.parametrize("what", ["kv_seq", "fsdp", "grad", "train_step",
                                  "no_group", "no_layout", "spliced"])
def test_what_is_not_ported_is_refused(what):
    cfg = cases.config("llama3-8b")
    mesh = sh.MeshAxes(("data", "model"), (2, 2))
    if what == "kv_seq":
        mqa = cases.config("granite-20b")
        tpm.check_tp_supported(mqa, mesh, sh.RULES_LONG_CONTEXT, entry="prefill")
        with pytest.raises(ValueError, match="sequence-parallel"):
            tpm.check_tp_supported(mqa, mesh, sh.RULES_LONG_CONTEXT)
        with pytest.raises(ValueError, match="all-to-all"):
            tpm.check_tp_supported(cfg, mesh, sh.RULES_LONG_CONTEXT,
                                   entry="prefill")
    elif what == "fsdp":
        # FSDP's serve entries have a program; with sequence-parallel KV
        # (RULES_FSDP_LONG) a decode step has none
        for entry in ("serve_step", "serve_step_paged", "prefill"):
            tpm.check_tp_supported(cfg, mesh, sh.RULES_FSDP, entry=entry)
        with pytest.raises(ValueError, match="sequence-parallel"):
            tpm.check_tp_supported(cfg, mesh, sh.RULES_FSDP_LONG)
    elif what == "grad":
        with pytest.raises(ValueError, match="gradients"):
            tpm.check_tp_supported(cfg, mesh, grad=True)
    elif what == "train_step":
        # a train step has a program (with gradients), FSDP's too; an
        # unknown entry and sequence-parallel KV do not
        tpm.check_tp_supported(cfg, mesh, entry="train_step", grad=True)
        with pytest.raises(ValueError, match="no tensor-parallel program"):
            tpm.check_tp_supported(cfg, mesh, entry="serve_step_paged_spliced")
        tpm.check_tp_supported(cfg, mesh, sh.RULES_FSDP, entry="train_step",
                               grad=True)
        with pytest.raises(ValueError, match="sequence-parallel"):
            tpm.check_tp_supported(cfg, mesh, sh.RULES_FSDP_LONG,
                                   entry="train_step", grad=True)
        with pytest.raises(ValueError, match="sequence-parallel"):
            tpm.check_tp_supported(cfg, mesh, sh.RULES_LONG_CONTEXT,
                                   entry="train_step", grad=True)
    else:
        model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.float32)
        if what == "no_layout":
            group = tpm.MetaTPGroup(2)
        else:
            model = tpm.shard_model(model, cfg, mesh, rank=1, device="cpu")
            group = None
        cache = tf.init_cache(cfg, 2, 8, torch.float32, "cpu",
                              kv_heads=model.wk.shape[2])
        inputs = {"token": torch.zeros(2, dtype=torch.int32),
                  "pos": torch.zeros(2, dtype=torch.int32)}
        with torch.no_grad(), pytest.raises(ValueError, match="TPGroup"):
            if what == "spliced":       # no tensor-parallel form: refused
                zero = torch.zeros((2, 2), dtype=torch.int32)
                tf.serve_step_paged_spliced(
                    model, cache["k"], cache["v"], zero, inputs["pos"], zero,
                    zero, inputs)
            else:
                tf.serve_step(model, cache, inputs, tp=group)


# (arch, model size, layout read off spec_for): heads, KV heads, experts,
# MLP split, vocabulary, queries padded into the global [KVH, G] layout
LAYOUTS = [
    ("llama3-8b", 8, (4, 1, None, True, 16032, False)),
    ("llama3-8b", 16, (2, 8, None, True, 8016, True)),
    ("granite-20b", 8, (6, 1, None, True, 6144, False)),
    ("granite-20b", 16, (3, 1, None, True, 3072, False)),
    ("nemotron-4-15b", 16, (3, 8, None, True, 16000, True)),
    ("granite-moe-3b-a800m", 8, (3, 1, 5, False, 49155, False)),
    ("granite-moe-3b-a800m", 16, (24, 8, None, True, 49155, False)),
    ("arctic-480b", 8, (7, 1, 16, False, 4000, False)),
    ("internvl2-1b", 8, (14, 2, None, True, 151655, False)),
    ("internvl2-1b", 2, (7, 1, None, True, 151655, False)),
    ("musicgen-large", 8, (4, 4, None, True, 256, False)),
]


@pytest.mark.parametrize("arch,m,want", LAYOUTS)
def test_layout_follows_spec_for(arch, m, want):
    """Full-width configs at the production mesh's ``model`` = 8 and at
    16: a dim that does not divide stays whole (granite-20b's one KV
    head, granite-moe's 40 experts over 16 ranks, whose ``mlp`` then
    takes ``model``, its vocabulary of 49,155, internvl2-1b's 14 heads
    over 8), and KVH 8 over 16 ranks pads the rank's queries."""
    cfg = get_arch(arch)
    lay = tpm.tp_layout(cfg, sh.MeshAxes(("data", "model"), (32, m)), rank=1)
    local = lay.local_shapes()
    span = lambda r, n: n if r is None else r[1] - r[0]
    got = (local["wq"][2], local["wk"][2],
           None if lay.experts is None else span(lay.experts, 0),
           lay.mlp_split, local["embed"][-2], lay.padded_heads)
    assert got == want
    assert tpm.local_kv_heads(cfg, sh.MeshAxes(("model",), (m,))) == want[1]


@pytest.mark.parametrize("arch,m", [("llama3-8b", 4), ("granite-20b", 4),
                                    ("internvl2-1b", 4)])
def test_kv_manager_holds_the_ranks_heads(arch, m):
    """``KVCacheManager(kv_heads=...)``: the slab and ``nbytes`` of one
    rank, KVH / model heads where they split, all of them where not."""
    cfg = cases.config(arch)
    kvh = tpm.local_kv_heads(cfg, sh.MeshAxes(("model",), (m,)))
    whole = KVCacheManager(cfg, torch.float32, device="cpu")
    rank = KVCacheManager(cfg, torch.float32, device="cpu", kv_heads=kvh)
    assert rank.nbytes(2, 16) * cfg.num_kv_heads == whole.nbytes(2, 16) * kvh
    assert rank.init_paged(6, 4).k.shape[3] == kvh
    assert kvh == (cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0
                   else cfg.num_kv_heads)
