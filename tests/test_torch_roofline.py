"""The port's roofline, dry run, report and hillclimb plan
(``repro_torch.launch.{roofline,dryrun,report,hillclimb,mesh}``) against
the reference's, on the CPU.

* ``model_flops_for`` equal to the reference's for all 11 archs and the
  three entries, exactly.
* ``RooflineReport``'s terms, bottleneck and fractions equal to the
  reference's for the same cost on one shared profile (the v5e's), and
  the per-axis collective term at the datasheet link figures.
* Per-card argument bytes for every arch x suite x rule set on the
  reference's own meshes (16 x 16 and 2 x 16 x 16, through the
  reference's ``input_specs`` over an abstract mesh, as
  ``tests/test_distributed.py:15-20`` builds one) equal to the sum of the
  reference's shard shapes, exactly.
* With the v5e's HBM passed in, the port's ``rules_for`` picks the
  reference's rule set in every cell.
* One reduced-arch ``dry_run_cell`` of each entry on a 2 x 2 mesh returns
  ``status: "ok"`` with the reference's cell keys, and
  ``report.roofline_table`` renders it.
* The hillclimb plan is the reference's, with the ``act_mode`` variants
  skipped with their reason.
* The production meshes' names and sizes, and ``make_host_mesh`` over a
  gloo world of one.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
from jax.sharding import Mesh

from repro.configs import SHAPE_SUITES as JSUITES
from repro.configs import get_arch as jget_arch
from repro.core import budget as jbudget
from repro.launch import roofline as jrl
from repro.launch.mesh import _axis_type_kwargs
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.configs.shapes import SHAPE_SUITES, ShapeSuite
from repro_torch.core import budget as tbudget
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import hillclimb as thc
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as trl

RULE_SETS = ("default", "long_context", "fsdp", "fsdp_long")
REF_MESHES = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model"))]


def _import_reference(name):
    """Import a reference launch module that sets XLA_FLAGS at import
    (for 512 host devices): with the backend already up the flag does
    nothing, and the variable is put back as it was."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return __import__(f"repro.launch.{name}", fromlist=[name])
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


jdr = _import_reference("dryrun")
jhc = _import_reference("hillclimb")


def fake_mesh(shape, axes):
    """tests/test_distributed.py's abstract mesh over repeated devices."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * (n // len(jax.devices()) + 1))[:n]
    return Mesh(devs.reshape(shape), axes, **_axis_type_kwargs(len(axes)))


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_for_is_the_reference_formula(arch):
    jc, tc = jget_arch(arch), tget_arch(arch)
    for entry in ("train_step", "prefill", "serve_step"):
        for S, B in ((4096, 256), (32768, 32), (524288, 1)):
            assert trl.model_flops_for(tc, entry, S, B) == \
                jrl.model_flops_for(jc, entry, S, B)


@pytest.mark.parametrize("cost", [(1e15, 1e12, 0.0), (1e12, 1e14, 3e9),
                                  (2e13, 1e9, 5e11), (0.0, 0.0, 0.0)])
def test_roofline_terms_are_the_reference_ones(cost):
    flops, nbytes, coll = cost
    kw = dict(arch="a", shape="s", mesh="m", chips=256, flops_global=flops,
              bytes_global=nbytes, coll_bytes_per_chip=coll,
              coll_breakdown={"all-reduce": int(coll)}, model_flops=7e12,
              peak_memory_bytes=1e9)
    want = jrl.RooflineReport(**kw, hw=jbudget.TPU_V5E)
    got = trl.RooflineReport(**kw, hw=tbudget.TPU_V5E)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "t_bound", "useful_flops_fraction", "roofline_fraction"):
        assert getattr(got, name) == getattr(want, name), name
    assert set(want.row()) <= set(got.row())


def test_collective_term_per_axis_at_datasheet_links():
    r = trl.build_report(arch="a", shape="s", mesh_name="h100x32x8",
                         chips=256, cost={"flops": 1e15, "bytes": 1e12},
                         model_flops=1e15, coll_by_axis={"data": 5e9},
                         tp_collectives=trl.NO_TP)
    assert r.hw is tbudget.H100 and tbudget.H100.ici_bw == 0.0
    assert r.t_collective == 5e9 / trl.NIC_BW == 0.1
    assert r.bottleneck == "collective"
    assert trl.axis_bw("pod+data") == trl.NIC_BW
    assert trl.axis_bw("model") == trl.NVLINK_BW == 450e9
    row = r.row()
    assert row["coll_by_axis"] == {"data": 5e9}
    assert "datasheet" in row["link_bw"] and row["tp_collectives"] == trl.NO_TP


def test_production_meshes():
    m = tmesh.make_production_mesh()
    assert (m.mesh_dim_names, m.shape) == (("data", "model"), (32, 8))
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert (mp.mesh_dim_names, mp.shape) == (("pod", "data", "model"),
                                             (2, 32, 8))
    assert tmesh.mesh_chip_count(m) == 256 and tmesh.mesh_chip_count(mp) == 512
    assert tmesh.mesh_name() == "h100x32x8"
    assert tmesh.mesh_name(True) == "h100x2x32x8"


def test_host_mesh_over_a_gloo_world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        m = tmesh.make_host_mesh()
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1) and tmesh.mesh_chip_count(m) == 1
    finally:
        dist.destroy_process_group()


def _ref_local_bytes(tree) -> int:
    return sum(int(np.prod(s.sharding.shard_shape(s.shape))) * s.dtype.itemsize
               for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", list_archs())
def test_argument_bytes_are_the_reference_shards(arch):
    jc, tc = jget_arch(arch), tget_arch(arch)
    for shape, names in REF_MESHES:
        jm, tm = fake_mesh(shape, names), tsh.MeshAxes(names, shape)
        for js, ts in zip(JSUITES, SHAPE_SUITES):
            for rules in RULE_SETS:
                want = jdr.input_specs(jc, js, jm, getattr(
                    jdr.shd, f"RULES_{rules.upper()}"))
                got = tdr.argument_bytes(tdr.input_specs(
                    tc, ts, tm, getattr(tsh, f"RULES_{rules.upper()}")), tm)
                ref = {"params": _ref_local_bytes(want["params"])}
                for g in ("opt_state", "batch", "inputs", "cache"):
                    if g in want:
                        ref[g] = _ref_local_bytes(want[g])
                assert got == ref, (shape, js.name, rules)


@pytest.mark.parametrize("arch", list_archs())
def test_rules_for_picks_the_reference_rules_at_v5e_hbm(arch):
    jc, tc = jget_arch(arch), tget_arch(arch)
    for shape, names in REF_MESHES:
        jm, tm = fake_mesh(shape, names), tsh.MeshAxes(names, shape)
        for js, ts in zip(JSUITES, SHAPE_SUITES):
            assert tdr.rules_for(tc, ts, tm, hbm_bytes=16e9) == \
                jdr.rules_for(jc, js, jm)


# the reference's cell keys (compile_cell), fits_16gb -> fits_80gb
CELL_KEYS = {"arch", "shape", "mesh", "rules", "variant", "status",
             "wave_batch", "num_waves", "t_lower_s", "t_compile_s", "memory",
             "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes", "fits_80gb"}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma2-27b"])
def test_dry_run_cell_of_each_entry_on_a_small_mesh(arch):
    cfg = tget_arch(arch).reduced()
    mesh = tsh.MeshAxes(("data", "model"), (2, 2))
    cells = {}
    for name, entry, S, B in (("train_4k", "train_step", 32, 8),
                              ("prefill_32k", "prefill", 32, 4),
                              ("decode_32k", "serve_step", 32, 4)):
        d = tdr.dry_run_cell(arch, name, mesh=mesh, cfg=cfg,
                             suite=ShapeSuite(name, entry, S, B),
                             attn_chunk=8, loss_chunk=8, verbose=False,
                             variant={"accum": 2})
        assert d["status"] == "ok", d.get("traceback")
        assert CELL_KEYS <= set(d) and MEMORY_KEYS <= set(d["memory"])
        assert set(jrl.RooflineReport(
            "a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0).row()) <= set(d["roofline"])
        mem = d["memory"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert mem["temp_bytes"] > 0 and mem["fits_80gb"]
        assert d["roofline"]["tp_collectives"] == trl.NO_TP
        # a card holds its blocks of the arguments: half of each
        # data-sharded batch, the model-sharded weights' quarters
        assert mem["argument_bytes"] < tdr.argument_bytes(
            tdr.input_specs(cfg, ShapeSuite(name, entry, S, B),
                            tsh.MeshAxes(("data",), (1,)),
                            tdr.rules_for(cfg, ShapeSuite(name, entry, S, B),
                                          mesh)),
            tsh.MeshAxes(("data",), (1,)))["params"] * 4
        cells[f"{arch}__{name}"] = d
    train = cells[f"{arch}__train_4k"]["roofline"]
    assert train["coll_by_axis"] and train["t_collective_s"] > 0
    assert cells[f"{arch}__decode_32k"]["roofline"]["t_collective_s"] == 0
    table = treport.roofline_table(cells)
    assert table.count(f"| {arch} |") == 3
    row = [r for r in treport.fit_table(cells).splitlines()
           if r.startswith(f"| {arch} |")]
    assert len(row) == 1 and row[0].count(" GB, ") == 3
    assert treport.summary(cells)["ok"] == 3


def test_hillclimb_plan_is_the_reference_one():
    assert [p[:5] for p in thc.PLAN] == [p[:5] for p in jhc.PLAN]
    for cell, arch, shape, vname, variant, _ in thc.PLAN:
        if "act_mode" not in variant:
            continue
        d = tdr.dry_run_cell(arch, shape, variant=variant, verbose=False)
        assert d["status"] == "skipped" and "tensor parallelism" in \
            d["skip_reason"], (cell, vname)
    kept = [p for p in thc.PLAN if "act_mode" not in p[4]]
    assert [p[3] for p in kept] == ["v0_unsplit", "v1_split", "v2_split_int8"]
