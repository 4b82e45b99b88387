"""Roofline terms of a dry-run cell on H100s (the reference's
``launch/roofline.py``).

Sources:
  * ``op_cost.op_cost`` — GLOBAL FLOPs and matmul/gather/scatter bytes
    of the cell's entry point, traced on meta tensors at the global
    batch (the reference takes them from ``hlo_cost.jaxpr_cost``);
  * the collectives the port's programs make, per card and per mesh
    axis: the data-parallel all-reduce of a card's gradient block over
    ``data`` x ``pod`` once a training step (``dryrun.dp_collectives``,
    ``compression.payload_bytes``).
    The port has no tensor-parallel program (its layers run whole on
    each card), so a cell with ``model`` > 1 counts no tensor-parallel
    collectives and says so in ``tp_collectives``.  The reference's HLO
    regexes and ``collective_bytes`` have no counterpart: there is no
    HLO to parse.

Terms (seconds):
  compute    = flops_global / (chips * peak_flops)
  memory     = bytes_global / (chips * hbm_bw)
  collective = sum over mesh axes of the axis's bytes a card / its link
               bandwidth a card (``LINK_BW``); without per-axis bytes,
               coll_bytes_per_chip / hw.ici_bw as in the reference.

A collective's bytes are the payload a card contributes (the
reference's convention: the collective's output size), with no ring
factor.  The link bandwidths are datasheet figures, not measured: the
H100 profile's ``ici_bw`` is 0 (``core/budget.py``), so the collective
term takes them from here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.budget import H100, HardwareProfile

# Datasheet figures, not measured: NVLink 4 gives an H100 18 links of
# 25 GB/s a direction (450 GB/s), for the ``model`` axis inside a node;
# a DGX H100 has one 400 Gb/s NDR NIC a card (50 GB/s), for ``data``
# and ``pod`` between nodes.
NVLINK_BW = 450e9
NIC_BW = 50e9
LINK_BW = {"model": NVLINK_BW, "data": NIC_BW, "pod": NIC_BW}
LINK_SOURCE = "datasheet (NVLink 4 450 GB/s, NDR NIC 50 GB/s a card)"
NO_TP = ("not counted: the port has no tensor-parallel program "
         "(layers run whole on each card)")


def axis_bw(axes: str) -> float:
    """Link bandwidth a card for a collective over ``axes`` ("data",
    "pod+data", ...): the slowest axis it crosses."""
    return min(LINK_BW[a] for a in axes.split("+"))


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    model_flops: float                       # 6·N(_active)·D global
    hw: HardwareProfile = H100
    peak_memory_bytes: Optional[float] = None
    # bytes a card by the mesh axes a collective crosses ("pod+data")
    coll_by_axis: Dict[str, float] = field(default_factory=dict)
    tp_collectives: str = ""

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        if self.coll_by_axis:
            return sum(b / axis_bw(a) for a, b in self.coll_by_axis.items())
        if not self.coll_bytes_per_chip:
            return 0.0
        return self.coll_bytes_per_chip / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy."""
        return self.model_flops / self.flops_global if self.flops_global \
            else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs / (bound time × peak)."""
        denom = self.t_bound * self.hw.peak_flops * self.chips
        return self.model_flops / denom if denom else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.flops_global,
            "hlo_bytes_global": self.bytes_global,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_bytes": self.peak_memory_bytes,
            "coll_by_axis": self.coll_by_axis,
            "link_bw": LINK_SOURCE if self.coll_by_axis else None,
            "tp_collectives": self.tp_collectives,
            "hw": self.hw.name,
        }


def model_flops_for(cfg: ArchConfig, entry: str, seq_len: int,
                    global_batch: int) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward-only (per the 6ND convention;
    decode D = batch tokens, one step)."""
    n = cfg.active_param_count()
    if entry == "train_step":
        return 6.0 * n * seq_len * global_batch
    if entry == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch            # serve_step: one token per seq


def build_report(*, arch: str, shape: str, mesh_name: str, chips: int,
                 cost: Dict, model_flops: float,
                 coll_by_axis: Optional[Dict[str, float]] = None,
                 tp_collectives: str = "",
                 peak_memory: Optional[float] = None,
                 hw: HardwareProfile = H100) -> RooflineReport:
    """cost: {'flops': global, 'bytes': global} from ``op_cost``;
    coll_by_axis: the all-reduce bytes a card by the axes it crosses."""
    coll = dict(coll_by_axis or {})
    total = float(sum(coll.values()))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_global=float(cost.get("flops", 0.0)),
        bytes_global=float(cost.get("bytes", 0.0)),
        coll_bytes_per_chip=total,
        coll_breakdown={"all-reduce": int(total)} if total else {},
        model_flops=model_flops, peak_memory_bytes=peak_memory, hw=hw,
        coll_by_axis=coll, tp_collectives=tp_collectives)
