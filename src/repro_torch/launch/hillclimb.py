"""Hillclimb driver: the reference's ``PLAN`` of hypotheses -> variant ->
dry run, on the ``h100x32x8`` mesh (the reference's
``launch/hillclimb.py``).

Each of the 15 variants of three cells goes through
``dryrun.dry_run_cell`` and its JSON to experiments/hillclimb_h100/.
The knobs the port can express (``accum``, ``moe_group``,
``split_cache``, ``kv_quant``, ``rules``, ``moment_bf16``) apply as the
reference applies them.  ``act_mode`` sets or drops ``act_spec``,
activation sharding inside the layers, which waits for tensor
parallelism: those variants (both modes, each measured against the
other) are written as ``status: "skipped"`` with that reason, never
dropped.  The hypotheses are the reference's, about TPU v5e pods; their
numbers are not the port's.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell NAME]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import dry_run_cell

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "hillclimb_h100")

# (cell_name, arch, shape, variant_name, variant, hypothesis), the
# reference's plan as it stands
PLAN = [
    # A. most collective-bound: gemma2-27b train_4k ---------------------------
    ("gemma2_train", "gemma2-27b", "train_4k", "v0_dshard_accum4",
     {"accum": 4, "act_mode": "model"},
     "baseline: d-sharded residual activations (fits HBM) but every "
     "matmul re-gathers x over the model axis -> collective-dominated"),
    ("gemma2_train", "gemma2-27b", "train_4k", "v1_noact_accum32",
     {"accum": 32, "act_mode": "none"},
     "drop activation d-sharding; recover HBM via 8x more microbatches. "
     "Napkin: activation all-gathers (~2*x_bytes*L per mb) vanish; FSDP "
     "weight gathers grow 8x (params/256*15 per layer per mb). For "
     "gemma2 act-AG ~ 2*0.6GB*46 >> weight-AG 8*29MB*46 -> expect big "
     "collective-term drop"),
    ("gemma2_train", "gemma2-27b", "train_4k", "v2_noact_accum16",
     {"accum": 16, "act_mode": "none"},
     "halve the weight re-gather count vs v1 if activations still fit"),
    ("gemma2_train", "gemma2-27b", "train_4k", "v3_noact_accum8",
     {"accum": 8, "act_mode": "none"},
     "push further: fewer weight gathers, more activation residency"),

    ("gemma2_train", "gemma2-27b", "train_4k", "v4_dshard_accum2",
     {"accum": 2, "act_mode": "model"},
     "v1-v3 refuted the no-act direction: FSDP weight re-gathers inside "
     "the microbatch loop dominate (~1.9s per microbatch from v1's "
     "61s/32). Keep d-sharded activations, HALVE accum instead: weight "
     "gathers 7.6s->3.8s, act gathers unchanged => predict ~18s (-17%)"),
    ("gemma2_train", "gemma2-27b", "train_4k", "v5_tponly_accum4",
     {"accum": 4, "act_mode": "model", "rules": "default",
      "moment_bf16": True},
     "remove FSDP entirely: TP-only weights (3.4GB/chip, fits with bf16 "
     "moments) => zero weight re-gathers; collective = act gathers + one "
     "grad all-reduce per step. Predict ~14.5s (-34%)"),

    # B. worst useful-FLOPs fraction: granite-moe train_4k --------------------
    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v0_baseline",
     {"accum": 4, "act_mode": "model"},
     "baseline MoE train: dispatch einsums at group 512 cost "
     "Tg*cf/(3*ff)=0.42x expert FLOPs; activation d-sharding collective-"
     "dominated like dense"),
    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v1_noact_accum16",
     {"accum": 16, "act_mode": "none"},
     "same activation-sharding hypothesis as gemma2 v1"),
    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v2_group256",
     {"accum": 16, "act_mode": "none", "moe_group": 256},
     "halve dispatch group: dispatch-einsum FLOPs scale with Tg "
     "(Tg*cf/(3*ff): 0.42 -> 0.21) at slightly higher drop variance"),
    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v3_group1024",
     {"accum": 16, "act_mode": "none", "moe_group": 1024},
     "counter-hypothesis: larger groups reduce cumsum/one-hot op count "
     "but double dispatch FLOPs — expect WORSE compute term (refutation "
     "test for v2's direction)"),

    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v4_group256_actmodel",
     {"accum": 4, "act_mode": "model", "moe_group": 256},
     "clean group-size comparison at the winning act config: dispatch "
     "FLOPs ratio 0.42->0.21 of expert FLOPs; predict compute term -11% "
     "and small collective win vs v0"),
    ("moe_train", "granite-moe-3b-a800m", "train_4k", "v5_tponly_accum4",
     {"accum": 4, "act_mode": "model", "rules": "default",
      "moment_bf16": True, "moe_group": 256},
     "apply the gemma2-v5 lesson: TP-only weights for a 3.4B model are "
     "only 0.42GB/chip; kill FSDP weight re-gathers entirely"),

    # C. paper-representative serving cell: gemma2-27b decode_32k -------------
    ("gemma2_decode", "gemma2-27b", "decode_32k", "v0_unsplit",
     {"split_cache": False},
     "original uniform cache: every layer holds 32k KV; memory term = "
     "weights + full cache read"),
    ("gemma2_decode", "gemma2-27b", "decode_32k", "v1_split",
     {},
     "split cache: local (sliding-window) layers keep a 4096-slot ring "
     "-> cache bytes ~halve (23/46 layers at window/Smax=1/8 size)"),
    ("gemma2_decode", "gemma2-27b", "decode_32k", "v2_split_int8",
     {"kv_quant": True},
     "int8-quantized global-layer KV (per-token,per-head scales): cache "
     "read bytes halve again; parity test shows 100% argmax agreement"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for cell, arch, shape, vname, variant, hyp in PLAN:
        if args.cell and cell != args.cell:
            continue
        path = os.path.join(args.out, f"{cell}__{vname}.json")
        if os.path.exists(path) and not args.force:
            print(f"{cell}/{vname}: cached")
            continue
        res = dry_run_cell(arch, shape, multi_pod=False, variant=variant,
                           verbose=False)
        res["hypothesis"] = hyp
        res["variant_name"] = vname
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        if res["status"] == "ok":
            r = res["roofline"]
            print(f"{cell}/{vname}: comp={r['t_compute_s']*1e3:.1f}ms "
                  f"mem={r['t_memory_s']*1e3:.1f}ms "
                  f"coll={r['t_collective_s']*1e3:.1f}ms "
                  f"bound={r['bottleneck']} "
                  f"peak={res['memory']['peak_bytes']/1e9:.1f}GB")
        else:
            print(f"{cell}/{vname}: {res['status']} "
                  f"{res.get('skip_reason', res.get('error', ''))[:120]}")


if __name__ == "__main__":
    main()
