"""The port's tensor-parallel train step (``make_tp_train_step``) over 2
and 4 gloo ranks against the reference's ``make_train_step`` as its
partitioner runs it under ``RULES_DEFAULT``, on the seven reduced
GQA/MQA/MoE configs of ``torch_tp_cases``.

A reference child an arch (JAX with 4 host devices,
``torch_dist_reference`` job ``tp_train``) jits ``make_train_step`` under
``param_shardings`` and the moments' shardings (the parameters'), the
batch over ``data``, as ``launch/dryrun.py`` lowers a train cell, on three
(mesh, accum_steps) cells: (1, 2) with 2 microbatches, (1, 4) with 1,
(2, 2) with 2 (each microbatch's rows split over ``data``);
``act_spec`` P("data", None, "model") on (1, 4) and (2, 2), None on
(1, 2).  It runs 2 steps from the
case's weights (the port's seeded ``init_params`` as numpy) and zero
fp32 moments, on global batches of 4 x 16 tokens (a vision model's
image prefix besides; lr 1e-3, remat in groups of 2 layers, attention
and loss chunks of 8, so the vocabulary-parallel loss runs within two
chunks and ``act_spec`` saves two group boundaries).  One spawn
of 4 ranks (``torch_dist_ranks`` job ``tp_train``), started beside the
reference (every step 0 needs only the weights), runs the port's step
on each cell, ``act_spec`` off and on, each step from the reference's
state before it (so fp32 noise cannot compound), and compares its
blocks with the reference's there.

Tolerances, ``tests/test_torch_dp_train.py``'s: the loss and ce within
rtol 1e-5, the MoE aux loss within rtol 1e-5 (plus 1e-8), the grad norm
1e-4, the learning rate 1e-6, the token count exact; every parameter
element within 2e-4 absolute, but for the elements whose gradient is
not 0 but within 1e-4 of its leaf's max-abs of it (Adam's step there is
about +-lr whichever way the noise points); the moments within 1e-4 of
their leaf's max-abs (the gradients' tolerance).  ``act_spec`` on gives
the bits of ``act_spec`` off on every rank (the saved columns are
gathered back whole).

The MoE configs on (2, 2) are the repair of a fault the port had: each
data shard routes its rows as part of the whole microbatch's dispatch
groups (the selected experts all-gathered over ``data``), and the
load-balancing loss's ``frac_tokens`` and ``frac_probs`` are the whole
microbatch's means.
"""

import concurrent.futures
import json

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

pytest.importorskip("jax")

# (mesh name, [data, model], accum_steps, the reference's act_spec)
CELLS = [("1x2", [1, 2], 2, False), ("1x4", [1, 4], 1, True),
         ("2x2", [2, 2], 2, True)]
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
KW = dict(attn_chunk=8, remat_group=2, loss_chunk=8)
WORLD = 4
PATHS = {**tf._JAX_PATHS, **tf._FAMILY_PATHS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    arrays = {}
    for arch in cases.ARCHS:
        cfg = cases.config(arch)
        arrays.update({f"w/{arch}/{k}": v
                       for k, v in cases.weights(cfg).items()})
        for s in range(STEPS):
            arrays.update({f"batch/{arch}/{s}/{k}": v for k, v in
                           cases.train_batch(cfg, s).items()})
    ref_cases = [[a, n, shape, acc, act] for a in cases.ARCHS
                 for n, shape, acc, act in CELLS]
    parts = [str(d / f"ref.{i}.npz") for i in range(len(cases.ARCHS))]
    ready, failed = d / "ref.ready", d / "ref.failed"
    meta = {"cases": ref_cases, "steps": STEPS, "opt": OPT, "kw": KW,
            "reference": parts, "ready": str(ready), "failed": str(failed)}
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    handle = torch_dist_reference.start("tp_train", d / "in.npz",
                                        d / "ref.npz", parts=cases.ARCHS)
    # the ranks run every step 0 while the reference computes, then wait
    # for it
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torch_dist_ranks.run, "tp_train", WORLD,
                            d / "in.npz", d, timeout=900.0)
        try:
            assert torch_dist_reference.wait(handle, timeout=600.0,
                                             merge=False) == parts
        except BaseException:
            failed.touch()
            raise
        ready.touch()
        ranks = ranks.result()
    ref = {}
    for p in parts:             # the metrics alone; the arrays stay on disk
        with np.load(p) as f:
            ref.update({k: f[k] for k in f.files
                        if k.count("/") == 4 and "/leaf/" not in k})
    return ref, ranks


def _ranks(shape):
    return range(shape[0] * shape[1])


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("mname,shape,accum,_", CELLS)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_tp_train_step_matches_reference(runs, arch, mname, shape, accum, _,
                                         act, step):
    ref, ranks = runs
    at = f"{arch}/{mname}/{accum}/{step}"
    cfg = cases.config(arch)
    for r in _ranks(shape):
        got = ranks[r]
        key = f"{at}/{int(act)}"
        for k, rtol, atol in (("loss", 1e-5, 0.0), ("ce", 1e-5, 0.0),
                              ("aux", 1e-5, 1e-8), ("grad_norm", 1e-4, 0.0),
                              ("lr", 1e-6, 0.0), ("tokens", 0.0, 0.0)):
            np.testing.assert_allclose(got[f"{key}/{k}"], ref[f"{at}/{k}"],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} {k}")
        for name in tf.param_shapes(cfg):
            err_p, _unsure, _n, err_m, scale_m, err_v, scale_v = \
                got[f"{key}/leaf/{name}"]
            assert err_p <= 2e-4, (r, name, "params", err_p)
            assert err_m <= 1e-4 * scale_m + 1e-12, (r, name, "m", err_m)
            assert err_v <= 1e-4 * scale_v + 1e-12, (r, name, "v", err_v)


@pytest.mark.parametrize("mname,shape,accum,_", CELLS)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_act_spec_changes_no_bit(runs, arch, mname, shape, accum, _):
    """``act_spec`` saves each remat group's input as the rank's columns
    and gathers them back whole: the same parameters, moments and
    metrics to the bit, on every rank, both steps."""
    _, ranks = runs
    for r in _ranks(shape):
        for s in range(STEPS):
            assert bool(ranks[r][f"{arch}/{mname}/{accum}/{s}/act_same"]), (r, s)


@pytest.mark.parametrize("mname,shape,accum,_", CELLS)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_data_collectives_only_where_data_splits(runs, arch, mname, shape,
                                                 accum, _):
    """A step makes ``data`` collectives only on a mesh with ``data`` >
    1 (the loss's counts and sum, the gradients; an MoE layer's routing
    and aux loss besides), and ``model`` ones on every rank."""
    _, ranks = runs
    for r in _ranks(shape):
        for act in (0, 1):
            calls, data_calls = ranks[r][f"{arch}/{mname}/{accum}/0/{act}/calls"]
            assert calls > 0
            assert (data_calls > 0) == (shape[0] > 1), (r, data_calls)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("mname,shape,accum,_", CELLS)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_meta_group_counts_the_ranks_collectives(runs, arch, mname, shape,
                                                 accum, _, act):
    """The dry run's ``MetaTPGroup`` sees every collective of a rank's
    step, forward, backward (the recompute's too) and update: the same
    number over ``model`` and over ``data`` as the gloo ranks made."""
    from repro_torch.launch import op_cost
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_tp_train_step)
    _, ranks = runs
    cfg = cases.config(arch)
    data, m = shape
    group = tpm.MetaTPGroup(m, data_size=data)
    model = tpm.shard_model(op_cost.meta_model(cfg, torch.float32), cfg,
                            sh.MeshAxes(("model",), (m,)), rank=0,
                            device="meta").set_trainable()
    state = init_opt_state(dict(model.named_parameters()), OptConfig(**OPT))
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in cases.train_batch(cfg, 0).items()}
    step = make_tp_train_step(cfg, OptConfig(**OPT), remat=True,
                              accum_steps=accum, act_spec=act, **KW)
    with op_cost.OpCounter():
        step(model, state, batch, group)
    got = ranks[0][f"{arch}/{mname}/{accum}/0/{int(act)}/calls"]
    assert [group.calls, group.data_calls] == got.tolist()


@pytest.mark.parametrize("what", ["fsdp", "kv_seq", "gemma2-27b",
                                  "minicpm3-4b", "rwkv6-3b", "zamba2-2.7b"])
def test_tp_train_refuses_what_has_no_program(what):
    mesh = sh.MeshAxes(("data", "model"), (2, 2))
    cfg, rules = cases.config("llama3-8b"), sh.RULES_DEFAULT
    if what == "fsdp":  # FSDP has a program; with sequence-parallel KV not
        tpm.check_tp_supported(cfg, mesh, sh.RULES_FSDP, entry="train_step",
                               grad=True)
        rules, match = sh.RULES_FSDP_LONG, "sequence-parallel"
    elif what == "kv_seq":
        rules, match = sh.RULES_LONG_CONTEXT, "sequence-parallel"
    else:
        cfg, match = get_arch(what).reduced(), "no tensor-parallel program"
    with pytest.raises(ValueError, match=match):
        tpm.check_tp_supported(cfg, mesh, rules, entry="train_step",
                               grad=True)


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_tp_train_accepts_the_seven(arch):
    for shape in ((1, 2), (1, 4), (2, 2), (32, 8), (32, 16)):
        tpm.check_tp_supported(get_arch(arch), sh.MeshAxes(
            ("data", "model"), shape), entry="train_step", grad=True)
