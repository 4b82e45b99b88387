"""The port's FSDP program (``RULES_FSDP``: every parameter's ``embed``
dim split over ``data`` and ``pod`` on top of the ``model`` split) for
the train step and the three serve entries of the seven reduced
GQA/MQA/MoE configs of ``torch_tp_cases``, over 2 and 4 gloo ranks,
against the reference's GSPMD program under the same rules.

One reference child an arch (``torch_dist_reference`` job ``fsdp``, 4
host devices) jits, under ``param_shardings(cfg, mesh, RULES_FSDP)``:

* ``make_train_step`` (moments sharded as the parameters, the batch
  over the batch axes) on the ``TRAIN`` cells, 2 steps from the case's
  weights and zero moments, lr 1e-3, remat in groups of 2, attention and
  loss chunks of 8: every config on ("data", "model") = (2, 1), and on
  (2, 2) with ``act_spec``; llama3-8b and granite-moe-3b on (4, 1);
  llama3-8b on ("pod", "data", "model") = (2, 2, 1), where the batch
  splits ``pod`` major and ``embed`` ``data`` major; nemotron-4-15b on
  (2, 1) with 2 microbatches; llama3-8b at a width of 130 on (4, 1),
  whose ``embed`` the divisibility pass keeps whole;
* ``serve_step``, ``prefill`` and ``serve_step_paged`` on (2, 2) and
  (2, 1): every config in fp32, and the five without MoE in bf16 as
  well.  As in ``tests/test_torch_tensor_parallel.py``, the MoE
  configs serve in fp32 alone: in bf16 a routing decision of these
  random networks flips on rounding, so two bf16 programs that sum in
  another order (the rank's ``model`` all-reduce in bf16, the
  reference's partitioned sums) route some token to other experts
  (granite-moe-3b's (2, 2) prefill: logits 2.06 from the fp32
  reference's, against 0.16 for the reference's own bf16 program).

One spawn of 4 ranks (``torch_dist_ranks`` job ``fsdp``) runs the same
on its blocks (``shard_model`` over the whole mesh, ``TPGroup`` with
the ``data`` axis's group), started beside the reference: the serve
steps and every step 0 first, each later step from the reference's
state before it.

Tolerances, those of ``tests/test_torch_tp_train.py`` and
``tests/test_torch_tensor_parallel.py``: a train step's loss and ce
within rtol 1e-5, the aux loss 1e-5 (plus 1e-8), the grad norm 1e-4,
the learning rate 1e-6, the token count exact; each parameter element
within 2e-4 absolute (but where the gradient is not 0 yet within 1e-4
of its leaf's max-abs), the moments within 1e-4 of their leaf's
max-abs; serve logits, caches and slabs within 1e-5 of the scale in
fp32, and bf16 within the reference's own bf16 program's distance from
its fp32 one plus 3e-2 of the scale.
"""

import concurrent.futures
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks  # noqa: E402
import torch_dist_reference  # noqa: E402
import torch_tp_cases as cases  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

pytest.importorskip("jax")

# (arch, mesh name, shape, accum_steps, act_spec, tweak)
TRAIN = ([(a, "f2x1", [2, 1], 1, False, "") for a in cases.ARCHS]
         + [(a, "f2x2", [2, 2], 1, True, "") for a in cases.ARCHS]
         + [("llama3-8b", "f4x1", [4, 1], 1, False, ""),
            ("granite-moe-3b-a800m", "f4x1", [4, 1], 1, False, ""),
            ("llama3-8b", "f2x2x1", [2, 2, 1], 1, False, ""),
            ("nemotron-4-15b", "f2x1", [2, 1], 2, False, ""),
            ("llama3-8b", "f4x1", [4, 1], 1, False, "d130")])
SERVE = ([(a, "", "float32") for a in cases.ARCHS]
         + [(a, "", "bfloat16") for a in cases.ARCHS
            if cases.config(a).moe is None])
MESHES = [["f2x2", [2, 2]], ["f2x1", [2, 1]]]
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
KW = dict(attn_chunk=8, remat_group=2, loss_chunk=8)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
WORLD = 4
RULES = sh.RULES_FSDP


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    arrays = {}
    for arch, *_, tw in TRAIN + [(a, tw) for a, tw, _ in SERVE]:
        key = arch + tw
        if f"w/{key}/final_norm" in arrays:
            continue
        cfg = cases.config(arch, tw)
        arrays.update({f"w/{key}/{k}": v for k, v in cases.weights(cfg).items()})
        arrays.update({f"in/{key}/{k}": v for k, v in cases.inputs(cfg).items()})
        for s in range(STEPS):
            arrays.update({f"batch/{key}/{s}/{k}": v for k, v in
                           cases.train_batch(cfg, s).items()})
    parts = [str(d / f"ref.{i}.npz") for i in range(len(cases.ARCHS))]
    ready, failed = d / "ref.ready", d / "ref.failed"
    train = {"cases": [[a, n, shape, acc, act, "FSDP", tw]
                       for a, n, shape, acc, act, tw in TRAIN],
             "steps": STEPS, "opt": OPT, "kw": KW, "reference": parts,
             "ready": str(ready), "failed": str(failed)}
    serve = {"cases": SERVE, "meshes": MESHES, "rules": "FSDP",
             "int8": False}
    meta = {"train": train, "serve": serve}
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    handle = torch_dist_reference.start("fsdp", d / "in.npz", d / "ref.npz",
                                        parts=cases.ARCHS)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torch_dist_ranks.run, "fsdp", WORLD,
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
    for p in parts:         # all but the train steps' state, read lazily
        with np.load(p) as f:
            ref.update({k: f[k] for k in f.files
                        if not any(f"/{x}/" in k for x in ("params", "m", "v"))})
    return ref, ranks, parts


def _mesh(shape) -> sh.MeshAxes:
    return sh.MeshAxes(("pod", "data", "model")[3 - len(shape):], tuple(shape))


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("arch,mname,shape,accum,_,tw", TRAIN)
def test_fsdp_train_step_matches_reference(runs, arch, mname, shape, accum, _,
                                           tw, act, step):
    ref, ranks, _ = runs
    at = f"{arch}{tw}/{mname}/{accum}/{step}"
    cfg = cases.config(arch, tw)
    for r in range(math.prod(shape)):
        key = f"{at}/{int(act)}"
        got = ranks[r]
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


@pytest.mark.parametrize("arch,mname,shape,accum,_,tw", TRAIN)
def test_fsdp_act_spec_changes_no_bit(runs, arch, mname, shape, accum, _, tw):
    _, ranks, _ = runs
    for r in range(math.prod(shape)):
        for s in range(STEPS):
            assert bool(ranks[r][f"{arch}{tw}/{mname}/{accum}/{s}/act_same"])


@pytest.mark.parametrize("arch,mname,shape,accum,_,tw", TRAIN)
def test_fsdp_blocks_are_split(runs, arch, mname, shape, accum, _, tw):
    """A rank's resident parameter and moment elements: a parameter
    split over ``data`` and ``model`` holds 1 / (data x model) of the
    whole, one split over one of them 1 / its size, and one whose
    ``embed`` the divisibility pass keeps (d130 over 4) the whole of
    its ``model`` block; summed over the ranks, each parameter's
    blocks come to the whole times its replication."""
    _, ranks, _ = runs
    cfg = cases.config(arch, tw)
    mesh = _mesh(shape)
    data, m = math.prod(shape[:-1]), shape[-1]
    shapes = tf.param_shapes(cfg)
    specs = sh.param_shardings(cfg, mesh, RULES)
    both = 0
    for r in range(math.prod(shape)):
        numel = ranks[r][f"{arch}{tw}/{mname}/{accum}/0/numel"]
        for (name, whole), row in zip(shapes.items(), numel):
            over = {a for e in specs[name] for a in sh._entry_axes(e)
                    if dict(zip(mesh.mesh_dim_names, mesh.shape))[a] > 1}
            split = (m if "model" in over else 1) * (data if over - {"model"}
                                                     else 1)
            assert list(row) == [math.prod(whole) // split] * 3, (r, name, row)
            if tw == "d130":
                assert not over - {"model"}, (name, over)
            both += over == {"model", "data"}
    if tw != "d130":
        assert both > 0 or m == 1


@pytest.mark.parametrize("arch,mname,shape,accum,_,tw",
                         [c for c in TRAIN if c[1] in ("f2x2", "f2x2x1")])
def test_meta_group_counts_the_fsdp_collectives(runs, arch, mname, shape,
                                                accum, _, tw):
    """The dry run's ``MetaTPGroup`` sees every collective of a rank's
    FSDP step (the gathers, their reduce-scatters, the recompute's, the
    update's): as many over ``model`` and over ``data`` as the gloo
    ranks made."""
    from repro_torch.launch import op_cost
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_tp_train_step)
    _, ranks, _ = runs
    cfg = cases.config(arch, tw)
    mesh = _mesh(shape)
    group = tpm.MetaTPGroup(shape[-1], data_size=math.prod(shape[:-1]))
    model = tpm.shard_model(op_cost.meta_model(cfg, torch.float32), cfg,
                            mesh, RULES, coord=(0,) * len(shape),
                            device="meta").set_trainable()
    state = init_opt_state(dict(model.named_parameters()), OptConfig(**OPT))
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in cases.train_batch(cfg, 0).items()}
    step = make_tp_train_step(cfg, OptConfig(**OPT), remat=True,
                              accum_steps=accum, act_spec=True, **KW)
    counter = op_cost.OpCounter()
    with counter:
        step(model, state, batch, group)
    got = ranks[0][f"{arch}{tw}/{mname}/{accum}/0/1/calls"]
    assert [group.calls, group.data_calls] == got.tolist()
    kinds = counter.coll["data"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0


def _close(got, want, tol, what, floor=0.0):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor, \
        f"{what}: {err:.3e} > {tol} x {scale:.3e} + {floor:.3e}"


@pytest.mark.parametrize("step", ("dense", "paged", "prefill"))
@pytest.mark.parametrize("mname,shape", MESHES)
@pytest.mark.parametrize("arch,tw,dname", SERVE)
def test_fsdp_serve_step_matches_reference(runs, arch, tw, dname, mname,
                                           shape, step):
    """Each rank's logits (its batch rows; every row of a paged step),
    cache and slab block against the reference's partitioned program
    on the same mesh."""
    ref, ranks, _ = runs
    data, m = shape
    cfg = cases.config(arch, tw)
    key = f"{arch}{tw}/{dname}"
    mesh = sh.MeshAxes(("data", "model"), (data, m))
    base = f"{mname}/{key}"
    exact = base.replace("/bfloat16", "/float32")
    for r in range(data * m):
        dc, n = r // m, cases.B // data
        for out in ("logits", "k", "v"):
            got = ranks[r][f"{mname}/{key}/{step}/{out}"]
            want = ref[f"{exact}/{step}/{out}"]
            mine = ref[f"{base}/{step}/{out}"]
            if out == "logits":
                sl = (slice(None) if step == "paged"
                      else slice(dc * n, (dc + 1) * n))
            else:
                axes = (tpm.SLAB_AXES if step == "paged"
                        else tf.cache_axes(cfg)[out])
                sl = sh.local_block(sh.spec_for(axes, want.shape, mesh, RULES),
                                    want.shape, mesh, (dc, r % m))
            floor = float(np.abs(mine[sl] - want[sl]).max())
            _close(got, want[sl], TOL[dname], f"rank {r} {out}", floor)


@pytest.mark.parametrize("mname,shape", MESHES)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_fsdp_serve_gathers_over_data(runs, arch, mname, shape):
    """A serve step gathers each parameter that ``data`` splits over
    ``data`` once a layer (the final norm, ``vit_proj`` and unembedding
    once; the embedding's rows take two all-gathers, the tokens and the
    rows), besides an MoE layer's routing over ``data``."""
    _, ranks, _ = runs
    cfg = cases.config(arch)
    lay = tpm.tp_layout(cfg, sh.MeshAxes(("data", "model"), tuple(shape)),
                        RULES, coord=(0, 0))
    for r in range(math.prod(shape)):
        for step in ("dense", "prefill"):
            # a decode step has no image prefix: no vit_proj
            gathers = sum(cfg.num_layers if n in tf._LAYER_PARAMS
                          else 2 if n == "embed" else 1
                          for n in lay.shapes if lay.data_dim(n) is not None
                          and not (n == "vit_proj" and step == "dense"))
            assert gathers > cfg.num_layers
            got = int(ranks[r][f"{mname}/{arch}/float32/{step}/data_calls"])
            assert got >= gathers and (got == gathers or cfg.moe), (r, step)
