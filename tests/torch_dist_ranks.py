"""The rank processes of the port's multi-rank CPU tests: one process a
rank over a gloo process group on the host, JAX-free.

``run(job, world, inputs, out_dir)`` starts ``world`` ranks of ``job``
(``python tests/torch_dist_ranks.py JOB RANK WORLD INIT INPUTS OUT``),
each joining one group through a ``file://`` store in ``out_dir`` (so
parallel test workers never race for a port), reading the inputs from
the ``.npz`` at ``inputs`` (a JSON ``meta`` entry beside the arrays) and
writing its results to ``OUT/JOB_RANK.npz``, and returns each rank's
results.  Jobs:

* ``distributed``: ``compressed_all_reduce`` over 1, 2 and 4 ranks
  (each case again with pieces of 7 elements), and every reduced arch's
  parameter and cache specs on two (2, 2) device meshes, each rank's
  block of an arange tensor by ``sharding.local_block`` and, where DTensor's
  placements express the spec, by ``distribute_tensor``;
* ``dp_train``: ``make_manual_dp_train_step``'s steps, each from the
  reference's state before it (read from the reference child's output);
* ``search``: ``sharded_device_search`` over 2 and 4 ranks;
* ``tp_serve``: the tensor-parallel ``serve_step``, ``serve_step_paged``
  and ``prefill`` of each case (``torch_tp_cases``) on each mesh
  ("data", "model") of the meta, each rank's model from
  ``tensor_parallel.shard_model`` of the case's weights, its dense cache
  (and, for an fp32 case, its int8 cache with the scales) and slab from
  ``shard_cache``: each rank's logits (its batch rows), cache and slab
  blocks, and the collectives a step made.  The meshes
  the size of the world are ``DeviceMesh``es; smaller ones plain groups
  of the first ranks, the layouts by coordinate.  ``meta["device"]``
  "cuda" runs every rank on card 0 (gloo takes the CUDA tensors);
* ``tp_train``: ``make_tp_train_step`` of each case (arch, mesh,
  accum_steps; optionally the rule set and a ``torch_tp_cases`` tweak)
  with ``act_spec`` off and on, each step from the reference's state
  before it (read from the reference children's files), compared there
  leaf by leaf (``job_tp_train``); ``meta["device"]`` "cuda" as
  ``tp_serve``'s;
* ``fsdp``: ``tp_serve`` of ``meta["serve"]`` then ``tp_train`` of
  ``meta["train"]`` in one spawn, both under the rule set their meta
  names (``RULES_FSDP``: the weights split over ``data`` too).

A mesh is ("data", "model") or, of three sizes, ("pod", "data",
"model"); ``meta["rules"]`` (or a train case's sixth entry) names the
rule set, ``RULES_DEFAULT`` where it names none.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run(job: str, world: int, inputs: Path, out_dir: Path,
        timeout: float = 300.0) -> list:
    """Run ``job`` on ``world`` rank processes; each rank's results (a
    dict of arrays).  A rank that fails raises with its output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = out_dir / f"{job}.pg"
    logs = [out_dir / f"{job}_{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, job, str(r), str(world),
                     str(init), str(inputs), str(out_dir)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            if p.wait(timeout=timeout) != 0:
                raise RuntimeError(f"rank {r} of {job} exited {p.returncode}:\n"
                                   + logs[r].read_text()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(out_dir / f"{job}_{r}.npz")) for r in range(world)]


def _block(block, full) -> list:
    """[start, shape] of ``block`` inside the arange tensor ``full``, or
    None where ``block`` is not a rectangular slice of it."""
    import torch
    start = list(np.unravel_index(int(block.flatten()[0]), tuple(full.shape)))
    start = [int(s) for s in start]
    sl = tuple(slice(s, s + n) for s, n in zip(start, block.shape))
    return [start, list(block.shape)] if torch.equal(block, full[sl]) else None


def job_distributed(rank: int, inp: dict, meta: dict) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer

    out = {}
    groups = {W: dist.new_group(list(range(W))) for W in meta["worlds"]}
    for W, group in groups.items():
        if rank >= W:
            continue
        for pieces in (0, 7):                 # whole leaves, then pieces of 7
            g = {n: torch.from_numpy(inp[f"car/{W}/{rank}/g/{n}"]).to(
                getattr(torch, dt)) for n, dt in meta["dtypes"].items()}
            e = {n: torch.from_numpy(inp[f"car/{W}/{rank}/e/{n}"]).clone()
                 for n in meta["dtypes"]}
            saved = optimizer.PIECE
            optimizer.PIECE = pieces or saved
            try:
                g_hat, e_new = comp.compressed_all_reduce(g, e, group)
            finally:
                optimizer.PIECE = saved
            assert e_new is e
            for n in meta["dtypes"]:
                out[f"car/{W}/{pieces}/g/{n}"] = g_hat[n].numpy()
                out[f"car/{W}/{pieces}/e/{n}"] = e_new[n].numpy()

    blocks = {}
    for mname, (shape, names, rules) in meta["meshes"].items():
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
        rules = getattr(sh, rules)
        for arch in list_archs():
            cfg = get_arch(arch).reduced()
            trees = {"params": (sh.param_shardings(cfg, mesh, rules),
                                tf.param_shapes(cfg))}
            for kq in (False, True):
                shapes = {n: s for n, (s, _) in
                          tf.cache_shapes(cfg, 4, 16, kv_quant=kq).items()}
                trees[f"cache{int(kq)}"] = (sh.tree_shardings(
                    tf.cache_axes(cfg, kq), shapes, mesh, rules), shapes)
            for tname, (specs, shapes) in trees.items():
                for n, spec in specs.items():
                    full = torch.arange(math.prod(shapes[n]),
                                        dtype=torch.float64).reshape(shapes[n])
                    local = full[sh.local_block(spec, full.shape, mesh)]
                    rec = {"spec": spec, "local": _block(local, full)}
                    try:
                        pl = sh.placements(spec, mesh)
                    except ValueError:
                        rec["dtensor"] = "refused"
                    else:
                        rec["dtensor"] = _block(distribute_tensor(
                            full, mesh, pl, src_data_rank=None).to_local(), full)
                    blocks[f"{mname}/{arch}/{tname}/{n}"] = rec
    out["blocks"] = np.array(json.dumps(blocks))
    return out


def job_dp_train(rank: int, inp: dict, meta: dict) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.models import transformer as tf
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_manual_dp_train_step)

    ref = np.load(meta["reference"])
    paths = {**tf._JAX_PATHS, **tf._FAMILY_PATHS}
    out = {}
    for arch, compress in meta["cases"]:
        cfg = get_arch(arch).reduced()
        tree: dict = {}
        for name in tf.param_shapes(cfg):
            node = tree
            for key in paths[name][:-1]:
                node = node.setdefault(key, {})
            node[paths[name][-1]] = inp[f"init/{arch}/{'/'.join(paths[name])}"]
        model = tf.from_jax_params(tree, cfg, device="cpu").set_trainable()
        opt = OptConfig(**meta["opt"])
        params = dict(model.named_parameters())
        state = init_opt_state(params, opt)
        err = init_error_feedback(params)
        step = make_manual_dp_train_step(cfg, opt, compress=compress,
                                         **meta["kw"])
        case = f"{arch}/{int(compress)}"
        for s in range(meta["steps"]):
            if s:       # from the reference's state after the step before
                before = f"{case}/{s - 1}"
                with torch.no_grad():
                    for n, p in params.items():
                        path = "/".join(paths[n])
                        p.copy_(torch.from_numpy(ref[f"{before}/params/{path}"]))
                        for k in ("m", "v"):
                            state[k][n].copy_(torch.from_numpy(
                                ref[f"{before}/{k}/{path}"]))
                        err[n].copy_(torch.from_numpy(
                            ref[f"{before}/err/{path}"][rank]))
                state["step"].fill_(int(ref[f"{before}/step"]))
            batch = {k: torch.from_numpy(inp[f"batch/{arch}/{s}/{k}"])
                     for k in meta["batch_keys"][arch]}
            model, state, err, m = step(model, state, err, batch)
            at = f"{case}/{s}"
            for k in ("loss", "lr", "grad_norm"):
                out[f"{at}/{k}"] = np.asarray(float(m[k]))
            same = True
            for n, p in params.items():
                mine = p.detach().clone()
                dist.broadcast(mine, src=0)
                same &= torch.equal(mine, p.detach())
                out[f"{at}/err/{n}"] = err[n].numpy().copy()
                if rank == 0:
                    out[f"{at}/params/{n}"] = p.detach().numpy().copy()
                    out[f"{at}/grad/{n}"] = p.grad.float().numpy().copy()
            out[f"{at}/same_as_rank0"] = np.asarray(same)
    return out


def job_search(rank: int, inp: dict, meta: dict) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core.hybrid_search import page_shard, sharded_device_search

    groups = {W: (dist.new_group(list(range(W))) if W < meta["world"]
                  else dist.group.WORLD) for W in meta["worlds"]}
    out = {}
    for case in meta["cases"]:
        q = torch.from_numpy(inp[f"{case}/queries"])
        pages = torch.from_numpy(inp[f"{case}/pages"]).to(torch.bfloat16)
        ids = torch.from_numpy(inp[f"{case}/page_ids"])
        mask = torch.from_numpy(inp[f"{case}/page_mask"])
        for W, group in groups.items():
            if rank >= W:
                continue
            sl = page_shard(pages.shape[0], group)
            s, i = sharded_device_search(q, pages[sl], ids[sl], mask[sl],
                                         k=meta["k"], group=group)
            out[f"{case}/{W}/scores"] = s.numpy()
            out[f"{case}/{W}/ids"] = i.numpy()
    for W, group in groups.items():          # the refusals, on every rank
        if rank >= W:
            continue
        out[f"refused/{W}/pages"] = out[f"refused/{W}/mask"] = np.asarray(False)
        try:
            page_shard(W * 3 + 1, group)
        except ValueError:
            out[f"refused/{W}/pages"] = np.asarray(True)
        try:
            sharded_device_search(q, pages[:2], ids[:2],
                                  torch.ones((q.shape[0], 2), dtype=torch.bool),
                                  k=meta["k"], group=group)
        except ValueError:
            out[f"refused/{W}/mask"] = np.asarray(True)
    return out


def job_tp_serve(rank: int, inp: dict, meta: dict) -> dict:
    import torch
    import torch.distributed as dist

    import torch_tp_cases as cases
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as tf
    from repro_torch.serving.kv_cache import KVPageSlab

    world = dist.get_world_size()
    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    rules = getattr(sh, f"RULES_{meta.get('rules', 'DEFAULT')}")
    out = {}
    for mname, (data, m) in meta["meshes"]:
        W = data * m
        tp, coord = _groups(rank, world, (data, m))
        if tp is None:
            continue
        mesh = sh.MeshAxes(("data", "model"), (data, m))
        dc = coord[0]
        for arch, tw, dname in meta["cases"]:
            cfg = cases.config(arch, tw)
            dtype = getattr(torch, dname)
            key = f"{arch}{tw}"
            flat = {k[len(f"w/{key}/"):]: v for k, v in inp.items()
                    if k.startswith(f"w/{key}/")}
            x = {k[len(f"in/{key}/"):]: v for k, v in inp.items()
                 if k.startswith(f"in/{key}/")}
            model = tpm.shard_model(cases.tree(flat), cfg, mesh, rules,
                                    coord=coord, device=dev, dtype=dtype)
            t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(
                device=dev, dtype=dt)
            n = cases.B // data
            rows = slice(dc * n, (dc + 1) * n)
            at = f"{mname}/{key}/{dname}"
            with torch.no_grad():
                cache = tpm.shard_cache({"k": t(x["k"], dtype),
                                         "v": t(x["v"], dtype)}, cfg, mesh,
                                        rules, coord=coord)
                tp.calls = tp.data_calls = 0
                logits, cache = tf.serve_step(
                    model, cache, {"token": t(x["token"][rows]),
                                   "pos": t(x["pos"][rows])}, tp=tp)
                out[f"{at}/dense/calls"] = np.asarray(tp.calls)
                out[f"{at}/dense/data_calls"] = np.asarray(tp.data_calls)
                out.update({f"{at}/dense/logits": logits.float().cpu().numpy(),
                            f"{at}/dense/k": cache["k"].float().cpu().numpy(),
                            f"{at}/dense/v": cache["v"].float().cpu().numpy()})
                if dname == "float32" and meta.get("int8", True):
                    # the int8 cache, its scales split
                    qc = {n: t(x[f"{n}_q"]) for n in "kv"}
                    qc.update({f"{n}_scale": t(x[f"{n}_scale"], torch.bfloat16)
                               for n in "kv"})
                    qc = tpm.shard_cache(qc, cfg, mesh, rules, coord=coord)
                    logits, qc = tf.serve_step(
                        model, qc, {"token": t(x["token"][rows]),
                                    "pos": t(x["pos"][rows])}, kv_quant=True,
                        tp=tp)
                    out[f"{at}/int8/logits"] = logits.float().cpu().numpy()
                    out.update({f"{at}/int8/{n}": v.float().cpu().numpy()
                                for n, v in qc.items()})
                slab = tpm.shard_cache(KVPageSlab(
                    k=t(x["k_slab"], dtype), v=t(x["v_slab"], dtype),
                    page_size=cases.PS), cfg, mesh, rules, coord=coord)
                logits, ks, vs = tf.serve_step_paged(
                    model, slab.k, slab.v, t(x["block_table"]),
                    t(x["lengths"]), {"token": t(x["token"])}, tp=tp)
                out.update({f"{at}/paged/logits": logits.float().cpu().numpy(),
                            f"{at}/paged/k": ks.float().cpu().numpy(),
                            f"{at}/paged/v": vs.float().cpu().numpy()})
                pin = {"tokens": t(x["tokens"][rows])}
                if "image_embeds" in x:
                    pin["image_embeds"] = t(x["image_embeds"][rows], dtype)
                tp.calls = tp.data_calls = 0
                logits, cache = tf.prefill(model, pin, attn_chunk=4, tp=tp)
                out[f"{at}/prefill/calls"] = np.asarray(tp.calls)
                out[f"{at}/prefill/data_calls"] = np.asarray(tp.data_calls)
                out.update({f"{at}/prefill/logits": logits.float().cpu().numpy(),
                            f"{at}/prefill/k": cache["k"].float().cpu().numpy(),
                            f"{at}/prefill/v": cache["v"].float().cpu().numpy()})
            if W == world:      # the whole cache back from every rank's block
                full = tpm.gather_cache({"k": cache["k"]}, cfg, tp)["k"]
                out[f"{at}/prefill/gathered_k"] = full.float().cpu().numpy()
                slab = tpm.gather_cache(KVPageSlab(k=ks, v=vs,
                                                   page_size=cases.PS), cfg, tp)
                out[f"{at}/paged/gathered_k"] = slab.k.float().cpu().numpy()
    return out


class _Parts:
    """The arrays of several ``.npz`` files by key, each read when asked
    for."""

    def __init__(self, paths):
        self.files = [np.load(p) for p in paths]
        self.where = {k: f for f in self.files for k in f.files}

    def __getitem__(self, key: str) -> np.ndarray:
        return self.where[key][key]


def _names(shape) -> tuple:
    """A mesh's axis names: ("data", "model"), or ("pod", "data",
    "model") for three sizes."""
    return ("pod", "data", "model")[3 - len(shape):]


def _groups(rank: int, world: int, shape):
    """This rank's ``TPGroup`` on a mesh of ``shape`` (``_names``; a
    ``DeviceMesh`` the size of the world; plain groups of the first
    ranks of a ("data", "model") mesh otherwise) and its coordinate,
    or (None, None) off the mesh.  Every rank makes every group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tensor_parallel as tpm
    W = math.prod(shape)
    if W == world:
        dm = init_device_mesh("cpu", tuple(shape),
                              mesh_dim_names=_names(shape))
        return tpm.TPGroup(mesh=dm), tuple(
            int(c) for c in np.unravel_index(rank, tuple(shape)))
    data, m = shape
    mg = [dist.new_group([d * m + i for i in range(m)]) for d in range(data)]
    dg = [dist.new_group([d * m + i for d in range(data)]) for i in range(m)]
    if rank >= W:
        return None, None
    dc, mc = rank // m, rank % m
    return tpm.TPGroup(mg[dc], data=dg[mc] if data > 1 else None), (dc, mc)


def _wait_for(ready: str, failed: str, timeout: float = 900.0) -> None:
    """Block until the file ``ready`` exists; raise if ``failed`` does
    first, or after ``timeout`` seconds."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(ready):
        if os.path.exists(failed):
            raise RuntimeError("the reference failed")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {ready} after {timeout} s")
        time.sleep(0.2)


def job_tp_train(rank: int, inp: dict, meta: dict) -> dict:
    """Each case's steps with ``act_spec`` off and on, each from the
    reference's state before it (its weights and zero moments first).
    Step 0 of every case runs first: it needs only the weights, so it
    runs while the reference still computes; then, where
    ``meta["ready"]`` names a file, the rank waits for it (the
    reference's parts written; ``meta["failed"]`` if the reference
    failed) before it compares step 0 and runs the later steps.
    A rank saves its metrics and, leaf by leaf, the largest difference
    of its parameter, m and v blocks from the reference's blocks (the
    parameters' over the elements whose gradient is 0 or at least 1e-4
    of the leaf's max-abs, and how many are not), and whether the two
    ``act_spec`` runs agree to the bit, and the elements of its
    parameter and moment blocks."""
    import torch

    import torch_tp_cases as cases
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as tf
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_tp_train_step)

    world = torch.distributed.get_world_size()
    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    paths = {**tf._JAX_PATHS, **tf._FAMILY_PATHS}
    opt = OptConfig(**meta["opt"])
    groups, todo = {}, []
    for arch, mname, shape, accum, _, *more in meta["cases"]:
        rname, tw = more + ["DEFAULT", ""][len(more):]
        if mname not in groups:         # every rank makes every group
            groups[mname] = _groups(rank, world, shape)
        tp, coord = groups[mname]
        if tp is not None:
            todo.append((arch + tw, mname, accum, tp, coord,
                         cases.config(arch, tw),
                         sh.MeshAxes(_names(shape), tuple(shape)),
                         getattr(sh, f"RULES_{rname}")))
    out = {}

    def run(case, s, ref):
        """Step ``s`` of ``case`` with ``act_spec`` off and on: {act:
        (model, state, metrics)}."""
        arch, mname, accum, tp, coord, cfg, mesh, rules = case
        pnames = tf.param_shapes(cfg)
        before = f"{arch}/{mname}/{accum}/{s - 1}"
        whole = ({n: ref[f"{before}/params/{'/'.join(paths[n])}"]
                  for n in pnames} if s else
                 {n: inp[f"w/{arch}/{'/'.join(paths[n])}"] for n in pnames})
        batch = {k[len(f"batch/{arch}/{s}/"):]: torch.from_numpy(v).to(dev)
                 for k, v in inp.items() if k.startswith(f"batch/{arch}/{s}/")}
        runs = {}
        for act in (False, True):
            model = tpm.shard_model(cases.tree({"/".join(paths[n]): a
                                                for n, a in whole.items()}),
                                    cfg, mesh, rules, coord=coord,
                                    device=dev).set_trainable()
            if s:
                state = tpm.shard_opt_state(
                    {k: {n: ref[f"{before}/{k}/{'/'.join(paths[n])}"]
                         for n in pnames} for k in ("m", "v")}
                    | {"step": int(ref[f"{before}/step"])}, model.tp_layout,
                    device=dev)
            else:
                state = init_opt_state(dict(model.named_parameters()), opt)
            step_fn = make_tp_train_step(cfg, opt, remat=True,
                                         accum_steps=accum, act_spec=act,
                                         **meta["kw"])
            tp.calls = tp.data_calls = 0
            model, state, met = step_fn(model, state, batch, tp)
            runs[act] = (model, state, met, [tp.calls, tp.data_calls])
        return runs

    def compare(case, s, runs, ref):
        arch, mname, accum, tp, _, cfg, _, _ = case
        at = f"{arch}/{mname}/{accum}/{s}"
        for act, (model, state, met, calls) in runs.items():
            key = f"{at}/{int(act)}"
            lay = model.tp_layout
            for k, v in met.items():
                out[f"{key}/{k}"] = np.asarray(float(v))
            out[f"{key}/calls"] = np.asarray(calls)
            grads = tpm.gather_tree({n: p.grad for n, p in
                                     model.named_parameters()}, lay, tp)
            for n, p in model.named_parameters():
                path = "/".join(paths[n])
                blk = lay.block(n)
                gmax = float(grads[n].abs().max())
                g = p.grad.abs()
                sure = (g == 0) | (g >= 1e-4 * gmax)
                want = torch.from_numpy(ref[f"{at}/params/{path}"][blk]).to(dev)
                err_p = float((p.detach() - want).abs()[sure].max()) \
                    if sure.any() else 0.0
                row = [err_p, float((~sure).sum()), float(sure.numel())]
                for k in ("m", "v"):
                    full = ref[f"{at}/{k}/{path}"]
                    w = torch.from_numpy(full[blk]).to(dev)
                    row += [float((state[k][n] - w).abs().max()),
                            float(np.abs(full).max())]
                out[f"{key}/leaf/{n}"] = np.asarray(row)
        (m0, s0, r0, _), (m1, s1, r1, _) = runs[False], runs[True]
        same = all(torch.equal(a, b) for a, b in
                   zip(m0.parameters(), m1.parameters()))
        same &= all(torch.equal(s0[k][n], s1[k][n]) for k in ("m", "v")
                    for n in tf.param_shapes(cfg))
        same &= all(float(r0[k]) == float(r1[k]) for k in r0)
        out[f"{at}/act_same"] = np.asarray(same)
        out[f"{at}/numel"] = np.asarray(
            [[p.numel(), s0["m"][n].numel(), s0["v"][n].numel()]
             for n, p in m0.named_parameters()])

    first = [run(case, 0, None) for case in todo]
    if meta.get("ready"):
        _wait_for(meta["ready"], meta["failed"])
    ref = _Parts(meta["reference"])
    for case, runs in zip(todo, first):
        compare(case, 0, runs, ref)
    del first
    for s in range(1, meta["steps"]):
        for case in todo:
            compare(case, s, run(case, s, ref), ref)
    return out


def job_fsdp(rank: int, inp: dict, meta: dict) -> dict:
    """``tp_serve`` of ``meta["serve"]`` (it needs no reference), then
    ``tp_train`` of ``meta["train"]``."""
    out = job_tp_serve(rank, inp, meta["serve"])
    out.update(job_tp_train(rank, inp, meta["train"]))
    return out


JOBS = {"distributed": job_distributed, "dp_train": job_dp_train,
        "search": job_search, "tp_serve": job_tp_serve,
        "tp_train": job_tp_train, "fsdp": job_fsdp}


def main(job: str, rank: int, world: int, init: str, inputs: str,
         out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        with np.load(inputs) as f:
            inp = dict(f)
        meta = json.loads(str(inp.pop("meta")))
        out = JOBS[job](rank, inp, meta)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"{job}_{rank}.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
