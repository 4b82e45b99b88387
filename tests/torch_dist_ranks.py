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
  and slab from ``shard_cache``: each rank's logits (its batch rows),
  cache and slab blocks, and the collectives a step made.  The meshes
  the size of the world are ``DeviceMesh``es; smaller ones plain groups
  of the first ranks, the layouts by coordinate.  ``meta["device"]``
  "cuda" runs every rank on card 0 (gloo takes the CUDA tensors).
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
    from torch.distributed.device_mesh import init_device_mesh

    import torch_tp_cases as cases
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as tf
    from repro_torch.serving.kv_cache import KVPageSlab

    world = dist.get_world_size()
    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for mname, (data, m) in meta["meshes"]:
        W = data * m
        if W == world:
            dm = init_device_mesh("cpu", (data, m),
                                  mesh_dim_names=("data", "model"))
            tp, mesh, mc, coord = tpm.TPGroup(mesh=dm), dm, None, None
        else:
            groups = [dist.new_group([d * m + i for i in range(m)])
                      for d in range(data)]
            mesh = sh.MeshAxes(("data", "model"), (data, m))
        if rank >= W:
            continue
        dc = rank // m
        if W != world:
            tp, mc, coord = tpm.TPGroup(groups[dc]), rank % m, (dc, rank % m)
        for arch, tw, dname in meta["cases"]:
            cfg = cases.config(arch, tw)
            dtype = getattr(torch, dname)
            key = f"{arch}{tw}"
            flat = {k[len(f"w/{key}/"):]: v for k, v in inp.items()
                    if k.startswith(f"w/{key}/")}
            x = {k[len(f"in/{key}/"):]: v for k, v in inp.items()
                 if k.startswith(f"in/{key}/")}
            model = tpm.shard_model(cases.tree(flat), cfg, mesh, rank=mc,
                                    device=dev, dtype=dtype)
            t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(
                device=dev, dtype=dt)
            n = cases.B // data
            rows = slice(dc * n, (dc + 1) * n)
            at = f"{mname}/{key}/{dname}"
            with torch.no_grad():
                cache = tpm.shard_cache({"k": t(x["k"], dtype),
                                         "v": t(x["v"], dtype)}, cfg, mesh,
                                        coord=coord)
                tp.calls = 0
                logits, cache = tf.serve_step(
                    model, cache, {"token": t(x["token"][rows]),
                                   "pos": t(x["pos"][rows])}, tp=tp)
                out[f"{at}/dense/calls"] = np.asarray(tp.calls)
                out.update({f"{at}/dense/logits": logits.float().cpu().numpy(),
                            f"{at}/dense/k": cache["k"].float().cpu().numpy(),
                            f"{at}/dense/v": cache["v"].float().cpu().numpy()})
                slab = tpm.shard_cache(KVPageSlab(
                    k=t(x["k_slab"], dtype), v=t(x["v_slab"], dtype),
                    page_size=cases.PS), cfg, mesh, coord=coord)
                logits, ks, vs = tf.serve_step_paged(
                    model, slab.k, slab.v, t(x["block_table"]),
                    t(x["lengths"]), {"token": t(x["token"])}, tp=tp)
                out.update({f"{at}/paged/logits": logits.float().cpu().numpy(),
                            f"{at}/paged/k": ks.float().cpu().numpy(),
                            f"{at}/paged/v": vs.float().cpu().numpy()})
                pin = {"tokens": t(x["tokens"][rows])}
                if "image_embeds" in x:
                    pin["image_embeds"] = t(x["image_embeds"][rows], dtype)
                tp.calls = 0
                logits, cache = tf.prefill(model, pin, attn_chunk=4, tp=tp)
                out[f"{at}/prefill/calls"] = np.asarray(tp.calls)
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


JOBS = {"distributed": job_distributed, "dp_train": job_dp_train,
        "search": job_search, "tp_serve": job_tp_serve}


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
