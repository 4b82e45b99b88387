"""The reference's side of the port's multi-device CPU tests, in a child
process of its own: JAX with 4 host CPU devices, so the reference's
``shard_map`` paths (``make_manual_dp_train_step``,
``sharded_device_search``) run over real device meshes.

``run(job, inputs, out, parts)`` (or ``start`` then ``wait``) starts
``python tests/torch_dist_reference.py JOB INPUTS OUT PART`` for each
part, all at once, under ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``; each reads the ``.npz`` at ``inputs`` (a JSON
``meta`` entry beside the arrays) and writes its outputs beside
``out``, which gets them all:

* ``dp_train``: the steps of each case of the part's arch (one compile
  a case, so the archs compile in parallel) from the given initial
  weights, each step's metrics and its state after (weights, moments,
  step, and the error feedback of every device, device order);
* ``search``: ``sharded_device_search`` over 2 and 4 devices;
* ``tp_serve``: each case of the part's arch (``torch_tp_cases``):
  ``serve_step``, ``prefill`` and ``serve_step_paged`` unsharded, then
  ``serve_step`` and ``prefill`` jitted under ``param_shardings`` /
  ``cache_shardings`` (batch inputs and logits over ``data``) on each
  ("data", "model") mesh of the meta, as the reference's
  ``launch/dryrun.py`` jits its serve cells, so GSPMD partitions them;
  for an fp32 case also ``serve_step(kv_quant=True)`` over the int8
  cache, jitted under the shardings of ``cache_axes(kv_quant=True)``
  as the dry run's ``kv_quant`` cells jit it;
* ``tp_train``: each case (arch, mesh, accum_steps, act_spec, and
  optionally the rule set and a ``torch_tp_cases`` tweak) of the part's
  arch: ``make_train_step`` jitted under ``param_shardings`` and the
  moments' (``opt_shardings``: the parameters'), the batch over
  ``data`` (``("pod", "data")`` on a three-axis mesh), ``act_spec``
  P(batch axes, None, "model") or None, as the dry run lowers a train
  cell; the steps from the case's weights and zero moments, each step's
  metrics and its state after;
* ``fsdp``: ``tp_serve`` of ``meta["serve"]`` and ``tp_train`` of
  ``meta["train"]`` in one child an arch, so the part's arch compiles
  its serve and train programs in one process.

A mesh is ("data", "model") or, of three sizes, ("pod", "data",
"model"), on its size's first devices.  ``meta["rules"]`` (or a train
case's sixth entry) names the rule set, ``RULES_DEFAULT`` where it
names none.  Under a named rule set ``tp_serve`` partitions every mesh
above one device (without one, only those of all four), and
``serve_step_paged`` too (the slab's K/V heads over ``model``); its
int8 step runs unless ``meta["int8"]`` is false.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def start(job: str, inputs: Path, out: Path, parts=("all",)) -> tuple:
    """Start ``job``, one child process a part; the handle ``wait`` takes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    runs = []
    for i, part in enumerate(parts):
        o, log = out.with_suffix(f".{i}.npz"), out.with_suffix(f".{i}.log")
        with open(log, "w") as f:
            runs.append((subprocess.Popen(
                [sys.executable, __file__, job, str(inputs), str(o), part],
                env=env, stdout=f, stderr=subprocess.STDOUT), o, log))
    return job, out, runs


def wait(handle: tuple, timeout: float = 300.0, merge: bool = True):
    """The outputs of every part of a started job, also saved to its
    ``out``; with ``merge`` False, the parts' file paths instead (each
    part's outputs stay in its own file, read lazily by whoever needs
    them).  A child that fails raises with its output."""
    job, out, runs = handle
    try:
        for p, _, log in runs:
            if p.wait(timeout=timeout) != 0:
                raise RuntimeError(f"reference {job} exited {p.returncode}:\n"
                                   + log.read_text()[-4000:])
    finally:
        for p, _, _ in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not merge:
        return [str(o) for _, o, _ in runs]
    merged = {}
    for _, o, _ in runs:
        with np.load(o) as f:
            merged.update(f)
    np.savez(out, **merged)
    return merged


def run(job: str, inputs: Path, out: Path, parts=("all",),
        timeout: float = 300.0) -> dict:
    """``wait(start(...))``."""
    return wait(start(job, inputs, out, parts), timeout)


def _mesh(n: int, axis: str):
    import jax
    from jax.sharding import Mesh

    from repro.launch.mesh import _axis_type_kwargs
    return Mesh(np.array(jax.devices()[:n]), (axis,), **_axis_type_kwargs(1))


def _names(shape) -> tuple:
    """A mesh's axis names: ("data", "model"), or ("pod", "data",
    "model") for three sizes."""
    return ("pod", "data", "model")[3 - len(shape):]


def _flat(tree, prefix: str) -> dict:
    """{prefix/path: array} over a nested dict of arrays."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = v
    return out


def job_dp_train(inp: dict, meta: dict, part: str) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed import init_error_feedback
    from repro.training import OptConfig, init_opt_state
    from repro.training.train_loop import make_manual_dp_train_step

    mesh = _mesh(meta["world"], "data")
    out = {}
    for arch, compress in meta["cases"]:
        if part not in ("all", arch):
            continue
        cfg = get_arch(arch).reduced()
        params: dict = {}
        for key, v in inp.items():
            if key.startswith(f"init/{arch}/"):
                node = params
                path = key.split("/")[2:]
                for name in path[:-1]:
                    node = node.setdefault(name, {})
                node[path[-1]] = jnp.asarray(v)
        opt = OptConfig(**meta["opt"])
        state = init_opt_state(params, opt)
        err = init_error_feedback(params)
        step = make_manual_dp_train_step(cfg, opt, mesh, compress=compress,
                                         **meta["kw"])
        for s in range(meta["steps"]):
            batch = {k: jnp.asarray(inp[f"batch/{arch}/{s}/{k}"])
                     for k in meta["batch_keys"][arch]}
            with mesh:
                params, state, err, m = step(params, state, err, batch)
            at = f"{arch}/{int(compress)}/{s}"
            for k in ("loss", "lr", "grad_norm"):
                out[f"{at}/{k}"] = np.asarray(m[k])
            out[f"{at}/step"] = np.asarray(state["step"])
            for name, tree in (("params", params), ("m", state["m"]),
                               ("v", state["v"])):
                out.update({k: np.asarray(v) for k, v in
                            _flat(tree, f"{at}/{name}").items()})
            for k, v in _flat(err, f"{at}/err").items():
                shards = sorted(v.addressable_shards, key=lambda sh: sh.device.id)
                out[k] = np.stack([np.asarray(sh.data) for sh in shards])
    return out


def job_search(inp: dict, meta: dict, part: str) -> dict:
    import jax.numpy as jnp

    from repro.core.hybrid_search import sharded_device_search

    out = {}
    for case in meta["cases"]:
        q = jnp.asarray(inp[f"{case}/queries"])
        pages = jnp.asarray(inp[f"{case}/pages"]).astype(jnp.bfloat16)
        ids = jnp.asarray(inp[f"{case}/page_ids"])
        mask = jnp.asarray(inp[f"{case}/page_mask"])
        for W in meta["worlds"]:
            s, i = sharded_device_search(_mesh(W, "model"), q, pages, ids, mask,
                                         k=meta["k"], axis="model")
            out[f"{case}/{W}/scores"] = np.asarray(s)
            out[f"{case}/{W}/ids"] = np.asarray(i)
    return out


def job_tp_serve(inp: dict, meta: dict, part: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import torch_tp_cases as cases
    from repro.configs import get_arch
    from repro.distributed import sharding as shd
    from repro.launch.mesh import _axis_type_kwargs
    from repro.models import transformer as tf

    named = "rules" in meta
    rules = getattr(shd, f"RULES_{meta.get('rules', 'DEFAULT')}")
    out = {}
    for arch, tw, dname in meta["cases"]:
        if part not in ("all", arch):
            continue
        cfg = cases.tweak(get_arch(arch).reduced(), tw)
        dt = getattr(jnp, dname)
        key = f"{arch}{tw}"
        params = jax.tree.map(lambda a: jnp.asarray(a).astype(dt), cases.tree(
            {k[len(f"w/{key}/"):]: v for k, v in inp.items()
             if k.startswith(f"w/{key}/")}))
        x = {k[len(f"in/{key}/"):]: v for k, v in inp.items()
             if k.startswith(f"in/{key}/")}
        cast = lambda a: jnp.asarray(a).astype(dt)

        def dense(p, c, tok, pos):
            return tf.serve_step(p, c, {"token": tok, "pos": pos}, cfg)

        def int8(p, c, tok, pos):
            return tf.serve_step(p, c, {"token": tok, "pos": pos}, cfg,
                                 kv_quant=True)

        def pf(p, tokens, img):
            pin = {"tokens": tokens}
            if img is not None:
                pin["image_embeds"] = img
            return tf.prefill(p, pin, cfg, attn_chunk=4)

        img = cast(x["image_embeds"]) if "image_embeds" in x else None
        at = f"{key}/{dname}"

        quant = dname == "float32" and meta.get("int8", True)

        def run(name, rows, fd, fp, fq=None):
            cache = {"k": cast(x["k"][:, rows]), "v": cast(x["v"][:, rows])}
            lg, c = fd(params, cache, jnp.asarray(x["token"][rows]),
                       jnp.asarray(x["pos"][rows]))
            out.update({f"{name}/dense/logits": np.asarray(lg, np.float32),
                        f"{name}/dense/k": np.asarray(c["k"], np.float32),
                        f"{name}/dense/v": np.asarray(c["v"], np.float32)})
            if fq is not None:
                cache = {n: jnp.asarray(x[f"{n}_q"][:, rows]) for n in "kv"}
                cache.update({f"{n}_scale": jnp.asarray(
                    x[f"{n}_scale"][:, rows]).astype(jnp.bfloat16)
                    for n in "kv"})
                lg, c = fq(params, cache, jnp.asarray(x["token"][rows]),
                           jnp.asarray(x["pos"][rows]))
                out[f"{name}/int8/logits"] = np.asarray(lg, np.float32)
                out.update({f"{name}/int8/{n}": np.asarray(c[n]).astype(
                    np.float32) for n in c})
            lg, c = fp(params, jnp.asarray(x["tokens"][rows]),
                       None if img is None else img[rows])
            out.update({f"{name}/prefill/logits": np.asarray(lg, np.float32),
                        f"{name}/prefill/k": np.asarray(c["k"], np.float32),
                        f"{name}/prefill/v": np.asarray(c["v"], np.float32)})

        whole = slice(None)
        run(f"whole/{at}", whole, jax.jit(dense), jax.jit(pf),
            jax.jit(int8) if quant else None)
        lg, ks, vs = jax.jit(tf.serve_step_paged, static_argnums=(6,))(
            params, cast(x["k_slab"]), cast(x["v_slab"]),
            jnp.asarray(x["block_table"]), jnp.asarray(x["lengths"]),
            {"token": jnp.asarray(x["token"])}, cfg)
        out.update({f"whole/{at}/paged/logits": np.asarray(lg, np.float32),
                    f"whole/{at}/paged/k": np.asarray(ks, np.float32),
                    f"whole/{at}/paged/v": np.asarray(vs, np.float32)})
        for mname, (data, m) in meta["meshes"]:
            if data * m == 1:
                continue
            if data * m != len(jax.devices()) and not named:
                continue
            mesh = jax.make_mesh((data, m), ("data", "model"),
                                 devices=jax.devices()[:data * m],
                                 **_axis_type_kwargs(2))
            psh = shd.param_shardings(cfg, mesh, rules)
            csh = shd.cache_shardings(cfg, mesh, cases.B, cases.S_MAX, rules)
            bsh = NamedSharding(mesh, P("data"))
            pcsh = shd.cache_shardings(cfg, mesh, cases.B, x["tokens"].shape[1]
                                       + (0 if img is None else img.shape[1]),
                                       rules)
            fd = jax.jit(dense, in_shardings=(psh, csh, bsh, bsh),
                         out_shardings=(bsh, csh))
            fp = jax.jit(pf, in_shardings=(psh, bsh, None if img is None
                                           else bsh),
                         out_shardings=(bsh, pcsh))
            fq = None
            if quant:           # the dry run's kv_quant cache shardings
                qsh = shd.tree_shardings(
                    tf.cache_axes(cfg, kv_quant=True), jax.eval_shape(
                        lambda: tf.init_cache(cfg, cases.B, cases.S_MAX,
                                              kv_quant=True)), mesh, rules)
                fq = jax.jit(int8, in_shardings=(psh, qsh, bsh, bsh),
                             out_shardings=(bsh, qsh))
            with mesh:
                run(f"{mname}/{at}", whole, fd, fp, fq)
            if not named:
                continue
            ssh = NamedSharding(mesh, shd.spec_for(
                ("layers", None, None, "kv_heads", None), x["k_slab"].shape,
                mesh, rules))
            repl = NamedSharding(mesh, P())
            fpg = jax.jit(lambda p, k, v, bt, ln, tok: tf.serve_step_paged(
                p, k, v, bt, ln, {"token": tok}, cfg),
                in_shardings=(psh, ssh, ssh, repl, repl, repl),
                out_shardings=(repl, ssh, ssh))
            with mesh:
                lg, ks, vs = fpg(params, cast(x["k_slab"]), cast(x["v_slab"]),
                                 jnp.asarray(x["block_table"]),
                                 jnp.asarray(x["lengths"]),
                                 jnp.asarray(x["token"]))
            out.update({f"{mname}/{at}/paged/{n}": np.asarray(a, np.float32)
                        for n, a in (("logits", lg), ("k", ks), ("v", vs))})
    return out


def job_tp_train(inp: dict, meta: dict, part: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import torch_tp_cases as cases
    from repro.configs import get_arch
    from repro.distributed import sharding as shd
    from repro.launch.mesh import _axis_type_kwargs
    from repro.training import OptConfig, init_opt_state
    from repro.training.train_loop import make_train_step

    out = {}
    opt = OptConfig(**meta["opt"])
    for arch, mname, shape, accum, act, *more in meta["cases"]:
        if part not in ("all", arch):
            continue
        rname, tw = more + ["DEFAULT", ""][len(more):]
        cfg = cases.tweak(get_arch(arch).reduced(), tw)
        arch = arch + tw
        params = jax.tree.map(jnp.asarray, cases.tree(
            {k[len(f"w/{arch}/"):]: v for k, v in inp.items()
             if k.startswith(f"w/{arch}/")}))
        state = init_opt_state(params, opt)
        names = _names(shape)
        mesh = jax.make_mesh(tuple(shape), names,
                             devices=jax.devices()[:int(np.prod(shape))],
                             **_axis_type_kwargs(len(shape)))
        psh = shd.param_shardings(cfg, mesh, getattr(shd, f"RULES_{rname}"))
        repl = NamedSharding(mesh, P())
        osh = {"m": psh, "v": psh, "step": repl}
        batch_axes = names[:-1] if len(names) > 2 else "data"
        bsh = NamedSharding(mesh, P(batch_axes))
        step = make_train_step(cfg, opt, remat=True, accum_steps=accum,
                               act_spec=P(batch_axes, None, "model") if act
                               else None, **meta["kw"])
        keys = sorted(k.split("/")[-1] for k in inp
                      if k.startswith(f"batch/{arch}/0/"))
        fn = jax.jit(step, in_shardings=(psh, osh, {k: bsh for k in keys}),
                     out_shardings=(psh, osh, repl))
        # placed as the step returns them, so its second call hits the cache
        params, state = jax.device_put(params, psh), jax.device_put(state, osh)
        for s in range(meta["steps"]):
            batch = {k: jax.device_put(jnp.asarray(inp[f"batch/{arch}/{s}/{k}"]),
                                       bsh) for k in keys}
            with mesh:
                params, state, metrics = fn(params, state, batch)
            at = f"{arch}/{mname}/{accum}/{s}"
            out.update({f"{at}/{k}": np.asarray(v) for k, v in metrics.items()})
            out[f"{at}/step"] = np.asarray(state["step"])
            for name, tree in (("params", params), ("m", state["m"]),
                               ("v", state["v"])):
                out.update({k: np.asarray(v) for k, v in
                            _flat(tree, f"{at}/{name}").items()})
    return out


def job_fsdp(inp: dict, meta: dict, part: str) -> dict:
    """``tp_train`` of ``meta["train"]``, then ``tp_serve`` of
    ``meta["serve"]``, for the part's arch."""
    out = job_tp_train(inp, meta["train"], part)
    out.update(job_tp_serve(inp, meta["serve"], part))
    return out


JOBS = {"dp_train": job_dp_train, "search": job_search,
        "tp_serve": job_tp_serve, "tp_train": job_tp_train,
        "fsdp": job_fsdp}


if __name__ == "__main__":
    job, inputs, out_path, part = sys.argv[1:5]
    with np.load(inputs) as f:
        arrays = dict(f)
    meta = json.loads(str(arrays.pop("meta")))
    np.savez(out_path, **JOBS[job](arrays, meta, part))
