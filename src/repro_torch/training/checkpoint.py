"""Fault-tolerant checkpointing: atomic, step-scoped, resumable, in the
reference's on-disk format, so a checkpoint written by either package
restores in the other.

Layout:
  <dir>/step_00000123.tmp/...   (written)
  <dir>/step_00000123/          (atomic rename commit)
  <dir>/LATEST                  (text file naming the newest committed step)

``manifest.json`` holds ``{"step", "trees": {name: entry}}``.  A tree
with no tensors (the data cursor) is ``{"kind": "json", "value"}``; a
tree of tensors is ``{"kind": "arrays", "treedef", "leaves": [{key,
file, dtype}]}`` with one ``.npy`` a leaf, bf16 stored widened to fp32
and tagged ``"bfloat16"``.  Leaf keys and their order are the
reference's pytree paths: a port parameter name maps through
``transformer._JAX_PATHS`` and ``_FAMILY_PATHS``, as ``from_jax_params``
reads them (``wq`` is ``layers/attn/wq``, ``router`` is
``layers/mlp/router``, ``lora_qa`` is ``lora/qa``), and the keys are
sorted at every level, as JAX flattens a dict.  Trees are a
``Transformer`` (its parameters), nested dicts of tensors (the
optimizer state, keyed by parameter name), or JSON values.
Restore matches leaves by key and copies each into its template leaf,
in place.  Uncommitted ``.tmp`` directories are ignored and
garbage-collected.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.models.transformer import (_FAMILY_PATHS, _JAX_PATHS,
                                            Transformer)

Path = Tuple[str, ...]

# port parameter name -> its path in the reference's pytree
_PATHS = {**_JAX_PATHS, **_FAMILY_PATHS}


def _children(tree: Any) -> Iterator[Tuple[Path, Any]]:
    """(key path, child) of a mapping or a ``Transformer``, sorted; a
    parameter name at its reference path."""
    if isinstance(tree, Transformer):
        tree = dict(tree.named_parameters())
    items = [(_PATHS.get(k, (k,)), v) for k, v in tree.items()]
    return iter(sorted(items, key=lambda kv: kv[0]))


def _walk(tree: Any, prefix: Path) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, (Mapping, Transformer)):
        for path, child in _children(tree):
            yield from _walk(child, prefix + path)
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)!r} is a "
                        f"{type(tree).__name__}, not a tensor")


def _leaves(tree: Any) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every tensor of ``tree``, in the reference's
    pytree order; two leaves at one path (which the reference, reading
    by order, would take for one) are refused."""
    out, seen = list(_walk(tree, ())), set()
    for path, _ in out:
        if path in seen:
            raise ValueError(f"two checkpoint leaves at {'/'.join(path)!r}")
        seen.add(path)
    return out


def _has_arrays(tree: Any) -> bool:
    if isinstance(tree, (torch.Tensor, Transformer)):
        return True
    return isinstance(tree, Mapping) and any(map(_has_arrays, tree.values()))


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:     # numpy has no bf16: store widened
        return leaf.float().cpu().numpy(), "bfloat16"
    arr = leaf.cpu().numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, state: Dict[str, Any], *,
                    keep: int = 3) -> str:
    """Write ``state`` ({tree name: tree}) as step ``step``, commit it by
    rename, point ``LATEST`` at it and keep the newest ``keep`` steps.
    Returns the committed directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "trees": {}}
    for tree_name, tree in state.items():
        if tree is None:
            continue
        if not _has_arrays(tree):
            manifest["trees"][tree_name] = {"kind": "json", "value": tree}
            continue
        entry = {"kind": "arrays", "treedef": type(tree).__name__,
                 "leaves": []}
        for i, (path, leaf) in enumerate(_leaves(tree)):
            fn = f"{tree_name}__{i:05d}.npy"
            arr, dtype = _to_numpy(leaf)
            np.save(os.path.join(tmp, fn), arr)
            entry["leaves"].append({"key": "/".join(path), "file": fn,
                                    "dtype": dtype})
        manifest["trees"][tree_name] = entry
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, final)                        # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # drop crashed partial writes
    for d in os.listdir(directory):
        if d.endswith(".tmp") and d.startswith("step_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _copy_into(tmpl: Any, load: Callable[[Path], np.ndarray]) -> None:
    """Copy every leaf of ``tmpl`` from ``load(path)``, in place."""
    with torch.no_grad():
        for path, leaf in _leaves(tmpl):
            arr = load(path)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {'/'.join(path)!r}: shape "
                                 f"{arr.shape}, template {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(arr))


def restore_checkpoint(directory: str, template: Dict[str, Any],
                       step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """Restore step ``step`` (default ``LATEST``) into ``template``'s
    tensors in place: each leaf matched by key and copied into its
    template leaf (its dtype and device), one leaf in host memory at a
    time, so a restore allocates no second copy of the state.  A JSON
    tree comes from the checkpoint; a tree the checkpoint lacks keeps
    its template.  Returns (step, state), state holding the template's
    own trees."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {}
    for tree_name, tmpl in template.items():
        entry = manifest["trees"].get(tree_name)
        if entry is None:
            out[tree_name] = tmpl
            continue
        if entry["kind"] == "json":
            out[tree_name] = entry["value"]
            continue
        files = {l["key"]: l["file"] for l in entry["leaves"]}
        want = {"/".join(p) for p, _ in _leaves(tmpl)}
        if want != set(files):
            raise ValueError(f"checkpoint tree {tree_name!r}: leaves "
                             f"{sorted(set(files) ^ want)} are in only one "
                             "of the checkpoint and the template")

        _copy_into(tmpl, lambda key: np.load(
            os.path.join(path, files["/".join(key)])))
        out[tree_name] = tmpl
    return manifest["step"], out
