"""Logical-axis sharding rules -> per-tensor specs, DTensor placements and
local blocks (the reference's ``distributed/sharding.py``).

Parameters and caches carry logical axis names
(``transformer.param_axes`` / ``cache_axes``); ``spec_for`` maps them
onto the axes of a mesh with the reference's two passes:
  * divisibility — a dim that does not divide by the mesh axes' size is
    replicated instead (granite-20b's single KV head under TP=16);
  * uniqueness — a mesh axis appears once a spec; the first logical dim
    that claims it wins (long-context KV: seq takes ``model``, so
    kv_heads drops to replicated).

A spec is the reference's ``PartitionSpec`` entries as a plain tuple: an
entry a tensor dim, ``None`` (replicated), a mesh axis name, or a tuple
of names (the dim split over several axes), trailing ``None``s dropped.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or a
``MeshAxes`` (names and sizes alone, for specs without a process group).

A dim split over several mesh axes is split as JAX splits it: the first
axis of the entry is the major one.  DTensor's placements split a dim
over several mesh dims in the mesh's order instead, so ``placements``
raises where the two differ (``RULES_FSDP``'s ``embed=("data", "pod")``
on a ``("pod", "data", ...)`` mesh with both axes above 1), and
``local_block`` gives the reference's block for any spec.

Rule sets:
  RULES_DEFAULT       — TP over heads/mlp/vocab/experts, DP over batch
  RULES_LONG_CONTEXT  — also kv_seq over ``model`` (sequence-parallel
                        decode for long_500k)
  RULES_FSDP          — also d_model over (data, pod): FSDP-style 2-D
                        weight sharding on top of TP
  RULES_FSDP_LONG     — both
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig

Rules = Dict[str, Any]
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

RULES_DEFAULT: Rules = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "mlp": "model",
    "experts": "model",
    "embed": None,
    "embed2": None,
    "layers": None,
    "kv_seq": None,
}

RULES_LONG_CONTEXT: Rules = dict(RULES_DEFAULT, kv_seq="model")

# FSDP-style 2-D weight sharding: d_model over the data (+pod) axes on top
# of TP (the reference trains arctic-480b this way)
RULES_FSDP: Rules = dict(RULES_DEFAULT, embed=("data", "pod"))
RULES_FSDP_LONG: Rules = dict(RULES_FSDP, kv_seq="model")


@dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names and sizes, without devices: the attributes of
    a ``DeviceMesh`` that specs read."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))


def _mesh_axes(sizes: Mapping[str, int], rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    axes = rule if isinstance(rule, tuple) else (rule,)
    return tuple(a for a in axes if a in sizes)


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Rules) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the logical
    ``axes``, under ``rules`` on ``mesh``."""
    sizes = _sizes(mesh)
    used: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        entry: Entry = None
        if ax is not None:
            maxes = tuple(a for a in _mesh_axes(sizes, rules.get(ax))
                          if a not in used)
            if maxes:
                size = math.prod(sizes[a] for a in maxes)
                if dim % size == 0 and dim > 0:
                    entry = maxes if len(maxes) > 1 else maxes[0]
                    used.update(maxes)
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_shardings(axes: Mapping[str, Sequence[Optional[str]]],
                   shapes: Mapping[str, Sequence[int]], mesh,
                   rules: Rules) -> Dict[str, Spec]:
    """Zip an axes tree with a shapes tree (both keyed by name) into a
    spec tree."""
    if set(axes) != set(shapes):
        raise ValueError(f"axes and shapes differ: {sorted(set(axes) ^ set(shapes))}")
    return {n: spec_for(axes[n], shapes[n], mesh, rules) for n in shapes}


def param_shardings(cfg: ArchConfig, mesh, rules: Rules = RULES_DEFAULT,
                    ) -> Dict[str, Spec]:
    """The spec of every parameter of ``transformer.init_params``."""
    from repro_torch.models import transformer as tf
    return tree_shardings(tf.param_axes(cfg), tf.param_shapes(cfg), mesh,
                          rules)


def cache_shardings(cfg: ArchConfig, mesh, batch: int, max_len: int,
                    rules: Rules = RULES_DEFAULT) -> Dict[str, Spec]:
    """The spec of every tensor of ``transformer.init_cache``."""
    from repro_torch.models import transformer as tf
    shapes = {n: s for n, (s, _) in
              tf.cache_shapes(cfg, batch, max_len).items()}
    return tree_shardings(tf.cache_axes(cfg), shapes, mesh, rules)


def data_sharding(mesh, *, rules: Rules = RULES_DEFAULT) -> Spec:
    """[batch, ...] arrays: batch over (pod, data), the rest replicated
    (the reference's ``P(axes)``: one entry, ``None`` on a mesh with
    neither axis)."""
    axes = _mesh_axes(_sizes(mesh), rules["batch"])
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def replicated(mesh) -> Spec:
    return ()


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` on each mesh axis that splits tensor dim ``d``, else
    ``Replicate()``.  Raises where DTensor would split a dim in another
    order than the reference (an entry of several mesh axes, above 1,
    not in the mesh's order); ``local_block`` gives that block."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names or ())
    sizes = _sizes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        split = [a for a in axes if sizes[a] > 1]
        if split != sorted(split, key=names.index):
            raise ValueError(
                f"dim {d} splits over {axes} with {axes[0]!r} major, as JAX "
                f"does; DTensor splits over mesh dims in the mesh's order "
                f"{tuple(names)}: use local_block")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def local_block(spec: Spec, shape: Sequence[int], mesh,
                coord: Optional[Sequence[int]] = None) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that ``spec`` puts at mesh
    coordinate ``coord`` (one index a mesh dim; default this rank's
    ``mesh.get_coordinate()``), as the reference's ``NamedSharding``
    does: a dim over several mesh axes splits with the entry's first
    axis major."""
    names = list(mesh.mesh_dim_names or ())
    sizes = _sizes(mesh)
    if coord is None:
        coord = mesh.get_coordinate()
    at = dict(zip(names, coord))
    out = [slice(None)] * len(shape)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        block, n = 0, 1
        for a in axes:
            block, n = block * sizes[a] + at[a], n * sizes[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {n}")
        step = shape[d] // n
        out[d] = slice(block * step, (block + 1) * step)
    return tuple(out)

