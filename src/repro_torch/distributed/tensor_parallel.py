"""Tensor parallelism over a mesh's ``model`` axis for the serve steps:
the program that the reference's GSPMD partitioner makes of
``serve_step``, ``prefill`` and ``serve_step_paged`` under its sharding
rules (``RULES_DEFAULT``: heads, kv_heads, mlp, experts and vocab over
``model``), written out by hand.

A rank holds the ``sharding.local_block`` of every parameter that
``spec_for`` gives it over the ``model`` axis (``shard_model``), and the
layers work on those blocks:

* attention on the rank's query heads and KV heads (kernels 1 and 4 at
  the local head counts), the row-parallel ``wo`` product all-reduced;
* the MLP column-parallel in ``w_up``/``w_gate``, row-parallel in
  ``w_down``, all-reduced;
* MoE experts split (the rank runs its experts, the fp32 combine
  all-reduced before its one cast) or, where the experts do not divide,
  the expert MLP split as a plain MLP;
* the embedding a masked lookup of the rank's vocabulary rows, then an
  all-reduce; the unembedding column-parallel, then an all-gather of the
  logits.

The layout is whatever ``spec_for`` gives, so a dim that does not divide
stays whole: granite-20b's single KV head (every rank computes the K/V
and holds the whole cache), a vocabulary that does not divide (no
collective at either end), internvl2-1b's 14 heads over 4 or 8 ranks
(attention whole on every rank, no all-reduce after ``wo``).  Where the
query heads split but the KV heads stay whole (KVH 8 over 16 ranks),
the rank's heads belong to a subset of the KV groups: its queries are
placed at their global positions in a zeroed [KVH, G] layout over the
whole cache, and only its heads' rows are kept, so query head ``h``
attends KV head ``h // G`` as unsharded.

Collectives (``TPGroup``; the wire dtype is the activations', as the
reference's partitioned program sends them, but for the MoE combine,
which is fp32 until its one cast):

* ``all_reduce_sum``: after ``wo``, after ``w_down`` or the MoE combine
  (and arctic's dense residual), once each a layer where the dim splits;
* ``TPRank.embed_lookup``: the masked lookup then ``all_reduce_sum``;
* ``all_gather_last``: the logits [..., V / model] to [..., V].

``MetaTPGroup`` makes none of them: it returns a tensor of the right
shape and hands the collective's bytes (its output's size, the
reference's convention) to ``launch.op_cost``, for the dry run.

Training (``entry="train_step"``, gradients on) runs the same layers
with Megatron's pair of autograd functions around those collectives
(``TPRank.copy`` and ``TPRank.reduce``): "f", identity forward and
all-reduce backward, wherever a replicated tensor enters split
computation (the layer input before the split projections; the whole
K and V where the query heads split and the KV heads do not; the MoE
gates before the split combine), and "g", all-reduce forward and
identity backward, after ``wo``, ``w_down`` and the MoE combine.  The
masked embedding lookup's backward reaches the rank's vocabulary rows
alone; ``all_gather_last``'s backward is the rank's slice of the
gradient (``TPRank.gather_last``), ``split_last`` its inverse; the loss
is vocabulary-parallel (``TPRank.nll``: the max and the exp-sum
all-reduced, the target's logit from the rank that holds it).

A group may also carry the mesh's ``data`` axis (``TPGroup(data=...)``,
or a ``DeviceMesh`` with a ``data`` dim; on a ("pod", "data", "model")
mesh the ranks of both, pod-major, as the batch splits over them): an
MoE layer then routes its dispatch groups as the reference's global
program does across data shards (``models/moe.py``), and a train step
sums its token counts, loss and gradients over ``data``.

FSDP (``RULES_FSDP``: ``embed`` over ``("data", "pod")`` on top of the
``model`` split) is the same program over blocks split twice: a rank
holds ``local_block`` of every parameter over the whole mesh (the
``embed`` dim data-major over ``data`` x ``pod``, where it divides;
whole where it does not, as the reference's divisibility pass keeps
it), and ``TPRank.whole`` all-gathers a parameter's ``data`` blocks
into its ``model`` block where the layers use it: a layer (or a remat
group, whose backward's recompute gathers again) at a time, the final
norm, ``vit_proj`` and the unembedding once a step.  The embedding's
table is not gathered: every data shard's tokens are, and each rank
looks up its columns of all their rows (``TPRank.embed_lookup``).  The
gather's backward is a reduce-scatter (``_GatherData``):
each rank gets its block of the gradient summed over ``data``, so a
train step all-reduces over ``data`` only the parameters ``data`` does
not split.  Bytes a gather moves: the whole ``model`` block out of
every rank (the output's size, the reference's convention); its
reduce-scatter's: the whole ``model`` block's gradient in
(``MetaTPGroup`` counts the input's size).  Moments follow the
parameters' blocks (``shard_opt_state``).

Not here (``check_tp_supported`` raises): gemma2's rings and split
cache, MLA, RWKV6, zamba2, ``kv_seq`` over ``model`` in a decode or
train step (sequence-parallel KV), weights split over an axis other
than ``model``, ``data`` and ``pod`` (or one dim split over ``model``
and another axis at once), and a decode step with gradients on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd

AXIS = "model"
# the paged slab [L, NP, ps, KVH, Dh], split as the dense cache's heads
SLAB_AXES = ("layers", None, None, "kv_heads", None)
ENTRIES = ("serve_step", "serve_step_paged", "prefill", "train_step")
DATA = "data"
# the mesh axes a parameter may split over besides ``model`` (FSDP)
DATA_AXES = ("data", "pod")


def _model_mesh(size: int) -> shd.MeshAxes:
    return shd.MeshAxes((AXIS,), (size,))


def _split(entry, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The axes of a spec entry that really split (size above 1)."""
    return tuple(a for a in shd._entry_axes(entry) if sizes[a] > 1)


def model_size(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one)."""
    return shd._sizes(mesh).get(AXIS, 1)


def check_tp_supported(cfg: ArchConfig, mesh, rules: shd.Rules = shd.RULES_DEFAULT,
                       *, entry: str = "serve_step", grad: bool = False) -> None:
    """Raise unless ``entry`` of ``cfg`` has a tensor-parallel program
    here under ``rules`` on ``mesh``: a global-causal or plainly windowed
    GQA/MQA decoder (dense MLP or MoE, an image prefix or codebooks),
    its weights split over ``model`` and, FSDP's, over ``data`` and
    ``pod`` (a parameter's one dim over every one of those of the mesh
    above 1, no dim over ``model`` and another axis), gradients only in
    a train step, and for a decode or train step KV not split along the
    sequence (a prefill returns the rank's block of its cache whatever
    splits it)."""
    from repro_torch.models import transformer as tf
    if entry not in ENTRIES:
        raise ValueError(f"no tensor-parallel program for {entry!r} "
                         f"({', '.join(ENTRIES)})")
    if grad and entry != "train_step":
        raise ValueError(f"a tensor-parallel {entry} runs without gradients "
                         "(torch.no_grad); gradients belong to train_step")
    kind = tf.family_kind(cfg)
    why = None
    if kind != "attn":
        why = f"the {kind} family"
    elif cfg.attn_kind != "gqa":
        why = f"{cfg.attn_kind} attention"
    elif cfg.local_global_pattern and cfg.sliding_window:
        why = "gemma2's local rings and split cache"
    if why:
        raise ValueError(f"arch {cfg.name!r}: no tensor-parallel program for "
                         f"{why} (GQA/MQA/MoE decoders only)")
    sizes = shd._sizes(mesh)
    for axis, rule in rules.items():
        if axis in ("batch", "kv_seq"):
            continue
        other = [a for a in shd._mesh_axes(sizes, rule)
                 if a != AXIS and a not in DATA_AXES]
        if other:
            raise ValueError(f"rules split {axis!r} over {other}: weights "
                             "sharded over an axis other than model, data "
                             "and pod have no program")
    data_axes = tuple(a for a in sizes if a != AXIS and sizes[a] > 1)
    for name, spec in shd.param_shardings(cfg, mesh, rules).items():
        split = [_split(e, sizes) for e in spec]
        over = [ax for ax in split if set(ax) - {AXIS}]
        if (any(AXIS in ax and len(ax) > 1 for ax in split) or len(over) > 1
                or (over and set(over[0]) != set(data_axes))):
            raise ValueError(f"parameter {name!r} splits as {spec} on "
                             f"{dict(sizes)}: a program gathers one dim "
                             "over every axis but model (FSDP), and no "
                             "dim over model and another axis")
    m = sizes.get(AXIS, 1)
    if m > 1 and AXIS in shd._mesh_axes(sizes, rules.get("kv_seq")):
        if entry != "prefill":
            raise ValueError("kv_seq over the model axis is sequence-parallel "
                             "KV (decode or training), which has no program")
        if cfg.num_kv_heads % m == 0:
            raise ValueError("a prefill cache split along the sequence from "
                             "K/V split along the heads needs an all-to-all, "
                             "which has no program")


@dataclass(frozen=True)
class TPLayout:
    """Which block of each parameter a rank holds: ``specs`` over the
    whole ``mesh`` (``spec_for``), the rank's ``coord`` on every axis,
    the ``model`` axis's size and the rank's coordinate there (``size``,
    ``rank``), and the ranges the layers read (its ``model`` block)."""

    size: int
    rank: int
    rules: shd.Rules
    specs: Dict[str, shd.Spec]
    shapes: Dict[str, Tuple[int, ...]]      # the whole parameters'
    mesh: shd.MeshAxes
    coord: Tuple[int, ...]

    def part(self, name: str, dim: int) -> Optional[Tuple[int, int]]:
        """[lo, hi) of parameter ``name``'s dim ``dim`` on this rank, or
        None where the dim is whole (or there is no such parameter)."""
        spec = self.specs.get(name)
        if spec is None or dim >= len(spec) or spec[dim] is None:
            return None
        sl = self.block(name)[dim]
        return sl.start, sl.stop

    def local_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The shape of each parameter's block on this rank."""
        return {n: tuple(len(range(*sl.indices(s)))
                         for sl, s in zip(self.block(n), shape))
                for n, shape in self.shapes.items()}

    def block(self, name: str) -> Tuple[slice, ...]:
        """The rank's block of parameter ``name``: both splits."""
        return shd.local_block(self.specs[name], self.shapes[name], self.mesh,
                               self.coord)

    def splits(self, name: str) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
        """Each dim of parameter ``name`` that splits over the ranks,
        with the mesh axes (above 1) it splits over, in the entry's
        order (the first major)."""
        sizes = shd._sizes(self.mesh)
        return tuple((d, _split(e, sizes)) for d, e in
                     enumerate(self.specs[name]) if _split(e, sizes))

    def model_dim(self, name: str) -> Optional[int]:
        """The dim of ``name`` split over ``model``, or None."""
        return next((d for d, ax in self.splits(name) if AXIS in ax), None)

    def data_dim(self, name: str) -> Optional[int]:
        """The dim of ``name`` split over ``data`` (and ``pod``: FSDP),
        or None where every data shard holds it whole."""
        return next((d for d, ax in self.splits(name) if AXIS not in ax),
                    None)

    def _data_block(self, at: Mapping[str, int]) -> int:
        """The index of the block along a ``data_dim`` at mesh coordinate
        ``at`` (the FSDP entry's first axis major)."""
        sizes = shd._sizes(self.mesh)
        axes = next((ax for n in self.specs for _, ax in self.splits(n)
                     if AXIS not in ax), ())
        b = 0
        for a in axes:
            b = b * sizes[a] + at[a]
        return b

    @property
    def data_block(self) -> int:
        """This rank's block index along a ``data_dim``."""
        return self._data_block(dict(zip(self.mesh.mesh_dim_names,
                                         self.coord)))

    @property
    def data_order(self) -> Tuple[int, ...]:
        """For each rank of the ``data`` group (the mesh's other axes,
        row-major in the mesh's order, as the batch splits over them),
        the index of its block along a ``data_dim``: the identity but on
        a ("pod", "data", ...) mesh, whose batch splits ``pod`` major and
        whose ``embed`` ``data`` major."""
        sizes = shd._sizes(self.mesh)
        others = [a for a in self.mesh.mesh_dim_names if a != AXIS]
        return tuple(self._data_block(dict(zip(others, at))) for at in
                     np.ndindex(*(sizes[a] for a in others)))

    # the ranges the layers read (None: whole on every rank)
    @property
    def heads(self):
        return self.part("wq", 2)

    @property
    def kv_heads(self):
        return self.part("wk", 2)

    @property
    def vocab(self):
        return self.part("embed", len(self.shapes["embed"]) - 2)

    @property
    def unembed_vocab(self):
        if "unembed" not in self.shapes:        # tied: the embedding's rows
            return self.vocab
        return self.part("unembed", len(self.shapes["unembed"]) - 1)

    @property
    def experts(self):
        return self.part("w_up", 1) if len(self.shapes["w_up"]) == 4 else None

    @property
    def mlp_split(self) -> bool:
        """The (expert) MLP's hidden dim is split: ``w_down`` all-reduces."""
        return self.part("w_up", len(self.shapes["w_up"]) - 1) is not None

    @property
    def dense_split(self) -> bool:
        return self.part("dense_w_up", 2) is not None

    @property
    def padded_heads(self) -> bool:
        """Query heads split, KV heads whole and more than one: the
        rank's queries sit in the zeroed global [KVH, G] layout."""
        return (self.heads is not None and self.kv_heads is None
                and self.shapes["wk"][2] > 1)

    @property
    def fsdp(self) -> bool:
        """Some parameter is split over ``data``: the steps gather it."""
        return any(self.data_dim(n) is not None for n in self.shapes)


def tp_layout(cfg: ArchConfig, mesh, rules: shd.Rules = shd.RULES_DEFAULT,
              rank: Optional[int] = None,
              coord: Optional[Sequence[int]] = None) -> TPLayout:
    """The layout of the rank at ``coord`` on ``mesh`` (one index a mesh
    dim); without it, of rank ``rank`` of the ``model`` axis at
    coordinate 0 on the others (default: this process's coordinate on a
    ``DeviceMesh``)."""
    from repro_torch.models import transformer as tf
    names = tuple(mesh.mesh_dim_names or ())
    whole = shd.MeshAxes(names, tuple(int(s) for s in mesh.shape))
    if coord is None:
        if rank is None and hasattr(mesh, "get_coordinate"):
            coord = mesh.get_coordinate()
        else:
            coord = [int(rank or 0) if n == AXIS else 0 for n in names]
    coord = tuple(int(c) for c in coord)
    shapes = tf.param_shapes(cfg)
    specs = shd.tree_shardings(tf.param_axes(cfg), shapes, whole, rules)
    return TPLayout(size=model_size(mesh),
                    rank=coord[names.index(AXIS)] if AXIS in names else 0,
                    rules=dict(rules), specs=specs, shapes=shapes, mesh=whole,
                    coord=coord)


def local_kv_heads(cfg: ArchConfig, mesh, rules: shd.Rules = shd.RULES_DEFAULT
                   ) -> int:
    """KV heads a rank's cache holds: KVH / model where they split, else
    all of them."""
    spec = shd.spec_for(SLAB_AXES, (1, 1, 1, cfg.num_kv_heads, 1),
                        _model_mesh(model_size(mesh)), rules)
    split = len(spec) > 3 and spec[3] is not None
    return cfg.num_kv_heads // model_size(mesh) if split else cfg.num_kv_heads


class TPGroup:
    """The ``model`` axis's process group: a ``DeviceMesh``'s ``model``
    dim (``TPGroup(mesh=...)``, its other dims' group too where it has
    them) or a plain group (``TPGroup(group)``, default the world), its
    rank and size, and the collectives the tensor-parallel steps make.
    ``data``: the process group through this rank of the ranks that
    share its ``model`` coordinate (None: a ``data`` axis of one), in
    the order the batch splits over them (``pod`` major on a ("pod",
    "data", "model") mesh), which an MoE layer routes over, a train step
    reduces over and FSDP gathers over.  A CUDA tensor goes to the backend
    as it is (gloo included: no copy through the host here, and none
    when a backend refuses one).  ``timed`` adds each collective's host
    seconds (the device synchronized before it starts and after it
    ends) to ``seconds``; ``calls`` counts those over ``model`` and
    ``data_calls`` those over ``data``."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None, *,
                 mesh=None, data: Optional[dist.ProcessGroup] = None,
                 timed: bool = False):
        if mesh is not None:
            group = mesh.get_group(AXIS)
            data = _data_group(mesh)
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.data = data
        self.data_rank = dist.get_rank(data) if data is not None else 0
        self.data_size = dist.get_world_size(data) if data is not None else 1
        self.timed = timed
        self.seconds = 0.0
        self.calls = 0
        self.data_calls = 0

    def _pg(self, axis: str):
        return self.group if axis == AXIS else self.data

    def _begin(self, x: torch.Tensor, axis: str) -> float:
        if axis == AXIS:
            self.calls += 1
        else:
            self.data_calls += 1
        if not self.timed:
            return 0.0
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def _end(self, x: torch.Tensor, t0: float) -> None:
        if self.timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            self.seconds += time.perf_counter() - t0

    def all_reduce_sum(self, x: torch.Tensor, axis: str = AXIS) -> torch.Tensor:
        """The sum of every rank's ``x`` over ``axis``, in place; returns
        ``x``."""
        t0 = self._begin(x, axis)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self._pg(axis))
        self._end(x, t0)
        return x

    def all_reduce_max(self, x: torch.Tensor, axis: str = AXIS) -> torch.Tensor:
        """The elementwise max of every rank's ``x``, in place."""
        t0 = self._begin(x, axis)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self._pg(axis))
        self._end(x, t0)
        return x

    def _gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        t0 = self._begin(x, axis)
        x = x.contiguous()
        n = self.size if axis == AXIS else self.data_size
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._pg(axis))
        out = torch.cat(parts, dim=dim)
        self._end(out, t0)
        return out

    def all_gather_last(self, x: torch.Tensor, axis: str = AXIS
                        ) -> torch.Tensor:
        """Every rank's ``x`` [..., n] joined in rank order along the last
        dim: [..., n * size]."""
        return self._gather(x, axis, -1)

    def all_gather_first(self, x: torch.Tensor, axis: str = DATA
                         ) -> torch.Tensor:
        """Every rank's ``x`` [n, ...] joined in rank order along the first
        dim (the ``data`` axis by default): [n * size, ...]."""
        return self._gather(x, axis, 0)

    def all_to_all_first(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk i of ``x`` [n k, ...] (along its first dim) sent to rank
        i of ``data``; returns [n k, ...], chunk j from rank j."""
        t0 = self._begin(x, DATA)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.data)
        self._end(out, t0)
        return out

    def all_gather_blocks(self, x: torch.Tensor, dim: int,
                          order: Sequence[int]) -> torch.Tensor:
        """Every ``data`` rank's block ``x`` joined along ``dim``, rank
        i's at place ``order[i]``: the whole tensor (``_join``)."""
        t0 = self._begin(x, DATA)
        n = self.data_size
        buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(buf, x.contiguous(), group=self.data)
        out = _join(buf.view((n,) + tuple(x.shape)), dim, order)
        self._end(out, t0)
        return out

    def reduce_scatter_blocks(self, x: torch.Tensor, dim: int,
                              order: Sequence[int]) -> torch.Tensor:
        """The sum of every ``data`` rank's ``x``, this rank's block of it
        along ``dim`` (the one at place ``order[data_rank]``): the
        inverse of ``all_gather_blocks``, its backward
        (``_split_blocks``)."""
        t0 = self._begin(x, DATA)
        parts = _split_blocks(x, dim, order, self.data_size)
        out = x.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out, parts.flatten(0, 1),
                                   op=dist.ReduceOp.SUM, group=self.data)
        self._end(out, t0)
        return out


def _join(buf: torch.Tensor, dim: int, order: Sequence[int]) -> torch.Tensor:
    """The whole tensor from ``buf`` [n, *block] (rank i's block at
    ``buf[i]``, its place ``order[i]``): a view of ``buf`` where the
    blocks split dim 0 in rank order, else one copy."""
    n = buf.shape[0]
    if list(order) != list(range(n)):
        at = {b: i for i, b in enumerate(order)}
        buf = buf[[at[b] for b in range(n)]]
    shape = list(buf.shape[1:])
    shape[dim] *= n
    return buf.movedim(0, dim).reshape(shape)


def _split_blocks(x: torch.Tensor, dim: int, order: Sequence[int],
                  n: int) -> torch.Tensor:
    """``x``'s ``n`` blocks along ``dim`` stacked [n, *block] in rank
    order (rank i's the one at place ``order[i]``): a view of ``x``
    where the blocks split dim 0 in rank order, else one copy."""
    shape = list(x.shape)
    shape[dim] //= n
    parts = x.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0)
    if list(order) != list(range(n)):
        parts = parts[list(order)]
    return parts.contiguous()


def _data_group(mesh) -> Optional[dist.ProcessGroup]:
    """The group of a ``DeviceMesh``'s ranks that share this rank's
    ``model`` coordinate (its one other dim's, or, over several, one
    made by ``new_group`` in the mesh's row-major order; every rank
    makes each), or None where it has no other dim."""
    names = list(mesh.mesh_dim_names or ())
    others = [n for n in names if n != AXIS]
    if not others:
        return None
    if len(others) == 1:
        return mesh.get_group(others[0])
    ranks = mesh.mesh
    if AXIS in names:
        ranks = ranks.movedim(names.index(AXIS), -1)
    ranks = ranks.reshape(-1, ranks.shape[-1] if AXIS in names else 1)
    me, mine = dist.get_rank(), None
    for col in ranks.T.tolist():
        g = dist.new_group(col)
        if me in col:
            mine = g
    return mine


def masked_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  lo: Optional[int]) -> torch.Tensor:
    """``table`` [n, d] (or [c, n, d] with ``tokens`` [..., c]: one table a
    codebook, giving [..., c, d]) at the rows of ``tokens`` - lo that
    fall in [0, n), zeros elsewhere (so backward reaches only those
    rows); ``lo`` None: the whole vocabulary, no mask."""
    n = table.shape[-2]
    local = tokens.long() - (lo or 0)
    if lo is not None:
        ok = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
    if table.dim() == 2:
        rows = table[local]
    else:
        rows = torch.stack([table[c][local[..., c]]
                            for c in range(table.shape[0])], dim=-2)
    if lo is None:
        return rows
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


class MetaTPGroup:
    """A ``TPGroup`` of ``size`` ranks (and a ``data`` axis of
    ``data_size``) that makes no call: each collective returns a tensor
    of its result's shape (an all-reduce its input) and hands its bytes,
    the output's size as the reference counts a collective, to
    ``launch.op_cost.collective`` under its axis (``data`` ones under
    ``data_axis``, the mesh axes the batch crosses, "pod+data" on a
    multi-pod mesh); backward's collectives are counted as they run."""

    def __init__(self, size: int, rank: int = 0, data_size: int = 1,
                 data_axis: str = DATA):
        self.size, self.rank = size, rank
        self.data, self.data_rank, self.data_size = None, 0, data_size
        self.data_axis = data_axis
        self.seconds, self.calls, self.data_calls, self.timed = 0.0, 0, 0, False

    def _count(self, kind: str, out: torch.Tensor, axis: str) -> None:
        from repro_torch.launch import op_cost
        if axis == AXIS:
            self.calls += 1
        else:
            self.data_calls += 1
            axis = self.data_axis
        op_cost.collective(axis, kind, float(out.numel()) * out.element_size())

    def all_reduce_sum(self, x: torch.Tensor, axis: str = AXIS) -> torch.Tensor:
        self._count("all-reduce", x, axis)
        return x

    all_reduce_max = all_reduce_sum

    def all_gather_last(self, x: torch.Tensor, axis: str = AXIS
                        ) -> torch.Tensor:
        n = self.size if axis == AXIS else self.data_size
        out = x.new_empty(tuple(x.shape[:-1]) + (x.shape[-1] * n,))
        self._count("all-gather", out, axis)
        return out

    def all_gather_first(self, x: torch.Tensor, axis: str = DATA
                         ) -> torch.Tensor:
        n = self.size if axis == AXIS else self.data_size
        out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
        self._count("all-gather", out, axis)
        return out

    def all_to_all_first(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        self._count("all-to-all", out, DATA)
        return out

    def all_gather_blocks(self, x: torch.Tensor, dim: int,
                          order: Sequence[int]) -> torch.Tensor:
        buf = x.new_empty((self.data_size,) + tuple(x.shape))
        out = _join(buf, dim, order)        # TPGroup's buffer and copy
        self._count("all-gather", out, DATA)
        return out

    def reduce_scatter_blocks(self, x: torch.Tensor, dim: int,
                              order: Sequence[int]) -> torch.Tensor:
        self._count("reduce-scatter", x, DATA)
        parts = _split_blocks(x, dim, order, self.data_size)
        return x.new_empty(parts.shape[1:])


Group = Union[TPGroup, MetaTPGroup]


class _Copy(torch.autograd.Function):
    """Megatron's "f": identity forward, the gradient all-reduced over
    ``axis`` backward."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(
            g.clone(memory_format=torch.contiguous_format), ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": all-reduce over ``axis`` forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group, axis):
        return group.all_reduce_sum(x.clone(memory_format=torch.contiguous_format),
                                    axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim over ``model``; backward the rank's
    slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.all_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


class _GatherData(torch.autograd.Function):
    """FSDP's gather: a parameter's ``data`` blocks all-gathered along
    ``dim`` into its ``model`` block; backward each rank's block of the
    gradient summed over ``data`` (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim, order):
        ctx.group, ctx.dim, ctx.order = group, dim, order
        return group.all_gather_blocks(x, dim, order)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter_blocks(g, ctx.dim, ctx.order), \
            None, None, None


def _data_rows(x: torch.Tensor, group, order: Sequence[int]) -> torch.Tensor:
    """[T, ..., d]: this data rank's T tokens' whole rows, from ``x`` [D T,
    ..., d / D] on every data rank, its column block of every data
    shard's rows (the shards' tokens in rank order): shard j's T rows
    sent to rank j (an all-to-all), the blocks received joined."""
    D = group.data_size
    mine = group.all_to_all_first(x).view((D, x.shape[0] // D)
                                          + tuple(x.shape[1:]))
    return _join(mine, x.dim() - 1, order)


class _DataRows(torch.autograd.Function):
    """FSDP's embedding exchange, ``_data_rows``; backward the other way:
    each data rank's column block of this shard's row gradients sent to
    it, every shard's rows of this rank's block received."""

    @staticmethod
    def forward(ctx, x, group, order):
        ctx.group, ctx.order = group, order
        return _data_rows(x, group, order)

    @staticmethod
    def backward(ctx, g):
        parts = _split_blocks(g, g.dim() - 1, ctx.order, ctx.group.data_size)
        return ctx.group.all_to_all_first(parts.flatten(0, 1)), None, None


class _SplitLast(torch.autograd.Function):
    """The rank's slice of a replicated tensor's last dim (a copy, so the
    whole tensor can be freed); backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[-1] // group.size
        return x[..., group.rank * n:(group.rank + 1) * n].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather_last(g.contiguous()), None


def _vocab_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int, group):
    """fp32 per-token NLL of logits whose last dim is the rank's vocabulary
    columns [lo, lo + n): the max and the exp-sum all-reduced over
    ``model`` (``log(sum(exp(l - max))) + max``, as the reference's
    ``logsumexp``), the target's logit taken by the rank that holds it
    and summed.  Returns (nll, the rank's softmax columns, the targets'
    local columns [..., 1], whether the rank holds each target)."""
    n = logits.shape[-1]
    m = group.all_reduce_max(logits.detach().amax(dim=-1))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m[..., None])
    s = group.all_reduce_sum(e.sum(dim=-1))
    local = labels.long() - lo
    ok = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)[..., None]
    gold = torch.where(ok, logits.gather(-1, idx)[..., 0],
                       torch.zeros((), dtype=logits.dtype, device=logits.device))
    gold = group.all_reduce_sum(gold.contiguous())
    return torch.log(s) + m - gold, e.div_(s[..., None]), idx, ok


class _VocabParallelNLL(torch.autograd.Function):
    """``_vocab_nll`` with its backward, (softmax - onehot) x grad on the
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        nll, sm, idx, ok = _vocab_nll(logits, labels, lo, group)
        ctx.save_for_backward(sm, idx, ok)
        return nll

    @staticmethod
    def backward(ctx, g):
        sm, idx, ok = ctx.saved_tensors
        grad = sm * g[..., None]
        grad.scatter_add_(-1, idx, -(g * ok)[..., None].to(grad.dtype))
        return grad, None, None, None


@dataclass(frozen=True)
class TPRank:
    """What the layers read on a rank: its ``layout`` and its ``group``.
    Each collective is the plain in-place call without gradients, and an
    autograd function (``_Copy``, ``_Reduce``, ...) where its input takes
    one."""

    layout: TPLayout
    group: Group
    # the step's batch is this rank's shard of one split over ``data`` (a
    # paged step's is its data replica's own)
    batch_over_data: bool = True

    @property
    def data_size(self) -> int:
        """The ``data`` shards the step's batch is split over."""
        return self.group.data_size if self.batch_over_data else 1

    def reduce(self, x: torch.Tensor, split, axis: str = AXIS) -> torch.Tensor:
        """Megatron's "g": ``x`` all-reduced where ``split`` (the
        contracted dim is split over the ranks), else ``x``."""
        if not split:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reduce.apply(x, self.group, axis)
        return self.group.all_reduce_sum(x, axis)

    def copy(self, x: torch.Tensor, split=True, axis: str = AXIS
             ) -> torch.Tensor:
        """Megatron's "f": ``x`` as it is, its gradient all-reduced where
        ``split`` (``x`` is replicated and enters split computation)."""
        if split and torch.is_grad_enabled() and x.requires_grad:
            return _Copy.apply(x, self.group, axis)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` [..., n] joined along the last dim;
        backward the rank's slice."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _GatherLast.apply(x, self.group)
        return self.group.all_gather_last(x)

    def split_last(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's 1 / size of a replicated ``x``'s last dim;
        backward all-gathers."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _SplitLast.apply(x, self.group)
        n = x.shape[-1] // self.group.size
        return x[..., self.group.rank * n:(self.group.rank + 1) * n].clone(
            memory_format=torch.contiguous_format)

    def whole(self, name: str, t: torch.Tensor, stacked: int = 0
              ) -> torch.Tensor:
        """Parameter ``name``'s ``model`` block from the rank's block
        ``t`` (its first ``stacked`` layer dims indexed away): all-gathered
        over ``data`` where FSDP splits it (``_GatherData`` where it takes
        a gradient), else ``t``."""
        d = self.layout.data_dim(name)
        if d is None:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _GatherData.apply(t, self.group, d - stacked,
                                     self.layout.data_order)
        return self.group.all_gather_blocks(t, d - stacked,
                                            self.layout.data_order)

    def layer(self, lp: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A layer's parameters (``Transformer.layer``), each ``whole``."""
        return {n: self.whole(n, t, 1) for n, t in lp.items()}

    def embed_lookup(self, table: torch.Tensor, tokens: torch.Tensor,
                     lo: Optional[int]) -> torch.Tensor:
        """Rows ``tokens`` (global ids) of the embedding's rank block
        ``table``, which holds rows [lo, lo + n) (``lo`` None: every row):
        ``masked_lookup``, then "g" where the vocabulary splits (each row
        is one rank's, so the sum is exact).  Under FSDP, whose block
        holds d / D columns, the rows are looked up, not the table
        gathered: every data shard's tokens all-gathered, this rank's
        columns of all their rows looked up, and each shard's rows sent
        to it and joined whole (``_DataRows``, an all-to-all each way;
        the table block's gradient from the lookup's backward): T d
        elements each way a rank of T tokens, and T d of memory, where
        the table's gather and reduce-scatter would move and hold V d
        each."""
        fsdp = self.layout.data_dim("embed") is not None
        shape = tokens.shape
        if fsdp:        # [T] (or [T, c]) tokens of every data shard
            tokens = self.group.all_gather_first(
                tokens.reshape((-1,) + tuple(shape[len(shape) - (table.dim()
                                                                 - 2):])))
        rows = self.reduce(masked_lookup(table, tokens, lo), lo is not None)
        if not fsdp:
            return rows
        order = self.layout.data_order
        if torch.is_grad_enabled() and rows.requires_grad:
            rows = _DataRows.apply(rows, self.group, order)
        else:
            rows = _data_rows(rows, self.group, order)
        return rows.reshape(tuple(shape) + (rows.shape[-1],))

    def nll(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """fp32 per-token NLL of the rank's logit columns (its block of
        the unembedding's vocabulary) against global ``labels``
        (``_VocabParallelNLL``)."""
        lo = self.layout.unembed_vocab[0]
        logits = logits.float()
        if torch.is_grad_enabled() and logits.requires_grad:
            return _VocabParallelNLL.apply(logits, labels, lo, self.group)
        return _vocab_nll(logits, labels, lo, self.group)[0]


def bind(model, tp: Optional[Group], entry: str) -> Optional[TPRank]:
    """The ``TPRank`` a step of ``model`` runs with: None for an
    unsharded model called without a group; raises for a rank's model
    without its group, a group without a rank's model, sizes that
    differ, or what ``check_tp_supported`` refuses."""
    layout = getattr(model, "tp_layout", None)
    if tp is None and layout is None:
        return None
    if tp is None or layout is None:
        raise ValueError("a rank's model (shard_model) runs with its TPGroup, "
                         "and a TPGroup with a rank's model")
    if tp.size != layout.size or tp.rank != layout.rank:
        raise ValueError(f"group rank {tp.rank} of {tp.size}, model block "
                         f"{layout.rank} of {layout.size}")
    if layout.fsdp and (tp.data_size != len(layout.data_order) or
                        layout.data_block != layout.data_order[tp.data_rank]):
        raise ValueError(f"data rank {tp.data_rank} of {tp.data_size} does "
                         "not hold the model's data block")
    check_tp_supported(model.cfg, layout.mesh, layout.rules, entry=entry,
                       grad=torch.is_grad_enabled())
    return TPRank(layout, tp, batch_over_data=entry != "serve_step_paged")


def prefill_block(layout: TPLayout, cache: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The rank's block of a prefill's K/V cache [L, B, S, KVH', Dh] as
    its rank computed it (KVH' its KV heads): as it is, but where the
    rules split ``kv_seq`` over ``model`` (every KV head on every rank,
    ``check_tp_supported``), the rank's positions of it."""
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    out = {}
    for n, t in cache.items():
        shape = list(t.shape)
        if layout.kv_heads is not None:
            shape[3] *= layout.size
        spec = shd.spec_for(axes, shape, _model_mesh(layout.size), layout.rules)
        if len(spec) > 2 and spec[2] is not None:
            t = t[:, :, shd.local_block(spec, shape, _model_mesh(layout.size),
                                        (layout.rank,))[2]]
        out[n] = t
    return out


def _leaf(src, name: str, paths) -> torch.Tensor:
    """Parameter ``name`` of a ``Transformer`` or a reference numpy tree."""
    if isinstance(src, torch.nn.Module):
        return getattr(src, name).detach()
    node = src
    for key in paths[name]:
        node = node[key]
    return torch.from_numpy(np.asarray(node))


def shard_model(src, cfg: ArchConfig, mesh,
                rules: shd.Rules = shd.RULES_DEFAULT, *,
                rank: Optional[int] = None,
                coord: Optional[Sequence[int]] = None,
                device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None):
    """The ``Transformer`` of the rank at ``coord`` on ``mesh`` (or of
    rank ``rank`` of its ``model`` axis, ``tp_layout``; default: this
    process's coordinate on a ``DeviceMesh``): each parameter's
    ``local_block`` of ``spec_for`` over the whole mesh (under FSDP
    rules split over ``data`` too), copied from ``src`` (a
    ``Transformer``, or the reference's ``init_params`` tree of numpy
    arrays as ``from_jax_params`` takes it) to ``device`` in ``dtype``
    (None: the source's).  Raises where ``check_tp_supported`` does for
    a prefill."""
    from repro_torch.models import transformer as tf
    check_tp_supported(cfg, mesh, rules, entry="prefill")
    layout = tp_layout(cfg, mesh, rules, rank, coord)
    dev = resolve_device(device)
    paths = {**tf._JAX_PATHS, **tf._FAMILY_PATHS}
    tensors = {}
    for name in layout.shapes:
        t = _leaf(src, name, paths)[layout.block(name)]
        tensors[name] = t.to(device=dev, dtype=dtype or t.dtype,
                             copy=True).contiguous()
    return tf.Transformer(cfg, tensors, layout=layout)


def shard_cache(cache, cfg: ArchConfig, mesh,
                rules: shd.Rules = shd.RULES_DEFAULT,
                coord: Optional[Sequence[int]] = None):
    """A rank's block of a dense cache ({name: tensor}, by
    ``cache_shardings``: batch over ``data``, ``kv_heads`` over
    ``model``) or of a ``KVPageSlab`` (its ``kv_heads`` split as the
    dense cache's; the free list kept).  ``coord``: the rank's
    coordinate on ``mesh`` (default this process's on a
    ``DeviceMesh``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.kv_cache import KVPageSlab
    if isinstance(cache, KVPageSlab):
        spec = shd.spec_for(SLAB_AXES, cache.k.shape, mesh, rules)
        sl = shd.local_block(spec, cache.k.shape, mesh, coord)
        return KVPageSlab(k=cache.k[sl].contiguous(), v=cache.v[sl].contiguous(),
                          page_size=cache.page_size, free=list(cache.free))
    kv_quant = any(n.endswith("_scale") for n in cache)
    axes = tf.cache_axes(cfg, kv_quant)
    out = {}
    for n, t in cache.items():
        spec = shd.spec_for(axes[n], t.shape, mesh, rules)
        out[n] = t[shd.local_block(spec, t.shape, mesh, coord)].contiguous()
    return out


def gather_cache(cache, cfg: ArchConfig, tp: TPGroup):
    """The whole cache from every rank's block over the ``model`` axis
    (``shard_cache``'s inverse there, the batch left as it is): each
    tensor of a dense cache or of a ``KVPageSlab`` that holds fewer than
    the config's KV heads, all-gathered along its ``kv_heads`` dim."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.kv_cache import KVPageSlab

    def whole(t, d):
        if t.shape[d] == cfg.num_kv_heads:
            return t
        return tp.all_gather_last(t.movedim(d, -1)).movedim(-1, d).contiguous()

    if isinstance(cache, KVPageSlab):
        d = SLAB_AXES.index("kv_heads")
        return KVPageSlab(k=whole(cache.k, d), v=whole(cache.v, d),
                          page_size=cache.page_size, free=list(cache.free))
    axes = tf.cache_axes(cfg, any(n.endswith("_scale") for n in cache))
    return {n: whole(t, axes[n].index("kv_heads")) for n, t in cache.items()}


def shard_tree(tree: Mapping[str, object], layout: TPLayout, *,
               device: DeviceLike = "cuda",
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A rank's blocks of whole arrays keyed by parameter name (tensors or
    numpy: gradients, or AdamW's moments, whose blocks follow their
    parameters' as the reference's ``opt_shardings`` do), copied to
    ``device`` in ``dtype`` (None: each array's own)."""
    dev = resolve_device(device)
    out = {}
    for name, a in tree.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        t = t[layout.block(name)]
        out[name] = t.to(device=dev, dtype=dtype or t.dtype,
                         copy=True).contiguous()
    return out


def shard_opt_state(state: Mapping[str, object], layout: TPLayout, *,
                    device: DeviceLike = "cuda") -> Dict[str, object]:
    """A rank's block of an AdamW state {"m", "v" (whole arrays by
    parameter name, ``shard_tree``), "step"}."""
    dev = resolve_device(device)
    step = state["step"]
    step = step if isinstance(step, torch.Tensor) else torch.tensor(int(step))
    return {"m": shard_tree(state["m"], layout, device=dev),
            "v": shard_tree(state["v"], layout, device=dev),
            "step": step.to(device=dev, dtype=torch.int32).clone()}


def gather_tree(blocks: Mapping[str, torch.Tensor], layout: TPLayout,
                tp: "TPGroup") -> Dict[str, torch.Tensor]:
    """``shard_tree``'s inverse: each block all-gathered along its dim
    split over ``data`` (and ``pod``), then along its dim split over
    ``model`` (whole ones as they are), for tests and checkpoints."""
    out = {}
    for name, t in blocks.items():
        t = t.detach()
        d = layout.data_dim(name)
        if d is not None:
            t = tp.all_gather_blocks(t, d, layout.data_order)
        d = layout.model_dim(name)
        if d is not None:
            t = tp.all_gather_last(t.movedim(d, -1)).movedim(-1, d)
        out[name] = t.contiguous()
    return out
