"""Operation-level cost of a function traced on meta tensors: the port's
counterpart of the reference's ``launch/hlo_cost.py``, named for what it
counts, since the port has no HLO.

``op_cost(fn, *args)`` runs ``fn`` on meta tensors (shapes and dtypes,
no data, nothing launched) under a ``TorchDispatchMode`` that sees every
aten op after autograd, and counts by the reference's ``_walk`` rules
(``hlo_cost.py:67-90``), op for op:

* matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``: what
  ``einsum``, ``matmul`` and ``linear`` lower to) count 2·M·N·K FLOPs
  and the bytes of both operands and the output (a bias is not an
  operand of the reference's ``dot_general``);
* gather-class ops (``index``, ``index_select``, ``gather``,
  ``embedding``) count their output's bytes;
* scatter-class ops (``index_put_``, ``index_copy_``, ``scatter``,
  ``scatter_add``, ``index_add``, and a ``copy_`` into a strict slice of
  a larger tensor, the counterpart of ``dynamic_update_slice``) count
  twice the update's bytes;
* elementwise ops, views, reductions and factories count nothing;
* collectives are not aten ops here: a tensor-parallel step traced with
  ``tensor_parallel.MetaTPGroup`` reports each one's bytes (its output's
  size, the reference's convention) through ``collective``, by mesh axis
  and kind (``OpCounter.coll``).

There are no trip counts: Python loops, backward and the recompute under
``torch.utils.checkpoint`` run, and count, as often as they run, so the
reference's scan trip-count correction has no counterpart.  The hand
-written kernels on the dry run's entry points (``flash_decode``,
``flash_decode_quant``, ``mla_decode``) take a meta branch that launches
nothing and reports its kernel's work here (``add``).

The mode also tracks live storage: the arguments' storages at the start,
then each op output's storage from its creation until it dies (a weak
reference to the storage object).  ``peak_bytes`` is the most alive at
once, the counterpart of XLA's argument + temporary sizes.

Many of PyTorch's meta kernels are Python decompositions, and a long
sequence repeats the same op on the same shapes thousands of times (an
attention chunk loop), so the mode remembers each op's output shapes,
strides and dtypes by its inputs' and makes empty outputs for a repeat
instead of running the meta kernel again.  Only ops that neither mutate
nor alias an input (by their schema, and by their outputs' storage)
are remembered; the counts are the same either way.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default}
_GATHER = {aten.index.Tensor, aten.index_select.default,
           aten.gather.default, aten.embedding.default}
# scatter-class op -> the position of its update among the arguments
_SCATTER = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2,
            aten.index_copy_.default: 3, aten.index_copy.default: 3,
            aten.scatter.src: 3, aten.scatter_.src: 3,
            aten.scatter.value: 2, aten.scatter_.value: 2,
            aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
            aten.index_add.default: 3, aten.index_add_.default: 3}

_active: List["OpCounter"] = []
# (op, the inputs' shapes, strides, dtypes and other arguments) -> the
# outputs' tree and (shape, stride, dtype) leaves, for meta inputs only
_META_OUT: Dict[tuple, tuple] = {}
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel()) * t.element_size()


def _matmul(func, args, out) -> tuple:
    """(flops, bytes) of a matmul-class op: 2·M·N·K and A + B + out."""
    a, b = (args[1], args[2]) if func in (aten.addmm.default,
                                          aten.baddbmm.default) else args[:2]
    k = a.shape[-1]
    return 2.0 * out.numel() * k, _nbytes(a) + _nbytes(b) + _nbytes(out)


_FRESH: Dict[Any, bool] = {}


def _fresh(func) -> bool:
    """``func`` neither mutates nor returns a view of an input."""
    ok = _FRESH.get(func)
    if ok is None:
        schema = func._schema
        ok = _FRESH[func] = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns)
    return ok


class _Unkeyable(Exception):
    pass


def _key(x):
    """A hashable stand-in for an op argument: a meta tensor by its
    shape, strides and dtype, a scalar with its type."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unkeyable
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_key(v) for v in x)
    if isinstance(x, _PLAIN):
        return type(x), x           # 1, 1.0 and True give other dtypes
    raise _Unkeyable


def _run(func, args, kwargs):
    """``func(*args, **kwargs)`` on meta tensors, its outputs made empty
    from ``_META_OUT`` where the same op ran on the same metadata."""
    if not _fresh(func):
        return func(*args, **kwargs)
    try:
        key = (func, _key(args), _key(tuple(kwargs.items())) if kwargs else ())
    except _Unkeyable:
        return func(*args, **kwargs)
    hit = _META_OUT.get(key)
    if hit is None:
        out = func(*args, **kwargs)
        outs, ospec = tree_flatten(out)
        ins = {id(t.untyped_storage()) for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        if any(isinstance(t, torch.Tensor) and id(t.untyped_storage()) in ins
               for t in outs):
            _FRESH[func] = False        # a view its schema does not declare
        elif all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                 for t in outs):
            _META_OUT[key] = (ospec, [(t.shape, t.stride(), t.dtype)
                                      for t in outs])
        return out
    ospec, metas = hit
    outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
            for s, st, dt in metas]
    return outs[0] if ospec.is_leaf() else tree_unflatten(outs, ospec)


def _is_slice(t: torch.Tensor) -> bool:
    """``t`` covers less than its storage: a copy into it writes a slice."""
    return _nbytes(t) < t.untyped_storage().nbytes()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes by the reference's rules and tracks live
    storage (see the module's docstring).  ``track(tree)`` adds tensors
    made before the mode was entered (the arguments) to the live set."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0.0
        self.peak = 0.0
        self._refs: Dict[int, weakref.ref] = {}
        # {mesh axis: {"all-reduce" | "all-gather": bytes}}
        self.coll: Dict[str, Dict[str, float]] = {}

    def track(self, tree: Any) -> None:
        leaves, _ = tree_flatten(tree)
        for x in leaves:
            if isinstance(x, nn.Module):
                self.track([*x.parameters(), *x.buffers()])
            elif isinstance(x, torch.Tensor):
                self._alloc(x)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = float(st.nbytes())

        def free(_ref, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, free)
        self.live += n
        self.peak = max(self.peak, self.live)

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.copy_.default and _is_slice(args[0]):
            self.bytes += 2 * _nbytes(args[1])
        out = _run(func, args, kwargs)
        if func in _MATMUL:
            self.add(*_matmul(func, args, out))
        elif func in _GATHER:
            self.bytes += _nbytes(out)
        elif func in _SCATTER:
            upd = args[_SCATTER[func]]
            self.bytes += 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                               else float(args[2].numel())   # scatter.value
                               * args[0].element_size())
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._alloc(t)
        return out

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)


def add(flops: float, nbytes: float) -> None:
    """Report work done outside aten (a kernel's meta branch) to the
    innermost active counter; nothing when none is active."""
    if _active:
        _active[-1].add(flops, nbytes)


def collective(axis: str, kind: str, nbytes: float) -> None:
    """Report a collective over mesh ``axis`` (its output's ``nbytes``)
    to the innermost active counter; nothing when none is active."""
    if _active:
        by_kind = _active[-1].coll.setdefault(axis, {})
        by_kind[kind] = by_kind.get(kind, 0.0) + nbytes


def op_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes", "peak_bytes", "coll"} of ``fn(*args, **kwargs)``
    on meta tensors (an ``nn.Module`` argument counts its parameters and
    buffers as arguments; "coll" the collectives' bytes by axis and
    kind)."""
    counter = OpCounter()
    counter.track((args, kwargs))
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak_bytes": counter.peak, "coll": counter.coll}


def meta_model(cfg, dtype: torch.dtype = torch.bfloat16,
               trainable: bool = False):
    """A ``Transformer`` of ``cfg`` with empty meta parameters (no init,
    no generator, no memory); ``trainable`` lets them take gradients."""
    from repro_torch.models import transformer as tf
    model = tf.Transformer(cfg, {n: torch.empty(s, dtype=dtype, device="meta")
                                 for n, s in tf.param_shapes(cfg).items()})
    return model.set_trainable() if trainable else model

