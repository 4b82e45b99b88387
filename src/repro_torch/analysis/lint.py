"""telint static rules over the port: AST lint for the lease/clock
discipline the serving stack depends on, the reference's
``analysis/lint.py`` with its scopes on ``src/repro_torch/``.

Rules (each is a heuristic tuned to this codebase's idioms, not a
general-purpose linter — violations it cannot prove are skipped, and
pre-existing findings are grandfathered via
``src/repro_torch/analysis/baseline.json``, which is empty):

  TL001  lease leak — the result of an acquire-like call
         (``lease_slots`` / ``lease_bytes`` / ``reserve`` / ``admit`` /
         ``acquire`` / ``acquire_paged`` / ``pin_clusters``) is bound to
         a local that neither escapes the function (returned, yielded,
         stored on an owner object/container) nor is released under a
         ``try/finally`` or ``except`` cleanup path.
  TL002  wall-clock discipline — ``time.time`` / ``perf_counter`` /
         ``monotonic`` / ``process_time`` inside the deterministic core
         (serving/memory/core/obs/analysis); the event clock (and the
         injectable ``repro_torch.obs.clock`` sources) are the only
         sanctioned time reads there.
  TL004  tenant threading — lease/ticket/ledger calls that accept a
         ``tenant=`` kwarg but are called without one inside
         serving/memory, silently falling back to the untenanted
         sentinel.
  TL005  swallowed pressure — bare ``except:`` anywhere, or an
         ``except`` catching ``PoolExhausted`` / ``Exception`` /
         ``BaseException`` whose whole body is ``pass``/``...``.

The reference's TL003 (kernel-mode discipline: an ``interpret=`` kwarg
or an interpret-mode literal outside ``kernels/``) has no counterpart:
the port has no mode switch (a kernel wrapper dispatches on its
tensor's device alone), so the rule could never fire here.  Rule ids
keep the reference's numbers.

This module is **stdlib-only** (ast + dataclasses + json), as the
reference's is.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# -- rule vocabulary ---------------------------------------------------------

# method names whose return value is a lease/ticket/reservation that
# must be released (TL001) — receiver-agnostic: the repo's pool, buffer,
# admission controller and KV manager all use these names
ACQUIRE_METHODS = frozenset({
    "lease_slots", "lease_bytes", "reserve", "admit",
    "acquire", "acquire_paged", "pin_clusters",
})

# method names that release/cancel/transfer what an acquire returned
RELEASE_METHODS = frozenset({
    "release", "release_paged", "release_pins", "unpin",
    "cancel", "commit", "drop", "drop_all", "evict_clusters",
})

WALL_CLOCK_ATTRS = frozenset({
    "time", "perf_counter", "monotonic", "process_time",
    "perf_counter_ns", "monotonic_ns", "time_ns",
})

# packages forming the deterministic core: all timing there must flow
# through the event clock (TL002 scope)
CLOCKED_PACKAGES = ("serving/", "memory/", "core/", "obs/", "analysis/")

# the one sanctioned wall-time source (``repro_torch.obs.clock``);
# launch entry points, which measure REAL decode/train wall time by design,
# are outside CLOCKED_PACKAGES
WALL_CLOCK_ALLOWLIST = ("obs/clock.py",)

# methods that accept ``tenant=`` and mis-attribute to the untenanted
# sentinel when it is dropped (TL004) — scope: serving/ + memory/
TENANT_METHODS = frozenset({
    "lease_slots", "lease_bytes", "reserve", "admit",
    "acquire", "acquire_paged",
})
TENANT_PACKAGES = ("serving/", "memory/")


@dataclass(frozen=True)
class LintViolation:
    """One finding: ``key`` (rule/path/symbol/detail) is what the
    ratchet baseline matches on — stable across line-number drift."""

    rule: str
    path: str          # repo-relative posix path
    line: int
    symbol: str        # enclosing function qualname ("" = module level)
    detail: str        # what triggered (name/attr), part of the key
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym} {self.message}"


def _call_method_name(call: ast.Call) -> Optional[str]:
    """``obj.meth(...)`` -> ``meth``; plain ``meth(...)`` -> ``meth``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _names_in(node: ast.AST) -> Iterable[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id


def _call_arg_names(call: ast.Call) -> set:
    """Names appearing in a call's arguments (NOT its receiver — a
    shared receiver like ``pool`` must not key the registry excuse)."""
    out: set = set()
    for arg in list(call.args) + [k.value for k in call.keywords]:
        out.update(_names_in(arg))
    return out


# -- TL001: lease leak -------------------------------------------------------


class _FuncLeaseAudit:
    """Per-function escape/release analysis for acquire-bound locals."""

    def __init__(self, func: ast.AST, path: str, symbol: str):
        self.func = func
        self.path = path
        self.symbol = symbol
        # name -> (line, acquire method) for locals bound to an acquire
        self.acquired: Dict[str, Tuple[int, str]] = {}
        # names that escape the function (returned / yielded / stored on
        # an owner object or container — ownership transferred)
        self.escaped: set = set()
        # names released under a protected path (finally/except body)
        self.protected: set = set()
        # names appearing anywhere in a release-method call
        self.released: set = set()
        # loop-target aliases: ``for m, pins in zip(keys, hit_pins)``
        # makes a release of ``pins`` credit ``hit_pins`` too
        self.alias: Dict[str, set] = {}
        # argument names of each acquire call, per bound local — the
        # keyed-registry idiom: ``buffer.pin_clusters(m, cs)`` registers
        # the lease under key ``m`` and a *protected* ``buffer.unpin(m)``
        # drops it by key, so the lease object itself need not be named
        self.acquire_args: Dict[str, set] = {}
        # argument names of release calls on protected paths (keys)
        self.protected_args: set = set()
        # acquire calls whose result is discarded outright
        self.discarded: List[Tuple[int, str, set]] = []
        # target -> names its value was built from: ``res = R(lease=l)``
        # transfers ownership of ``l`` wherever ``res`` escapes to
        self.built_from: Dict[str, set] = {}

    def run(self) -> List[LintViolation]:
        body = getattr(self.func, "body", [])
        for stmt in body:
            self._scan_stmt(stmt, protected=False)
        # transitive escape: a name wrapped into an escaping object
        # (constructor arg, tuple member) escaped with it
        todo = list(self.escaped)
        while todo:
            for src in self.built_from.get(todo.pop(), ()):
                if src not in self.escaped:
                    self.escaped.add(src)
                    todo.append(src)
        out = [LintViolation(
            rule="TL001", path=self.path, line=line, symbol=self.symbol,
            detail=f"discard:{meth}",
            message=f"result of `.{meth}(...)` is discarded — the lease "
                    f"cannot be released on failure paths")
            for line, meth, args in self.discarded
            if not (args & self.protected_args)]
        for name, (line, meth) in self.acquired.items():
            if name in self.escaped or name in self.protected:
                continue
            if self.acquire_args.get(name, set()) & self.protected_args:
                # keyed-registry idiom: a protected release drops the
                # lease by the key it was acquired under
                continue
            if name in self.released:
                msg = (f"`{name}` from `.{meth}(...)` is released, but "
                       f"not on exception paths (no try/finally or "
                       f"except cleanup)")
            else:
                msg = (f"`{name}` from `.{meth}(...)` is never released "
                       f"and does not escape this function")
            out.append(LintViolation(
                rule="TL001", path=self.path, line=line,
                symbol=self.symbol, detail=name, message=msg))
        return out

    # -- statement walk ------------------------------------------------------
    def _scan_stmt(self, stmt: ast.stmt, *, protected: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                      # nested defs audited separately
        if isinstance(stmt, ast.Assign):
            self._scan_assign(stmt.targets, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_assign([stmt.target], stmt.value)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            m = _call_method_name(stmt.value)
            if m in ACQUIRE_METHODS:
                self.discarded.append(
                    (stmt.lineno, m, _call_arg_names(stmt.value)))
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            # loop targets alias the iterated names for release credit
            sources = set(_names_in(stmt.iter))
            for name in _names_in(stmt.target):
                self.alias.setdefault(name, set()).update(sources)
        if isinstance(stmt, ast.Try):
            for s in stmt.body:
                self._scan_stmt(s, protected=protected)
            handler_protects = bool(stmt.finalbody) or bool(stmt.handlers)
            for h in stmt.handlers:
                for s in h.body:
                    self._scan_stmt(s, protected=True)
            for s in stmt.orelse:
                self._scan_stmt(s, protected=protected)
            for s in stmt.finalbody:
                self._scan_stmt(s, protected=True)
            # a release in an except handler only covers the failure
            # path; pair it with the success-path release recorded by
            # the plain walk — both land in self.released/_protected
            _ = handler_protects
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    self._scan_stmt(child, protected=protected)
        # expression-level scanning of this statement (calls, escapes)
        self._scan_expr_uses(stmt, protected=protected)

    def _closure(self, names: Iterable[str]) -> set:
        """Expand ``names`` through loop-target aliases (worklist)."""
        out, todo = set(), list(names)
        while todo:
            n = todo.pop()
            if n in out:
                continue
            out.add(n)
            todo.extend(self.alias.get(n, ()))
        return out

    def _scan_assign(self, targets: Sequence[ast.expr],
                     value: ast.expr) -> None:
        meth, args = None, set()
        for n in ast.walk(value):
            if isinstance(n, ast.Call):
                m = _call_method_name(n)
                if m in ACQUIRE_METHODS:
                    meth, args = m, _call_arg_names(n)
                    break
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                if meth is not None:
                    self.acquired[tgt.id] = (tgt.lineno, meth)
                    self.acquire_args.setdefault(tgt.id, set()).update(args)
                else:
                    # rebound acquires keep their audit; the new binding
                    # carries ownership of the names it was built from
                    self.built_from.setdefault(tgt.id, set()).update(
                        _names_in(value))
            elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
                # stored on an owner object/container: escapes
                for name in _names_in(value):
                    self.escaped.add(name)

    def _scan_expr_uses(self, stmt: ast.stmt, *, protected: bool) -> None:
        if isinstance(stmt, (ast.Return, ast.Expr)) \
                and isinstance(getattr(stmt, "value", None), ast.AST):
            if isinstance(stmt, ast.Return):
                for name in _names_in(stmt):
                    self.escaped.add(name)
                return
        for n in ast.walk(stmt):
            if isinstance(n, (ast.Yield, ast.YieldFrom)) and n.value:
                for name in _names_in(n.value):
                    self.escaped.add(name)
            if isinstance(n, ast.Call):
                m = _call_method_name(n)
                if m in RELEASE_METHODS:
                    arg_names = _call_arg_names(n)
                    used = set(arg_names)
                    # ``lease.release()`` form: receiver is the lease
                    if isinstance(n.func, ast.Attribute) \
                            and isinstance(n.func.value, ast.Name):
                        used.add(n.func.value.id)
                    for name in self._closure(used):
                        self.released.add(name)
                        if protected:
                            self.protected.add(name)
                    if protected:
                        self.protected_args.update(self._closure(arg_names))
                elif m in ("append", "add", "setdefault", "put"):
                    # handed to a long-lived container: ownership moves
                    for arg in list(n.args) + [k.value for k in n.keywords]:
                        for name in _names_in(arg):
                            self.escaped.add(name)


def _check_tl001(tree: ast.AST, path: str) -> List[LintViolation]:
    out: List[LintViolation] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.extend(_FuncLeaseAudit(child, path, qual).run())
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


# -- TL002: wall-clock discipline --------------------------------------------


def _check_tl002(tree: ast.AST, path: str) -> List[LintViolation]:
    if not path.startswith("src/repro_torch/"):
        return []
    rel = path[len("src/repro_torch/"):]
    if not rel.startswith(CLOCKED_PACKAGES):
        return []
    if rel in WALL_CLOCK_ALLOWLIST:
        return []
    # names imported straight from the time module count too
    from_time: set = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module == "time":
            for a in n.names:
                from_time.add(a.asname or a.name)
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        name = None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "time" and f.attr in WALL_CLOCK_ATTRS:
            name = f"time.{f.attr}"
        elif isinstance(f, ast.Name) and f.id in from_time \
                and f.id in WALL_CLOCK_ATTRS:
            name = f.id
        if name is not None:
            out.append(LintViolation(
                rule="TL002", path=path, line=n.lineno,
                symbol=_enclosing(tree, n), detail=name,
                message=f"wall-clock read `{name}()` in the deterministic "
                        f"core — inject `repro_torch.obs.clock` instead"))
    return out


# -- TL004: tenant threading -------------------------------------------------


def _check_tl004(tree: ast.AST, path: str) -> List[LintViolation]:
    if not path.startswith("src/repro_torch/"):
        return []
    rel = path[len("src/repro_torch/"):]
    if not rel.startswith(TENANT_PACKAGES):
        return []
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        m = _call_method_name(n)
        if m not in TENANT_METHODS or not isinstance(n.func, ast.Attribute):
            continue
        kws = {k.arg for k in n.keywords}
        if "tenant" in kws or None in kws:     # **kwargs may carry it
            continue
        out.append(LintViolation(
            rule="TL004", path=path, line=n.lineno,
            symbol=_enclosing(tree, n), detail=m,
            message=f"`.{m}(...)` without `tenant=` falls back to the "
                    f"untenanted sentinel — thread the requester's "
                    f"tenant through"))
    return out


# -- TL005: swallowed pressure -----------------------------------------------


def _check_tl005(tree: ast.AST, path: str) -> List[LintViolation]:
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.ExceptHandler):
            continue
        caught: List[str] = []
        if n.type is None:
            caught = ["<bare>"]
        else:
            types = (n.type.elts if isinstance(n.type, ast.Tuple)
                     else [n.type])
            for t in types:
                if isinstance(t, ast.Name):
                    caught.append(t.id)
                elif isinstance(t, ast.Attribute):
                    caught.append(t.attr)
        swallows = all(
            isinstance(s, ast.Pass)
            or (isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
            for s in n.body)
        if "<bare>" in caught:
            out.append(LintViolation(
                rule="TL005", path=path, line=n.lineno,
                symbol=_enclosing(tree, n), detail="bare-except",
                message="bare `except:` hides PoolExhausted and "
                        "KeyboardInterrupt alike — name the exception"))
        elif swallows and any(c in ("PoolExhausted", "Exception",
                                    "BaseException") for c in caught):
            what = "/".join(caught)
            out.append(LintViolation(
                rule="TL005", path=path, line=n.lineno,
                symbol=_enclosing(tree, n), detail=f"swallow:{what}",
                message=f"`except {what}` with an empty body swallows "
                        f"memory pressure — handle or re-raise"))
    return out


# -- running the rules -------------------------------------------------------

_RULES = (_check_tl001, _check_tl002, _check_tl004, _check_tl005)

_ENCLOSING_CACHE: Dict[int, Dict[int, str]] = {}


def _enclosing(tree: ast.AST, node: ast.AST) -> str:
    """Qualname of the function containing ``node`` ("" = module)."""
    cache = _ENCLOSING_CACHE.get(id(tree))
    if cache is None:
        cache = {}

        def index(parent: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(parent):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    for sub in ast.walk(child):
                        cache.setdefault(id(sub), qual)
                    index(child, f"{qual}.")
                elif isinstance(child, ast.ClassDef):
                    index(child, f"{prefix}{child.name}.")
                else:
                    index(child, prefix)

        index(tree, "")
        _ENCLOSING_CACHE[id(tree)] = cache
    return cache.get(id(node), "")


def lint_source(src: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[LintViolation]:
    """Lint one source string.  ``path`` drives the scope rules (TL002/
    TL004 only fire inside their packages); pass a repo-relative path
    like ``src/repro_torch/serving/engine.py`` to get production
    behaviour.
    ``rules`` restricts to a subset of rule ids (None = all)."""
    tree = ast.parse(src, filename=path)
    out: List[LintViolation] = []
    try:
        for rule_fn in _RULES:
            found = rule_fn(tree, path)
            if rules is not None:
                found = [v for v in found if v.rule in rules]
            out.extend(found)
    finally:
        _ENCLOSING_CACHE.pop(id(tree), None)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(paths: Sequence[str], *, repo_root: str = ".",
               rules: Optional[Sequence[str]] = None) -> List[LintViolation]:
    """Lint files given as paths relative to ``repo_root``."""
    import os
    out: List[LintViolation] = []
    for rel in paths:
        full = os.path.join(repo_root, rel)
        with open(full) as f:
            src = f.read()
        out.extend(lint_source(src, rel.replace(os.sep, "/"), rules=rules))
    return out


def lint_tree(root: str = "src/repro_torch", *, repo_root: str = ".",
              rules: Optional[Sequence[str]] = None) -> List[LintViolation]:
    """Lint every ``.py`` under ``root`` (relative to ``repo_root``)."""
    import os
    paths = []
    base = os.path.join(repo_root, root)
    for dirpath, _dirnames, filenames in os.walk(base):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                paths.append(os.path.relpath(full, repo_root))
    return lint_paths(sorted(paths), repo_root=repo_root, rules=rules)


# -- ratchet baseline --------------------------------------------------------


def load_baseline(path: str) -> Dict[str, int]:
    """Baseline file -> {violation key: grandfathered count}."""
    with open(path) as f:
        doc = json.load(f)
    assert doc.get("schema") == "telint.baseline/v1", doc.get("schema")
    return {str(k): int(v) for k, v in doc["violations"].items()}


def dump_baseline(violations: Sequence[LintViolation], path: str) -> None:
    counts: Dict[str, int] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
    with open(path, "w") as f:
        json.dump({"schema": "telint.baseline/v1",
                   "violations": dict(sorted(counts.items()))},
                  f, indent=2, sort_keys=False)
        f.write("\n")


def ratchet(violations: Sequence[LintViolation], baseline: Dict[str, int],
            ) -> Tuple[List[LintViolation], List[str]]:
    """(new violations not covered by the baseline, stale baseline keys
    that no longer fire — candidates for --update-baseline)."""
    counts: Dict[str, List[LintViolation]] = {}
    for v in violations:
        counts.setdefault(v.key, []).append(v)
    new: List[LintViolation] = []
    for key, vs in counts.items():
        allowed = baseline.get(key, 0)
        if len(vs) > allowed:
            new.extend(vs[allowed:])
    stale = [k for k, c in baseline.items()
             if len(counts.get(k, ())) < c]
    return sorted(new, key=lambda v: (v.path, v.line, v.rule)), sorted(stale)
