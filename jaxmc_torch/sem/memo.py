r"""Operator memoization for the reference interpreter.

TLC evaluates operator definitions by substitution, so a definition like
InnerSerial's totalOpOrder (a filtered SUBSET of opId \X opId,
tla-rust examples/SpecifyingSystems/AdvancedExamples/InnerSerial.tla:46-52)
is recomputed at every reference — and the corpus's golden runs took 17-22h
on it (testout1:59). Here every module-level operator gets a static
dependency analysis: the set of state variables its body (transitively)
reads, unprimed and primed. Evaluation results are then cached per model,
keyed by (operator, argument values, dependency-variable values) — so
totalOpOrder is computed once per distinct opQ value instead of once per
reference.

Soundness notes:
- Only "stable" closures (built once per loaded module, Loader.build) are
  memoized; LET bodies and instance-substitution closures are created per
  evaluation and are skipped.
- The store lives on the Model (Model.ctx threads it through evaluation),
  never on the closure: the same module (and its closures) can be bound by
  several models with different cfg constants.
- Anything the analysis cannot prove deterministic-in-(deps, args) marks
  the operator uncacheable: Print/PrintT (side effects), ENABLED, temporal
  and action forms, instance paths, unresolvable names. Legal TLA+ cannot
  shadow a defined operator name with a bound variable, so defs-resolution
  at analysis time matches runtime resolution.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set, Tuple

from ..front import tla_ast as A

# builtin operators with observable side effects — bodies referencing
# these are never memoized
IMPURE_BUILTINS = {"Print", "PrintT"}

# logical forms handled structurally by the evaluator (not via BUILTIN_OPS)
_LOGICAL = {"/\\", "\\/", "=>", "<=>", "\\equiv", "~", "=", "/=", "#",
            "\\in", "\\notin"}

_VALS_CAP = 1 << 20  # entries; epoch-cleared beyond this


class _Uncacheable(Exception):
    pass


class MemoStore:
    """Per-model memoization state.

    deps: id(closure) -> (closure, analysis) — the closure reference pins
          the id against reuse after garbage collection.
    analysis: (state_deps tuple, prime_deps tuple) or None (uncacheable).
    vals: (id(closure), *args, *dep values) -> cached result.
    base_defs: the model's definition table. Memoization only applies when
    evaluation runs under exactly this table — name resolution (and so the
    dependency analysis) is table-relative, and instance/LET contexts swap
    the table.
    hits/misses: cache-effectiveness counters (plain ints, incremented on
    the eval hot path) — read by the obs telemetry rollup at end of run.
    """
    __slots__ = ("deps", "vals", "base_defs", "hits", "misses")

    def __init__(self, base_defs=None):
        self.deps: Dict[int, Tuple[Any, Optional[Tuple[Tuple[str, ...],
                                                       Tuple[str, ...]]]]] = {}
        self.vals: Dict[tuple, Any] = {}
        self.base_defs = base_defs
        self.hits = 0
        self.misses = 0

    def put(self, key: tuple, val: Any) -> None:
        if len(self.vals) >= _VALS_CAP:
            self.vals.clear()
        self.vals[key] = val

    def stats(self) -> Tuple[int, int]:
        """(hits, misses) — the unit the parallel engine merges: each
        worker's forked store counts independently, and the parent folds
        the per-chunk deltas back so the end-of-run memo gauges cover
        the whole run, not just the parent's share."""
        return self.hits, self.misses

    def merge_stats(self, hits: int, misses: int) -> None:
        self.hits += hits
        self.misses += misses


def analyze_closure(clo, defs: Dict[str, Any], vars) -> Optional[
        Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """Free-state-variable analysis of a closure body.

    Returns (unprimed deps, primed deps) sorted, or None if the body is
    not safely memoizable."""
    state: Set[str] = set()
    primed: Set[str] = set()
    varset = set(vars)
    in_progress: Set[int] = set()

    def resolve_name(name: str, local: Set[str], prime_mode: bool):
        if name in local:
            return
        if name in varset:
            (primed if prime_mode else state).add(name)
            return
        if name in defs:
            walk_target(defs[name], prime_mode)
            return
        from .stdlib import BUILTIN_OPS  # late import (module cycle)
        if name in BUILTIN_OPS or name in _LOGICAL:
            if name in IMPURE_BUILTINS:
                raise _Uncacheable(name)
            return
        # unknown: would resolve through runtime bindings we cannot see
        raise _Uncacheable(name)

    def walk_target(tgt, prime_mode: bool):
        # a referenced definition: fold its own deps in
        from .eval import OpClosure, BuiltinOp  # late import
        if isinstance(tgt, OpClosure):
            if tgt.bound:
                raise _Uncacheable("closure with captured environment")
            if id(tgt) in in_progress:
                return  # RECURSIVE: deps covered by the outer walk
            in_progress.add(id(tgt))
            try:
                body = tgt.body
                local = set(tgt.params)
                if isinstance(body, A.FnConstrDef):
                    for pats, sexpr in body.binders:
                        walk(sexpr, local, prime_mode)
                        local = local | set(_pat_names(pats))
                    local.add(body.name)
                    walk(body.body, local, prime_mode)
                else:
                    walk(body, local, prime_mode)
            finally:
                in_progress.discard(id(tgt))
            return
        if isinstance(tgt, BuiltinOp):
            if tgt.name in IMPURE_BUILTINS:
                raise _Uncacheable(tgt.name)
            return
        if isinstance(tgt, A.Node):
            raise _Uncacheable("AST-valued definition")
        # plain value (cfg constant, model value, number, set...)
        return

    def _pat_names(pats):
        out = []
        for p in pats:
            if isinstance(p, str):
                out.append(p)
            else:
                out.extend(_pat_names(p))
        return out

    def walk_binders(binders, local: Set[str], prime_mode: bool) -> Set[str]:
        loc = set(local)
        for pats, sexpr in binders:
            if sexpr is not None:
                walk(sexpr, loc, prime_mode)
            loc |= set(_pat_names(pats))
        return loc

    def walk(e, local: Set[str], prime_mode: bool):
        if isinstance(e, (A.Num, A.Str, A.Bool, A.At)):
            return
        if isinstance(e, A.Ident):
            resolve_name(e.name, local, prime_mode)
            return
        if isinstance(e, A.OpApp):
            if e.path or e.name == "!sel":
                raise _Uncacheable("instance path / !sel")
            if e.name not in local and e.name not in _LOGICAL:
                resolve_name(e.name, local, prime_mode)
            for a in e.args:
                walk(a, local, prime_mode)
            return
        if isinstance(e, A.Prime):
            if prime_mode:
                raise _Uncacheable("nested prime")
            walk(e.expr, local, True)
            return
        if isinstance(e, A.FnApp):
            walk(e.fn, local, prime_mode)
            for a in e.args:
                walk(a, local, prime_mode)
            return
        if isinstance(e, A.Dot):
            walk(e.expr, local, prime_mode)
            return
        if isinstance(e, (A.TupleExpr, A.SetEnum)):
            for x in e.items:
                walk(x, local, prime_mode)
            return
        if isinstance(e, A.SetFilter):
            walk(e.set, local, prime_mode)
            loc = local | set(_pat_names([e.var]))
            walk(e.pred, loc, prime_mode)
            return
        if isinstance(e, A.SetMap):
            loc = walk_binders(e.binders, local, prime_mode)
            walk(e.expr, loc, prime_mode)
            return
        if isinstance(e, A.FnDef):
            loc = walk_binders(e.binders, local, prime_mode)
            walk(e.body, loc, prime_mode)
            return
        if isinstance(e, A.FnSet):
            walk(e.dom, local, prime_mode)
            walk(e.rng, local, prime_mode)
            return
        if isinstance(e, (A.RecordExpr, A.RecordSet)):
            for _nm, x in e.fields:
                walk(x, local, prime_mode)
            return
        if isinstance(e, A.Except):
            walk(e.fn, local, prime_mode)
            for path, rhs in e.updates:
                for kind, item in path:
                    if kind == "idx":
                        for x in item:
                            walk(x, local, prime_mode)
                walk(rhs, local, prime_mode)
            return
        if isinstance(e, A.If):
            walk(e.cond, local, prime_mode)
            walk(e.then, local, prime_mode)
            walk(e.els, local, prime_mode)
            return
        if isinstance(e, A.Case):
            for c, v in e.arms:
                walk(c, local, prime_mode)
                walk(v, local, prime_mode)
            if e.other is not None:
                walk(e.other, local, prime_mode)
            return
        if isinstance(e, A.Let):
            loc = set(local)
            # LET RECURSIVE declarations put names in scope before their
            # definitions (textbookSnapshotIsolation.tla:647)
            for d in e.defs:
                if isinstance(d, A.RecursiveDecl):
                    loc |= {nm for nm, _arity in d.names}
            for d in e.defs:
                if isinstance(d, A.OpDef):
                    walk(d.body, loc | set(d.params), prime_mode)
                    loc.add(d.name)
                elif isinstance(d, A.FnConstrDef):
                    loc2 = set(loc)
                    for pats, sexpr in d.binders:
                        walk(sexpr, loc2, prime_mode)
                        loc2 |= set(_pat_names(pats))
                    walk(d.body, loc2 | {d.name}, prime_mode)
                    loc.add(d.name)
                elif isinstance(d, A.RecursiveDecl):
                    pass
                else:
                    raise _Uncacheable("unsupported LET unit")
            walk(e.body, loc, prime_mode)
            return
        if isinstance(e, A.Quant):
            loc = walk_binders(e.binders, local, prime_mode)
            walk(e.body, loc, prime_mode)
            return
        if isinstance(e, A.Choose):
            if e.set is not None:
                walk(e.set, local, prime_mode)
            loc = local | set(_pat_names([e.var]))
            walk(e.pred, loc, prime_mode)
            return
        if isinstance(e, A.Lambda):
            walk(e.body, local | set(e.params), prime_mode)
            return
        # temporal/action forms, ENABLED, UNCHANGED, \AA/\EE: not
        # deterministic in (deps, args) under this evaluation model
        raise _Uncacheable(type(e).__name__)

    try:
        body = clo.body
        local = set(clo.params)
        if isinstance(body, A.FnConstrDef):
            return None  # recursive fn constructors build their own memo
        walk(body, local, False)
    except _Uncacheable:
        return None
    return (tuple(sorted(state)), tuple(sorted(primed)))


def memo_key(store: MemoStore, clo, defs, ctx, args=()) -> Optional[tuple]:
    """Build the cache key for applying `clo` to `args` in `ctx`, or None
    when this call is not cacheable (non-base defs table, unknown deps,
    partial state, unhashable argument)."""
    if defs is not store.base_defs:
        return None
    ent = store.deps.get(id(clo))
    if ent is None or ent[0] is not clo:
        ent = (clo, analyze_closure(clo, defs, ctx.vars))
        store.deps[id(clo)] = ent
    an = ent[1]
    if an is None:
        return None
    sdeps, pdeps = an
    # type names ride along because Python conflates True==1/False==0 in
    # tuple equality — TLA+ treats them as different values (sem/values.py
    # _enum_key has the same guard). Nested conflation inside containers
    # remains the documented True/1 deviation.
    parts = [id(clo)]
    for a in args:
        parts.append(type(a).__name__)
        parts.append(a)
    st, pr = ctx.state, ctx.primes
    for v in sdeps:
        if st is None or v not in st:
            return None
        parts.append(type(st[v]).__name__)
        parts.append(st[v])
    for v in pdeps:
        if pr is None or v not in pr:
            return None
        parts.append(type(pr[v]).__name__)
        parts.append(pr[v])
    key = tuple(parts)
    try:
        hash(key)
    except TypeError:
        return None
    return key
