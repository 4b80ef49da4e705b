r"""Capture-aware AST substitution.

TLA+ operator application is call-by-name: Lose(msgQ) with
Lose(q) == ... q' = ... means msgQ' gets assigned
(tla-rust examples/SpecifyingSystems/TLC/AlternatingBit.tla:55-64),
and operator-constant instantiations like Send(p, d, memInt, memInt')
(CachingMemory/MemoryInterface.tla) pass a primed variable as an argument.
The enumeration walker therefore expands such applications by substituting
argument ASTs for parameters instead of evaluating eagerly.

Substitution skips occurrences shadowed by binders. (Alpha-capture of an
argument's free names by a binder inside the body is not renamed — no
corpus spec does this.)
"""

from __future__ import annotations

from typing import Dict

from . import tla_ast as A


def _names_of(pat) -> set:
    if isinstance(pat, str):
        return {pat}
    return set(pat)


def subst(e: A.Node, m: Dict[str, A.Node]) -> A.Node:
    """Substitute m's ASTs for free identifier occurrences in e."""
    if not m:
        return e
    t = type(e)
    if t is A.Ident:
        return m.get(e.name, e)
    if t in (A.Num, A.Str, A.Bool, A.At):
        return e
    if t is A.OpApp:
        # an applied operator name is not substitutable (op params are
        # first-order here); only its arguments are
        return A.OpApp(e.name, tuple(subst(a, m) for a in e.args),
                       tuple((n, tuple(subst(a, m) for a in args))
                             for n, args in e.path))
    if t is A.FnApp:
        return A.FnApp(subst(e.fn, m), tuple(subst(a, m) for a in e.args))
    if t is A.Dot:
        return A.Dot(subst(e.expr, m), e.fld)
    if t is A.TupleExpr:
        return A.TupleExpr(tuple(subst(x, m) for x in e.items))
    if t is A.SetEnum:
        return A.SetEnum(tuple(subst(x, m) for x in e.items))
    if t is A.SetFilter:
        inner = {k: v for k, v in m.items() if k not in _names_of(e.var)}
        return A.SetFilter(e.var, subst(e.set, m), subst(e.pred, inner))
    if t is A.SetMap:
        bound = set()
        new_binders = []
        for names, s in e.binders:
            new_binders.append((names, subst(s, {k: v for k, v in m.items()
                                                 if k not in bound})))
            for pat in names:
                bound |= _names_of(pat)
        inner = {k: v for k, v in m.items() if k not in bound}
        return A.SetMap(subst(e.expr, inner), tuple(new_binders))
    if t is A.FnDef:
        bound = set()
        new_binders = []
        for names, s in e.binders:
            new_binders.append((names, subst(s, {k: v for k, v in m.items()
                                                 if k not in bound})))
            for pat in names:
                bound |= _names_of(pat)
        inner = {k: v for k, v in m.items() if k not in bound}
        return A.FnDef(tuple(new_binders), subst(e.body, inner))
    if t is A.FnSet:
        return A.FnSet(subst(e.dom, m), subst(e.rng, m))
    if t is A.RecordExpr:
        return A.RecordExpr(tuple((k, subst(v, m)) for k, v in e.fields))
    if t is A.RecordSet:
        return A.RecordSet(tuple((k, subst(v, m)) for k, v in e.fields))
    if t is A.Except:
        return A.Except(subst(e.fn, m), tuple(
            (tuple(("idx", tuple(subst(i, m) for i in arg)) if k == "idx"
                   else (k, arg) for k, arg in path),
             subst(rhs, m))
            for path, rhs in e.updates))
    if t is A.If:
        return A.If(subst(e.cond, m), subst(e.then, m), subst(e.els, m))
    if t is A.Case:
        return A.Case(tuple((subst(g, m), subst(b, m)) for g, b in e.arms),
                      subst(e.other, m) if e.other is not None else None)
    if t is A.Let:
        bound = set()
        new_defs = []
        for d in e.defs:
            if isinstance(d, A.OpDef):
                inner = {k: v for k, v in m.items()
                         if k not in bound and k not in d.params}
                new_defs.append(A.OpDef(d.name, d.params,
                                        subst(d.body, inner), d.local))
                bound.add(d.name)
            elif isinstance(d, A.FnConstrDef):
                binder_names = set()
                for names, _ in d.binders:
                    for pat in names:
                        binder_names |= _names_of(pat)
                inner = {k: v for k, v in m.items()
                         if k not in bound and k not in binder_names
                         and k != d.name}
                new_defs.append(A.FnConstrDef(
                    d.name,
                    tuple((names, subst(s, {k: v for k, v in m.items()
                                            if k not in bound}))
                          for names, s in d.binders),
                    subst(d.body, inner), d.local))
                bound.add(d.name)
            else:
                new_defs.append(d)
        inner = {k: v for k, v in m.items() if k not in bound}
        return A.Let(tuple(new_defs), subst(e.body, inner))
    if t is A.Quant:
        bound = set()
        new_binders = []
        for names, s in e.binders:
            new_binders.append((names,
                                subst(s, {k: v for k, v in m.items()
                                          if k not in bound})
                                if s is not None else None))
            for pat in names:
                bound |= _names_of(pat)
        inner = {k: v for k, v in m.items() if k not in bound}
        return A.Quant(e.kind, tuple(new_binders), subst(e.body, inner))
    if t is A.Choose:
        inner = {k: v for k, v in m.items() if k not in _names_of(e.var)}
        return A.Choose(e.var,
                        subst(e.set, m) if e.set is not None else None,
                        subst(e.pred, inner))
    if t is A.Prime:
        return A.Prime(subst(e.expr, m))
    if t is A.BoxAction:
        return A.BoxAction(subst(e.action, m), subst(e.sub, m))
    if t is A.AngleAction:
        return A.AngleAction(subst(e.action, m), subst(e.sub, m))
    if t is A.Fair:
        return A.Fair(e.kind, subst(e.sub, m), subst(e.action, m))
    if t is A.Unchanged:
        return A.Unchanged(subst(e.expr, m))
    if t is A.Enabled:
        return A.Enabled(subst(e.expr, m))
    if t is A.TemporalQuant:
        inner = {k: v for k, v in m.items() if k not in e.vars}
        return A.TemporalQuant(e.kind, e.vars, subst(e.body, inner))
    if t is A.Lambda:
        inner = {k: v for k, v in m.items() if k not in e.params}
        return A.Lambda(e.params, subst(e.body, inner))
    return e


def occurs_free(e: A.Node, names) -> bool:
    """Does any of `names` occur FREE in e — as an identifier reference
    or an applied-operator name — under the same shadowing rules subst
    uses? ground.split_arms asks this before distributing a rider
    conjunct under a disjunct's binder bindings (raft's Next shape,
    tla-rust examples/raft.tla:482-493): a rider whose free names
    collide with the new bindings would be captured, so the conjunction
    then stays one arm."""
    ns = set(names)
    if not ns:
        return False

    def tup(tv, sh) -> bool:
        for x in tv:
            if isinstance(x, A.Node):
                if go(x, sh):
                    return True
            elif isinstance(x, tuple):
                if tup(x, sh):
                    return True
        return False

    def go(x, sh) -> bool:
        t = type(x)
        if t is A.Ident:
            return x.name in ns and x.name not in sh
        if t in (A.Num, A.Str, A.Bool, A.At):
            return False
        if t is A.OpApp:
            if x.name in ns and x.name not in sh:
                return True
            if any(go(a, sh) for a in x.args):
                return True
            return any(go(a, sh)
                       for _n, args in x.path for a in args)
        if t is A.SetFilter:
            return go(x.set, sh) or go(x.pred, sh | _names_of(x.var))
        if t in (A.SetMap, A.FnDef):
            bound = set()
            for bn, s in x.binders:
                if s is not None and go(s, sh | bound):
                    return True
                for pat in bn:
                    bound |= _names_of(pat)
            body = x.expr if t is A.SetMap else x.body
            return go(body, sh | bound)
        if t is A.Quant:
            bound = set()
            for bn, s in x.binders:
                if s is not None and go(s, sh | bound):
                    return True
                for pat in bn:
                    bound |= _names_of(pat)
            return go(x.body, sh | bound)
        if t is A.Choose:
            if x.set is not None and go(x.set, sh):
                return True
            return go(x.pred, sh | _names_of(x.var))
        if t is A.Let:
            bound = set()
            for d in x.defs:
                if isinstance(d, A.OpDef):
                    if go(d.body, sh | bound | set(d.params)):
                        return True
                    bound.add(d.name)
                elif isinstance(d, A.FnConstrDef):
                    bn = set()
                    for nms, s in d.binders:
                        if s is not None and go(s, sh | bound):
                            return True
                        for pat in nms:
                            bn |= _names_of(pat)
                    if go(d.body, sh | bound | bn | {d.name}):
                        return True
                    bound.add(d.name)
            return go(x.body, sh | bound)
        if t is A.Lambda:
            return go(x.body, sh | set(x.params))
        if t is A.TemporalQuant:
            return go(x.body, sh | set(x.vars))
        for f in getattr(x, "__dataclass_fields__", {}):
            v = getattr(x, f)
            if isinstance(v, A.Node):
                if go(v, sh):
                    return True
            elif isinstance(v, tuple):
                if tup(v, sh):
                    return True
        return False

    return go(e, frozenset())


_CONTAINS_PRIME_CACHE: dict = {}


def contains_prime(e: A.Node) -> bool:
    r = _CONTAINS_PRIME_CACHE.get(id(e))
    if r is not None:
        return r
    if isinstance(e, A.Prime):
        r = True
    else:
        r = False
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Node) and contains_prime(v):
                r = True
                break
            if isinstance(v, tuple) and _tuple_contains_prime(v):
                r = True
                break
    # key on id(): AST nodes are immutable and owned by the loaded module,
    # which outlives any check run; map also keeps e alive via the value
    _CONTAINS_PRIME_CACHE[id(e)] = r
    _CONTAINS_PRIME_KEEPALIVE.append(e)
    return r


_CONTAINS_PRIME_KEEPALIVE: list = []


def _tuple_contains_prime(t) -> bool:
    for x in t:
        if isinstance(x, A.Node) and contains_prime(x):
            return True
        if isinstance(x, tuple) and _tuple_contains_prime(x):
            return True
    return False


_PRIMES_PARAMS_CACHE: dict = {}
_PRIMES_PARAMS_KEEPALIVE: list = []


def primes_params(e: A.Node, params) -> bool:
    """Does e contain p' for any p in params? (Lose(q) assigns q',
    AlternatingBit.tla:55-64 — such bodies need call-by-name expansion.)"""
    ps = set(params)
    if not ps:
        return False
    ck = (id(e), tuple(sorted(ps)))
    hit = _PRIMES_PARAMS_CACHE.get(ck)
    if hit is not None:
        return hit

    def walk(x) -> bool:
        if isinstance(x, A.Prime) and isinstance(x.expr, A.Ident) \
                and x.expr.name in ps:
            return True
        for f in getattr(x, "__dataclass_fields__", {}):
            v = getattr(x, f)
            if isinstance(v, A.Node) and walk(v):
                return True
            if isinstance(v, tuple) and _tuple_walk(v):
                return True
        return False

    def _tuple_walk(t) -> bool:
        for x in t:
            if isinstance(x, A.Node) and walk(x):
                return True
            if isinstance(x, tuple) and _tuple_walk(x):
                return True
        return False

    r = walk(e)
    _PRIMES_PARAMS_CACHE[ck] = r
    _PRIMES_PARAMS_KEEPALIVE.append(e)
    return r


def contains_box(e: A.Node) -> bool:
    if isinstance(e, A.BoxAction):
        return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, A.Node) and contains_box(v):
            return True
        if isinstance(v, tuple) and _tuple_contains_box(v):
            return True
    return False


def _tuple_contains_box(t) -> bool:
    for x in t:
        if isinstance(x, A.Node) and contains_box(x):
            return True
        if isinstance(x, tuple) and _tuple_contains_box(x):
            return True
    return False
