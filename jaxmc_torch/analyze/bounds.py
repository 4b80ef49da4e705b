r"""Static bounds/type inference over the TLA+ AST.

Abstract interpretation on an interval/type lattice: starting from the
cfg-bound CONSTANT values and Init's assignments, the analyzer walks the
next-state relation the way sem/enumerate.Walker does — conjunction
threads abstract assignments, disjunction joins, `v' = e` assigns an
abstract evaluation of e, `v' \in S` assigns S's element abstraction,
guards REFINE the pre-state intervals — and iterates to a fixpoint over
the transition relation, widening to ±inf when an interval keeps
growing.  The result is a per-variable summary interval covering every
integer scalar component the encoded value can hold.

Soundness contract (what compile/pack.py relies on): a variable's
summary must contain every int that can appear in ANY row the engines
encode — reachable states, their raw successors (CONSTRAINT-violating
candidates are fingerprinted before being discarded, so post-states are
NOT refined by constraints), and layout-sampler rows.  Anything the
abstract evaluator does not model precisely evaluates to TOP, and a
budget/branch-cap breach abandons the whole proof (returns no bounds)
rather than guessing.  Statically-proven lanes additionally keep the
runtime OV_PACK guard as a safety net — if a proof were ever wrong the
engine aborts exactly (naming the analyzer), never miscounts.

The same machinery answers the linter's dead-action question: an action
arm whose guards are definitely false under the fixpoint env can never
fire (analyze/lint.py JMC202).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..front import tla_ast as A
from ..sem.values import Fcn, InfiniteSet, ModelValue

# ---------------------------------------------------------------------------
# interval lattice
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Iv:
    """Integer interval; a None bound is ±infinity."""
    lo: Optional[int]
    hi: Optional[int]

    def join(self, o: "Iv") -> "Iv":
        lo = None if (self.lo is None or o.lo is None) \
            else min(self.lo, o.lo)
        hi = None if (self.hi is None or o.hi is None) \
            else max(self.hi, o.hi)
        return Iv(lo, hi)

    def bounded(self) -> bool:
        return self.lo is not None and self.hi is not None


TOP = Iv(None, None)


def _add(a, b):
    return None if a is None or b is None else a + b


def _neg(a):
    return None if a is None else -a


def iv_add(a: Iv, b: Iv) -> Iv:
    return Iv(_add(a.lo, b.lo), _add(a.hi, b.hi))


def iv_sub(a: Iv, b: Iv) -> Iv:
    return Iv(_add(a.lo, _neg(b.hi)), _add(a.hi, _neg(b.lo)))


def iv_mul(a: Iv, b: Iv) -> Iv:
    if not (a.bounded() and b.bounded()):
        return TOP
    cands = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return Iv(min(cands), max(cands))


def iv_div(a: Iv, b: Iv) -> Iv:
    # TLA \div on a positive divisor; anything else is TOP
    if not (a.bounded() and b.bounded()) or b.lo is None or b.lo < 1:
        return TOP
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            cands += [x // y, -((-x) // y)]  # floor and trunc variants
    return Iv(min(cands), max(cands))


def iv_mod(a: Iv, b: Iv) -> Iv:
    # TLA a % b with b > 0 always lands in [0, b-1]
    if b.lo is not None and b.lo >= 1:
        return Iv(0, None if b.hi is None else b.hi - 1)
    return TOP


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------
#
# AV = ("int", Iv)          integer scalar
#    | ("bool",)            boolean scalar
#    | ("enum", vals|None)  string / model value scalar; vals is the
#                           frozenset of every value it can hold (None:
#                           unknown / too many) — cardinalities feed
#                           state_space_estimate
#    | ("set", elem|None)   set; elem abstracts every member (None: empty)
#    | ("seq", elem|None)   sequence/tuple
#    | ("fun", dom, rng)    function/record; dom/rng abstract keys/values
#    | ("rec", fields)      record with KNOWN string keys: fields is a
#                           sorted tuple of (key, AV) — per-key precision
#                           through Dot/EXCEPT; degrades to
#                           "fun" on any key mismatch
#    | ("blob", Iv)         opaque value whose int components lie in Iv
#
# summary(AV) -> Iv | None: every integer scalar component anywhere in
# the value (None = the value contains no ints).

AV = Tuple
INT_TOP = ("int", TOP)
BOOL = ("bool",)
ENUM = ("enum", None)
BLOB_TOP = ("blob", TOP)

_MAX_DEPTH = 8
# enum value-set tracking cap: past this many distinct scalar values the
# set degrades to None (unknown) — joins stay O(small)
_ENUM_MAX = 64
# record width cap for per-key tracking
_REC_MAX = 32


def _enum_join(a, b):
    if a is None or b is None:
        return None
    u = a | b
    return u if len(u) <= _ENUM_MAX else None


def summary(av: Optional[AV]) -> Optional[Iv]:
    if av is None:
        return TOP
    k = av[0]
    if k == "int":
        return av[1]
    if k in ("bool", "enum"):
        return None
    if k in ("set", "seq"):
        return summary(av[1]) if av[1] is not None else None
    if k == "fun":
        return _sum_join(summary(av[1]), summary(av[2]))
    if k == "rec":
        s = None
        for _k, v in av[1]:
            s = _sum_join(s, summary(v))
        return s
    if k == "blob":
        return av[1]
    return TOP


def _sum_join(a: Optional[Iv], b: Optional[Iv]) -> Optional[Iv]:
    if a is None:
        return b
    if b is None:
        return a
    return a.join(b)


def _rec_to_fun(av: AV) -> AV:
    """Degrade a per-key record to the keyless function abstraction."""
    rng = None
    keys = []
    for k, v in av[1]:
        keys.append(k)
        rng = join(rng, v)
    return ("fun", ("enum", frozenset(keys)),
            rng if rng is not None else BLOB_TOP)


def join(a: Optional[AV], b: Optional[AV], depth: int = 0) -> AV:
    if a is None:
        return b if b is not None else BLOB_TOP
    if b is None:
        return a
    if depth > _MAX_DEPTH:
        sa, sb = summary(a), summary(b)
        s = _sum_join(sa, sb)
        return ("blob", s) if s is not None else ENUM
    ka, kb = a[0], b[0]
    if ka == "rec" and kb == "rec":
        if tuple(k for k, _ in a[1]) == tuple(k for k, _ in b[1]):
            return ("rec", tuple(
                (k, join(v, w, depth + 1))
                for (k, v), (_k2, w) in zip(a[1], b[1])))
        return join(_rec_to_fun(a), _rec_to_fun(b), depth)
    if ka == "rec":
        return join(_rec_to_fun(a), b, depth)
    if kb == "rec":
        return join(a, _rec_to_fun(b), depth)
    if ka == kb:
        if ka == "int":
            return ("int", a[1].join(b[1]))
        if ka == "bool":
            return a
        if ka == "enum":
            return ("enum", _enum_join(a[1], b[1]))
        if ka in ("set", "seq"):
            if a[1] is None:
                return b
            if b[1] is None:
                return a
            return (ka, join(a[1], b[1], depth + 1))
        if ka == "fun":
            return ("fun", join(a[1], b[1], depth + 1),
                    join(a[2], b[2], depth + 1))
        if ka == "blob":
            return ("blob", a[1].join(b[1]))
    s = _sum_join(summary(a), summary(b))
    return ("blob", s) if s is not None else ENUM


def widen(new: AV, old: AV, depth: int = 0) -> AV:
    """Widen `new` against the previous iterate `old`: any interval bound
    that moved goes to infinity (guarantees fixpoint termination)."""
    if depth > _MAX_DEPTH or new[0] != old[0]:
        s = summary(new)
        if s is None:
            return new
        so = summary(old)
        lo = s.lo if (so is not None and so.lo is not None
                      and s.lo is not None and s.lo >= so.lo) else None
        hi = s.hi if (so is not None and so.hi is not None
                      and s.hi is not None and s.hi <= so.hi) else None
        return ("blob", Iv(lo, hi))
    k = new[0]
    if k == "int" or k == "blob":
        ln, lo_ = new[1], old[1]
        wlo = ln.lo if (lo_.lo is not None and ln.lo is not None
                        and ln.lo >= lo_.lo) else None
        whi = ln.hi if (lo_.hi is not None and ln.hi is not None
                        and ln.hi <= lo_.hi) else None
        return (k, Iv(wlo, whi))
    if k == "bool":
        return new
    if k == "enum":
        # a still-growing value set widens to unknown (termination)
        if new[1] is not None and old[1] is not None \
                and new[1] <= old[1]:
            return new
        return ENUM
    if k in ("set", "seq"):
        if new[1] is None or old[1] is None:
            return new
        return (k, widen(new[1], old[1], depth + 1))
    if k == "fun":
        return ("fun", widen(new[1], old[1], depth + 1),
                widen(new[2], old[2], depth + 1))
    if k == "rec":
        if tuple(kk for kk, _ in new[1]) == \
                tuple(kk for kk, _ in old[1]):
            return ("rec", tuple(
                (kk, widen(v, w, depth + 1))
                for (kk, v), (_k2, w) in zip(new[1], old[1])))
        return widen(_rec_to_fun(new), _rec_to_fun(old), depth)
    return new


def lift_concrete(v: Any, depth: int = 0) -> AV:
    """Abstract a concrete interpreter value (cfg constants, def
    results)."""
    if isinstance(v, bool):
        return BOOL
    if isinstance(v, int):
        return ("int", Iv(v, v))
    if isinstance(v, (str, ModelValue)):
        return ("enum", frozenset((v,)))
    if isinstance(v, InfiniteSet):
        if v.kind == "Nat":
            return ("set", ("int", Iv(0, None)))
        if v.kind in ("Int", "Real"):
            return ("set", INT_TOP)
        if v.kind == "STRING":
            return ("set", ENUM)
        if v.kind == "Seq":
            return ("set", ("seq", lift_concrete(v.param, depth + 1)
                            if v.param is not None else BLOB_TOP))
        return BLOB_TOP
    if depth > _MAX_DEPTH:
        return BLOB_TOP
    if isinstance(v, frozenset):
        elem = None
        for x in list(v)[:4096]:
            elem = join(elem, lift_concrete(x, depth + 1), depth)
        return ("set", elem)
    if isinstance(v, Fcn):
        items = list(v.d.items())
        if items and len(items) <= _REC_MAX and \
                all(isinstance(k, str) for k, _ in items):
            return ("rec", tuple(
                (k, lift_concrete(val, depth + 1))
                for k, val in sorted(items)))
        dom = rng = None
        for k, val in items[:4096]:
            dom = join(dom, lift_concrete(k, depth + 1), depth)
            rng = join(rng, lift_concrete(val, depth + 1), depth)
        if dom is None:
            return ("seq", None)
        return ("fun", dom, rng if rng is not None else BLOB_TOP)
    return BLOB_TOP


def elem_opt(av: AV) -> Optional[AV]:
    """Abstract element of a set/sequence-like value; None for a
    definitely-empty container (the lattice bottom for elements)."""
    if av[0] in ("set", "seq"):
        return av[1]
    if av[0] == "blob":
        return av
    return BLOB_TOP


def elem_of(av: AV) -> AV:
    e = elem_opt(av)
    return e if e is not None else BLOB_TOP


def join_opt(a: Optional[AV], b: Optional[AV]) -> Optional[AV]:
    if a is None:
        return b
    if b is None:
        return a
    return join(a, b)


# ---------------------------------------------------------------------------
# abstract expression evaluation
# ---------------------------------------------------------------------------

_CMP_OPS = {"<", ">", "<=", ">=", "=<", "\\leq", "\\geq"}
_NORM = {"=<": "<=", "\\leq": "<=", "\\geq": ">=", "\\mod": "%", "#": "/="}


def _norm(name: str) -> str:
    return _NORM.get(name, name)


class _Bail(Exception):
    """Analysis abandoned (budget/branch cap/recursion) — no proof."""


class AbsEval:
    """Abstract evaluator + abstract transition walker for one model."""

    def __init__(self, model, budget_s: float = 5.0):
        self.model = model
        self.vars = tuple(model.vars)
        self.defs = model.defs
        self.budget_s = budget_s
        self.t0 = time.time()
        self.branch_cap = int(os.environ.get("JAXMC_ANALYZE_BRANCH_CAP",
                                             "768"))
        self._branches = 0
        self._const_cache: Dict[int, AV] = {}

    def _tick(self):
        if time.time() - self.t0 > self.budget_s:
            raise _Bail("analysis budget exceeded")

    # ---- expression evaluation ---------------------------------------
    def eval(self, e: A.Node, env: Dict[str, AV], bound: Dict[str, Any],
             primes: Dict[str, AV], stack: Tuple[str, ...] = ()) -> AV:
        self._tick()
        if isinstance(e, A.Num):
            return ("int", Iv(e.val, e.val))
        if isinstance(e, A.Bool):
            return BOOL
        if isinstance(e, A.Str):
            return ("enum", frozenset((e.val,)))
        if isinstance(e, A.Prime):
            if isinstance(e.expr, A.Ident) and e.expr.name in self.vars:
                return primes.get(e.expr.name, BLOB_TOP)
            return BLOB_TOP
        if isinstance(e, A.Ident):
            return self._ident(e.name, env, bound, primes, stack)
        if isinstance(e, A.OpApp):
            return self._opapp(e, env, bound, primes, stack)
        if isinstance(e, A.If):
            return join(self.eval(e.then, env, bound, primes, stack),
                        self.eval(e.els, env, bound, primes, stack))
        if isinstance(e, A.Case):
            out = None
            for _g, b in e.arms:
                out = join(out, self.eval(b, env, bound, primes, stack))
            if e.other is not None:
                out = join(out, self.eval(e.other, env, bound, primes,
                                          stack))
            return out if out is not None else BLOB_TOP
        if isinstance(e, A.TupleExpr):
            elem = None
            for x in e.items:
                elem = join(elem, self.eval(x, env, bound, primes, stack))
            return ("seq", elem)
        if isinstance(e, A.SetEnum):
            elem = None
            for x in e.items:
                elem = join(elem, self.eval(x, env, bound, primes, stack))
            return ("set", elem)
        if isinstance(e, A.SetFilter):
            return ("set", elem_opt(self.eval(e.set, env, bound, primes,
                                              stack)))
        if isinstance(e, A.SetMap):
            b2 = dict(bound)
            for names, sexpr in e.binders:
                ev = elem_of(self.eval(sexpr, env, bound, primes, stack))
                for nm in names:
                    b2[nm] = ev
            return ("set", self.eval(e.expr, env, b2, primes, stack))
        if isinstance(e, A.FnDef):
            b2 = dict(bound)
            dom = None
            for names, sexpr in e.binders:
                ev = elem_of(self.eval(sexpr, env, bound, primes, stack))
                dom = join(dom, ev)
                for nm in names:
                    b2[nm] = ev
            return ("fun", dom if dom is not None else BLOB_TOP,
                    self.eval(e.body, env, b2, primes, stack))
        if isinstance(e, A.FnSet):
            return ("set", ("fun",
                            elem_of(self.eval(e.dom, env, bound, primes,
                                              stack)),
                            elem_of(self.eval(e.rng, env, bound, primes,
                                              stack))))
        if isinstance(e, A.RecordExpr):
            # per-key record abstraction: each field keeps
            # its own AV so Dot/EXCEPT stay field-precise
            if 0 < len(e.fields) <= _REC_MAX:
                return ("rec", tuple(sorted(
                    ((k, self.eval(vex, env, bound, primes, stack))
                     for k, vex in e.fields),
                    key=lambda kv: kv[0])))
            rng = None
            for _k, vex in e.fields:
                rng = join(rng, self.eval(vex, env, bound, primes, stack))
            return ("fun", ENUM, rng if rng is not None else BLOB_TOP)
        if isinstance(e, A.RecordSet):
            rng = None
            for _k, sexpr in e.fields:
                rng = join(rng, elem_of(self.eval(sexpr, env, bound,
                                                  primes, stack)))
            return ("set", ("fun", ENUM,
                            rng if rng is not None else BLOB_TOP))
        if isinstance(e, A.FnApp):
            # applied-element fact: a guard like
            # `turns[p] + k =< MaxTurns` refined THIS application's
            # interval — the fact outranks the keyless rng join
            if isinstance(e.fn, A.Ident) and e.fn.name in self.vars \
                    and e.fn.name not in bound and len(e.args) == 1:
                fav = self._fact_lookup(e.fn.name, e.args[0], env, bound)
                if fav is not None:
                    return fav
            f = self.eval(e.fn, env, bound, primes, stack)
            if f[0] == "rec":
                return self._rec_app(f, e.args, env, bound, primes,
                                     stack)
            if f[0] == "fun":
                return f[2]
            if f[0] == "seq":
                return f[1] if f[1] is not None else BLOB_TOP
            if f[0] == "blob":
                return f
            return BLOB_TOP
        if isinstance(e, A.Dot):
            if isinstance(e.expr, A.Ident) and e.expr.name in self.vars \
                    and e.expr.name not in bound:
                fav = self._fact_lookup(e.expr.name, A.Str(e.fld),
                                        env, bound)
                if fav is not None:
                    return fav
            f = self.eval(e.expr, env, bound, primes, stack)
            if f[0] == "rec":
                d = dict(f[1])
                return d.get(e.fld, BLOB_TOP)
            if f[0] == "fun":
                return f[2]
            if f[0] == "blob":
                return f
            return BLOB_TOP
        if isinstance(e, A.Except):
            f = self.eval(e.fn, env, bound, primes, stack)
            fname = e.fn.name if (isinstance(e.fn, A.Ident)
                                  and e.fn.name in self.vars
                                  and e.fn.name not in bound) else None
            acc = f
            for ui, (path, rhs) in enumerate(e.updates):
                # the applied-element FACT describes the PRE-state
                # value: only the FIRST update may bind @ through it —
                # later updates read the already-updated function,
                # whose joined rng/field covers the new value
                at = self._path_at(acc, list(path), env, bound,
                                   fname if ui == 0 else None)
                rv = self.eval(rhs, env, dict(bound, **{"@": at}),
                               primes, stack)
                acc = self._path_update(acc, list(path), rv, env, bound)
            return acc
        if isinstance(e, A.At):
            at = bound.get("@")
            return at if at is not None else BLOB_TOP
        if isinstance(e, A.Quant):
            return BOOL
        if isinstance(e, A.Choose):
            if e.set is not None:
                return elem_of(self.eval(e.set, env, bound, primes,
                                         stack))
            return BLOB_TOP
        if isinstance(e, A.Let):
            b2 = dict(bound)
            for d in e.defs:
                if isinstance(d, A.OpDef):
                    b2[d.name] = ("$closure", d.params, d.body)
                elif isinstance(d, A.FnConstrDef):
                    b2[d.name] = BLOB_TOP
            return self.eval(e.body, env, b2, primes, stack)
        if isinstance(e, (A.Unchanged, A.Enabled, A.Fair, A.BoxAction,
                          A.AngleAction, A.TemporalQuant)):
            return BOOL
        return BLOB_TOP

    def _ident(self, name, env, bound, primes, stack) -> AV:
        if name in bound:
            v = bound[name]
            if isinstance(v, tuple) and v and v[0] == "$closure":
                if v[1]:
                    return BLOB_TOP
                return self.eval(v[2], env, bound, primes, stack)
            return v if isinstance(v, tuple) else lift_concrete(v)
        if name in self.vars and name in env:
            return env[name]
        d = self.defs.get(name)
        if d is None:
            return BLOB_TOP
        return self._def_value(name, d, env, bound, primes, stack)

    def _def_value(self, name, d, env, bound, primes, stack) -> AV:
        from ..sem.eval import OpClosure
        if isinstance(d, OpClosure):
            if d.params:
                return BLOB_TOP  # operator used as a value
            if name in stack or len(stack) > 48:
                return BLOB_TOP  # recursion/depth: no proof through it
            body = d.body
            if isinstance(body, A.FnConstrDef):
                return BLOB_TOP
            return self.eval(body, env, dict(d.bound), primes,
                             stack + (name,))
        if not callable(d):
            key = id(d)
            av = self._const_cache.get(key)
            if av is None:
                av = lift_concrete(d)
                self._const_cache[key] = av
            return av
        return BLOB_TOP

    def _opapp(self, e: A.OpApp, env, bound, primes, stack) -> AV:
        name = _norm(e.name)
        if e.path:
            return BLOB_TOP  # instance-qualified: unmodelled
        args = e.args
        if name in ("/\\", "\\/", "=>", "<=>", "~", "=", "/=", "\\in",
                    "\\notin", "\\subseteq", "\\supseteq"):
            return BOOL
        if name in _CMP_OPS:
            return BOOL
        if name in ("+", "-", "*", "\\div", "/", "%"):
            if name == "-" and len(args) == 1:
                a = self._as_iv(args[0], env, bound, primes, stack)
                return ("int", Iv(_neg(a.hi), _neg(a.lo)))
            a = self._as_iv(args[0], env, bound, primes, stack)
            b = self._as_iv(args[1], env, bound, primes, stack)
            if name == "+":
                return ("int", iv_add(a, b))
            if name == "-":
                return ("int", iv_sub(a, b))
            if name == "*":
                return ("int", iv_mul(a, b))
            if name == "%":
                return ("int", iv_mod(a, b))
            return ("int", iv_div(a, b))
        if name == "-." and len(args) == 1:
            a = self._as_iv(args[0], env, bound, primes, stack)
            return ("int", Iv(_neg(a.hi), _neg(a.lo)))
        if name == "..":
            a = self._as_iv(args[0], env, bound, primes, stack)
            b = self._as_iv(args[1], env, bound, primes, stack)
            return ("set", ("int", Iv(a.lo, b.hi)))
        if name in ("\\cup", "\\union"):
            return ("set", join_opt(
                elem_opt(self.eval(args[0], env, bound, primes, stack)),
                elem_opt(self.eval(args[1], env, bound, primes,
                                   stack))))
        if name in ("\\cap", "\\intersect", "\\"):
            return ("set", elem_opt(self.eval(args[0], env, bound,
                                              primes, stack)))
        if name in ("Cardinality", "Len"):
            return ("int", Iv(0, None))
        if name == "SUBSET":
            return ("set", ("set", elem_of(
                self.eval(args[0], env, bound, primes, stack))))
        if name == "UNION":
            return ("set", elem_of(elem_of(
                self.eval(args[0], env, bound, primes, stack))))
        if name == "DOMAIN":
            f = self.eval(args[0], env, bound, primes, stack)
            if f[0] == "rec":
                return ("set", ("enum",
                                frozenset(k for k, _ in f[1])))
            if f[0] == "fun":
                return ("set", f[1])
            if f[0] == "seq":
                return ("set", ("int", Iv(1, None)))
            return ("set", ("blob", summary(f) or Iv(0, 0))) \
                if summary(f) is not None else ("set", ENUM)
        if name == "Append":
            s = self.eval(args[0], env, bound, primes, stack)
            x = self.eval(args[1], env, bound, primes, stack)
            return ("seq", join_opt(elem_opt(s) if s[0] in ("seq", "set")
                                    else s, x))
        if name in ("Head", "Last"):
            return elem_of(self.eval(args[0], env, bound, primes, stack))
        if name in ("Tail", "SubSeq", "Front", "SelectSeq"):
            s = self.eval(args[0], env, bound, primes, stack)
            return s if s[0] == "seq" else ("seq", elem_of(s))
        if name == "\\o":
            return ("seq", join_opt(
                elem_opt(self.eval(args[0], env, bound, primes, stack)),
                elem_opt(self.eval(args[1], env, bound, primes,
                                   stack))))
        if name == "Seq":
            return ("set", ("seq", elem_of(
                self.eval(args[0], env, bound, primes, stack))))
        if name in ("Min", "Max"):
            a = self._as_iv(args[0], env, bound, primes, stack)
            b = self._as_iv(args[1], env, bound, primes, stack)
            return ("int", a.join(b))
        # user-defined operator application
        tgt = bound.get(name)
        if isinstance(tgt, tuple) and tgt and tgt[0] == "$closure":
            if len(tgt[1]) != len(args):
                return BLOB_TOP
            b2 = dict(bound)
            for p, aex in zip(tgt[1], args):
                b2[p] = self.eval(aex, env, bound, primes, stack)
            return self.eval(tgt[2], env, b2, primes, stack)
        from ..sem.eval import OpClosure
        d = self.defs.get(name)
        if isinstance(d, OpClosure) and d.params and \
                len(d.params) == len(args):
            if name in stack or len(stack) > 48:
                return BLOB_TOP
            b2 = dict(d.bound)
            for p, aex in zip(d.params, args):
                b2[p] = self.eval(aex, env, bound, primes, stack)
            if isinstance(d.body, A.FnConstrDef):
                return BLOB_TOP
            return self.eval(d.body, env, b2, primes, stack + (name,))
        return BLOB_TOP

    def _as_iv(self, e, env, bound, primes, stack) -> Iv:
        av = self.eval(e, env, bound, primes, stack)
        if av[0] == "int":
            return av[1]
        s = summary(av)
        return s if s is not None else TOP

    # ---- per-element precision helpers --------------------

    def _rec_app(self, f: AV, args, env, bound, primes, stack) -> AV:
        """Apply a per-key record: a literal (or enum-valued) key picks
        its field(s); anything else joins every field."""
        d = dict(f[1])
        if len(args) == 1:
            a0 = args[0]
            if isinstance(a0, A.Str):
                return d.get(a0.val, BLOB_TOP)
            kv = self.eval(a0, env, bound, primes, stack)
            if kv[0] == "enum" and kv[1] is not None and \
                    all(isinstance(x, str) and x in d for x in kv[1]):
                out = None
                for x in kv[1]:
                    out = join(out, d[x])
                if out is not None:
                    return out
        out = None
        for _k, v in f[1]:
            out = join(out, v)
        return out if out is not None else BLOB_TOP

    def _fact_id(self, fname: str, idx, bound):
        """(env key, binding token) for the applied element f[idx].
        The token is the CURRENT binding object of an identifier index,
        compared by identity at lookup, so a rebound binder name can
        never resurrect a stale fact."""
        if isinstance(idx, A.Ident):
            return f"{fname}[{idx.name}]", bound.get(idx.name)
        if isinstance(idx, A.Num):
            return f"{fname}[{idx.val}]", None
        if isinstance(idx, A.Str):
            return f"{fname}[{idx.val!r}]", None
        return None, None

    def _fact_lookup(self, fname: str, idx, env, bound) -> Optional[AV]:
        key, tok = self._fact_id(fname, idx, bound)
        if key is None:
            return None
        f = env.get(key)
        if isinstance(f, tuple) and len(f) == 3 and f[0] == "$fact" \
                and f[1] is tok:
            return f[2]
        return None

    def _fact_store(self, env, fname: str, idx, bound, av: AV):
        """Returns env (a copy on write) with the applied-element fact
        recorded; the pre-state value of f[idx] lies in av for the rest
        of this branch (pre-state vars never change mid-branch)."""
        key, tok = self._fact_id(fname, idx, bound)
        if key is None:
            return env
        env = dict(env)
        env[key] = ("$fact", tok, av)
        return env

    def _step_into(self, cur: AV, kind: str, part, env, bound) -> AV:
        """Abstract value one EXCEPT-path step below `cur`."""
        if cur[0] == "rec":
            d = dict(cur[1])
            if kind == "dot":
                return d.get(part, BLOB_TOP)
            if kind == "idx" and len(part) == 1 and \
                    isinstance(part[0], A.Str):
                return d.get(part[0].val, BLOB_TOP)
            out = None
            for _k, v in cur[1]:
                out = join(out, v)
            return out if out is not None else BLOB_TOP
        if cur[0] == "fun":
            return cur[2]
        if cur[0] == "seq":
            return cur[1] if cur[1] is not None else BLOB_TOP
        if cur[0] == "blob":
            return cur
        return BLOB_TOP

    def _path_at(self, acc: AV, path, env, bound,
                 fname: Optional[str]) -> AV:
        """The value @ is bound to for one EXCEPT update: the element at
        the full path, consulting applied-element facts at the root."""
        cur = acc
        for i, (kind, part) in enumerate(path):
            if i == 0 and fname is not None:
                idx = None
                if kind == "idx" and len(part) == 1:
                    idx = part[0]
                elif kind == "dot":
                    idx = A.Str(part)
                if idx is not None:
                    fav = self._fact_lookup(fname, idx, env, bound)
                    if fav is not None:
                        cur = fav
                        continue
            cur = self._step_into(cur, kind, part, env, bound)
        return cur if cur is not None else BLOB_TOP

    def _path_update(self, acc: AV, path, rv: AV, env, bound) -> AV:
        """[acc EXCEPT !<path> = rv]: strong update on known record
        keys, weak (join) update everywhere else — always covers both
        the updated and the untouched elements."""
        if not path:
            return rv
        (kind, part), rest = path[0], path[1:]
        inner = self._step_into(acc, kind, part, env, bound)
        nv = self._path_update(inner, rest, rv, env, bound)
        if acc[0] == "rec":
            key = None
            if kind == "dot":
                key = part
            elif kind == "idx" and len(part) == 1 and \
                    isinstance(part[0], A.Str):
                key = part[0].val
            if key is not None and any(k == key for k, _ in acc[1]):
                return ("rec", tuple(
                    (k, nv if k == key else v) for k, v in acc[1]))
            return ("rec", tuple((k, join(v, nv)) for k, v in acc[1]))
        if acc[0] == "fun":
            return ("fun", acc[1], join(acc[2], nv))
        if acc[0] == "seq":
            return ("seq", join(acc[1], nv))
        s = _sum_join(summary(acc), summary(nv))
        return ("blob", s) if s is not None else acc

    # ---- guard refinement --------------------------------------------
    def refine(self, e: A.Node, env: Dict[str, AV],
               bound: Dict[str, Any]) -> Dict[str, AV]:
        """Return env refined by guard e holding (pre-state vars only);
        refinement is best-effort — returning env unchanged is sound."""
        if isinstance(e, A.OpApp):
            name = _norm(e.name)
            if name == "/\\":
                return self.refine(e.args[1],
                                   self.refine(e.args[0], env, bound),
                                   bound)
            if name in ("<", "<=", ">", ">=", "="):
                return self._refine_cmp(name, e.args[0], e.args[1], env,
                                        bound)
            if name == "\\in":
                x, s = e.args
                sv = self.eval(s, env, bound, {})
                el = elem_of(sv)
                if el[0] == "int" and (el[1].lo is not None
                                       or el[1].hi is not None):
                    env = self._clamp_expr(x, env, bound,
                                           lo=el[1].lo, hi=el[1].hi)
                return env
        if isinstance(e, A.Ident):
            from ..sem.eval import OpClosure
            d = self.defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params \
                    and e.name not in self.vars:
                return self.refine(d.body, env, dict(d.bound))
        return env

    def _clamp_expr(self, ex, env, bound, lo=None, hi=None):
        """Refine a comparable LVALUE by [lo, hi] (either side None =
        unconstrained): a state-variable Ident narrows its env interval;
        a single-index function application `f[i]` or record field
        access `r.fld` on a state variable records an applied-element
        FACT — the pre-state value of that element lies in
        the clamped interval for the rest of this branch.  Unrefinable
        shapes return env unchanged (always sound)."""
        if lo is None and hi is None:
            return env
        if isinstance(ex, A.Ident):
            var = ex.name
            if var in self.vars and var not in bound and var in env \
                    and env[var][0] == "int":
                cur = env[var][1]
                nlo = cur.lo if lo is None else \
                    (lo if cur.lo is None else max(cur.lo, lo))
                nhi = cur.hi if hi is None else \
                    (hi if cur.hi is None else min(cur.hi, hi))
                env = dict(env)
                env[var] = ("int", Iv(nlo, nhi))
            return env
        fname = idx = None
        if isinstance(ex, A.FnApp) and isinstance(ex.fn, A.Ident) \
                and ex.fn.name in self.vars \
                and ex.fn.name not in bound and len(ex.args) == 1:
            fname, idx = ex.fn.name, ex.args[0]
        elif isinstance(ex, A.Dot) and isinstance(ex.expr, A.Ident) \
                and ex.expr.name in self.vars \
                and ex.expr.name not in bound:
            fname, idx = ex.expr.name, A.Str(ex.fld)
        if fname is None:
            return env
        base = self._as_iv(ex, env, bound, {}, ())
        nlo = base.lo if lo is None else \
            (lo if base.lo is None else max(base.lo, lo))
        nhi = base.hi if hi is None else \
            (hi if base.hi is None else min(base.hi, hi))
        return self._fact_store(env, fname, idx, bound,
                                ("int", Iv(nlo, nhi)))

    def _is_lvalue(self, ex, bound) -> bool:
        """Can _clamp_expr refine this shape?  Cheap pre-test so the
        comparison refinement only pays an abstract evaluation of the
        OPPOSING side when there is something to clamp."""
        if isinstance(ex, A.Ident):
            return ex.name in self.vars and ex.name not in bound
        if isinstance(ex, A.FnApp):
            return (isinstance(ex.fn, A.Ident)
                    and ex.fn.name in self.vars
                    and ex.fn.name not in bound and len(ex.args) == 1)
        if isinstance(ex, A.Dot):
            return (isinstance(ex.expr, A.Ident)
                    and ex.expr.name in self.vars
                    and ex.expr.name not in bound)
        return False

    def _refine_cmp(self, op, l, r, env, bound) -> Dict[str, AV]:
        def clamp(ex, lo=None, hi=None):
            nonlocal env
            env = self._clamp_expr(ex, env, bound, lo=lo, hi=hi)

        def iv(e):
            return self._as_iv(e, env, bound, {}, ())

        # x op e  /  e op x  (x an Ident, f[i] or r.fld lvalue)
        if self._is_lvalue(l, bound):
            b = iv(r)
            if op == "<" and b.hi is not None:
                clamp(l, hi=b.hi - 1)
            elif op == "<=" and b.hi is not None:
                clamp(l, hi=b.hi)
            elif op == ">" and b.lo is not None:
                clamp(l, lo=b.lo + 1)
            elif op == ">=" and b.lo is not None:
                clamp(l, lo=b.lo)
            elif op == "=":
                clamp(l, lo=b.lo, hi=b.hi)
        if self._is_lvalue(r, bound):
            a = iv(l)
            if op == "<" and a.lo is not None:
                clamp(r, lo=a.lo + 1)
            elif op == "<=" and a.lo is not None:
                clamp(r, lo=a.lo)
            elif op == ">" and a.hi is not None:
                clamp(r, hi=a.hi - 1)
            elif op == ">=" and a.hi is not None:
                clamp(r, hi=a.hi)
            elif op == "=":
                clamp(r, lo=a.lo, hi=a.hi)

        # x + y <= c  (CONSTRAINT shape, constoy; EXCEPT-guard shape,
        # symtoy/raft): bound each refinable addend by c - other.lo
        def sum_shape(sumex, cex, op2):
            x1, x2 = sumex.args
            if not (self._is_lvalue(x1, bound)
                    or self._is_lvalue(x2, bound)):
                return
            c = iv(cex)
            if c.hi is None:
                return
            chi = c.hi - (1 if op2 == "<" else 0)
            for me, other in ((x1, x2), (x2, x1)):
                if not self._is_lvalue(me, bound):
                    continue
                o = iv(other)
                if o.lo is not None:
                    clamp(me, hi=chi - o.lo)

        if op in ("<", "<=") and isinstance(l, A.OpApp) \
                and _norm(l.name) == "+" and len(l.args) == 2:
            sum_shape(l, r, op)
        if op in (">", ">=") and isinstance(r, A.OpApp) \
                and _norm(r.name) == "+" and len(r.args) == 2:
            sum_shape(r, l, {">": "<", ">=": "<="}[op])
        return env

    # ---- abstract transition walker ----------------------------------
    def walk(self, e: A.Node, env: Dict[str, AV], bound: Dict[str, Any],
             partial: Dict[str, AV], mode: str,
             stack: Tuple[str, ...] = ()) -> List[Tuple[Dict[str, AV],
                                                        Dict[str, AV]]]:
        """Abstract mirror of sem/enumerate.Walker.walk: returns a list
        of (assignments, refined-env) branches.  A definitely-false
        guard kills its branch; everything unmodelled keeps the branch
        with TOP effects (sound)."""
        self._tick()
        self._branches += 1
        if self._branches > self.branch_cap:
            raise _Bail("branch cap exceeded")
        from ..sem.eval import OpClosure
        if isinstance(e, A.OpApp):
            name = _norm(e.name)
            if name == "/\\":
                out = []
                for p1, env1 in self.walk(e.args[0], env, bound, partial,
                                          mode, stack):
                    out.extend(self.walk(e.args[1], env1, bound, p1,
                                         mode, stack))
                return out
            if name == "\\/":
                out = []
                for arm in e.args:
                    out.extend(self.walk(arm, env, bound, dict(partial),
                                         mode, stack))
                return out
            if name == "=":
                tgt = self._target(e.args[0], mode, bound)
                if tgt is not None:
                    if tgt in partial:
                        return [(partial, env)]
                    rhs = self.eval(e.args[1], env, bound, partial,
                                    stack)
                    p2 = dict(partial)
                    p2[tgt] = rhs
                    return [(p2, env)]
            if name == "\\in":
                tgt = self._target(e.args[0], mode, bound)
                if tgt is not None:
                    if tgt in partial:
                        return [(partial, env)]
                    sv = self.eval(e.args[1], env, bound, partial, stack)
                    p2 = dict(partial)
                    p2[tgt] = elem_of(sv)
                    return [(p2, env)]
            # user operator expansion
            tgt_d = bound.get(name)
            if isinstance(tgt_d, tuple) and tgt_d and \
                    tgt_d[0] == "$closure":
                from ..front.subst import subst
                if len(tgt_d[1]) != len(e.args) or name in stack \
                        or len(stack) > 48:
                    return [(partial, env)]
                try:
                    body = subst(tgt_d[2], dict(zip(tgt_d[1], e.args)))
                except Exception:
                    return [(partial, env)]
                return self.walk(body, env, bound, partial, mode,
                                 stack + (name,))
            d = self.defs.get(name) if name not in bound else None
            if isinstance(d, OpClosure) and d.params and \
                    len(d.params) == len(e.args):
                if name in stack or len(stack) > 48:
                    return [(partial, env)]
                from ..front.subst import subst
                try:
                    body = subst(d.body, dict(zip(d.params, e.args)))
                except Exception:
                    return [(partial, env)]
                # call-by-name, like Walker: the substituted body carries
                # the CALLER's arg ASTs, so it walks under the caller's
                # binder env (module-level closures capture nothing)
                return self.walk(body, env, {**d.bound, **bound},
                                 partial, mode, stack + (name,))
        elif isinstance(e, A.Ident):
            d = bound.get(e.name)
            if isinstance(d, tuple) and d and d[0] == "$closure" \
                    and not d[1] and e.name not in stack \
                    and len(stack) <= 48:
                return self.walk(d[2], env, bound, partial, mode,
                                 stack + (e.name,))
            if not (isinstance(d, tuple) and d) and e.name not in bound:
                dd = self.defs.get(e.name)
                from ..sem.eval import OpClosure as OC
                if isinstance(dd, OC) and not dd.params \
                        and e.name not in self.vars \
                        and e.name not in stack and len(stack) <= 48:
                    return self.walk(dd.body, env,
                                     {**bound, **dd.bound},
                                     partial, mode,
                                     stack + (e.name,))
        elif isinstance(e, A.Quant):
            if e.kind == "E":
                b2 = dict(bound)
                for names, sexpr in e.binders:
                    if sexpr is None:
                        for nm in names:
                            b2[nm] = BLOB_TOP
                        continue
                    ev = elem_of(self.eval(sexpr, env, bound, partial,
                                           stack))
                    for nm in names:
                        b2[nm] = ev
                return self.walk(e.body, env, b2, dict(partial), mode,
                                 stack)
            # \A as a guard: fall through
        elif isinstance(e, A.If):
            out = self.walk(e.then, env, bound, dict(partial), mode,
                            stack)
            out += self.walk(e.els, env, bound, dict(partial), mode,
                             stack)
            return out
        elif isinstance(e, A.Case):
            out = []
            for _g, b in e.arms:
                out += self.walk(b, env, bound, dict(partial), mode,
                                 stack)
            if e.other is not None:
                out += self.walk(e.other, env, bound, dict(partial),
                                 mode, stack)
            return out
        elif isinstance(e, A.Let):
            b2 = dict(bound)
            for d in e.defs:
                if isinstance(d, A.OpDef):
                    b2[d.name] = ("$closure", d.params, d.body)
                elif isinstance(d, A.FnConstrDef):
                    b2[d.name] = BLOB_TOP
            return self.walk(e.body, env, b2, partial, mode, stack)
        elif isinstance(e, A.Unchanged):
            p2 = dict(partial)
            self._unchanged(e.expr, env, bound, p2)
            return [(p2, env)]
        elif isinstance(e, A.BoxAction):
            out = self.walk(e.action, env, bound, dict(partial), mode,
                            stack)
            p2 = dict(partial)
            self._unchanged(e.sub, env, bound, p2)
            out.append((p2, env))
            return out
        elif isinstance(e, A.Bool):
            return [(partial, env)] if e.val else []
        # default: boolean guard — kill the branch only when DEFINITELY
        # false, refine the env otherwise
        verdict = self.guard_verdict(e, env, bound, partial, stack)
        if verdict is False:
            return []
        return [(partial, self.refine(e, env, bound))]

    def _target(self, e, mode, bound) -> Optional[str]:
        if mode == "next":
            if isinstance(e, A.Prime) and isinstance(e.expr, A.Ident) \
                    and e.expr.name in self.vars:
                return e.expr.name
            return None
        if isinstance(e, A.Ident) and e.name in self.vars \
                and e.name not in bound:
            return e.name
        return None

    def _unchanged(self, e, env, bound, partial) -> None:
        from ..sem.eval import OpClosure
        if isinstance(e, A.Ident):
            if e.name in self.vars:
                if e.name not in partial:
                    partial[e.name] = env.get(e.name, BLOB_TOP)
                return
            d = self.defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params:
                self._unchanged(d.body, env, bound, partial)
            return
        if isinstance(e, A.TupleExpr):
            for x in e.items:
                self._unchanged(x, env, bound, partial)

    def guard_verdict(self, e, env, bound, primes,
                      stack=()) -> Optional[bool]:
        """True/False when the guard is decided under the abstract env,
        None when unknown.  Only interval-decidable comparisons are
        modelled — everything else is None (keep the branch)."""
        if isinstance(e, A.Bool):
            return e.val
        if not isinstance(e, A.OpApp):
            return None
        name = _norm(e.name)
        if name in ("<", "<=", ">", ">=") and len(e.args) == 2:
            a = self._as_iv(e.args[0], env, bound, primes, stack)
            b = self._as_iv(e.args[1], env, bound, primes, stack)
            if name in (">", ">="):
                a, b = b, a
                name = {"<": "<", ">": "<", ">=": "<=", "<=": "<="}[name]
            # now: a < b or a <= b
            if name == "<":
                if a.hi is not None and b.lo is not None \
                        and a.hi < b.lo:
                    return True
                if a.lo is not None and b.hi is not None \
                        and a.lo >= b.hi:
                    return False
            else:
                if a.hi is not None and b.lo is not None \
                        and a.hi <= b.lo:
                    return True
                if a.lo is not None and b.hi is not None \
                        and a.lo > b.hi:
                    return False
            return None
        if name == "/\\":
            va = self.guard_verdict(e.args[0], env, bound, primes, stack)
            vb = self.guard_verdict(e.args[1], env, bound, primes, stack)
            if va is False or vb is False:
                return False
            if va is True and vb is True:
                return True
            return None
        return None


# ---------------------------------------------------------------------------
# per-element proven bounds
# ---------------------------------------------------------------------------


class EB:
    """Per-element PROVEN bounds for one variable — the structured shape
    compile/pack.py descends alongside the vspec tree, so a container's
    element lanes pack at their own proven widths instead of the
    whole-variable summary.

      all    (lo, hi) covering EVERY int component anywhere in the
             value (None: not fully bounded) — the sound fallback for
             any component without a more precise child bound
      dom    key-side bounds (fun/kvtable key lanes)
      rng    value-side bounds (fun/pfcn value lanes)
      elem   element bounds (seq/growset element lanes)
      keys   per-key bounds for record fields (str keys)
    """

    __slots__ = ("all", "dom", "rng", "elem", "keys")

    def __init__(self, all=None, dom=None, rng=None, elem=None,
                 keys=None):
        self.all = all
        self.dom = dom
        self.rng = rng
        self.elem = elem
        self.keys = keys

    def __repr__(self):
        parts = [f"all={self.all}"]
        for f in ("dom", "rng", "elem", "keys"):
            v = getattr(self, f)
            if v is not None:
                parts.append(f"{f}={v}")
        return "EB(" + ", ".join(parts) + ")"

    def empty(self) -> bool:
        return (self.all is None and self.dom is None
                and self.rng is None and self.elem is None
                and not self.keys)


def _fin(iv: Optional[Iv]) -> Optional[Tuple[int, int]]:
    if iv is None or not iv.bounded():
        return None
    if abs(iv.lo) >= 2 ** 31 or iv.hi >= 2 ** 31:
        return None
    return (int(iv.lo), int(iv.hi))


def av_to_eb(av: Optional[AV], depth: int = 0) -> Optional[EB]:
    """Structured proven bounds from a converged abstract value; None
    when nothing below this node is provably bounded (pack then falls
    back to structural/observed widths — never a wrong lane)."""
    if av is None or depth > _MAX_DEPTH:
        return None
    k = av[0]
    if k == "int":
        a = _fin(av[1])
        return EB(all=a) if a is not None else None
    if k in ("bool", "enum"):
        return None  # no int lanes below
    if k in ("set", "seq"):
        eb = EB(all=_fin(summary(av)),
                elem=av_to_eb(av[1], depth + 1) if av[1] is not None
                else None)
        return None if eb.empty() else eb
    if k == "fun":
        eb = EB(all=_fin(summary(av)), dom=av_to_eb(av[1], depth + 1),
                rng=av_to_eb(av[2], depth + 1))
        return None if eb.empty() else eb
    if k == "rec":
        keys = {kk: av_to_eb(v, depth + 1) for kk, v in av[1]}
        rng = None
        for _kk, v in av[1]:
            rng = join(rng, v)
        eb = EB(all=_fin(summary(av)), keys=keys,
                rng=av_to_eb(rng, depth + 1) if rng is not None
                else None)
        return None if eb.empty() else eb
    if k == "blob":
        a = _fin(av[1])
        return EB(all=a) if a is not None else None
    return None


# ---------------------------------------------------------------------------
# fixpoint driver
# ---------------------------------------------------------------------------


@dataclass
class BoundsReport:
    """The fixpoint result: per-variable abstract values + summaries."""
    env: Dict[str, AV]
    iterations: int
    converged: bool
    wall_s: float

    def summaries(self) -> Dict[str, Iv]:
        """var -> summary interval over every int component (only vars
        whose summary exists — vars with no int components are absent)."""
        out = {}
        for v, av in self.env.items():
            s = summary(av)
            if s is not None:
                out[v] = s
        return out

    def lane_bounds(self) -> Dict[str, Tuple[int, int]]:
        """var -> (lo, hi) for vars with a FINITE proven int summary —
        the shape compile/pack.py consumes as structural bounds.

        A truncated (non-converged) fixpoint proves NOTHING: its
        intervals only cover states reachable within max_iter abstract
        steps, so consuming them would mislabel correct values as
        analyzer bugs (OV_PACK) — no proofs in that case."""
        if not self.converged:
            return {}
        out = {}
        for v, s in self.summaries().items():
            if s.bounded() and abs(s.lo) < 2 ** 31 and s.hi < 2 ** 31:
                out[v] = (s.lo, s.hi)
        return out

    def element_bounds(self) -> Dict[str, "EB"]:
        """var -> structured per-element proven bounds: the
        richer shape compile/pack.py consumes — a variable appears as
        soon as ANY component below it proves, even when the whole-value
        summary does not (e.g. a bounded function range under an
        unbounded-count container).  Same truncation rule as
        lane_bounds: a non-converged fixpoint proves nothing."""
        if not self.converged:
            return {}
        out = {}
        for v, av in self.env.items():
            eb = av_to_eb(av)
            if eb is not None:
                out[v] = eb
        return out


def _join_env(a: Dict[str, AV], b: Dict[str, AV],
              vars_) -> Dict[str, AV]:
    return {v: join(a.get(v), b.get(v)) for v in vars_
            if v in a or v in b}


def infer_state_bounds(model, budget_s: Optional[float] = None
                       ) -> Optional[BoundsReport]:
    """Fixpoint interval inference for every state variable; returns
    None when the analysis bails (budget, branch explosion, internal
    error) — callers treat None as 'no proofs'."""
    t0 = time.time()
    if budget_s is None:
        budget_s = float(os.environ.get("JAXMC_ANALYZE_BUDGET", "5"))
    try:
        ae = AbsEval(model, budget_s=budget_s)
        # Init: abstract assignments from the initial predicate
        init_branches = ae.walk(model.init, {}, {}, {}, "init")
        env: Dict[str, AV] = {}
        for p, _e in init_branches:
            env = _join_env(env, p, model.vars)
        for v in model.vars:
            env.setdefault(v, BLOB_TOP)
        max_iter = int(os.environ.get("JAXMC_ANALYZE_MAX_ITER", "64"))
        widen_at = max(8, max_iter // 2)
        converged = False
        it = 0
        for it in range(1, max_iter + 1):
            ae._branches = 0
            pre = dict(env)
            # frontier states satisfy every CONSTRAINT; successors of
            # refined pre-states are NOT re-refined (candidate rows are
            # encoded before the constraint check discards them)
            for _nm, cexpr in model.constraints:
                pre = ae.refine(cexpr, pre, {})
            new = dict(env)
            for p, _e in ae.walk(model.next, pre, {}, {}, "next"):
                post = {v: p.get(v, BLOB_TOP) for v in model.vars}
                new = _join_env(new, post, model.vars)
            if it >= widen_at:
                new = {v: widen(new[v], env[v]) for v in model.vars}
            if new == env:
                converged = True
                break
            env = new
        return BoundsReport(env=env, iterations=it, converged=converged,
                            wall_s=time.time() - t0)
    except _Bail:
        return None
    except RecursionError:
        return None
    except Exception:
        # the analyzer must never break a build; no proof is always safe
        if os.environ.get("JAXMC_DEBUG"):
            raise
        return None


def dead_arms(model, arms, report: Optional[BoundsReport] = None
              ) -> List[Tuple[int, str]]:
    """Indices (+labels) of action arms that can NEVER fire: every
    abstract branch of the arm dies on a definitely-false guard under
    the fixpoint env.  Used by the linter (JMC202)."""
    if report is None:
        report = infer_state_bounds(model)
    if report is None or not report.converged:
        # a truncated fixpoint env is NOT an invariant: a guard that is
        # false under it may hold in deeper states — no dead verdicts
        return []
    out = []
    for i, arm in enumerate(arms):
        try:
            ae = AbsEval(model)
            env = dict(report.env)
            for _nm, cexpr in model.constraints:
                env = ae.refine(cexpr, env, {})
            branches = ae.walk(arm.expr, env, dict(arm.bound or {}), {},
                               "next")
            if not branches:
                out.append((i, arm.label or "Next"))
        except (_Bail, RecursionError):
            continue
        except Exception:
            if os.environ.get("JAXMC_DEBUG"):
                raise
            continue
    return out


# ---------------------------------------------------------------------------
# cross-model batch compatibility
# ---------------------------------------------------------------------------
#
# The vmapped multi-model engine (backend/batch.py) shares ONE compiled
# kernel across layout-compatible models by LIFTING per-model CONSTANT
# values into traced batch-axis lanes (kernel2.KernelCtx.const_lanes).
# A constant is liftable only when every occurrence sits in a VALUE
# position — arithmetic, comparisons, boolean structure, IF/CASE arms,
# assignment right-hand sides — never in a position compilation needs
# statically (quantifier/set-constructor domains, `..` range endpoints,
# function application, container shapes).  The walk below is the
# conservative parse-time oracle; the kernel trace itself is the
# soundness net (a lifted constant reaching a static-only position
# raises CompileError, which the batch planner reads as "not
# batchable", never as a wrong kernel).

# boolean structure + comparisons + integer arithmetic: operand
# positions stay value-transparent (kernel2 evaluates them over traced
# lanes)
_LIFT_SAFE_OPS = frozenset({
    "/\\", "\\/", "~", "\\lnot", "\\neg", "=>", "<=>", "\\equiv",
    "=", "/=", "<", "<=", ">", ">=",
    "+", "-", "*", "\\div", "%", "-.",
})


def _lift_walk(e, safe: bool, consts: set, pinned: set,
               defs: Dict[str, Any], seen_ops: set) -> None:
    """Mark every constant Ident reached in a non-transparent context
    as pinned.  `safe` is the context flag for THIS node's position."""
    from ..sem.eval import OpClosure
    if e is None:
        return
    if isinstance(e, A.Ident):
        if e.name in consts and not safe:
            pinned.add(e.name)
        return
    if isinstance(e, (A.Num, A.Str, A.Bool, A.At)):
        return
    if isinstance(e, A.OpApp):
        nm = _norm(e.name)
        if e.path:  # instance-path application: opaque, pin everything
            for _inst, iargs in e.path:
                for a in iargs:
                    _lift_walk(a, False, consts, pinned, defs, seen_ops)
            for a in e.args:
                _lift_walk(a, False, consts, pinned, defs, seen_ops)
            return
        if nm in consts and not e.args:
            # zero-arg application of the constant itself
            if not safe:
                pinned.add(nm)
            return
        if nm in _LIFT_SAFE_OPS:
            for a in e.args:
                _lift_walk(a, safe, consts, pinned, defs, seen_ops)
            return
        d = defs.get(e.name)
        if isinstance(d, OpClosure):
            # user operator: walk its body ONCE (occurrences inside are
            # classified by their own contexts); call-site arguments are
            # conservatively pinned — the body may route a parameter
            # into a static-only position
            if e.name not in seen_ops:
                seen_ops.add(e.name)
                _lift_walk(d.body, True, consts, pinned, defs, seen_ops)
            for a in e.args:
                _lift_walk(a, False, consts, pinned, defs, seen_ops)
            return
        # unknown / static-shaped builtin (.., Cardinality, DOMAIN,
        # SUBSET, Append, ...): operand positions are pinned
        for a in e.args:
            _lift_walk(a, False, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.If):
        for c in (e.cond, e.then, e.els):
            _lift_walk(c, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.Case):
        for cond, body in e.arms:
            _lift_walk(cond, safe, consts, pinned, defs, seen_ops)
            _lift_walk(body, safe, consts, pinned, defs, seen_ops)
        _lift_walk(e.other, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.Quant):
        for _names, dom in e.binders:
            _lift_walk(dom, False, consts, pinned, defs, seen_ops)
        _lift_walk(e.body, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.SetFilter):
        _lift_walk(e.set, False, consts, pinned, defs, seen_ops)
        _lift_walk(e.pred, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.SetMap):
        for _names, dom in e.binders:
            _lift_walk(dom, False, consts, pinned, defs, seen_ops)
        _lift_walk(e.expr, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.FnDef):
        for _names, dom in e.binders:
            _lift_walk(dom, False, consts, pinned, defs, seen_ops)
        _lift_walk(e.body, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.Let):
        for d in e.defs:
            body = getattr(d, "body", None) or getattr(d, "expr", None)
            _lift_walk(body, safe, consts, pinned, defs, seen_ops)
        _lift_walk(e.body, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.Except):
        _lift_walk(e.fn, False, consts, pinned, defs, seen_ops)
        for path, rhs in e.updates:
            for kind, part in path:
                if kind == "idx":
                    for p in part:
                        _lift_walk(p, False, consts, pinned, defs,
                                   seen_ops)
            _lift_walk(rhs, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, (A.TupleExpr,)):
        for x in e.items:
            _lift_walk(x, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.RecordExpr):
        for _f, v in e.fields:
            _lift_walk(v, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, A.Prime):
        _lift_walk(e.expr, safe, consts, pinned, defs, seen_ops)
        return
    if isinstance(e, (A.BoxAction, A.AngleAction)):
        _lift_walk(e.expr, safe, consts, pinned, defs, seen_ops)
        return
    # everything else (SetEnum, FnApp, Dot, FnSet, RecordSet, Choose,
    # Unchanged, Enabled, Fair, Lambda, temporal forms): conservative —
    # every child is a pinned context
    for f in getattr(e, "__dataclass_fields__", ()):
        v = getattr(e, f)
        if isinstance(v, A.Node):
            _lift_walk(v, False, consts, pinned, defs, seen_ops)
        elif isinstance(v, tuple):
            for x in _flat_nodes(v):
                _lift_walk(x, False, consts, pinned, defs, seen_ops)


def _flat_nodes(v):
    for x in v:
        if isinstance(x, A.Node):
            yield x
        elif isinstance(x, tuple):
            yield from _flat_nodes(x)


def _pin_all(e, consts: set, pinned: set, defs: Dict[str, Any],
             seen_ops: set) -> None:
    """Pin EVERY constant reachable from `e`, including through user
    operator bodies — used for VIEW/SYMMETRY, whose whole expression
    feeds the dedup-key basis."""
    from ..sem.eval import OpClosure
    if e is None or isinstance(e, (A.Num, A.Str, A.Bool, A.At)):
        return
    if isinstance(e, A.Ident):
        if e.name in consts:
            pinned.add(e.name)
        return
    if isinstance(e, A.OpApp):
        if e.name in consts and not e.args:
            pinned.add(e.name)
        d = defs.get(e.name)
        if isinstance(d, OpClosure) and e.name not in seen_ops:
            seen_ops.add(e.name)
            _pin_all(d.body, consts, pinned, defs, seen_ops)
    for f in getattr(e, "__dataclass_fields__", ()):
        v = getattr(e, f)
        if isinstance(v, A.Node):
            _pin_all(v, consts, pinned, defs, seen_ops)
        elif isinstance(v, tuple):
            for x in _flat_nodes(v):
                _pin_all(x, consts, pinned, defs, seen_ops)


def liftable_constants(model) -> Tuple[str, ...]:
    """Sorted cfg CONSTANT names whose values may become per-model
    batch lanes: plain ints (not bools — bool lanes would change guard
    structure) used only in value positions across Init, Next, the
    checked predicates, and every reachable operator body."""
    consts = {n for n, v in model.cfg.constants.items()
              if type(model.defs.get(n)) is int}
    if not consts:
        return ()
    pinned: set = set()
    seen_ops: set = set()
    tops = [model.init, model.next]
    tops += [ex for _n, ex in model.invariants]
    tops += [ex for _n, ex in model.constraints]
    tops += [ex for _n, ex in model.action_constraints]
    tops += [ex for _n, ex in model.properties]
    try:
        for t in tops:
            _lift_walk(t, True, consts, pinned, model.defs, seen_ops)
        # VIEW and SYMMETRY feed the DEDUP-KEY basis, which the device
        # engines also trace OUTSIDE the constant-lane install sites
        # (_keys_of under _host_keys): any constant they reach — value
        # position or not — must stay baked, so pin wholesale
        for t in (model.view, model.symmetry):
            _pin_all(t, consts, pinned, model.defs, set())
    except RecursionError:
        return ()
    return tuple(sorted(consts - pinned))


_NO_REPORT = object()  # "never analyzed" vs a cached ran-and-bailed None


def av_cardinality(av: Optional[AV], depth: int = 0) -> Optional[int]:
    """Upper bound on the number of distinct concrete values the
    abstract value can denote; None = unbounded/unknown.  Soundly
    over-counts (a possibly-partial function counts each key as
    absent-or-any-value), never under-counts."""
    if av is None or depth > _MAX_DEPTH:
        return None
    k = av[0]
    if k == "bool":
        return 2
    if k == "int":
        iv = av[1]
        if iv.bounded():
            return max(int(iv.hi) - int(iv.lo) + 1, 1)
        return None
    if k == "enum":
        return len(av[1]) if av[1] else None
    if k == "set":
        if av[1] is None:
            return 1  # provably always empty
        c = av_cardinality(av[1], depth + 1)
        if c is not None and c <= 24:
            return 2 ** c
        return None
    if k == "fun":
        dc = av_cardinality(av[1], depth + 1)
        rc = av_cardinality(av[2], depth + 1)
        if dc is not None and rc is not None and dc <= 16 \
                and rc < 2 ** 20:
            # rc+1: each key may also be ABSENT (partial functions /
            # varying domains share this abstraction)
            return min((rc + 1) ** dc, 2 ** 62)
        return None
    if k == "rec":
        est = 1
        for _kk, v in av[1]:
            c = av_cardinality(v, depth + 1)
            if c is None:
                return None
            est *= c
            if est >= 2 ** 62:
                return 2 ** 62
        return est
    return None  # seq/blob: an unbounded count axis


def state_space_estimate(model, report: Optional[BoundsReport] = None
                         ) -> Optional[int]:
    """A pre-scheduling COST bound from the converged fixpoint: the
    product of per-variable value-count bounds (interval spans, enum
    value-set cardinalities, set powersets, function spaces — 
    widened this beyond pure-int vars).  None when the fixpoint bails,
    fails to converge, or ANY variable's count is unbounded — the fast
    lane and the predicted-capacity rung must never act on a guess (a
    multi-minute search jumping the queue, or an undersized engine
    paying growth recompiles, is the exact inversion they exist to
    prevent)."""
    if report is None:
        rep = getattr(model, "_bounds_report", _NO_REPORT)
        if rep is None:
            # the analysis already RAN on this model and bailed —
            # re-running the whole fixpoint would bail again after
            # paying the full budget a second time
            return None
        report = rep if isinstance(rep, BoundsReport) \
            else infer_state_bounds(model)
    if report is None or not report.converged:
        return None
    est = 1
    for v in model.vars:
        c = av_cardinality(report.env.get(v))
        if c is None:
            return None
        est *= max(c, 1)
        if est >= 2 ** 62:
            return 2 ** 62
    return est


def merge_lane_bounds(bounds_list) -> Dict[str, Tuple[int, int]]:
    """Interval-union of per-member proven lane bounds for a batched
    engine's shared layout: a variable keeps a proof only when EVERY
    member proves one (absent anywhere -> unproven, sampled+guarded)."""
    merged: Dict[str, Tuple[int, int]] = {}
    bl = [b for b in bounds_list]
    if not bl or any(b is None for b in bl):
        return {}
    common = set(bl[0])
    for b in bl[1:]:
        common &= set(b)
    for v in common:
        merged[v] = (min(b[v][0] for b in bl),
                     max(b[v][1] for b in bl))
    return merged


def _union_iv(a: Optional[Tuple[int, int]], b: Optional[Tuple[int, int]]
              ) -> Optional[Tuple[int, int]]:
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def merge_eb(a: Optional[EB], b: Optional[EB]) -> Optional[EB]:
    """Structural interval-union of two per-element bound trees: every
    node keeps a proof only when BOTH sides prove one (a None child on
    either side drops to None, and the consumer — pack._sb_child —
    falls back to the merged covering `all`, a superset for both
    members).  Record keys survive only where both sides track a
    non-None per-key bound."""
    if a is None or b is None:
        return None
    keys = None
    if a.keys and b.keys:
        keys = {}
        for k in set(a.keys) & set(b.keys):
            m = merge_eb(a.keys.get(k), b.keys.get(k))
            if m is not None:
                keys[k] = m
        keys = keys or None
    out = EB(all=_union_iv(a.all, b.all),
             dom=merge_eb(a.dom, b.dom),
             rng=merge_eb(a.rng, b.rng),
             elem=merge_eb(a.elem, b.elem),
             keys=keys)
    return None if out.empty() else out


def merge_element_bounds(eb_list) -> Dict[str, "EB"]:
    """Per-element analog of merge_lane_bounds: the
    STRUCTURAL union of every member's element_bounds() trees, so a
    batch donor's container element lanes still pack at proven
    per-element widths instead of dropping to whole-variable summary
    intervals.  A variable keeps its tree only when every member proves
    one; the result is sound for all members by construction (each node
    is an interval union, each missing node a superset fallback)."""
    el = [e for e in eb_list]
    if not el or any(e is None for e in el):
        return {}
    common = set(el[0])
    for e in el[1:]:
        common &= set(e)
    merged: Dict[str, EB] = {}
    for v in common:
        m = el[0][v]
        for e in el[1:]:
            m = merge_eb(m, e[v])
            if m is None:
                break
        if m is not None:
            merged[v] = m
    return merged
