r"""Action-independence analysis.

Per split arm (compile/ground.split_arms), a conservative READ/WRITE
variable footprint over the arm's AST:

  reads   pre-state variables the arm's guards, binder domains and
          assignment right-hand sides may depend on
  writes  variables whose post-value may differ from the pre-value
          (primed assignments + any variable whose disposition the walk
          cannot prove — UNCHANGED variables are neither)

Two arms COMMUTE when their footprints are non-interfering:

  W_i \cap W_j = {}   and   W_i \cap R_j = {}   and   W_j \cap R_i = {}

which is the classic dependency relation of partial-order reduction
(Godefroid/Valmari persistent sets; Holzmann's SPIN): firing one arm
cannot enable, disable, or change the effect of the other, and both
orders reach the same state.  Anything the walk cannot analyze (instance
paths, unresolvable UNCHANGED targets, recursion) bails to the FULL
footprint — commuting with nothing, which is always sound.

Consumers:

  * safe arm REGROUPING (backend/bfs._hstep_groups, mesh grouped
    expand): commuting arms pack into the same <=24-instance fused
    dispatch via `plan_arm_groups`; the engines restore provenance
    order at the merge, so counts/traces stay byte-identical while
    `expand.fused_groups` shrinks.  Default ON; JAXMC_ANALYZE_INDEP=0
    keeps the legacy contiguous grouping.
  * POR frontier reduction (engine/explore.py, opt-in --por): a
    persistent-set-style filter expands ONE globally-commuting
    invisible arm per state (when all its successors are new — the BFS
    cycle proviso) instead of every enabled arm, preserving
    invariant/deadlock verdicts (not raw state counts).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..front import tla_ast as A


def indep_enabled() -> bool:
    """JAXMC_ANALYZE_INDEP=0 disables independence-driven regrouping
    (the POR filter has its own opt-in flag, --por)."""
    return os.environ.get("JAXMC_ANALYZE_INDEP", "1").strip().lower() \
        not in ("0", "off", "false")


class _NoKey:
    __slots__ = ()

    def __repr__(self):
        return "<nokey>"


_NOKEY = _NoKey()

# a binder domain larger than this never becomes a _KeySet: the
# interference rules take set intersections and (for key arithmetic)
# cross products over the domain values
_KEYSET_MAX = 64


class _KeySet:
    """A binder key known only by its DOMAIN: the set of values the
    binder may take (dynamic element keys).  Interferes with
    a concrete key iff the key is a possible value, and with another
    _KeySet iff the domains overlap — two arms writing msgs[self] for
    bindings with disjoint domains commute element-wise instead of
    bailing to the whole-variable footprint."""
    __slots__ = ("vals",)

    def __init__(self, vals):
        self.vals = frozenset(vals)

    def __eq__(self, other):
        return isinstance(other, _KeySet) and self.vals == other.vals

    def __hash__(self):
        return hash((_KeySet, self.vals))

    def __repr__(self):
        return "{%s}" % "|".join(sorted(str(v) for v in self.vals))


class _TupleKey:
    """A statically-resolved tuple index (msgs[<<p, q>>]) — a dedicated
    wrapper so tuple keys cannot collide with the internal raw-tuple
    markers ($slotv etc.) that _static_key must keep rejecting."""
    __slots__ = ("items",)

    def __init__(self, items):
        self.items = tuple(items)

    def __eq__(self, other):
        return isinstance(other, _TupleKey) and self.items == other.items

    def __hash__(self):
        return hash((_TupleKey, self.items))

    def __repr__(self):
        return "<<%s>>" % ",".join(str(v) for v in self.items)


def _is_static_scalar(v) -> bool:
    from ..sem.values import ModelValue
    return isinstance(v, (int, str, ModelValue)) and \
        not isinstance(v, bool)


def _keys_may_equal(k1, k2) -> bool:
    """Could two STATIC keys denote the same container element?
    Concrete keys compare by equality; a _KeySet stands for any of its
    domain values; a tuple key never equals a scalar (TLA+ tuples and
    scalars are distinct values)."""
    if isinstance(k1, _TupleKey) and isinstance(k2, _TupleKey):
        if len(k1.items) != len(k2.items):
            return False
        return all(_keys_may_equal(a, b)
                   for a, b in zip(k1.items, k2.items))
    if isinstance(k1, _TupleKey) or isinstance(k2, _TupleKey):
        other = k2 if isinstance(k1, _TupleKey) else k1
        if isinstance(other, _KeySet):
            # scalar domain members never equal a tuple value; any
            # non-scalar member is conservatively a possible match
            return any(not _is_static_scalar(v) for v in other.vals)
        return False
    if isinstance(k1, _KeySet) and isinstance(k2, _KeySet):
        return bool(k1.vals & k2.vals)
    if isinstance(k1, _KeySet):
        return k2 in k1.vals
    if isinstance(k2, _KeySet):
        return k1 in k2.vals
    return k1 == k2


def _key_arith(op: str, a, b):
    """Static integer arithmetic over keys (msgs[self+1]): concrete op
    concrete folds; a _KeySet maps over its domain (bounded cross
    product)."""
    def ints(k):
        if isinstance(k, int) and not isinstance(k, bool):
            return [k]
        if isinstance(k, _KeySet) and all(
                isinstance(v, int) and not isinstance(v, bool)
                for v in k.vals):
            return list(k.vals)
        return None
    av, bv = ints(a), ints(b)
    if av is None or bv is None or len(av) * len(bv) > _KEYSET_MAX:
        return _NOKEY
    f = (lambda x, y: x + y) if op == "+" else (lambda x, y: x - y)
    out = {f(x, y) for x in av for y in bv}
    if len(out) == 1:
        return next(iter(out))
    return _KeySet(out)


# Footprint ATOMS are (var, key) pairs: key None = the whole variable,
# a concrete key = ONE container element (pc[p1]), a _KeySet = one
# element from a known domain, a _TupleKey = one tuple-indexed element.
# Two atoms interfere when they name the same variable and either is
# whole-var or the keys MAY be equal — the granularity that lets
# raft/Paxos-style per-process arms over one shared container commute.
Atom = Tuple[str, object]


def _interfere(a: FrozenSet[Atom], b: FrozenSet[Atom]) -> bool:
    for v1, k1 in a:
        for v2, k2 in b:
            if v1 != v2:
                continue
            if k1 is None or k2 is None or _keys_may_equal(k1, k2):
                return True
    return False


def _fmt_atoms(atoms: FrozenSet[Atom]) -> str:
    out = []
    for v, k in sorted(atoms, key=lambda a: (a[0], repr(a[1]))):
        out.append(v if k is None else f"{v}[{k}]")
    return ",".join(out)


@dataclass(frozen=True)
class ArmFootprint:
    label: str
    reads: FrozenSet[Atom]
    writes: FrozenSet[Atom]
    exact: bool  # False: the walk bailed and the footprint is ALL vars
    bail_reason: Optional[str] = None  # named, when exact is False

    def write_vars(self) -> FrozenSet[str]:
        return frozenset(v for v, _k in self.writes)

    def key_class(self) -> str:
        """Dynamic-key classification: did the writes
        resolve to element atoms — the granularity regrouping and POR
        consume — and when not, why."""
        if not self.exact:
            return ("full-footprint bail "
                    f"({self.bail_reason or 'unanalyzable'})")
        whole = sorted({v for v, k in self.writes if k is None})
        if whole:
            return f"whole-var writes: {','.join(whole)}"
        return "element-commuting"


def _bail(acc, why: str) -> None:
    acc["bail"] = True
    acc.setdefault("why", why)


class _FootprintWalk:
    """One model's footprint collector; def-body footprints memoized."""

    def __init__(self, model):
        self.model = model
        self.vars = set(model.vars)
        self.defs = model.defs
        self._def_memo: Dict[str, Tuple[Set[Atom], Set[Atom], Set[str],
                                        bool, Optional[str]]] = {}
        self._nodes = 0

    # ---- one arm ------------------------------------------------------
    def arm(self, arm) -> ArmFootprint:
        label = arm.label or "Next"
        acc = {"r": set(), "w": set(), "u": set(), "bail": False}
        try:
            self._walk(arm.expr, frozenset(), acc, (),
                       dict(arm.bound or {}))
        except RecursionError:
            _bail(acc, "python recursion limit")
        if acc["bail"]:
            allv = frozenset((v, None) for v in self.vars)
            return ArmFootprint(label, allv, allv, exact=False,
                                bail_reason=acc.get("why"))
        # a variable the walk never classified is an unknown write
        classified = {v for v, _k in acc["w"]} | acc["u"]
        for v in self.vars - classified:
            acc["w"].add((v, None))
        reads = frozenset((v, k) for v, k in acc["r"]
                          if v in self.vars)
        writes = frozenset((v, k) for v, k in acc["w"]
                           if v in self.vars)
        return ArmFootprint(label, reads, writes, exact=True)

    # ---- static-key resolution ---------------------------------------
    def _static_key(self, e, shadow, bound):
        """The static key of an index expression, or _NOKEY.  A key is
        concrete (binder/CONSTANT scalar), a _KeySet (binder over a
        statically-enumerable domain), a _TupleKey (tuple index of
        static components), or static +/- arithmetic over those."""
        if isinstance(e, A.Num):
            return e.val
        if isinstance(e, A.Str):
            return e.val
        if isinstance(e, A.TupleExpr):
            items = []
            for it in e.items:
                k = self._static_key(it, shadow, bound)
                if k is _NOKEY:
                    return _NOKEY
                items.append(k)
            return _TupleKey(items)
        if isinstance(e, A.OpApp) and not e.path and \
                e.name in ("+", "-") and len(e.args) == 2:
            return _key_arith(e.name,
                              self._static_key(e.args[0], shadow, bound),
                              self._static_key(e.args[1], shadow, bound))
        if isinstance(e, A.Ident) and e.name not in shadow:
            v = _NOKEY
            if e.name in bound:
                v = bound[e.name]
            elif e.name not in self.vars:
                # a cfg-bound CONSTANT scalar is as static as a binder
                from ..sem.values import ModelValue
                d = self.defs.get(e.name)
                if isinstance(d, (int, str, ModelValue)) and \
                        not isinstance(d, bool):
                    v = d
            if v is _NOKEY:
                return _NOKEY
            try:
                hash(v)
            except TypeError:
                return _NOKEY
            if isinstance(v, tuple):
                return _NOKEY  # internal markers ($slotv etc.)
            return v
        return _NOKEY

    def _index_key(self, args, shadow, bound):
        """The static key of an index-argument list: one argument is
        the key itself, several are the implicit tuple f[a, b]."""
        if len(args) == 1:
            return self._static_key(args[0], shadow, bound)
        items = []
        for a in args:
            k = self._static_key(a, shadow, bound)
            if k is _NOKEY:
                return _NOKEY
            items.append(k)
        return _TupleKey(items)

    def _static_domain(self, dom, shadow, bound):
        """The statically-enumerable value set of a binder domain, or
        None.  Members must be concrete scalar keys: the _KeySet
        interference rules reason over possible key VALUES, so one
        unresolvable member poisons the whole domain."""
        if dom is None:
            return None
        if isinstance(dom, A.SetEnum):
            vals = []
            for it in dom.items:
                k = self._static_key(it, shadow, bound)
                if not _is_static_scalar(k):
                    return None
                vals.append(k)
            return frozenset(vals) \
                if 0 < len(vals) <= _KEYSET_MAX else None
        if isinstance(dom, A.Ident) and dom.name not in shadow \
                and dom.name not in self.vars:
            d = self.defs.get(dom.name)
            if isinstance(d, (set, frozenset)) and \
                    0 < len(d) <= _KEYSET_MAX and \
                    all(_is_static_scalar(v) for v in d):
                return frozenset(d)
            return None
        if isinstance(dom, A.SetFilter):
            # a filter only narrows its base set: the base's value set
            # over-approximates the binder's possible keys, which is
            # sound (a larger _KeySet only interferes MORE) — this is
            # the dynamic raft shape `\E i \in {j \in Server : cond}`
            base = getattr(dom, "set", None)
            return None if base is None else \
                self._static_domain(base, shadow, bound)
        if isinstance(dom, A.OpApp) and not dom.path and \
                dom.name == ".." and len(dom.args) == 2:
            lo = self._static_key(dom.args[0], shadow, bound)
            hi = self._static_key(dom.args[1], shadow, bound)
            if _is_static_scalar(lo) and _is_static_scalar(hi) and \
                    isinstance(lo, int) and isinstance(hi, int) and \
                    0 < hi - lo + 1 <= _KEYSET_MAX:
                return frozenset(range(lo, hi + 1))
        return None

    # ---- recursive walk ----------------------------------------------
    def _walk(self, e, shadow: FrozenSet[str], acc, stack,
              bound) -> None:
        self._nodes += 1
        if e is None or acc["bail"] or self._nodes > 200000:
            if self._nodes > 200000:
                _bail(acc, "node budget exceeded")
            return
        if isinstance(e, (A.Num, A.Str, A.Bool, A.At)):
            return
        if isinstance(e, A.Ident):
            if e.name in shadow:
                return
            if e.name in self.vars:
                acc["r"].add((e.name, None))
                return
            self._def_use(e.name, acc, stack)
            return
        if isinstance(e, A.FnApp):
            # element read: pc[p] with a statically-bound p reads ONE
            # atom, not the whole container (f[a, b] = f[<<a, b>>])
            if isinstance(e.fn, A.Ident) and e.fn.name in self.vars \
                    and e.fn.name not in shadow and len(e.args) >= 1:
                k = self._index_key(e.args, shadow, bound)
                if k is not _NOKEY:
                    acc["r"].add((e.fn.name, k))
                    return
            self._walk(e.fn, shadow, acc, stack, bound)
            for a in e.args:
                self._walk(a, shadow, acc, stack, bound)
            return
        if isinstance(e, A.Prime):
            if isinstance(e.expr, A.Ident) and e.expr.name in self.vars:
                acc["w"].add((e.expr.name, None))
                return
            # primed compound: every var under it may be written
            sub = {"r": set(), "w": set(), "u": set(),
                   "bail": False}
            self._walk(e.expr, shadow, sub, stack, bound)
            if sub["bail"]:
                _bail(acc, sub.get("why", "unanalyzable primed "
                                          "expression"))
                return
            acc["w"] |= {(v, None) for v, _k in sub["r"] | sub["w"]}
            return
        if isinstance(e, A.Unchanged):
            if not self._unchanged(e.expr, shadow, acc, stack):
                _bail(acc, "unresolvable UNCHANGED target")
            return
        if isinstance(e, A.OpApp):
            if e.path:  # instance-qualified: unmodelled
                _bail(acc, "instance-qualified operator")
                return
            # the per-element assignment shape: v' = [v EXCEPT ![k]=e]
            if e.name == "=" and len(e.args) == 2 and \
                    self._prime_assign(e.args[0], e.args[1], shadow,
                                       acc, stack, bound):
                return
            # user operator with statically-resolvable args (Grab(p)
            # under a split \E binding): walk the BODY under the
            # argument binding so element keys inside stay resolvable
            from ..sem.eval import OpClosure
            d = self.defs.get(e.name) if e.name not in shadow else None
            if isinstance(d, OpClosure) and \
                    len(d.params) == len(e.args) and \
                    not isinstance(d.body, A.FnConstrDef):
                if e.name in stack or len(stack) > 32:
                    _bail(acc, f"recursive operator {e.name}")
                    return
                bound2 = {}
                static_args = True
                for p, aexpr in zip(d.params, e.args):
                    k = self._static_key(aexpr, shadow, bound)
                    if k is _NOKEY:
                        static_args = False
                        break
                    bound2[p] = k
                if static_args:
                    self._walk(d.body, frozenset(), acc,
                               stack + (e.name,), bound2)
                    return
            if e.name not in shadow:
                self._def_use(e.name, acc, stack)
            for a in e.args:
                self._walk(a, shadow, acc, stack, bound)
            return
        # binder forms extend the shadow for their bodies
        shadow2 = shadow
        binders = None
        if isinstance(e, (A.Quant, A.SetMap, A.FnDef)):
            binders = e.binders
        if binders is not None:
            # a binder over a statically-enumerable domain binds its
            # name to a _KeySet of the possible values instead of
            # shadowing it: element keys indexed by the
            # binder stay resolvable, so a DYNAMIC \E (one arm) still
            # gets an element-level footprint.  Names colliding with a
            # state variable or an operator keep the shadow path (the
            # Ident walk would misread them otherwise).
            names: List[str] = []
            ks_bound: Dict[str, object] = {}
            for bnames, dom in binders:
                names.extend(bnames)
                self._walk(dom, shadow, acc, stack, bound)
                dvals = self._static_domain(dom, shadow, bound)
                if dvals is not None:
                    ks = _KeySet(dvals)
                    for n in bnames:
                        if isinstance(n, str) and n not in self.vars \
                                and self.defs.get(n) is None:
                            ks_bound[n] = ks
            shadow2 = (shadow - frozenset(ks_bound)) | frozenset(
                n for n in names
                if isinstance(n, str) and n not in ks_bound)
            bound2 = bound if not ks_bound else {**bound, **ks_bound}
            self._walk(e.expr if isinstance(e, A.SetMap) else e.body,
                       shadow2, acc, stack, bound2)
            return
        if isinstance(e, (A.SetFilter, A.Choose)):
            v = e.var
            names = list(v) if isinstance(v, tuple) else [v]
            if getattr(e, "set", None) is not None:
                self._walk(e.set, shadow, acc, stack, bound)
            shadow2 = shadow | frozenset(n for n in names
                                         if isinstance(n, str))
            self._walk(e.pred, shadow2, acc, stack, bound)
            return
        if isinstance(e, A.Lambda):
            self._walk(e.body, shadow | frozenset(e.params), acc,
                       stack, bound)
            return
        if isinstance(e, A.Let):
            shadow2 = shadow
            for d in e.defs:
                body = getattr(d, "body", None)
                if body is not None:
                    params = tuple(getattr(d, "params", ()) or ())
                    self._walk(body, shadow2 | frozenset(
                        p for p in params if isinstance(p, str)),
                        acc, stack, bound)
                nm = getattr(d, "name", None)
                if isinstance(nm, str):
                    shadow2 = shadow2 | frozenset((nm,))
            self._walk(e.body, shadow2, acc, stack, bound)
            return
        # generic structural descent
        for f in getattr(e, "__dataclass_fields__", ()):
            v = getattr(e, f)
            if isinstance(v, A.Node):
                self._walk(v, shadow, acc, stack, bound)
            elif isinstance(v, tuple):
                self._walk_tuple(v, shadow, acc, stack, bound)

    def _walk_tuple(self, t, shadow, acc, stack, bound) -> None:
        for x in t:
            if isinstance(x, A.Node):
                self._walk(x, shadow, acc, stack, bound)
            elif isinstance(x, tuple):
                self._walk_tuple(x, shadow, acc, stack, bound)

    def _prime_assign(self, tgt, rhs, shadow, acc, stack,
                      bound) -> bool:
        """Element-precise handling of `v' = [v EXCEPT ![k] = e]` (and
        the identity `v' = v`): returns True when the shape was fully
        classified, False to fall back to the generic walk."""
        if not (isinstance(tgt, A.Prime) and isinstance(tgt.expr,
                                                        A.Ident)):
            return False
        var = tgt.expr.name
        if var not in self.vars:
            return False
        if isinstance(rhs, A.Ident) and rhs.name == var \
                and var not in shadow:
            acc["u"].add(var)  # v' = v: provably unchanged
            return True
        if isinstance(rhs, A.Except) and isinstance(rhs.fn, A.Ident) \
                and rhs.fn.name == var and var not in shadow:
            keys = []
            for path, upd in rhs.updates:
                if len(path) != 1 or path[0][0] != "idx" \
                        or len(path[0][1]) < 1:
                    return False  # nested/dot path: generic fallback
                k = self._index_key(path[0][1], shadow, bound)
                if k is _NOKEY:
                    return False
                keys.append(k)
                # @ refers to the SAME element being replaced
                self._walk(upd, shadow, acc, stack, bound)
            for k in keys:
                acc["w"].add((var, k))
                acc["r"].add((var, k))  # @ / read-modify-write shape
            return True
        return False

    def _unchanged(self, e, shadow, acc, stack) -> bool:
        """UNCHANGED target: vars under it are neither read nor
        written.  Returns False when a target cannot be resolved."""
        from ..sem.eval import OpClosure
        if isinstance(e, A.Ident):
            if e.name in self.vars:
                acc["u"].add(e.name)
                return True
            d = self.defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params:
                if e.name in stack or len(stack) > 24:
                    return False
                return self._unchanged(d.body, shadow, acc,
                                       stack + (e.name,))
            return False
        if isinstance(e, A.TupleExpr):
            return all(self._unchanged(x, shadow, acc, stack)
                       for x in e.items)
        return False

    def _def_use(self, name: str, acc, stack) -> None:
        """Fold a referenced definition's memoized footprint in."""
        from ..sem.eval import OpClosure
        d = self.defs.get(name)
        if not isinstance(d, OpClosure):
            return
        fp = self._def_memo.get(name)
        if fp is None:
            if name in stack or len(stack) > 32:
                _bail(acc, f"recursive operator {name}")
                return
            sub = {"r": set(), "w": set(), "u": set(), "bail": False}
            body = d.body
            if isinstance(body, A.FnConstrDef):
                body = body.body
            self._walk(body, frozenset(
                p for p in d.params if isinstance(p, str)),
                sub, stack + (name,), {})
            fp = (sub["r"], sub["w"], sub["u"], sub["bail"],
                  sub.get("why"))
            self._def_memo[name] = fp
        r, w, u, bail, why = fp
        if bail:
            _bail(acc, why or f"unanalyzable operator {name}")
            return
        acc["r"] |= r
        acc["w"] |= w
        acc["u"] |= u


def _expr_vars(model, e) -> Set[str]:
    """State variables an expression may depend on (transitively)."""
    fw = _FootprintWalk(model)
    acc = {"r": set(), "w": set(), "u": set(), "bail": False}
    try:
        fw._walk(e, frozenset(), acc, (), {})
    except RecursionError:
        acc["bail"] = True
    if acc["bail"]:
        return set(model.vars)
    return {v for v, _k in acc["r"] | acc["w"]} & set(model.vars)


@dataclass
class IndependenceReport:
    """Per-arm footprints + the conservative commutativity matrix."""
    labels: List[str]
    footprints: List[ArmFootprint]
    commutes: List[List[bool]]          # NxN, symmetric, False on diag
    visible: FrozenSet[str] = frozenset()  # property-support vars
    por_safe: Tuple[int, ...] = ()      # arms eligible as singleton
    # ample sets: globally commuting AND invisible
    wall_s: float = 0.0

    def commuting_pairs(self) -> int:
        n = len(self.labels)
        return sum(1 for i in range(n) for j in range(i + 1, n)
                   if self.commutes[i][j])

    def matrix_rows(self) -> List[str]:
        """Render for `jaxmc info --cfg` / logs: one row per arm."""
        out = []
        for i, lb in enumerate(self.labels):
            fp = self.footprints[i]
            marks = "".join("c" if self.commutes[i][j] else
                            ("." if i == j else "x")
                            for j in range(len(self.labels)))
            out.append(
                f"{lb:24s} [{marks}] R={{{_fmt_atoms(fp.reads)}}}"
                f" W={{{_fmt_atoms(fp.writes)}}}"
                + ("" if fp.exact else " (bailed: full footprint)")
                + (" por-safe" if i in self.por_safe else ""))
        return out

    def keyclass_rows(self) -> List[str]:
        """Dynamic-key classification per arm, rendered for
        `jaxmc info --cfg` next to the matrix: element-commuting /
        whole-var writes / full-footprint bail with the reason named."""
        return [f"{lb:24s} {self.footprints[i].key_class()}"
                for i, lb in enumerate(self.labels)]


def independence_report(model, arms=None) -> IndependenceReport:
    """Compute (and cache on the model) the arm-independence report.
    Never raises: an analysis defect degrades to full footprints."""
    import time
    cached = getattr(model, "_indep_report", None)
    if isinstance(cached, IndependenceReport):
        return cached
    t0 = time.time()
    if arms is None:
        from ..compile.ground import split_arms
        arms = split_arms(model)
    try:
        fw = _FootprintWalk(model)
        fps = [fw.arm(a) for a in arms]
    except Exception:
        if os.environ.get("JAXMC_DEBUG"):
            raise
        full = frozenset((v, None) for v in model.vars)
        fps = [ArmFootprint(a.label or "Next", full, full, exact=False,
                            bail_reason="analysis error")
               for a in arms]
    n = len(fps)
    mat = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            a, b = fps[i], fps[j]
            ok = not _interfere(a.writes, b.writes) and \
                not _interfere(a.writes, b.reads) and \
                not _interfere(b.writes, a.reads)
            mat[i][j] = mat[j][i] = ok
    # visibility: the support of every checked predicate — an arm
    # writing none of these cannot change any property verdict's
    # atomic propositions (POR condition C2)
    vis: Set[str] = set()
    try:
        for _nm, ex in list(model.invariants) + list(model.properties):
            vis |= _expr_vars(model, ex)
    except Exception:
        if os.environ.get("JAXMC_DEBUG"):
            raise
        vis = set(model.vars)
    safe = tuple(
        i for i in range(n)
        if fps[i].exact
        and all(mat[i][j] for j in range(n) if j != i)
        and not (fps[i].write_vars() & vis))
    rep = IndependenceReport(
        labels=[fp.label for fp in fps], footprints=fps, commutes=mat,
        visible=frozenset(vis), por_safe=safe,
        wall_s=round(time.time() - t0, 6))
    try:
        model._indep_report = rep
    except AttributeError:
        pass
    return rep


def por_refusal(model) -> Optional[str]:
    """Why --por must NOT reduce this model (run unreduced, named):
    constructs whose semantics interact with the reduction.  CONSTRAINT
    discards intermediate states (a commuting arm's effect could be
    lost through a discarded interleaving), SYMMETRY/VIEW already
    collapse the state space on their own orbits, and refinement/
    temporal properties quantify over the full behavior graph."""
    if model.constraints:
        return "cfg CONSTRAINT discards interleaving states"
    if model.action_constraints:
        return "cfg ACTION-CONSTRAINT filters interleavings"
    if model.symmetry is not None:
        return "cfg SYMMETRY (two reductions would compose unsoundly)"
    if getattr(model, "view", None) is not None:
        return "cfg VIEW collapses the dedup basis"
    if model.properties:
        return "temporal/refinement PROPERTYs need the full graph"
    return None


# ---------------------------------------------------------------------------
# fused-group planning (regrouping consumer)
# ---------------------------------------------------------------------------


def plan_arm_groups(weights: List[int], arm_of: List[int],
                    commutes: Optional[List[List[bool]]],
                    fused_max: int) -> List[List[int]]:
    """Partition compiled-action indices into fused dispatch groups of
    total instance weight <= fused_max.

    Legacy behavior (and the JAXMC_ANALYZE_INDEP=0 / no-matrix
    fallback): contiguous first-fit in index order.  With a
    commutativity matrix, actions cluster into mutually-commuting
    cliques first and the cliques bin-pack first-fit-decreasing — the
    plan with FEWER groups wins (ties keep the contiguous plan, zero
    churn).  Callers restore original provenance order at the merge,
    so ANY permutation here is result-identical; the matrix only
    steers which arms share a dispatch.
    """
    def contiguous() -> List[List[int]]:
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_w = 0
        for i, w in enumerate(weights):
            if cur and cur_w + w > fused_max:
                groups.append(cur)
                cur, cur_w = [], 0
            cur.append(i)
            cur_w += w
        if cur:
            groups.append(cur)
        return groups

    base = contiguous()
    if commutes is None or not indep_enabled() or len(weights) <= 1:
        return base

    def commute(i: int, j: int) -> bool:
        ai, aj = arm_of[i], arm_of[j]
        if ai == aj:
            return True  # instances of one arm always share a dispatch
        return commutes[ai][aj]

    # mutually-commuting cliques, greedy in index order
    cliques: List[List[int]] = []
    for i in range(len(weights)):
        for cl in cliques:
            if all(commute(i, o) for o in cl):
                cl.append(i)
                break
        else:
            cliques.append([i])
    # split any clique larger than the cap into weight-bounded runs
    units: List[List[int]] = []
    for cl in cliques:
        cur, cur_w = [], 0
        for i in cl:
            w = weights[i]
            if cur and cur_w + w > fused_max:
                units.append(cur)
                cur, cur_w = [], 0
            cur.append(i)
            cur_w += w
        if cur:
            units.append(cur)
    # first-fit-decreasing over clique units; a unit only joins a bin
    # whose members it fully commutes with (the point of regrouping is
    # commuting arms SHARING a dispatch, not arbitrary packing)
    units.sort(key=lambda u: -sum(weights[i] for i in u))
    packed: List[Tuple[int, List[int]]] = []  # (weight, members)
    for u in units:
        uw = sum(weights[i] for i in u)
        for gi, (gw, members) in enumerate(packed):
            if gw + uw <= fused_max and \
                    all(commute(i, o) for i in u for o in members):
                packed[gi] = (gw + uw, members + u)
                break
        else:
            packed.append((uw, list(u)))
    planned = [sorted(members) for _w, members in packed]
    # deterministic dispatch order: by first member index
    planned.sort(key=lambda g: g[0])
    if len(planned) < len(base):
        return planned
    return base
