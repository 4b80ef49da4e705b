r"""TLC-style state enumeration: walking Init and Next as assignment programs.

This is the loop reconstructed in SURVEY.md §3.2: a conjunction is processed
left-to-right threading partial assignments; `v = e` assigns (or filters, if
already assigned), `v \in S` branches over S's elements, disjunctions and
\E branch, user operator applications expand, everything else is a boolean
guard. The same walker serves Init (unprimed targets), Next (primed targets),
and ENABLED.

Action labels: the innermost named operator expanded before the action's
first guard or assignment is evaluated (Restart(s1), Receive(m), ...) — the
provenance TLC prints in counterexample traces
(tla-rust README.md:278-311). A label is a (name, args, frozen)
triple: operator expansion overwrites it until frozen by the first
guard/assignment.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..front import tla_ast as A
from .values import EvalError, enumerate_set, fmt, in_set, tla_eq
from .eval import (Ctx, OpClosure, _arg_value, _bool, _resolve, eval_expr,
                   iter_binders, make_let_defs)


_OP_PLAN_CAP = 1 << 16  # entries; cleared beyond (LET-heavy specs mint
# fresh closures per evaluation, so an id-keyed cache must be bounded)


class Walker:
    """mode 'init': assign unprimed variables; mode 'next': assign primes.

    A Walker is reusable across states (engine hot loop): the expansion
    plan for each operator application — call-by-name vs call-by-value,
    and the substituted body for the call-by-name case — depends only on
    the application node and the resolved closure, so it is decided ONCE
    per run and cached, instead of re-running the contains_prime /
    primes_params AST scans and the subst() tree rebuild on every state
    (the dominant per-state cost the profiler showed on transfer_scaled).
    """

    def __init__(self, mode: str, vars: Tuple[str, ...], state=None):
        assert mode in ("init", "next")
        self.mode = mode
        self.vars = set(vars)
        self.var_order = tuple(vars)
        self.state = state  # fixed pre-state in next mode
        # (id(app-node), id(closure)) -> ("cbn", substituted-body) |
        # ("call", None); _plan_pins keeps the keyed objects alive so a
        # gc'd closure's id is never reused against a stale plan
        self._op_plan = {}
        self._plan_pins = []

    def _ctx(self, base: Ctx, partial: Dict[str, Any]) -> Ctx:
        if self.mode == "init":
            return Ctx(base.defs, base.bound, partial, None, self.var_order,
                       base.on_print, base.memo)
        return Ctx(base.defs, base.bound, self.state, partial, self.var_order,
                   base.on_print, base.memo)

    def _target(self, e: A.Node, ctx: Ctx) -> Optional[str]:
        """Variable name if e is an assignable occurrence in this mode."""
        if self.mode == "next":
            if isinstance(e, A.Prime) and isinstance(e.expr, A.Ident) \
                    and e.expr.name in self.vars:
                return e.expr.name
            return None
        if isinstance(e, A.Ident) and e.name in self.vars \
                and e.name not in ctx.bound:
            return e.name
        return None

    def _op_expand_plan(self, e: A.OpApp, target: OpClosure):
        """The once-per-run expansion decision for `target` applied at
        node `e`: call-by-name (with the substituted body, built once)
        when an argument or the body primes a parameter, else plain
        call-by-value. Both inputs are immutable, so the plan is a pure
        function of (node, closure)."""
        ck = (id(e), id(target))
        plan = self._op_plan.get(ck)
        if plan is None:
            from ..front.subst import (contains_prime, primes_params,
                                       subst)
            if (any(contains_prime(a) for a in e.args)
                    or primes_params(target.body, target.params)) \
                    and target.defs is None:
                # call-by-name: an argument carries a primed variable
                # (Lose(msgQ) assigning q', Send(..., memInt') through an
                # operator constant) — substitute argument ASTs so the
                # assignment target survives into the body
                plan = ("cbn", subst(target.body,
                                     dict(zip(target.params, e.args))))
            else:
                plan = ("call", None)
            if len(self._op_plan) >= _OP_PLAN_CAP:
                self._op_plan.clear()
                self._plan_pins.clear()
            self._op_plan[ck] = plan
            self._plan_pins.append((e, target))
        return plan

    def walk(self, e: A.Node, ctx: Ctx, partial: Dict[str, Any],
             label) -> Iterator[Tuple[Dict[str, Any], Any]]:
        """Yield (complete-or-partial assignment, action label) pairs.

        The evaluation context (ectx) is built lazily per branch: the
        structural branches (conjunction, disjunction, operator
        expansion, UNCHANGED) never evaluate an expression, and they are
        the bulk of the walk calls."""
        if isinstance(e, A.OpApp):
            name = e.name
            if name == "/\\":
                for p1, l1 in self.walk(e.args[0], ctx, partial, label):
                    yield from self.walk(e.args[1], ctx, p1, l1)
                return
            if name == "\\/":
                for arm in e.args:
                    yield from self.walk(arm, ctx, dict(partial), label)
                return
            if name == "=":
                tgt = self._target(e.args[0], ctx)
                if tgt is not None:
                    label = _freeze(label)
                    ectx = self._ctx(ctx, partial)
                    if tgt in partial:
                        # second assignment acts as an equality filter
                        rhs = eval_expr(e.args[1], ectx)
                        if tla_eq(partial[tgt], rhs):
                            yield partial, label
                        return
                    rhs = eval_expr(e.args[1], ectx)
                    partial[tgt] = rhs
                    yield partial, label
                    return
                # fall through to guard evaluation
            if name == "\\in":
                tgt = self._target(e.args[0], ctx)
                if tgt is not None:
                    label = _freeze(label)
                    sval = eval_expr(e.args[1], self._ctx(ctx, partial))
                    if tgt in partial:
                        if in_set(partial[tgt], sval):
                            yield partial, label
                        return
                    for v in enumerate_set(sval):
                        p = dict(partial)
                        p[tgt] = v
                        yield p, label
                    return
            if name == "!sel":
                base, num = e.args
                if isinstance(base, A.Ident):
                    d = _resolve(base.name, ctx)
                    if isinstance(d, OpClosure):
                        conjs = _flatten(d.body, "/\\")
                        idx = num.val
                        if 1 <= idx <= len(conjs):
                            yield from self.walk(conjs[idx - 1], ctx, partial,
                                                 label)
                            return
            # user-defined operator application → expand as action
            target = ctx.bound[name] if name in ctx.bound else ctx.defs.get(name)
            if isinstance(target, OpClosure):
                plan = self._op_plan.get((id(e), id(target)))
                if plan is None:
                    plan = self._op_expand_plan(e, target)
                if plan[0] == "cbn":
                    new_label = label
                    if label is None or not label[2]:
                        new_label = (name, (), False)
                    yield from self.walk(plan[1], ctx, partial, new_label)
                    return
                ectx = self._ctx(ctx, partial)
                args = [_arg_value(a, ectx) for a in e.args]
                inner = ctx
                if target.defs is not None:
                    inner = Ctx(target.defs, ctx.bound, ctx.state, ctx.primes,
                                ctx.vars, ctx.on_print, ctx.memo)
                inner = inner.with_bound(
                    {**target.bound, **dict(zip(target.params, args))})
                new_label = label
                if label is None or not label[2]:
                    new_label = (name, tuple(args), False)
                yield from self.walk(target.body, inner, partial, new_label)
                return
            # else: boolean guard below

        elif isinstance(e, A.Ident):
            target = ctx.bound[e.name] if e.name in ctx.bound \
                else ctx.defs.get(e.name)
            if isinstance(target, OpClosure) and not target.params:
                inner = ctx
                if target.defs is not None:
                    inner = Ctx(target.defs, ctx.bound, ctx.state, ctx.primes,
                                ctx.vars, ctx.on_print, ctx.memo)
                if target.bound:
                    inner = inner.with_bound(target.bound)
                new_label = label
                if label is None or not label[2]:
                    new_label = (e.name, (), False)
                yield from self.walk(target.body, inner, partial, new_label)
                return

        elif isinstance(e, A.Quant):
            if e.kind == "E":
                ectx = self._ctx(ctx, partial)
                for b in iter_binders(e.binders, ectx, eval_expr):
                    yield from self.walk(e.body, ctx.with_bound(b),
                                         dict(partial), label)
                return
            # \A as guard (fall through)

        elif isinstance(e, A.If):
            c = _bool(eval_expr(e.cond, self._ctx(ctx, partial)),
                      "IF condition")
            yield from self.walk(e.then if c else e.els, ctx, partial, label)
            return

        elif isinstance(e, A.Case):
            ectx = self._ctx(ctx, partial)
            for g, b in e.arms:
                if _bool(eval_expr(g, ectx), "CASE guard"):
                    yield from self.walk(b, ctx, partial, label)
                    return
            if e.other is not None:
                yield from self.walk(e.other, ctx, partial, label)
                return
            raise EvalError("CASE: no guard matched")

        elif isinstance(e, A.Let):
            new = make_let_defs(e.defs, self._ctx(ctx, partial))
            inner = ctx.with_defs(new)
            for v in new.values():
                if isinstance(v, OpClosure):
                    v.defs = inner.defs
            yield from self.walk(e.body, inner, partial, label)
            return

        elif isinstance(e, A.Unchanged):
            if self.mode != "next":
                raise EvalError("UNCHANGED in Init")
            label = _freeze(label)
            p = dict(partial)
            if self._unchanged(e.expr, ctx, p):
                yield p, label
            return

        elif isinstance(e, A.BoxAction):
            # [A]_v as an action: A \/ (v' = v)  (MCRealTimeHourClock's
            # BigNext composes subactions this way)
            if self.mode != "next":
                raise EvalError("[A]_v in Init")
            yield from self.walk(e.action, ctx, dict(partial), label)
            p = dict(partial)
            if self._unchanged(e.sub, ctx, p):
                yield p, _freeze(label)
            return

        elif isinstance(e, A.Bool):
            if e.val:
                yield partial, label
            return

        # default: boolean guard
        label = _freeze(label)
        v = eval_expr(e, self._ctx(ctx, partial))
        if _bool(v, "action conjunct"):
            yield partial, label

    def _unchanged(self, e: A.Node, ctx: Ctx, partial) -> bool:
        """Assign v' = v for every variable under e; returns False if an
        existing assignment contradicts."""
        if isinstance(e, A.Ident):
            if e.name in self.vars:
                old = self.state[e.name]
                if e.name in partial:
                    return tla_eq(partial[e.name], old)
                partial[e.name] = old
                return True
            target = ctx.bound[e.name] if e.name in ctx.bound \
                else ctx.defs.get(e.name)
            if isinstance(target, OpClosure) and not target.params:
                inner = ctx
                if target.defs is not None:
                    inner = Ctx(target.defs, ctx.bound, ctx.state, ctx.primes,
                                ctx.vars, ctx.on_print, ctx.memo)
                return self._unchanged(target.body, inner, partial)
            raise EvalError(f"UNCHANGED of non-variable {e.name}")
        if isinstance(e, A.TupleExpr):
            return all(self._unchanged(x, ctx, partial) for x in e.items)
        raise EvalError(f"unsupported UNCHANGED argument {e!r}")


def _freeze(label):
    if label is not None and not label[2]:
        return (label[0], label[1], True)
    return label


def _flatten(e: A.Node, op: str):
    if isinstance(e, A.OpApp) and e.name == op and len(e.args) == 2:
        return _flatten(e.args[0], op) + _flatten(e.args[1], op)
    return [e]


def label_str(label) -> str:
    if label is None:
        return "Next"
    name, args = label[0], label[1]
    if not args:
        return name
    return f"{name}({', '.join(fmt(a) for a in args)})"


def enumerate_init(init: A.Node, base_ctx: Ctx,
                   vars: Tuple[str, ...]) -> List[Dict[str, Any]]:
    w = Walker("init", vars)
    out = []
    for partial, _ in w.walk(init, base_ctx, {}, None):
        missing = [v for v in vars if v not in partial]
        if missing:
            raise EvalError(f"Init leaves variables unassigned: {missing}")
        out.append(partial)
    return out


def enumerate_next(next_expr: A.Node, base_ctx: Ctx, vars: Tuple[str, ...],
                   state: Dict[str, Any], walker: Optional[Walker] = None):
    """Yield (successor-state dict, label) for every enabled instance.

    Pass a reusable `walker` (Walker("next", vars)) when enumerating many
    states of one run: its per-run expansion-plan cache then amortizes the
    action-AST split across the whole search instead of redoing it per
    state (the engines' hot loop does this; one-shot callers like ENABLED
    get a fresh walker)."""
    if walker is None:
        walker = Walker("next", vars)
    walker.state = state
    for partial, label in walker.walk(next_expr, base_ctx, {}, None):
        missing = [v for v in vars if v not in partial]
        if missing:
            raise EvalError(
                f"action {label_str(label)} leaves {missing} unassigned")
        yield partial, label


def action_enabled(action: A.Node, ctx: Ctx) -> bool:
    """ENABLED A: does any assignment complete A from the current state?"""
    if ctx.state is None:
        raise EvalError("ENABLED outside a behavior")
    w = Walker("next", tuple(ctx.vars), dict(ctx.state))
    for _ in w.walk(action, ctx, {}, None):
        return True
    return False
