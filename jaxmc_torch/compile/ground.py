r"""Static action grounding (SURVEY.md §7.3).

Action grounding statically expands the Next disjunction: operator expansion,
\/ splits, and \E over constant domains become a finite list of
GroundedActions, each a conjunct list evaluated by the kernel compiler
(compile/kernel2.py; state encodings live in compile/vspec.py). This is the
raft.tla:482-493 shape: ~10 action families x parameter instantiations
(SURVEY.md §3.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..front import tla_ast as A
from ..sem.values import EvalError, fmt
from ..sem.eval import Ctx, OpClosure, eval_expr, iter_binders
from ..sem.modules import Model


# ONE CompileError class for the whole compile package — ground and
# vspec/kernel2 raise interchangeably and callers catch one type
from .vspec import CompileError  # noqa: F401  (re-export)


# shared demotion-reason wording for the dynamic-\E slot axis:
# analyze/verdicts.py predicts these ground-time demotions and
# must report the exact build-time string — both sides read the one
# constant (the SUBSET_SYMBOLIC_MSG pattern)
DYN_NESTED_MSG = ("nested dynamic \\E binders not supported "
                  "(one slot axis per action)")
DYN_SHAPE_MSG = ("dynamic \\E with multiple binders/patterns not "
                 "supported (one slot axis per action)")


# ---------------- static action grounding ----------------

@dataclass
class GroundedAction:
    label: str
    # ordered conjuncts with their static binding environments
    items: List[Tuple[A.Node, Dict[str, Any]]]


@dataclass
class ActionArm:
    """One top-level disjunct of Next, pre-grounding: the unit of hybrid
    fallback. Compiled arms ground into GroundedActions; an arm whose
    grounding or kernel compilation fails is enumerated by the exact
    interpreter (sem/enumerate.py) over decoded frontier states instead
    of rejecting the whole spec. `bound` holds static
    VALUE bindings only (operator params, static \\E binders) so the
    interpreter can evaluate the arm via ctx.with_bound(bound). `label`
    is None when no operator expansion named the arm yet — grounding's
    first-leaf-conjunct policy (walk2) then assigns it, so a None must
    be passed through to ground_arm unchanged (display sites default it
    to "Next")."""
    label: Optional[str]
    expr: A.Node
    bound: Dict[str, Any]


def _static_ctx(model: Model) -> Ctx:
    """Context with constants/defs only — evaluating anything that touches
    state raises, which is how we detect non-static constructs."""
    return Ctx(model.defs, {}, None, None, ())


def split_arms(model: Model) -> List[ActionArm]:
    """Decompose Next into its disjunct arms: operator expansion, \\/
    splits, static \\E instantiation, AND distribution of rider
    conjuncts over a splitting conjunct — the same top
    structure ground_actions walks, stopping at anything non-static
    (those stay whole inside one arm). The concatenation of ground_arm()
    over these arms equals ground_actions() on Next — same instances,
    same order, same labels, same conjunct exprs — so compiled-path
    labels and traces are unchanged. Sole deviation: a rider conjunct
    distributed under a \\E's static binding carries that binding in its
    static env (inert by construction — occurs_free guarantees the rider
    never references it; the whole-grounding walk scopes the binding to
    the \\E body only).

    Conjunction distribution: raft's
    Next == /\\ (\\/ ...10 action families...) /\\ allLogs' = ...
    (tla-rust examples/raft.tla:482-493) is ONE top-level
    conjunction; without distribution the whole transition relation was
    a single arm, so one uncompilable message variant demoted ALL of
    raft to the interpreter (the r4 mid4 abort). (a /\\ b) where a
    splits into arms L_i becomes arms (L_i /\\ b) — exact by
    distributivity of /\\ over \\/, order-preserving (left-outer /
    right-inner, ground_actions' own walk order). New binder bindings
    introduced by one side must not capture free names of the other
    (occurs_free); on a collision the conjunction stays one arm."""
    ctx = _static_ctx(model)
    from ..front.subst import occurs_free

    def walk(e: A.Node, bound: Dict[str, Any], label) -> List[ActionArm]:
        if isinstance(e, A.OpApp) and e.name == "\\/":
            res: List[ActionArm] = []
            for arm in e.args:
                res.extend(walk(arm, bound, label))
            return res
        if isinstance(e, A.OpApp) and e.name == "/\\":
            left = walk(e.args[0], bound, label)
            right = walk(e.args[1], bound, label)
            if len(left) == 1 and len(right) == 1:
                # nothing under the conjunction splits: stay one arm
                # (the grounder expands it; do NOT decompose a plain
                # conjunction into per-conjunct arms)
                return [ActionArm(label, e, dict(bound))]
            base = set(bound)
            res = []
            for la in left:
                newl = set(la.bound) - base
                for ra in right:
                    newr = set(ra.bound) - base
                    if (newl & newr or occurs_free(ra.expr, newl)
                            or occurs_free(la.expr, newr)):
                        # capture risk: keep the whole conjunction as
                        # one arm rather than mis-scope a rider
                        return [ActionArm(label, e, dict(bound))]
                    res.append(ActionArm(
                        la.label or ra.label or label,
                        A.OpApp("/\\", (la.expr, ra.expr), ()),
                        {**la.bound, **ra.bound}))
            return res
        if isinstance(e, A.Quant) and e.kind == "E":
            try:
                bindings = list(iter_binders(
                    e.binders, ctx.with_bound(bound), eval_expr))
            except EvalError:
                # dynamic domain: the whole \E is one arm (the grounder
                # slot-expands it on the compiled path; the interpreter
                # enumerates it natively on the fallback path)
                return [ActionArm(label, e, dict(bound))]
            res = []
            for b in bindings:
                res.extend(walk(e.body, {**bound, **b}, label))
            return res
        if isinstance(e, A.OpApp) and e.name not in _LEAF_OPS \
                and not e.path and e.name not in bound:
            d = model.defs.get(e.name)
            if isinstance(d, OpClosure) and len(d.params) == len(e.args):
                args = []
                argable = True
                for a in e.args:
                    try:
                        args.append(eval_expr(a, ctx.with_bound(bound)))
                    except EvalError:
                        argable = False
                        break
                if argable:
                    nb = {**bound, **dict(zip(d.params, args))}
                    return walk(d.body, nb, _mk_label(e.name, args))
                # non-static args (assigns through params / reads state):
                # one arm; both paths expand it themselves
        if isinstance(e, A.Ident):
            d = model.defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params \
                    and e.name not in bound:
                return walk(d.body, bound, e.name)
        return [ActionArm(label, e, dict(bound))]

    return walk(model.next, {}, None)


def ground_arm(model: Model, arm: ActionArm, max_actions: int = 4096,
               dyn_slots: int = 0) -> List[GroundedAction]:
    """Ground one arm (see split_arms); raises CompileError when the arm
    holds constructs the grounder can't expand — the hybrid engine then
    demotes that arm to interpreter enumeration."""
    return _ground_expr(model, arm.expr, arm.bound, arm.label,
                        max_actions, dyn_slots)


def ground_actions(model: Model, max_actions: int = 4096,
                   dyn_slots: int = 0) -> List[GroundedAction]:
    """Statically expand Next. dyn_slots > 0 additionally expands
    \\E x \\in <state-dependent set> (raft's
    \\E m \\in ValidMessage(messages), raft.tla:449-478) into one instance
    per table slot; the kernel binds x to slot k's element guarded by the
    slot's membership mask."""
    return _ground_expr(model, model.next, {}, None, max_actions,
                        dyn_slots)


def _ground_expr(model: Model, root: A.Node, root_bound: Dict[str, Any],
                 root_label, max_actions: int,
                 dyn_slots: int) -> List[GroundedAction]:
    ctx = _static_ctx(model)

    def static_eval(e, bound):
        return eval_expr(e, ctx.with_bound(bound))

    results: List[GroundedAction] = []

    def walk2(e: A.Node, bound, label) -> List[Tuple[Optional[str], List]]:
        # label policy: operator expansion overwrites the label; the first
        # leaf conjunct freezes it (conjunction prefers the left label) —
        # mirrors sem/enumerate.py so traces agree across backends
        if isinstance(e, A.OpApp) and e.name == "/\\":
            left = walk2(e.args[0], bound, label)
            out2 = []
            for ll, litems in left:
                for rl, ritems in walk2(e.args[1], bound, ll or label):
                    out2.append((ll or rl, litems + ritems))
            return out2
        if isinstance(e, A.OpApp) and e.name == "\\/":
            out2 = []
            for arm in e.args:
                out2.extend(walk2(arm, bound, label))
            return out2
        if isinstance(e, A.Quant) and e.kind == "E":
            try:
                bindings = list(iter_binders(
                    e.binders, ctx.with_bound(_clean(bound)), eval_expr))
            except EvalError as ex:
                if dyn_slots > 0 and len(e.binders) == 1 \
                        and len(e.binders[0][0]) == 1 \
                        and isinstance(e.binders[0][0][0], str):
                    if any(isinstance(bv, tuple) and len(bv) == 2
                           and bv[0] == "$slotv" for bv in bound.values()):
                        # two dynamic binders would share the one traced
                        # slot index and only explore diagonal pairs —
                        # reject rather than silently drop transitions
                        raise CompileError(DYN_NESTED_MSG) from ex
                    # one vectorized instance: the kernel binds the slot
                    # element by a traced slot index and the engine vmaps
                    # over slots (keeps trace size O(1) in table capacity)
                    var = e.binders[0][0][0]
                    sexpr = e.binders[0][1]
                    nb = {**bound, var: ("$slotv", sexpr)}
                    return walk2(e.body, nb, label)
                if dyn_slots > 0:
                    # dynamic domain but an UNSIZED slot axis: the
                    # binder shape disqualifies slot expansion — a
                    # constant reason the predictor mirrors verbatim
                    raise CompileError(DYN_SHAPE_MSG) from ex
                raise CompileError(f"\\E over non-static domain: {ex}") \
                    from ex
            out2 = []
            for b in bindings:
                out2.extend(walk2(e.body, {**bound, **b}, label))
            return out2
        if isinstance(e, A.Let):
            nb = dict(bound)
            for d in e.defs:
                if isinstance(d, A.OpDef) and not d.params:
                    nb[d.name] = ("$letexpr", d.body)
                elif isinstance(d, A.OpDef):
                    nb[d.name] = ("$op", d, {})
                else:
                    raise CompileError("unsupported LET in action")
            return walk2(e.body, nb, label)
        if isinstance(e, A.OpApp) and e.name not in _LEAF_OPS and not e.path \
                and e.name not in bound:
            d = model.defs.get(e.name)
            if isinstance(d, OpClosure) and len(d.params) == len(e.args):
                args = []
                argable = True
                for a in e.args:
                    # bound-marker references pass through symbolically
                    if isinstance(a, A.Ident) and isinstance(
                            bound.get(a.name), tuple):
                        args.append(bound[a.name])
                        continue
                    try:
                        args.append(static_eval(a, _clean(bound)))
                    except EvalError:
                        argable = False
                        break
                if not argable:
                    from ..front.subst import contains_prime, subst
                    if contains_prime(d.body):
                        # the body assigns through its parameters or primes
                        # variables (Reply, Send, the raft handlers):
                        # call-by-name expansion keeps the assignment
                        # structure visible to the action compiler
                        body = subst(d.body, dict(zip(d.params, e.args)))
                        return walk2(body, bound, _mk_label(e.name, []))
                    # pure read: leave as a leaf for the kernel's symbolic
                    # evaluator
                    return [(label, [(e, dict(bound))])]
                nb = {**bound, **dict(zip(d.params, args))}
                return walk2(d.body, nb, _mk_label(
                    e.name, [a for a in args
                             if not isinstance(a, tuple)]))
        if isinstance(e, A.Ident):
            d = model.defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params \
                    and e.name not in bound:
                return walk2(d.body, bound, e.name)
        return [(label, [(e, dict(bound))])]

    for label, items in walk2(root, dict(root_bound), root_label):
        results.append(GroundedAction(label or "Next", items))
        if len(results) > max_actions:
            raise CompileError(f"more than {max_actions} grounded actions")
    return results


def _clean(bound):
    """Drop compile-time marker bindings before interpreter evaluation."""
    return {k: v for k, v in bound.items() if not isinstance(v, tuple)}


def _mk_label(name, args):
    if not args:
        return name
    return f"{name}({', '.join(fmt(a) for a in args)})"


_LEAF_OPS = {
    "=", "/=", "#", "<", ">", "<=", ">=", "=<", "\\leq", "\\geq",
    "\\in", "\\notin", "+", "-", "*", "^", "\\div", "%", "..",
    "~", "=>", "<=>", "\\equiv", "\\cup", "\\cap", "\\", "\\union",
    "\\intersect", "\\subseteq", "\\subset", "\\supseteq", "\\supset",
    "SUBSET", "UNION", "DOMAIN", "\\X", "@@", ":>", "-.", "!sel",
    "Assert", "Print", "PrintT", "Cardinality", "Len",
}
