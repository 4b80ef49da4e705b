r"""Per-arm compilability prediction.

`kernel2.compile_action2` discovers an arm's uncompilability at forced-
trace time — after grounding and (for recursive operators) after an
exponentially expensive unroll attempt.  This module recasts the
CompileError taxonomy as a syntactic/type scan over the arm's AST so
`tpu/bfs.py` can skip the doomed build outright, generalizing the corpus
manifest's measured `pin_interp_arms` pins to derived ones.

Prediction policy — a verdict is issued ONLY when the build is certain
to demote, and its reason string is EXACTLY what the build-time path
would report (the message constants live in compile/kernel2.py; the
satellite test pins predicted == built wording):

  * a construct outside the compilable subset (today: SUBSET of a
    state-dependent set) in an eagerly-evaluated position of an item
    while the action is still DEFINITELY enabled (`enabled is True` at
    trace time — before any state-dependent guard), where
    compile_action2 re-raises instead of recovering;
  * a RECURSIVE operator applied to state-dependent arguments anywhere
    reachable from the arm — UnrollLimitError is deliberately
    non-recoverable at every recovery site, so position does not matter.

Everything else returns no verdict and the build proceeds exactly as
before: a false negative costs one build attempt (today's behavior), a
false positive would wrongly demote a compilable arm — so the scan stays
narrow and stops at every lazily-recovered position (IF/CASE branches,
conjunction/disjunction operands, quantifier bodies).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

from ..front import tla_ast as A

# eagerly-evaluated builtin operators: a CompileError inside their
# argument evaluation propagates to the enclosing item (no recovery)
_LAZY_OPS = {"/\\", "\\/", "=>", "<=>", "~", "\\lnot"}


def _op_unroll_limit() -> int:
    return int(os.environ.get("JAXMC_OP_UNROLL_LIMIT", "64"))


class _StateRefs:
    """Transitive does-this-expression-reference-state oracle."""

    def __init__(self, model):
        self.vars = set(model.vars)
        self.defs = model.defs
        self._memo: Dict[str, bool] = {}

    def expr(self, e: A.Node, shadow: Set[str] = frozenset()) -> bool:
        if isinstance(e, A.Ident):
            if e.name in shadow:
                return False
            if e.name in self.vars:
                return True
            return self._def(e.name)
        if isinstance(e, A.Prime):
            return True
        if isinstance(e, A.OpApp):
            if e.name not in shadow and \
                    (e.name in self.vars or self._def(e.name)):
                return True
            return any(self.expr(a, shadow) for a in e.args) or \
                any(any(self.expr(pa, shadow) for pa in pargs)
                    for _pn, pargs in e.path)
        shadow2 = shadow
        if isinstance(e, (A.Quant, A.SetFilter, A.SetMap, A.FnDef,
                          A.Choose, A.Lambda)):
            names: List[str] = []
            if isinstance(e, (A.SetFilter, A.Choose)):
                v = e.var
                names = list(v) if isinstance(v, tuple) else [v]
            elif isinstance(e, A.Lambda):
                names = list(e.params)
            else:
                for bnames, _s in e.binders:
                    names.extend(bnames)
            shadow2 = set(shadow) | set(names)
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Node):
                if self.expr(v, shadow2):
                    return True
            elif isinstance(v, tuple):
                if self._tuple(v, shadow2):
                    return True
        return False

    def _tuple(self, t, shadow) -> bool:
        for x in t:
            if isinstance(x, A.Node):
                if self.expr(x, shadow):
                    return True
            elif isinstance(x, tuple):
                if self._tuple(x, shadow):
                    return True
        return False

    def _def(self, name: str) -> bool:
        if name in self._memo:
            return self._memo[name]
        from ..sem.eval import OpClosure
        d = self.defs.get(name)
        if not isinstance(d, OpClosure):
            self._memo[name] = False
            return False
        self._memo[name] = False  # cycle-safe default while recursing
        body = d.body
        if isinstance(body, A.FnConstrDef):
            body = body.body
        res = self.expr(body, set(d.params))
        self._memo[name] = res
        return res


class _ArmScan:
    def __init__(self, model):
        self.model = model
        self.defs = model.defs
        self.vars = set(model.vars)
        self.refs = _StateRefs(model)
        self._nodes = 0

    # ---- fatal-construct scan over eager positions --------------------
    def fatal(self, e: A.Node, stack: Tuple[str, ...],
              local: Dict[str, Tuple]) -> Optional[Tuple[str, bool]]:
        """(reason, always_raises) when evaluating e is certain to raise
        a CompileError at trace time; None otherwise.  Descends ONLY
        eagerly-evaluated positions."""
        self._nodes += 1
        if self._nodes > 20000:
            return None
        from ..compile.kernel2 import (SUBSET_SYMBOLIC_MSG,
                                       unroll_limit_message)
        if isinstance(e, A.OpApp):
            name = e.name
            if e.path:
                return None
            if name == "SUBSET" and len(e.args) == 1:
                if self.refs.expr(e.args[0]):
                    return (SUBSET_SYMBOLIC_MSG, False)
                return None
            if name in _LAZY_OPS:
                return None
            # user-defined operator: expand through it
            d = local.get(name)
            body = params = None
            if d is not None:
                params, body = d
            else:
                from ..sem.eval import OpClosure
                dd = self.defs.get(name)
                if isinstance(dd, OpClosure) and \
                        not isinstance(dd.body, A.FnConstrDef):
                    params, body = dd.params, dd.body
            if body is not None and params is not None and \
                    len(params) == len(e.args):
                if name in stack:
                    # recursion: diverges at trace time iff it runs on
                    # symbolic data — UnrollLimitError re-raises through
                    # every recovery site, so this verdict is positional
                    # ly unconditional
                    if any(self.refs.expr(a) for a in e.args):
                        return (unroll_limit_message(
                            name, _op_unroll_limit()), True)
                    return None
                if len(stack) > 48:
                    return None
                from ..front.subst import subst
                try:
                    body2 = subst(body, dict(zip(params, e.args)))
                except Exception:
                    return None
                return self.fatal(body2, stack + (name,), local)
            # builtin with eager argument evaluation
            for a in e.args:
                r = self.fatal(a, stack, local)
                if r is not None:
                    return r
            return None
        if isinstance(e, A.Ident):
            d = local.get(e.name)
            if d is not None and not d[0]:
                return self.fatal(d[1], stack, local)
            from ..sem.eval import OpClosure
            dd = self.defs.get(e.name)
            if isinstance(dd, OpClosure) and not dd.params and \
                    e.name not in self.vars and \
                    not isinstance(dd.body, A.FnConstrDef):
                if e.name in stack or len(stack) > 48:
                    return None
                return self.fatal(dd.body, stack + (e.name,), local)
            return None
        if isinstance(e, A.FnApp):
            r = self.fatal(e.fn, stack, local)
            if r is not None:
                return r
            for a in e.args:
                r = self.fatal(a, stack, local)
                if r is not None:
                    return r
            return None
        if isinstance(e, A.Dot):
            return self.fatal(e.expr, stack, local)
        if isinstance(e, A.Prime):
            return self.fatal(e.expr, stack, local)
        if isinstance(e, (A.TupleExpr, A.SetEnum)):
            for x in e.items:
                r = self.fatal(x, stack, local)
                if r is not None:
                    return r
            return None
        if isinstance(e, A.RecordExpr):
            for _k, v in e.fields:
                r = self.fatal(v, stack, local)
                if r is not None:
                    return r
            return None
        if isinstance(e, A.Except):
            return self.fatal(e.fn, stack, local)
        if isinstance(e, A.Quant):
            # the taxonomy: a quantifier whose binder has NO
            # domain, or whose domain is an infinite constant set,
            # is certain to raise at trace time (kernel2's
            # _binder_combos / set_elements) — the predictor names it
            # with the build-time constant.  Bounded-finite domains are
            # compilable: do not descend (binder scoping unmodelled)
            from ..compile.kernel2 import (UNBOUNDED_QUANTIFIER_MSG,
                                           cannot_enumerate_message)
            for _names, dom in e.binders:
                if dom is None:
                    return (UNBOUNDED_QUANTIFIER_MSG, False)
                iv = self._static_infinite(dom, local)
                if iv is not None:
                    return (cannot_enumerate_message(iv), False)
            return None
        # IF/CASE/LET/filters: lazily recovered or scoped — never
        # predict through them
        return None

    def _static_infinite(self, dom: A.Node, local):
        """The InfiniteSet a domain expression statically denotes, or
        None.  Only Ident / zero-arg applications resolved through the
        defs table are claimed — anything else might be finite."""
        from ..sem.values import InfiniteSet
        name = None
        if isinstance(dom, A.Ident):
            name = dom.name
        elif isinstance(dom, A.OpApp) and not dom.args and not dom.path:
            name = dom.name
        if name is None or name in local or name in self.vars:
            return None
        d = self.defs.get(name)
        return d if isinstance(d, InfiniteSet) else None

    # ---- arm-item walk ------------------------------------------------
    def scan_arm(self, arm) -> Optional[str]:
        # arm.bound holds static VALUE bindings (split_arms' \E
        # instantiation) — opaque and non-fatal, so they need no entry
        state = {"enabled": True, "assigned": set(), "stop": False,
                 "verdict": None}
        self._walk_items(arm.expr, {}, state, ())
        return state["verdict"]

    def _walk_items(self, e: A.Node, local: Dict[str, Tuple], state,
                    stack: Tuple[str, ...]) -> None:
        if state["stop"] or state["verdict"] is not None:
            return
        from ..sem.eval import OpClosure
        if isinstance(e, A.OpApp):
            name = e.name
            if name == "/\\":
                self._walk_items(e.args[0], local, state, stack)
                self._walk_items(e.args[1], local, state, stack)
                return
            if name == "=":
                tgt = e.args[0]
                if isinstance(tgt, A.Prime) and \
                        isinstance(tgt.expr, A.Ident) and \
                        tgt.expr.name in self.vars:
                    var, rhs = tgt.expr.name, e.args[1]
                    r = self.fatal(rhs, stack, local)
                    if r is not None and (state["enabled"] or r[1]):
                        state["verdict"] = r[0]
                        return
                    if var in state["assigned"]:
                        # second assignment compiles to an equality
                        # filter on traced lanes: enabled goes symbolic
                        state["enabled"] = False
                    state["assigned"].add(var)
                    return
                self._guard(e, local, state, stack)
                return
            if name == "\\in":
                tgt = e.args[0]
                if isinstance(tgt, A.Prime) and \
                        isinstance(tgt.expr, A.Ident) and \
                        tgt.expr.name in self.vars:
                    r = self.fatal(e.args[1], stack, local)
                    if r is not None and (state["enabled"] or r[1]):
                        state["verdict"] = r[0]
                        return
                    state["assigned"].add(tgt.expr.name)
                    state["enabled"] = False  # slot/member guards
                    return
                self._guard(e, local, state, stack)
                return
            # user operator expansion (the action-family case)
            d = local.get(name)
            if d is not None and d[0] is not None and \
                    len(d[0]) == len(e.args):
                from ..front.subst import subst
                try:
                    body = subst(d[1], dict(zip(d[0], e.args)))
                except Exception:
                    state["stop"] = True
                    return
                self._walk_items(body, local, state, stack)
                return
            dd = self.defs.get(name)
            if isinstance(dd, OpClosure) and dd.params and \
                    len(dd.params) == len(e.args) and \
                    not isinstance(dd.body, A.FnConstrDef):
                if name in stack or len(stack) > 24:
                    state["stop"] = True
                    return
                from ..front.subst import subst
                try:
                    body = subst(dd.body, dict(zip(dd.params, e.args)))
                except Exception:
                    state["stop"] = True
                    return
                self._walk_items(body, local, state, stack + (name,))
                return
            self._guard(e, local, state, stack)
            return
        if isinstance(e, A.Ident):
            dd = self.defs.get(e.name)
            if isinstance(dd, OpClosure) and not dd.params and \
                    e.name not in self.vars and \
                    not isinstance(dd.body, A.FnConstrDef):
                if e.name in stack or len(stack) > 24:
                    state["stop"] = True
                    return
                self._walk_items(dd.body, local, state,
                                 stack + (e.name,))
                return
            self._guard(e, local, state, stack)
            return
        if isinstance(e, A.Unchanged):
            return
        if isinstance(e, A.Quant) and e.kind == "E":
            from ..compile.ground import DYN_NESTED_MSG, DYN_SHAPE_MSG
            # a binder domain that IS a state variable certainly
            # raises in ground's static iter_binders, forcing the
            # dynamic slot path — the certainty the shape verdicts
            # below need (unsized dynamic \E axes).  Ground
            # failures demote the whole arm regardless of position, so
            # these verdicts ignore `enabled`.
            certain_dynamic = any(
                isinstance(sexpr, A.Ident) and sexpr.name in self.vars
                for _names, sexpr in e.binders if sexpr is not None)
            slot_ok = (len(e.binders) == 1
                       and len(e.binders[0][0]) == 1
                       and isinstance(e.binders[0][0][0], str))
            if certain_dynamic and not slot_ok:
                state["verdict"] = DYN_SHAPE_MSG
                return
            if certain_dynamic and state.get("dyn_slot"):
                state["verdict"] = DYN_NESTED_MSG
                return
            for _names, sexpr in e.binders:
                if sexpr is None:
                    state["stop"] = True
                    return
                r = self.fatal(sexpr, stack, local)
                if r is not None and (state["enabled"] or r[1]):
                    state["verdict"] = r[0]
                    return
                if self.refs.expr(sexpr):
                    # dynamic \E: slot guards make `enabled` symbolic
                    # before any item runs
                    state["enabled"] = False
            if certain_dynamic:
                state["dyn_slot"] = True
            self._walk_items(e.body, local, state, stack)
            return
        if isinstance(e, A.Let):
            local2 = dict(local)
            for d in e.defs:
                if isinstance(d, A.OpDef):
                    local2[d.name] = (d.params, d.body)
                else:
                    state["stop"] = True
                    return
            self._walk_items(e.body, local2, state, stack)
            return
        if isinstance(e, A.Bool):
            if not e.val:
                state["stop"] = True
            return
        # disjunction / IF / CASE / anything else structural: the
        # compile path through these has recovery we do not model
        if isinstance(e, (A.If, A.Case, A.BoxAction)):
            state["stop"] = True
            return
        self._guard(e, local, state, stack)

    def _guard(self, e: A.Node, local, state, stack) -> None:
        r = self.fatal(e, stack, local)
        if r is not None and (state["enabled"] or r[1]):
            state["verdict"] = r[0]
            return
        if self.refs.expr(e):
            state["enabled"] = False
        # a static guard evaluates to a python bool at trace time and
        # leaves `enabled is True` intact (or kills the arm — either
        # way no new verdict can be wrong, so keep scanning)


def predict_arm_demotions(model, arms) -> Dict[int, str]:
    """arm index -> build-time demotion reason, for arms the scan is
    CERTAIN compile_action2 would demote.  Reasons use kernel2's own
    message constants so the predicted and built wording is identical."""
    out: Dict[int, str] = {}
    try:
        scan = _ArmScan(model)
        for i, arm in enumerate(arms):
            try:
                v = scan.scan_arm(arm)
            except RecursionError:
                v = None
            if v is not None:
                out[i] = v
    except Exception:
        if os.environ.get("JAXMC_DEBUG"):
            raise
        return {}
    return out
