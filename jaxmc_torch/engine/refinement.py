r"""Action-level refinement checking (SURVEY.md §3.4, §7.7).

A cfg PROPERTY naming a specification formula — V!Spec through an instance
(MCPaxos.cfg:11 via Paxos.tla:195), a sibling spec of the same module
(HourClock2.cfg PROPERTY HC2), or a hand-built refinement
(MCWriteThroughCache.cfg PROPERTY LM_Inner_ISpec, MCAlternatingBit.cfg
ABCSpec) — is checked stepwise:

  * every initial state must satisfy the property's initial predicate;
  * every explored edge (s, s') must be a [PropertyNext]_sub step: either
    PropertyNext holds with state := s, primes := s', or the step
    stutters (the refined spec's subscript is unchanged).

With full primed assignments available, PropertyNext evaluates as a plain
boolean — no action enumeration needed. Substituted instance variables
evaluate through the outer state via the primed-definition rule in
sem/eval.py. WF/SF conjuncts of the property are liveness obligations and
stay reported as unchecked (the behavior-graph/SCC machinery is the
round-2+ item, ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..front import tla_ast as A
from ..sem.values import EvalError, tla_eq
from ..sem.eval import Ctx, OpClosure, eval_expr, _bool
from ..sem.modules import InstanceNamespace, Model, _split_spec


class NotASpecFormula(Exception):
    pass


class RefinementChecker:
    """One checked PROPERTY that resolves to a specification formula."""

    def __init__(self, model: Model, name: str, expr: A.Node):
        self.model = model
        self.name = name
        self.instances: List[InstanceNamespace] = []
        body, defs = self._resolve(expr, model.defs)
        try:
            self.init, self.next, self.sub, self.fair = \
                _split_spec(body, defs)
        except EvalError as ex:
            raise NotASpecFormula(str(ex))
        self.liveness_skipped = bool(self.fair)
        self.last_error = None

    def _resolve(self, expr: A.Node, defs):
        """Chase Ident -> OpClosure bodies and instance paths down to the
        spec formula; record instance namespaces entered on the way."""
        seen = set()
        while True:
            if isinstance(expr, A.Ident):
                d = defs.get(expr.name)
                if isinstance(d, OpClosure) and not d.params \
                        and expr.name not in seen:
                    seen.add(expr.name)
                    expr = d.body
                    continue
                raise NotASpecFormula(f"{expr.name} is not a definition")
            if isinstance(expr, A.OpApp) and expr.path and not expr.args:
                cur_defs = defs
                ok = True
                for iname, iargs in expr.path:
                    if iargs:
                        ok = False
                        break
                    inst = cur_defs.get(iname)
                    if not isinstance(inst, InstanceNamespace):
                        ok = False
                        break
                    self.instances.append(inst)
                    cur_defs = inst.module.defs
                if not ok:
                    raise NotASpecFormula("unresolvable instance path")
                d = cur_defs.get(expr.name)
                if not isinstance(d, OpClosure):
                    raise NotASpecFormula(f"{expr.name} not found in "
                                          f"instance")
                # build the effective defs via a dummy enter to pick up
                # substitutions at eval time; keep inner module defs for
                # _split_spec name resolution
                defs = self._entered_defs()
                expr = d.body
                continue
            return expr, defs

    def _entered_defs(self):
        ctx = self.model.ctx()
        for inst in self.instances:
            ctx = inst.enter(ctx, [])
        return ctx.defs

    def _ctx(self, state, primes) -> Ctx:
        ctx = self.model.ctx(state=state, primes=primes)
        for inst in self.instances:
            ctx = inst.enter(ctx, [])
            # keep outer state/primes visible through the chain
            ctx = Ctx(ctx.defs, ctx.bound, state, primes, self.model.vars,
                      ctx.on_print, ctx.memo)
        return ctx

    def check_init(self, state: Dict[str, Any]) -> bool:
        ctx = self._ctx(state, None)
        return _bool(eval_expr(self.init, ctx),
                     f"property {self.name} init")

    def check_edge(self, s: Dict[str, Any], s2: Dict[str, Any]) -> bool:
        """Is (s, s') a [Next]_sub step of the property spec? On failure,
        self.last_error carries any underlying evaluation error so a
        broken property is distinguishable from a real violation."""
        self.last_error = None
        ctx = self._ctx(s, s2)
        try:
            if _bool(eval_expr(self.next, ctx),
                     f"property {self.name} next"):
                return True
        except EvalError as ex:
            # an inapplicable disjunct crashed (CHOOSE with no witness,
            # partial function application): record and fall through to
            # the stuttering test
            self.last_error = str(ex)
        # stuttering: [N]_sub allows sub' = sub — evaluate the box
        # subscript (the exact tuple the refined spec observes) under both
        # states through the refinement mapping
        if self.sub is None:
            return all(tla_eq(s[v], s2[v]) for v in self.model.vars)
        try:
            now = eval_expr(self.sub, ctx)
            nxt = eval_expr(A.Prime(self.sub), ctx)
            return tla_eq(now, nxt)
        except EvalError as ex:
            self.last_error = (self.last_error or "") + f"; subscript: {ex}"
            return False


def build_refinement_checkers(model: Model):
    """Partition cfg PROPERTY entries into stepwise-checkable specification
    formulas and liveness-only formulas (returned as unchecked names)."""
    checkers: List[RefinementChecker] = []
    unchecked: List[str] = []
    for nm, expr in model.properties:
        try:
            checkers.append(RefinementChecker(model, nm, expr))
        except (NotASpecFormula, EvalError):
            unchecked.append(nm)
    return checkers, unchecked
