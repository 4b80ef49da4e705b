r"""Temporal (liveness) property checking over the behavior graph.

TLC checks PROPERTY formulas with temporal operators against the full
reachable state graph plus fairness from the SPECIFICATION formula
(SURVEY.md §3.2 "liveness" row). This module covers the corpus's property
forms exactly:

  []P                      LiveHourClock.tla:27 TypeInvariance
  []<>P                    LiveHourClock.tla:22 AllTimes (\A-quantified)
  []<><<A>>_v              LiveHourClock.tla:17 AlwaysTick
  P ~> Q                   MCAlternatingBit.tla:11 SentLeadsToRcvd,
                           MCInnerSerial.tla AlwaysResponds (quantified)
  <>[]Q and [](P => <>[]Q) RealTime/MCRealTimeHourClock.tla:43
                           ErrorTemporal (an expected-to-fail property)
  WF_v(A) / SF_v(A)        fairness-as-property: MCLiveInternalMemory.cfg:7
                           PROPERTY Liveness (LiveInternalMemory.tla:17)
  disjunctions of []<>-class atoms
                           MCLiveWriteThroughCache.tla:129-143
                           LM_Inner_Liveness/Liveness2 ([]<>~EnabledX \/
                           []<><<X>>_v — the hand-instantiated ENABLED
                           construction), incl. the fairness half of a
                           spec-shaped PROPERTY (LM_Inner_LISpec, whose
                           Init/[][Next]_v half the refinement checker
                           covers stepwise)

with fairness WF_v(A) / SF_v(A), possibly \A-quantified or behind named
operators (AlternatingBit.tla:72-75 ABFairness).

Semantics. A behavior is an infinite path through the kept-state graph
where every state additionally has an implicit stuttering self-loop (TLC's
view: finite behaviors extend by stuttering). A property of the forms
above is violated iff some FAIR lasso (reachable cycle) avoids it:

  []<>G : a fair cycle with no G-state (or no G-edge for <<A>>_v)
  P ~> Q: a fair cycle inside the ~Q subgraph, reachable from a P/\~Q
          state through ~Q states
  <>[]Q : a fair cycle visiting a ~Q state
  [](P => <>[]Q): as <>[]Q but the cycle must be reachable from a P-state

A cycle through SCC S is fair iff for every WF(A,v): S has an <<A>>_v
edge, or some state of S has <<A>>_v disabled (an all-states closed walk
then passes it infinitely often, so A is not continuously enabled); for
every SF(A,v): S has an <<A>>_v edge, or NO state of S enables <<A>>_v —
otherwise the A-enabled states are deleted and the remaining sub-SCCs
searched (the standard refinement). Stuttering self-loops are never
<<A>>_v edges (v is unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from ..front import tla_ast as A
from ..sem.values import EvalError, fmt, tla_eq
from ..sem.eval import OpClosure, eval_expr, iter_binders, _bool
from ..sem.enumerate import Walker
from ..sem.modules import Model


class UnsupportedProperty(Exception):
    """The property is outside the supported temporal fragment."""


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

@dataclass
class Obligation:
    """One checkable temporal obligation (a conjunct of a PROPERTY, with
    any \\A binders already instantiated into `bound`).

    For kind 'ae_disj', exprs holds atom tuples instead of plain nodes:
    ('pred', P) for []<>P, ('action', A, v) for []<><<A>>_v, and
    ('WF'|'SF', A, v) for fairness-as-property — the obligation is the
    disjunction of the atoms, and its negation (the violation search) is
    the conjunction of the atoms' <>[]-style negations."""
    prop_name: str
    kind: str          # 'always' | 'ae' | 'ae_action' | 'leadsto' | 'ea'
    #                    | 'p_ea' | 'ae_disj'
    exprs: Tuple[Any, ...]
    bound: Dict[str, Any]

    def describe(self) -> str:
        b = ""
        if self.bound:
            b = " [" + ", ".join(f"{k} = {fmt(v)}"
                                 for k, v in sorted(self.bound.items())) + "]"
        return f"{self.prop_name}{b}"


def _chase(e: A.Node, model: Model, seen=None):
    """Resolve Ident/0-ary OpApp references to definition bodies."""
    seen = seen or set()
    while True:
        nm = None
        if isinstance(e, A.Ident):
            nm = e.name
        elif isinstance(e, A.OpApp) and not e.args and not e.path:
            nm = e.name
        if nm is None or nm in seen:
            return e
        d = model.defs.get(nm)
        if isinstance(d, OpClosure) and not d.params:
            seen.add(nm)
            e = d.body
            continue
        return e


def _op(e, name, nargs=None):
    return isinstance(e, A.OpApp) and e.name == name and \
        (nargs is None or len(e.args) == nargs)


def _ae_atom(e: A.Node, model: Model):
    """Recognize one []<>-class disjunct. Returns an atom tuple —
    ('pred', P) | ('action', A, v) | ('WF'|'SF', A, v) — or None."""
    e = _chase(e, model)
    if isinstance(e, A.Fair):
        return (e.kind, e.action, e.sub)
    if _op(e, "[]", 1):
        x = _chase(e.args[0], model)
        if _op(x, "<>", 1):
            y = _chase(x.args[0], model)
            if isinstance(y, A.AngleAction):
                return ("action", y.action, y.sub)
            if not _contains_temporal(y, model):
                return ("pred", y)
    return None


def classify_property(model: Model, prop_name: str, expr: A.Node,
                      bound: Dict[str, Any]) -> List[Obligation]:
    """Split a PROPERTY into obligations; raises UnsupportedProperty."""
    e = _chase(expr, model)
    if _op(e, "/\\", 2):
        return (classify_property(model, prop_name, e.args[0], bound) +
                classify_property(model, prop_name, e.args[1], bound))
    if isinstance(e, A.Quant) and e.kind == "A":
        out = []
        ctx = model.ctx().with_bound(bound)
        for b in iter_binders(e.binders, ctx, eval_expr):
            out.extend(classify_property(model, prop_name, e.body,
                                         {**bound, **b}))
        return out
    if isinstance(e, A.Fair):
        # WF_v(A) / SF_v(A) checked AS a property (MCLiveInternalMemory
        # PROPERTY Liveness): a one-atom disjunction
        return [Obligation(prop_name, "ae_disj",
                           ((e.kind, e.action, e.sub),), bound)]
    if _op(e, "\\/", 2):
        # disjunction of []<>-class atoms (LM_Inner_Liveness[2]'s
        # []<>~EnabledX \/ []<><<X>>_v construction)
        disj: List[A.Node] = []
        work = [e]
        while work:
            d = _chase(work.pop(), model)
            if _op(d, "\\/", 2):
                work.extend(d.args)
            else:
                disj.append(d)
        atoms = [_ae_atom(d, model) for d in disj]
        if all(a is not None for a in atoms):
            return [Obligation(prop_name, "ae_disj", tuple(atoms), bound)]
        raise UnsupportedProperty("disjunction outside the []<> fragment")
    if _op(e, "~>", 2):
        return [Obligation(prop_name, "leadsto",
                           (e.args[0], e.args[1]), bound)]
    if _op(e, "[]", 1):
        x = _chase(e.args[0], model)
        if _op(x, "<>", 1):
            y = _chase(x.args[0], model)
            if isinstance(y, A.AngleAction):
                return [Obligation(prop_name, "ae_action",
                                   (y.action, y.sub), bound)]
            return [Obligation(prop_name, "ae", (y,), bound)]
        if _op(x, "=>", 2):
            q = _chase(x.args[1], model)
            if _op(q, "<>", 1):
                q2 = _chase(q.args[0], model)
                if _op(q2, "[]", 1):
                    return [Obligation(prop_name, "p_ea",
                                       (x.args[0], q2.args[0]), bound)]
        if _contains_temporal(x, model):
            raise UnsupportedProperty(f"[] over unsupported formula")
        return [Obligation(prop_name, "always", (x,), bound)]
    if _op(e, "<>", 1):
        x = _chase(e.args[0], model)
        if _op(x, "[]", 1):
            return [Obligation(prop_name, "ea", (x.args[0],), bound)]
        raise UnsupportedProperty("bare <> property")
    raise UnsupportedProperty(f"unsupported temporal form")


def collect_obligations(model: Model, refiners
                        ) -> Tuple[List[Obligation], List[str], bool]:
    """Classify every cfg PROPERTY into temporal obligations — the shared
    policy of the interp and jax backends (verdict/warning parity).

    `refiners` is the list of RefinementCheckers already built for
    spec-shaped PROPERTYs (engine/refinement.py): their Init/[][Next]_v
    halves check stepwise, and their fairness conjuncts are classified
    HERE into temporal obligations (the fairness half of LM_Inner_LISpec,
    MCLiveWriteThroughCache.cfg:4). On success the checker's
    liveness_skipped flag is cleared so the "fairness conjuncts are NOT
    checked" warning disappears. Instance-path refinements (V!Spec) keep
    the warning: their fairness would need instance-entered evaluation.

    Returns (obligations, unsupported_names, collect_edges):
    unsupported_names excludes properties a refinement checker already
    covers; collect_edges is True iff some obligation needs the edge log
    (everything except bare '[]P')."""
    refined_names = {rc.name for rc in refiners}
    obligations: List[Obligation] = []
    unsupported: List[str] = []
    for pnm, pexpr in model.properties:
        try:
            obligations.extend(classify_property(model, pnm, pexpr, {}))
        except (UnsupportedProperty, EvalError):
            if pnm not in refined_names:
                unsupported.append(pnm)
    for rc in refiners:
        if not rc.fair or rc.instances:
            continue
        try:
            obs = []
            for f in rc.fair:
                obs.extend(classify_property(model, rc.name, f, {}))
        except (UnsupportedProperty, EvalError):
            continue  # keep liveness_skipped: warning stays honest
        obligations.extend(obs)
        rc.liveness_skipped = False
    collect_edges = any(ob.kind != "always" for ob in obligations)
    return obligations, unsupported, collect_edges


def _contains_temporal(e: A.Node, model: Model, depth=0) -> bool:
    if depth > 40:
        return True
    e = _chase(e, model)
    if isinstance(e, (A.BoxAction, A.AngleAction, A.Fair, A.TemporalQuant,
                      A.Enabled)):
        return True
    if isinstance(e, A.OpApp):
        if e.name in ("[]", "<>", "~>", "-+->"):
            return True
        return any(_contains_temporal(a, model, depth + 1) for a in e.args)
    if isinstance(e, A.Quant):
        return _contains_temporal(e.body, model, depth + 1)
    return False


@dataclass
class FairnessConstraint:
    kind: str          # 'WF' | 'SF'
    action: A.Node
    sub: A.Node
    bound: Dict[str, Any]

    def describe(self) -> str:
        return f"{self.kind}({fmt_node(self.action)})"


def fmt_node(e) -> str:
    return getattr(e, "name", type(e).__name__)


def extract_fairness(model: Model) -> Tuple[List[FairnessConstraint],
                                            List[str]]:
    """Flatten the SPECIFICATION's fairness conjuncts into WF/SF
    constraints; returns (constraints, warnings for unhandled forms)."""
    out: List[FairnessConstraint] = []
    warns: List[str] = []

    def walk(e, bound):
        e = _chase(e, model)
        if _op(e, "/\\", 2):
            walk(e.args[0], bound)
            walk(e.args[1], bound)
            return
        if isinstance(e, A.Quant) and e.kind == "A":
            ctx = model.ctx().with_bound(bound)
            for b in iter_binders(e.binders, ctx, eval_expr):
                walk(e.body, {**bound, **b})
            return
        if isinstance(e, A.Fair):
            out.append(FairnessConstraint(e.kind, e.action, e.sub, bound))
            return
        if _op(e, "=>", 2):
            # (guard) => WF(...) with a constant guard under the binders
            # (InnerSerial.tla:116 "(oi # oj) => WF_...")
            try:
                g = _bool(eval_expr(e.args[0],
                                    model.ctx().with_bound(bound)))
            except EvalError:
                warns.append("fairness conjunct with unevaluable guard: "
                             "liveness may pass vacuously")
                return
            if g:
                walk(e.args[1], bound)
            return
        warns.append(f"fairness conjunct not understood "
                     f"({type(e).__name__}): liveness may pass vacuously")

    for f in model.fairness:
        walk(f, {})
    return out, warns


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

class LivenessChecker:
    """Checks obligations over a completed search's behavior graph.

    states: list of kept states; edges: list of (src_sid, dst_sid);
    parents/labels: BFS tree for trace reconstruction."""

    def __init__(self, model: Model, states: List[Dict], edges,
                 parents, labels):
        self.model = model
        self.states = states
        self.edges = edges
        self.parents = parents
        self.labels = labels
        self.n = len(states)
        self.adj: List[List[int]] = [[] for _ in range(self.n)]
        for s, t in edges:
            self.adj[s].append(t)
        self.fair, self.warnings = extract_fairness(model)
        # per-constraint caches: successor sets (enabledness) and edge
        # classifications (relation evaluation)
        self._succ_cache: List[Dict[int, Set[int]]] = \
            [dict() for _ in self.fair]
        self._edge_cache: List[Dict[Tuple[int, int], bool]] = \
            [dict() for _ in self.fair]
        self._state_key = {}
        for i, st in enumerate(states):
            self._state_key[self._key(st)] = i

    def _key(self, st):
        # value-equality key (NOT repr: repr of equal frozensets is
        # insertion-order dependent) — all TLA values are hashable
        return tuple(st[v] for v in self.model.vars)

    # ---- fairness action evaluation ----

    def _action_succs(self, c: FairnessConstraint, cache: Dict,
                      sid: int) -> Set[int]:
        """Graph-node ids of <<A>>_v successors of state sid for the
        action/subscript in `c` (sub must change). Used for ENABLEDness
        only — edge classification is relational (_is_action_edge),
        because an abstract action (ABCorrectness's CRcvMsg checked as a
        fairness atom of PROPERTY ABCSpec) assigns only the mapped
        variables: its instances are completed with the current state's
        values for unassigned variables (the refinement leaves them
        existentially free; "unchanged" witnesses enabledness)."""
        hit = cache.get(sid)
        if hit is not None:
            return hit
        st = self.states[sid]
        ctx = self.model.ctx().with_bound(c.bound)
        out: Set[int] = set()
        try:
            v0 = eval_expr(c.sub,
                           self.model.ctx(state=st).with_bound(c.bound))
            w = Walker("next", tuple(self.model.vars), st)
            for partial, _lbl in w.walk(c.action, ctx, {}, None):
                succ = {**st, **partial}
                # <<A>>_v: the subscript must change
                v1 = eval_expr(c.sub, self.model.ctx(state=succ)
                               .with_bound(c.bound))
                if tla_eq(v0, v1):
                    continue
                tid = self._state_key.get(self._key(succ))
                out.add(tid if tid is not None else -1)
        except EvalError:
            # treat evaluation failure as "enabled, successors unknown":
            # conservative for WF/SF (cannot justify fairness from it)
            out = {-1}
        cache[sid] = out
        return out

    def _is_action_edge(self, c: FairnessConstraint, ecache: Dict,
                        s: int, t: int) -> bool:
        """Is graph edge (s, t) an <<A>>_v step? Evaluated RELATIONALLY —
        A as a boolean over (state, primes), like refinement's
        check_edge — so abstract actions that leave concrete variables
        unconstrained classify correctly (the concrete step may change
        them alongside the mapped ones). Evaluation failure counts as
        "not an A-step": fairness is then never justified by this edge
        (conservative, same direction as the enabledness fallback)."""
        key = (s, t)
        hit = ecache.get(key)
        if hit is not None:
            return hit
        try:
            ctx = self.model.ctx(state=self.states[s],
                                 primes=self.states[t]).with_bound(c.bound)
            ok = _bool(eval_expr(c.action, ctx), "fairness action")
            if ok:
                v0 = eval_expr(c.sub, self.model.ctx(
                    state=self.states[s]).with_bound(c.bound))
                v1 = eval_expr(c.sub, self.model.ctx(
                    state=self.states[t]).with_bound(c.bound))
                ok = not tla_eq(v0, v1)
        except EvalError:
            ok = False
        ecache[key] = ok
        return ok

    def _enabled(self, ci: int, sid: int) -> bool:
        return bool(self._action_succs(self.fair[ci],
                                       self._succ_cache[ci], sid))

    def _is_fair_edge(self, ci: int, s: int, t: int) -> bool:
        return self._is_action_edge(self.fair[ci], self._edge_cache[ci],
                                    s, t)

    # ---- SCC machinery ----

    def _sccs(self, nodes: Set[int], edge_ok=None) -> List[Set[int]]:
        """Tarjan over the subgraph induced by `nodes` and the real edges
        passing edge_ok (iterative). Stuttering self-loops are implicit —
        every returned singleton is still a cycle."""
        index = {}
        low = {}
        onstack = {}
        stack: List[int] = []
        out: List[Set[int]] = []
        counter = [0]
        for root in nodes:
            if root in index:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    onstack[v] = True
                recurse = False
                nbrs = [w for w in self.adj[v] if w in nodes
                        and (edge_ok is None or edge_ok(v, w))]
                for i in range(pi, len(nbrs)):
                    w = nbrs[i]
                    if w not in index:
                        work[-1] = (v, i + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    if onstack.get(w):
                        low[v] = min(low[v], index[w])
                if recurse:
                    continue
                if low[v] == index[v]:
                    scc = set()
                    while True:
                        w = stack.pop()
                        onstack[w] = False
                        scc.add(w)
                        if w == v:
                            break
                    out.append(scc)
                work.pop()
                if work:
                    u, _ = work[-1]
                    low[u] = min(low[u], low[v])
        return out

    def _scc_supports_fair_cycle(self, scc: Set[int], edge_ok=None,
                                 require: Optional[List[Set[int]]] = None
                                 ) -> Optional[Set[int]]:
        """A subset of scc through which a fair cycle runs, or None.
        edge_ok(s, t) additionally restricts usable real edges; when
        `require` is given the cycle must visit one state of EACH set (so
        SF refinement keeps searching sub-cores that still contain one).
        Every node has an implicit stuttering self-loop (usable, never an
        <<A>>_v step), so singleton SCCs are cycles too."""
        def inner_edges(S):
            for s in S:
                for t in self.adj[s]:
                    if t in S and (edge_ok is None or edge_ok(s, t)):
                        yield s, t

        S = set(scc)
        if not S:
            return None
        if require is not None and any(not (S & r) for r in require):
            return None
        for ci, c in enumerate(self.fair):
            has_edge = any(self._is_fair_edge(ci, s, t)
                           for s, t in inner_edges(S))
            if has_edge:
                continue
            en = {s for s in S if self._enabled(ci, s)}
            if not en:
                continue
            if c.kind == "WF":
                if len(en) == len(S):
                    return None  # A continuously enabled, never taken
                continue  # some state disables A: covering walk is fair
            # SF: must avoid A-enabled states entirely
            S2 = S - en
            for sub in self._sccs(S2, edge_ok):
                r = self._scc_supports_fair_cycle(sub, edge_ok, require)
                if r is not None:
                    return r
            return None
        return S

    # ---- reachability + traces ----

    def _reachable_within(self, starts: Set[int],
                          nodes: Set[int]) -> Set[int]:
        seen = set(s for s in starts if s in nodes)
        work = list(seen)
        while work:
            v = work.pop()
            for w in self.adj[v]:
                if w in nodes and w not in seen:
                    seen.add(w)
                    work.append(w)
        return seen

    def _trace_to(self, sid: int) -> List[Tuple[Dict, str]]:
        out = []
        cur = sid
        while cur is not None:
            out.append((self.states[cur], self.labels[cur]))
            cur = self.parents[cur]
        out.reverse()
        return out

    def _eval_pred(self, expr: A.Node, bound, sid: int) -> bool:
        ctx = self.model.ctx(state=self.states[sid]).with_bound(bound)
        return _bool(eval_expr(expr, ctx), "temporal sub-formula")

    # ---- obligation checking ----

    def check(self, obligations: List[Obligation]
              ) -> Tuple[Optional[Tuple[str, List, str]], List[str]]:
        """Returns ((prop_name, trace, message) | None, warnings).
        Obligations come pre-classified (engine/explore.py) so the caller
        controls the unsupported-form warnings."""
        for ob in obligations:
            bad = self._check_obligation(ob)
            if bad is not None:
                return bad, list(self.warnings)
        return None, list(self.warnings)

    def _check_obligation(self, ob: Obligation):
        allnodes = set(range(self.n))
        if ob.kind == "always":
            for sid in range(self.n):
                if not self._eval_pred(ob.exprs[0], ob.bound, sid):
                    return (ob.describe(), self._trace_to(sid),
                            "state violates the []-predicate")
            return None

        if ob.kind == "ae":
            # violation: fair cycle within ~P
            nodes = {s for s in allnodes
                     if not self._eval_pred(ob.exprs[0], ob.bound, s)}
            return self._lasso(ob, nodes, starts=nodes,
                               msg="a fair behavior eventually avoids the "
                                   "[]<> target forever")

        if ob.kind == "ae_action":
            # the checked action is NOT a fairness assumption — it only
            # classifies edges (the violating cycle must avoid A-steps)
            action, sub = ob.exprs
            c = FairnessConstraint("", action, sub, ob.bound)
            cache: Dict[Tuple[int, int], bool] = {}

            def edge_ok(s, t):
                return not self._is_action_edge(c, cache, s, t)
            return self._lasso(
                ob, allnodes, starts=allnodes, edge_ok=edge_ok,
                msg="a fair behavior takes the <<A>>_v action only "
                    "finitely often")

        if ob.kind == "leadsto":
            # evaluate lazily: the consequent only needs a value on states
            # reachable after the antecedent held (TLC-style laziness —
            # AlwaysResponds's opIdQ(oi) is out-of-domain on states where
            # oi never entered opId, and those states never matter)
            p, q = ob.exprs
            starts = set()
            for s in allnodes:
                try:
                    if not self._eval_pred(p, ob.bound, s):
                        continue
                except EvalError:
                    continue  # antecedent unevaluable: no obligation here
                if self._eval_pred(q, ob.bound, s):
                    continue  # satisfied immediately
                starts.add(s)
            notq = set(starts)
            work = list(starts)
            while work:
                v = work.pop()
                for w in self.adj[v]:
                    if w in notq:
                        continue
                    if not self._eval_pred(q, ob.bound, w):
                        notq.add(w)
                        work.append(w)
            return self._lasso(
                ob, notq, starts=starts,
                msg="after the ~> antecedent, a fair behavior never "
                    "reaches the consequent")

        if ob.kind == "ae_disj":
            # violation of  atom1 \/ atom2 \/ ...  =  a fair lasso whose
            # cycle satisfies EVERY atom's <>[]-negation:
            #   ('pred', P)      ~[]<>P        : cycle within ~P
            #   ('action', A, v) ~[]<><<A>>_v  : no <<A>>_v edge on cycle
            #   ('WF', A, v)     <>[]En /\ <>[]~taken :
            #                    cycle within ENABLED<<A>>_v, no A-edge
            #   ('SF', A, v)     []<>En /\ <>[]~taken :
            #                    cycle meets ENABLED<<A>>_v, no A-edge
            nodes = set(allnodes)
            acts: List[Tuple[FairnessConstraint, Dict]] = []
            requires: List[Set[int]] = []
            for atom in ob.exprs:
                if atom[0] == "pred":
                    nodes = {s for s in nodes
                             if not self._eval_pred(atom[1], ob.bound, s)}
                    continue
                c = FairnessConstraint("", atom[1], atom[2], ob.bound)
                en_cache: Dict[int, Set[int]] = {}
                acts.append((c, {}))
                if atom[0] == "WF":
                    nodes = {s for s in nodes
                             if self._action_succs(c, en_cache, s)}
                elif atom[0] == "SF":
                    requires.append(
                        {s for s in allnodes
                         if self._action_succs(c, en_cache, s)})

            def edge_ok(s, t):
                return all(not self._is_action_edge(c, ecache, s, t)
                           for c, ecache in acts)
            return self._lasso(
                ob, nodes, starts=nodes,
                edge_ok=edge_ok if acts else None, require=requires,
                msg="a fair behavior violates every disjunct: each []<> "
                    "target (or fairness atom) fails from some point on")

        if ob.kind in ("ea", "p_ea"):
            if ob.kind == "p_ea":
                p, q = ob.exprs
                starts = {s for s in allnodes
                          if self._eval_pred(p, ob.bound, s)}
            else:
                q, = ob.exprs
                starts = allnodes
            reach = self._reachable_within(starts, allnodes)
            notq = {s for s in reach
                    if not self._eval_pred(q, ob.bound, s)}
            # fair cycle (within reach) visiting a ~Q state
            for scc in self._sccs(reach):
                if not (scc & notq):
                    continue
                core = self._scc_supports_fair_cycle(scc, require=[notq])
                if core is not None:
                    ent = min(core & notq)
                    return (ob.describe(), self._trace_to(ent),
                            "a fair behavior violates <>[] (the negated "
                            "state recurs forever after this point)")
            return None

        raise AssertionError(ob.kind)

    def _lasso(self, ob: Obligation, nodes: Set[int], starts: Set[int],
               msg: str, edge_ok=None, require=None):
        """Fair cycle within `nodes`, reachable (inside `nodes`) from
        `starts`, meeting each `require` set — the generic violation
        search."""
        reach = self._reachable_within(starts, nodes)
        for scc in self._sccs(reach, edge_ok):
            core = self._scc_supports_fair_cycle(scc, edge_ok,
                                                 require or None)
            if core is not None:
                ent = min(core)
                return (ob.describe(), self._trace_to(ent), msg)
        return None


