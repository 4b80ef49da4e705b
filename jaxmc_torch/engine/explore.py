r"""Host BFS model-checking engine (the exact oracle path, BACKEND=interp).

Reproduces TLC's observable behavior (SURVEY.md §3.2): enumerate Init states,
breadth-first apply Next, dedup on full states, check invariants and
constraints on every new distinct state, detect deadlock, report progress in
TLC's format (testout1:3-9) and shortest counterexample traces with action
provenance (README.md:268-318).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..sem.values import Fcn, ModelValue, fmt, sort_key
from ..sem.eval import TLCAssertFailure, eval_expr, _bool
from ..sem.enumerate import (Walker, enumerate_init, enumerate_next,
                             label_str)
from ..sem.modules import Model


@dataclass
class Violation:
    kind: str  # 'invariant' | 'assert' | 'deadlock' | 'constraint-eval' | 'error'
    name: str
    trace: List[Tuple[Dict[str, Any], str]]  # (state, action label)
    message: str = ""


@dataclass
class CheckResult:
    ok: bool
    distinct: int
    generated: int
    diameter: int
    violation: Optional[Violation] = None
    wall_s: float = 0.0
    prints: List[Any] = field(default_factory=list)
    truncated: bool = False
    warnings: List[str] = field(default_factory=list)
    # a cooperative drain (jaxmc_torch/drain.py: SIGTERM, serve daemon
    # shutdown) stopped the search at a safe boundary after writing a
    # checkpoint; implies truncated=True — the explored prefix is clean
    # but incomplete, and the run is resumable
    drained: bool = False
    # truncation ATTRIBUTION: which resource ran
    # out — "max_states: distinct N >= limit M", a named tier/cap with
    # the observed need, a drain reason — so `obs diff` can tell a
    # capacity regression from a deliberate limit.  None on complete
    # runs.
    trunc_reason: Optional[str] = None
    # dedup-key mode the run actually used ("exact" | "fingerprint")
    # and, in fingerprint mode, the reported collision-probability
    # bound (< n^2 * 2^-129 over n admitted keys) — TLC reports the
    # same estimate for its 64-bit fingerprints
    seen_mode: str = "exact"
    collision_p: Optional[float] = None
    # hierarchical seen-set summary when the run spilled (tiers.py
    # stats(): host/disk keys, spills, compactions, probe wall)
    tiers: Optional[Dict[str, Any]] = None

    @property
    def states_per_sec(self) -> float:
        return self.generated / self.wall_s if self.wall_s > 0 else 0.0


def _state_key(state: Dict[str, Any], vars: Tuple[str, ...]):
    return tuple(state[v] for v in vars)


def state_fingerprint(model: Model, canon, view_expr,
                      vars: Tuple[str, ...], st: Dict[str, Any]):
    """The ONE dedup fingerprint for the exact engines: the canonical
    (SYMMETRY-least) state's value tuple, or the VIEW expression's VALUE
    when the cfg declares one (TLC fingerprints the view, not the state).
    The serial engine, the parallel engine's parent merge, and the
    parallel workers must all agree on this — a change here changes all
    three together (tests/test_parallel.py pins the parity)."""
    cst = canon(st) if canon is not None else st
    if view_expr is not None:
        return ("$view", eval_expr(view_expr, model.ctx(state=cst)))
    return _state_key(cst, vars)


def _apply_perm(v, pd):
    """Apply a model-value permutation (dict ModelValue->ModelValue) to a
    value tree."""
    if isinstance(v, ModelValue):
        return pd.get(v, v)
    if isinstance(v, frozenset):
        return frozenset(_apply_perm(x, pd) for x in v)
    if isinstance(v, Fcn):
        return Fcn({_apply_perm(k, pd): _apply_perm(x, pd)
                    for k, x in v.d.items()})
    from ..sem.values import FcnSetV
    if isinstance(v, FcnSetV):
        return frozenset(_apply_perm(x, pd) for x in v.materialize())
    return v


def make_canonicalizer(model: Model):
    """cfg SYMMETRY (TLC.tla:13-14 Permutations): canonicalize each state
    to the least representative under the declared permutation set, the
    standard symmetry reduction (SURVEY.md §5). Returns None when no
    symmetry is declared or every permutation is the identity."""
    from ..sem.symmetry import symmetry_group
    perms = symmetry_group(model)
    if not perms:
        return None

    def canon(state: Dict[str, Any]) -> Dict[str, Any]:
        best = state
        best_key = sort_key(tuple(state[v] for v in model.vars))
        for pd in perms:
            cand = {v: _apply_perm(state[v], pd) for v in model.vars}
            k = sort_key(tuple(cand[v] for v in model.vars))
            if k < best_key:
                best, best_key = cand, k
        return best

    return canon


def liveness_setup(model: Model, refiners, view_expr):
    """Temporal-obligation collection + the warning lines both exact
    engines must emit IDENTICALLY (the parity suite pins warnings
    byte-for-byte).  Returns (live_obligations, collect_edges,
    warnings).  collect_obligations also adopts the fairness halves of
    spec-shaped PROPERTYs (clearing liveness_skipped), so it runs BEFORE
    the refiner warning pass."""
    from .liveness import collect_obligations
    warnings: List[str] = []
    live_obligations, unsupported, collect_edges = \
        collect_obligations(model, refiners)
    for rc in refiners:
        if rc.liveness_skipped:
            warnings.append(
                f"property {rc.name}: refinement checked stepwise; its "
                f"fairness conjuncts are NOT checked")
    if unsupported:
        warnings.append(
            "temporal properties NOT checked (unsupported form): "
            + ", ".join(unsupported))
    if view_expr is not None and live_obligations:
        # the behavior graph under VIEW links view-collapsed
        # representatives — liveness verdicts over it would be wrong
        # (TLC likewise refuses VIEW together with liveness)
        warnings.append(
            "temporal properties NOT checked: cfg VIEW collapses "
            "the behavior graph (TLC also rejects VIEW with "
            "liveness): "
            + ", ".join(sorted({ob.prop_name
                                for ob in live_obligations})))
        live_obligations = []
        collect_edges = False
    return live_obligations, collect_edges, warnings


class Explorer:
    def __init__(self, model: Model, log: Callable[[str], None] = None,
                 max_states: Optional[int] = None,
                 progress_every: float = 30.0,
                 trace_parents: bool = True,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: float = 600.0,
                 resume_from: Optional[str] = None,
                 final_checkpoint: bool = False,
                 por: bool = False):
        from .. import obs
        self.model = model
        # partial-order reduction (opt-in --por): expand ONE
        # globally-commuting invisible arm per state when every one of
        # its successors is new (persistent-set filter + BFS cycle
        # proviso) — preserves invariant/deadlock verdicts, NOT raw
        # state counts.  Disabled with a named reason on models whose
        # constructs interact with the reduction (CONSTRAINT, SYMMETRY,
        # VIEW, temporal/refinement PROPERTYs).
        self.por = por
        # default sink: silent on stdout but still mirrored into the
        # telemetry trace (obs.Logger is THE log funnel — cli.py passes
        # a printing one; library callers get the quiet one)
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.max_states = max_states
        self.progress_every = progress_every
        self.trace_parents = trace_parents
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.resume_from = resume_from
        # write one last checkpoint when the search COMPLETES (empty
        # queue, full state table): the serve daemon's warm-resume
        # source — a later identical job resumes it and finishes
        # instantly with the same counts.  Off by default: `check`
        # keeps its exact log-line surface
        self.final_checkpoint = final_checkpoint
        self.prints: List[Any] = []

    def _ctx(self, state=None, primes=None):
        return self.model.ctx(state, primes, on_print=self.prints.append)

    def _check_state_preds(self, state) -> Optional[str]:
        """Returns the name of a violated invariant, else None."""
        if not self.model.invariants:
            return None  # skip the per-state ctx build entirely
        ctx = self._ctx(state=state)
        for name, expr in self.model.invariants:
            if not _bool(eval_expr(expr, ctx), f"invariant {name}"):
                return name
        return None

    def _satisfies_action_constraints(self, state, succ) -> bool:
        ctx = self._ctx(state=state, primes=succ)
        for name, expr in self.model.action_constraints:
            if not _bool(eval_expr(expr, ctx),
                         f"action constraint {name}"):
                return False
        return True

    def _satisfies_constraints(self, state) -> bool:
        from ..sem.modules import satisfies_constraints
        return satisfies_constraints(self.model, state)

    def _trace_to(self, sid, parents, states, labels) -> List[Tuple[Dict, str]]:
        out = []
        while sid is not None:
            out.append((states[sid], labels[sid]))
            sid = parents[sid]
        out.reverse()
        return out

    def run(self) -> CheckResult:
        from .. import obs
        model = self.model
        vars = model.vars
        t0 = time.time()
        tel = obs.current()
        base_ctx = self._ctx()

        # state table
        seen: Dict[tuple, int] = {}
        states: List[Dict[str, Any]] = []
        parents: List[Optional[int]] = []
        labels: List[str] = []
        queue = deque()
        generated = 0
        depth_of: List[int] = []
        diameter = 0
        last_progress = time.time()
        last_checkpoint = time.time()

        # checkpoint cost accounting: each write pickles the FULL state
        # table, so its cost grows with the search — surface it as a
        # checkpoint.write span (the phase rollup used to hide it as
        # anonymous search wall) and stretch the interval when a write
        # gets expensive relative to it (the cheap size/time guard:
        # never spend more than ~5% of the wall checkpointing)
        ck_state = {"every": self.checkpoint_every}

        def write_checkpoint(queue_head=(), generated_at=None,
                             prints_at=None):
            # TLC-style periodic checkpoint (testout1:10; SURVEY.md §5):
            # the full search state, resumable with --resume. A state whose
            # expansion is in flight is re-queued at the head with
            # `generated` rolled back to its pop, so resume re-expands it
            # exactly once and full-run counts stay exact. Written through
            # engine/ckpt.py (checksum + schema header): a clipped or
            # bit-rotted file is refused at resume, never half-trusted
            from . import ckpt as _ckpt
            payload = _ckpt.interp_payload(
                model, vars, states, parents, labels, depth_of,
                list(queue_head) + list(queue),
                generated if generated_at is None else generated_at,
                diameter, seen, edges, collect_edges,
                self.prints if prints_at is None
                else self.prints[:prints_at])
            _ckpt.write_periodic(
                self.checkpoint_path, "interp",
                {"module": model.module.name, "engine": "serial"},
                payload, tel, self.log, ck_state,
                span_attrs={"states": len(states),
                            "queue": len(queue_head) + len(queue)})

        canon = make_canonicalizer(model)

        VIOL = -1  # seen-value for constraint-violating states: TLC (1.57,
        # testout2:265 — 195 distinct) discards them entirely: fingerprinted
        # so they are not re-processed, but never counted as distinct,
        # never invariant-checked, never explored (Specifying Systems §14)

        view_expr = getattr(model, "view", None)

        def _lstr(label) -> str:
            return label if isinstance(label, str) else label_str(label)

        def add_state(st, parent, label, depth):
            """Returns (sid | None, new). sid None = discarded by
            CONSTRAINT; new is True the first time any state (kept or
            discarded) is seen.  MIRRORED in engine/parallel.py (its
            add_state + merge replay): any change to this dedup/discard
            flow must land there too or the engines' bit-identical
            parity breaks (tests/test_parallel.py pins it)."""
            # the POR proviso check may have fingerprinted this very
            # successor object already — reuse its key (por_keys is
            # empty on unreduced runs; defined below, bound at call
            # time)
            key = por_keys.pop(id(st), None) if por_keys else None
            if key is None:
                key = state_fingerprint(model, canon, view_expr, vars,
                                        st)
            # single-hash insert: tentatively claim the next sid; a dup
            # returns the existing mapping without a second key hash (the
            # fingerprint tuple is hashed once per generated state instead
            # of once for the probe plus once for the store)
            nid = len(states)
            sid = seen.setdefault(key, nid)
            if sid != nid:
                return (None if sid == VIOL else sid), False
            if not self._satisfies_constraints(st):
                seen[key] = VIOL
                return None, True
            states.append(st)
            parents.append(parent)
            labels.append(label)
            depth_of.append(depth)
            return nid, True

        from .refinement import build_refinement_checkers
        refiners, live_only = build_refinement_checkers(model)
        # temporal obligations are checked over the behavior graph after
        # the search completes (engine/liveness.py) — collect the full
        # edge log only when some property needs it ('always'
        # obligations only iterate states; don't pay the RAM +
        # checkpoint size otherwise)
        live_obligations, collect_edges, warnings = \
            liveness_setup(model, refiners, view_expr)
        edges: List[Tuple[int, int]] = []

        # ---- partial-order reduction setup ----
        por_active = False
        por_stats = {"ample": 0, "full": 0}
        por_arms = por_safe = por_ctxs = por_walkers = None
        if self.por:
            from ..analyze.independence import (independence_report,
                                                por_refusal)
            from ..compile.ground import split_arms
            por_reason = por_refusal(model)
            if por_reason is None and canon is not None:
                por_reason = "symmetry canonicalizer active"
            if por_reason is None:
                por_arms = split_arms(model)
                irep = independence_report(model, por_arms)
                tel.gauge("analyze.independence_pairs",
                          irep.commuting_pairs())
                tel.gauge("analyze.independence_safe",
                          len(irep.por_safe))
                if not irep.por_safe:
                    por_reason = ("no arm commutes with every other "
                                  "arm invisibly")
            if por_reason is not None:
                warnings.append(f"--por requested but reduction "
                                f"disabled: {por_reason} (running "
                                f"unreduced)")
                tel.gauge("por.disabled_reason", por_reason)
            else:
                por_active = True
                por_safe = sorted(irep.por_safe)
                por_ctxs = [base_ctx.with_bound(a.bound) if a.bound
                            else base_ctx for a in por_arms]
                por_walkers = [Walker("next", vars) for _ in por_arms]
                self.log(f"-- por: {len(por_safe)}/{len(por_arms)} "
                         f"arms eligible as singleton ample sets")

        def _arm_succs(i, st):
            arm = por_arms[i]
            fallback = arm.label or "Next"
            out = []
            for succ, label in enumerate_next(arm.expr, por_ctxs[i],
                                              vars, st,
                                              walker=por_walkers[i]):
                out.append((succ, _lstr(label) if label is not None
                            else fallback))
            return out

        # keys computed by the ample proviso check, reused by add_state
        # (the single-hash-per-state discipline the serial hot loop is
        # built around); repopulated per _por_expand call — entries
        # only ever describe the CURRENTLY-returned successor objects,
        # so a recycled id() can never resurrect a stale key
        por_keys: Dict[int, Any] = {}

        def _por_expand(st):
            """The persistent-set filter: the FIRST eligible arm whose
            successor set is nonempty and entirely NEW (keys outside
            `seen` — the BFS cycle proviso) becomes the singleton ample
            set; otherwise every arm expands, in original arm order
            (byte-identical to the unreduced walk's stream).

            Verdict preservation for SKIPPED arms (why an Assert or a
            guard violation in arm B cannot be lost): every ample arm
            commutes with EVERY arm, so no ample-only chain writes
            B's read set — B's enabledness and full evaluation
            (including any Assert outcome) are INVARIANT along the
            chain — and the all-successors-new proviso forces each
            chain to end in a full expansion (the seen set is finite
            and grows), which evaluates B with bit-identical inputs.
            Only TLC PRINT side effects of skipped interleavings are
            lost (documented in the README)."""
            por_keys.clear()
            cached = {}
            for i in por_safe:
                ss = _arm_succs(i, st)
                keys = [state_fingerprint(model, canon, view_expr,
                                          vars, s) for s, _l in ss]
                cached[i] = (ss, keys)
                if ss and all(k not in seen for k in keys):
                    por_stats["ample"] += 1
                    for (s, _l), k in zip(ss, keys):
                        por_keys[id(s)] = k
                    return ss
            out = []
            for i in range(len(por_arms)):
                hit = cached.get(i)
                if hit is None:
                    out.extend(_arm_succs(i, st))
                    continue
                ss, keys = hit
                # the proviso trials already hashed these successors:
                # keep their keys for add_state too
                for (s, _l), k in zip(ss, keys):
                    por_keys[id(s)] = k
                out.extend(ss)
            por_stats["full"] += 1
            return out

        # per-level BFS telemetry: record level d when its last state has
        # been expanded (the queue is depth-ordered, so the first pop of
        # depth d+1 closes level d); `lv` accumulates the in-flight level
        lv = {"depth": 0, "frontier": 0, "generated": 0, "new": 0,
              "t0": time.time()}

        def flush_level():
            if lv["frontier"] == 0 and lv["generated"] == 0:
                return
            tel.level(lv["depth"], frontier=lv["frontier"],
                      generated=lv["generated"], new=lv["new"],
                      distinct=len(states), seen=len(seen),
                      queue=len(queue),
                      wall_s=round(time.time() - lv["t0"], 6))
            lv.update(frontier=0, generated=0, new=0, t0=time.time())

        def result(ok, violation=None, truncated=False, drained=False,
                   trunc_reason=None):
            if truncated and live_obligations:
                warnings.append("temporal properties NOT checked: the "
                                "search was truncated (behavior graph "
                                "incomplete)")
            flush_level()
            mst = model._memo
            if mst is not None:
                tel.gauge("memo.hits", mst.hits)
                tel.gauge("memo.misses", mst.misses)
            tel.gauge("fingerprint.occupancy", len(seen))
            if self.por:
                tel.gauge("por.enabled", por_active)
                if por_active:
                    total = por_stats["ample"] + por_stats["full"]
                    tel.counter("por.ample_states", por_stats["ample"])
                    tel.counter("por.full_states", por_stats["full"])
                    tel.gauge("por.ample_ratio",
                              round(por_stats["ample"] / total, 4)
                              if total else 0.0)
                    # the REDUCED run's distinct count — obs diff reads
                    # it against an unreduced baseline's result.distinct
                    tel.gauge("por.reduced_states", len(states))
            if truncated and trunc_reason is None:
                # name the exhausted resource —
                # the serial engine truncates on max_states or a drain
                trunc_reason = (f"drain" if drained else
                                f"max_states: distinct {len(states)} "
                                f">= limit {self.max_states}")
            if trunc_reason:
                tel.gauge("truncation.reason", trunc_reason)
            return CheckResult(ok=ok, distinct=len(states),
                               generated=generated, diameter=diameter,
                               violation=violation, wall_s=time.time() - t0,
                               prints=self.prints, truncated=truncated,
                               warnings=warnings, drained=drained,
                               trunc_reason=trunc_reason)

        def drain_out():
            # cooperative drain (jaxmc_torch/drain.py): checkpoint at this
            # safe boundary (nothing in flight — the drained state goes
            # back on the queue untouched) and stop with the named
            # reason; the caller's finally blocks close spans/watchdog
            from .. import drain as _drain
            why = _drain.reason()
            self.log(f"-- drain requested ({why}): stopping at a safe "
                     f"boundary")
            if self.checkpoint_path:
                write_checkpoint()
            tel.event("drain", reason=why, engine="serial")
            warnings.append(
                f"run drained before completion ({why})"
                + (f"; resume with --resume {self.checkpoint_path}"
                   if self.checkpoint_path else "; no checkpoint was "
                   "configured — progress was discarded"))
            return result(True, truncated=True, drained=True)

        # ---- resume from a checkpoint ----
        if self.resume_from:
            # integrity (checksum/truncation/format) and module/vars
            # validation live in engine/ckpt.py; every defect is a
            # CkptError (exit 2 at the CLI), never a traceback or a
            # silently-wrong resume.
            # dedup keys must be symmetry-canonical, matching add_state.
            # seen_items stores (key, sid-or-VIOL) directly so resume is a
            # linear dict fill — no re-canonicalization, and discarded
            # (constraint-violating) fingerprints survive the checkpoint.
            from .ckpt import load_interp_checkpoint
            ck = load_interp_checkpoint(self.resume_from, model, vars,
                                        collect_edges)
            self.prints.extend(ck.get("prints", []))
            states.extend(ck["states"])
            parents.extend(ck["parents"])
            labels.extend(ck["labels"])
            depth_of.extend(ck["depth_of"])
            queue.extend(ck["queue"])
            generated = ck["generated"]
            diameter = ck["diameter"]
            seen.update(ck["seen_items"])
            if collect_edges:
                edges.extend(ck["edges"])
            self.log(f"Resumed from {self.resume_from}: {len(states)} "
                     f"distinct states, {len(queue)} on queue.")

        # ---- initial states ----
        try:
            inits = [] if self.resume_from else                 enumerate_init(model.init, base_ctx, vars)
        except TLCAssertFailure as ex:
            return result(False, Violation("assert", "Init", [], str(ex.out)))
        init_count = 0
        for st in inits:
            sid, new = add_state(st, None, "Initial predicate", 0)
            if not new:
                continue
            generated += 1
            if sid is None:
                continue  # discarded by CONSTRAINT
            init_count += 1
            bad = self._check_state_preds(st)
            if bad is not None:
                return result(False, Violation(
                    "invariant", bad,
                    self._trace_to(sid, parents, states, labels)))
            for rc in refiners:
                if not rc.check_init(st):
                    return result(False, Violation(
                        "property", rc.name,
                        self._trace_to(sid, parents, states, labels),
                        f"initial state violates {rc.name}'s initial "
                        f"predicate"))
            queue.append(sid)
        if not self.resume_from:
            self.log(f"Finished computing initial states: {init_count} "
                     f"distinct state{'s' if init_count != 1 else ''} "
                     f"generated.")

        # first progress record IMMEDIATELY: a short run used
        # to produce zero progress lines because the first one waited a
        # full --progress-every interval
        d0 = depth_of[queue[0]] if queue else 0
        self.log(f"Progress({d0}): {generated} states generated, "
                 f"{len(states)} distinct states found, "
                 f"{len(queue)} states left on queue."
                 f"{obs.eta_suffix(len(states), tel)}")

        # ---- BFS ----
        # one reusable walker for the whole search: the action AST is
        # split (call-by-name decisions, substituted bodies) once per run
        # instead of once per state (sem/enumerate.py Walker)
        next_walker = Walker("next", vars)
        from .. import drain as _drain
        while queue:
            if _drain.requested():
                return drain_out()
            sid = queue.popleft()
            st = states[sid]
            depth = depth_of[sid]
            if depth > lv["depth"]:
                flush_level()
                lv["depth"] = depth
                # chaos harness: simulated hard crash entering a level
                # (the kill/resume parity suite SIGKILLs here and pins
                # the resumed counts bit-identical to an uninterrupted
                # run). No-op unless JAXMC_FAULTS configures run_kill.
                from .. import faults
                faults.kill_self("run_kill", level=depth,
                                 engine="serial")
            lv["frontier"] += 1
            diameter = max(diameter, depth)
            succ_count = 0
            gen_at_pop = generated
            prints_at_pop = len(self.prints)
            try:
                pairs = _por_expand(st) if por_active else \
                    enumerate_next(model.next, base_ctx, vars, st,
                                   walker=next_walker)
                for succ, label in pairs:
                    succ_count += 1
                    generated += 1
                    lv["generated"] += 1
                    if model.action_constraints and not \
                            self._satisfies_action_constraints(st, succ):
                        continue
                    nid, new = add_state(succ, sid, _lstr(label),
                                         depth + 1)
                    if nid is None:
                        continue  # discarded by CONSTRAINT (not checked)
                    if collect_edges:
                        edges.append((sid, nid))
                    for rc in refiners:
                        if not rc.check_edge(st, succ):
                            trace = self._trace_to(sid, parents, states,
                                                   labels)
                            trace.append((succ, _lstr(label)))
                            msg = (f"step is not a [{rc.name}-Next]_v "
                                   f"step of the refined specification")
                            if rc.last_error:
                                msg += (f"; while evaluating the property: "
                                        f"{rc.last_error}")
                            return result(False, Violation(
                                "property", rc.name, trace, msg))
                    if not new:
                        continue
                    lv["new"] += 1
                    bad = self._check_state_preds(succ)
                    if bad is not None:
                        return result(False, Violation(
                            "invariant", bad,
                            self._trace_to(nid, parents, states, labels)))
                    queue.append(nid)
                    if self.max_states and len(states) >= self.max_states:
                        self.log("-- state limit reached, search truncated")
                        if self.checkpoint_path:
                            write_checkpoint(queue_head=[sid],
                                             generated_at=gen_at_pop,
                                             prints_at=prints_at_pop)
                        return result(True, truncated=True)
            except TLCAssertFailure as ex:
                trace = self._trace_to(sid, parents, states, labels)
                return result(False, Violation("assert", "Assert", trace,
                                               str(ex.out)))
            if succ_count == 0 and model.check_deadlock:
                return result(False, Violation(
                    "deadlock", "deadlock",
                    self._trace_to(sid, parents, states, labels)))
            now = time.time()
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} states generated, "
                         f"{len(states)} distinct states found, "
                         f"{len(queue)} states left on queue."
                         f"{obs.eta_suffix(len(states), tel)}")
            if self.checkpoint_path and \
                    now - last_checkpoint >= ck_state["every"]:
                last_checkpoint = now
                write_checkpoint()

        # completed search: persist the FINAL checkpoint when asked (the
        # serve daemon's warm-resume source — resuming it replays the
        # stored totals over an empty queue and finishes immediately)
        if self.checkpoint_path and self.final_checkpoint:
            write_checkpoint()

        # ---- temporal properties over the completed behavior graph ----
        if live_obligations:
            from .liveness import LivenessChecker
            lc = LivenessChecker(model, states, edges, parents, labels)
            bad, live_warns = lc.check(live_obligations)
            warnings.extend(live_warns)
            if bad is not None:
                pname, trace, msg = bad
                return result(False, Violation("property", pname, trace,
                                               msg))

        self.log(f"Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {len(states)} distinct "
                 f"states found, 0 states left on queue.")
        self.log(f"The depth of the complete state graph search is "
                 f"{diameter + 1}.")
        return result(True)


def format_trace(violation: Violation) -> str:
    lines = []
    if violation.kind == "invariant":
        lines.append(f"Error: Invariant {violation.name} is violated.")
    elif violation.kind == "property":
        lines.append(f"Error: Property {violation.name} is violated"
                     + (f" ({violation.message})." if violation.message
                        else "."))
    elif violation.kind == "assert":
        lines.append(f"Error: Assertion failed: {violation.message}")
    elif violation.kind == "deadlock":
        lines.append("Error: Deadlock reached.")
    else:  # engine errors (capacity overflow, ...) — never print silently
        lines.append(f"Error: {violation.name}"
                     + (f": {violation.message}" if violation.message
                        else "."))
    if not violation.trace:
        return "\n".join(lines)
    lines.append("The behavior up to this point is:")
    for i, (st, label) in enumerate(violation.trace):
        head = "Initial predicate" if i == 0 else f"Action {label}"
        lines.append(f"State {i + 1}: <{head}>")
        for k in sorted(st.keys()):
            lines.append(f"  {k} = {fmt(st[k])}")
        lines.append("")
    return "\n".join(lines)
