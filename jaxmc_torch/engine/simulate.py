r"""Random-walk simulation (TLC's -simulate mode) and deep state sampling.

Two uses: (a) a CLI `simulate` subcommand checking invariants along random
behaviors without exhaustive search, (b) the layout sampler for the TPU
backend — raft's interesting structures (leaders, log entries, elections)
appear many levels deep, so shape inference mixes a BFS prefix with long
random walks (compile/vspec.py docstring).
"""

from __future__ import annotations

import random
from collections import deque
from typing import Dict, List

from ..sem.eval import TLCAssertFailure, eval_expr, _bool
from ..sem.enumerate import enumerate_init, enumerate_next, label_str
from ..sem.modules import Model
from .explore import Violation


def random_walks(model: Model, n_walks: int, depth: int,
                 seed: int = 0, collect=None,
                 check_invariants: bool = False,
                 coverage_guided: bool = False,
                 check_deadlock: bool = False):
    """Run random behaviors; returns a Violation or None. collect(state)
    is called on every visited state when given.

    coverage_guided biases successor choice toward action labels taken
    least often so far — plain uniform walks essentially never complete a
    raft election (Timeout keeps winning), while novelty-weighted walks
    reach leaders, log entries, and elections quickly."""
    rng = random.Random(seed)
    ctx = model.ctx()
    inits = enumerate_init(model.init, ctx, model.vars)
    if not inits:
        raise EvalError("no initial states satisfy the initial predicate")
    if check_invariants:
        for st in inits:
            ictx = model.ctx(state=st)
            for nm, expr in model.invariants:
                if not _bool(eval_expr(expr, ictx), f"invariant {nm}"):
                    return Violation("invariant", nm,
                                     [(st, "Initial predicate")])
    label_counts: Dict[str, int] = {}
    for w in range(n_walks):
        st = rng.choice(inits)
        trace = [(st, "Initial predicate")]
        if collect:
            collect(st)
        for _ in range(depth):
            try:
                succs = list(enumerate_next(model.next, ctx, model.vars, st))
            except TLCAssertFailure as ex:
                return Violation("assert", "Assert", trace, str(ex.out))
            if not succs:
                if check_deadlock:
                    return Violation("deadlock", "deadlock", trace)
                break
            if coverage_guided:
                # weight by action-family novelty (label name sans args)
                weights = []
                for _, lbl in succs:
                    fam = (lbl[0] if lbl else "?")
                    c = label_counts.get(fam, 0)
                    weights.append(1.0 / (1 + c) ** 2)
                st, label = rng.choices(succs, weights=weights, k=1)[0]
                fam = (label[0] if label else "?")
                label_counts[fam] = label_counts.get(fam, 0) + 1
            else:
                st, label = rng.choice(succs)
            trace.append((st, label_str(label)))
            if collect:
                collect(st)
            if check_invariants:
                ictx = model.ctx(state=st)
                for nm, expr in model.invariants:
                    if not _bool(eval_expr(expr, ictx), f"invariant {nm}"):
                        return Violation("invariant", nm, trace)
    return None


def sample_states(model: Model, bfs_states: int = 1500,
                  n_walks: int = 60, walk_depth: int = 60,
                  seed: int = 0) -> List[Dict]:
    """States for layout inference: BFS prefix (covers the breadth of early
    actions) + random walks (cover depth: leaders, full logs, elections).

    Constraint-violating states are excluded: the checker discards them
    (TLC semantics), so including them would size container capacities for
    a space the search never explores — on raft, sampling without the cfg
    CONSTRAINT grows the message table to the full potential message
    universe and the compiled kernels with it. The encoder's overflow
    guard still aborts exactly if a real run outgrows the inferred caps
    (one frontier step can exceed the constrained envelope; the sizing
    margin covers it)."""
    from ..sem.modules import satisfies_constraints
    ctx = model.ctx()

    def in_bounds(st):
        return satisfies_constraints(model, st)

    inits = enumerate_init(model.init, ctx, model.vars)
    states = [st for st in inits if in_bounds(st)]
    # ALL inits are sampled (discarded ones are still fingerprinted, so
    # the layout must encode them); only kept inits seed the expansion
    out = list(inits)

    def key(s):
        return tuple(sorted((k, repr(v)) for k, v in s.items()))

    seen = {key(s) for s in out}
    q = deque(states)
    while q and len(out) < bfs_states:
        st = q.popleft()
        try:
            succs = enumerate_next(model.next, ctx, model.vars, st)
            for succ, _ in succs:
                k = key(succ)
                if k not in seen and in_bounds(succ):
                    seen.add(k)
                    out.append(succ)
                    q.append(succ)
        except TLCAssertFailure:
            continue

    # coverage-guided walks with novelty restarts: whenever a walk first
    # takes a new action family, the resulting state seeds later walks —
    # deep structures (a raft leader's ClientRequest) are reached by
    # continuing from the rare prefix instead of re-finding it
    rng = random.Random(seed)
    label_counts: Dict[str, int] = {}
    novel_starts: List[Dict] = []

    def collect(st):
        k = key(st)
        if k not in seen and in_bounds(st):
            seen.add(k)
            out.append(st)

    starts = states
    if not starts:
        return out  # no constraint-satisfying init: nothing to walk
    for w in range(n_walks):
        pool = starts + novel_starts
        st = rng.choice(pool)
        for _ in range(walk_depth):
            try:
                succs = [sl for sl in
                         enumerate_next(model.next, ctx, model.vars, st)
                         if in_bounds(sl[0])]
            except TLCAssertFailure:
                break
            if not succs:
                break
            weights = []
            for _, lbl in succs:
                fam = lbl[0] if lbl else "?"
                weights.append(1.0 / (1 + label_counts.get(fam, 0)) ** 2)
            st, label = rng.choices(succs, weights=weights, k=1)[0]
            fam = label[0] if label else "?"
            first = fam not in label_counts
            label_counts[fam] = label_counts.get(fam, 0) + 1
            collect(st)
            if first:
                novel_starts.append(st)
    return out
