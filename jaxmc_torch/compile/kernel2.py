r"""Lanes-first kernel compiler: grounded actions -> batch-first transition
kernels over vspec layouts (SURVEY.md §7.4).

The port of jaxmc/compile/kernel2.py.  Where the reference traces one
state row and vmaps it, this compiler evaluates each expression once
over a whole block of rows: a traced lane is a `lanes.BL` over an
[N] or [N, w] int32 tensor, static lanes stay numpy and broadcast
(compile/lanes.py).  A compiled action is
fn(rows[N, W]) -> (en[N], aok[N], ov[N] int32, succ[N, W]); a slotted
action takes its slot index as a Python int, and the engine loops over
the static n_slots.  Evaluation is eager: calling a compiled unit runs
the symbolic evaluation over the given block, so the engine calls each
unit once on a one-row block at build time to surface a lazy
CompileError before the search starts.

Every symbolic value is a SymV(spec, lanes): a vspec shape plus its encoded
i32 lanes (python ints when static, traced scalars otherwise). Because
encodings are canonical (vspec.py), equality is lane equality, IF is a
lane-wise where, and containers are lane slices — one uniform rule set
covers raft's sequences, message unions, bags, and history sets.

Spec unification: before comparing/merging two values their specs are
vspec.merge'd and both re-encoded (coerce) — e.g. a 2-entry log literal
meets the cap-4 log layout, a concrete RequestVote record meets the
message-union spec.

Capacity overflow (Append past seq cap, bag insert past table cap, interval
past the int-set universe) raises an overflow flag that the engine treats
as a hard error — never silent truncation, counts stay exact
(BASELINE.json).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import lanes as bnp

from ..front import tla_ast as A
from ..sem.values import (EvalError, Fcn, InfiniteSet, ModelValue,
                          in_set, sort_key, tla_eq)
from ..sem.eval import OpClosure, bind_pattern
from ..sem.modules import Model
from .vspec import (Bounds, CompileError, EnumUniverse, SENTINEL_LANE, VS,
                    encode as vs_encode, merge as vs_merge)

BOOL = VS("bool")
INT = VS("int")
ENUM = VS("enum")


def _is_traced(v) -> bool:
    return isinstance(v, bnp.BL)


class SymV:
    """A symbolic value: vspec shape + its encoded lanes as ONE i32 array
    (np.ndarray when fully static, a batch-first `lanes.BL` otherwise).
    Array lanes keep the work O(expression size): slices, splices,
    equality and selects are single tensor ops over the whole block
    instead of per-lane scalar graphs."""
    __slots__ = ("spec", "lanes")

    def __init__(self, spec: VS, lanes):
        self.spec = spec
        if isinstance(lanes, (list, tuple)):
            lanes = _cat([_as_lane_arr(x) for x in lanes]) if lanes \
                else np.zeros(0, np.int32)
        self.lanes = lanes

    @property
    def static(self) -> bool:
        return isinstance(self.lanes, np.ndarray)

    def __repr__(self):
        return f"SymV({self.spec.kind}, {len(self.lanes)} lanes)"


def _as_lane_arr(x):
    """One lane (scalar int/bool, traced scalar, or an array) as a 1-D
    lane array segment."""
    if isinstance(x, np.ndarray):
        return x.astype(np.int32) if x.ndim else x.reshape(1).astype(np.int32)
    if _is_traced(x):
        if x.ndim == 0:
            x = bnp.reshape(x, (1,))
        if x.dtype == bnp.bool_:
            x = x.astype(bnp.int32)
        return x.astype(bnp.int32)
    if isinstance(x, bool):
        return np.asarray([1 if x else 0], np.int32)
    return np.asarray([x], np.int32)


def _cat(segs):
    """Concatenate lane segments; stays numpy when all static."""
    segs = [sg for sg in segs if len(sg)]
    if not segs:
        return np.zeros(0, np.int32)
    if len(segs) == 1:
        return segs[0]
    if all(isinstance(sg, np.ndarray) for sg in segs):
        return np.concatenate(segs)
    return bnp.concatenate([bnp.asarray(sg) for sg in segs])


def _zeros(n):
    return np.zeros(n, np.int32)


def _fill(n, v):
    return np.full(n, v, np.int32)


def _ite(c, a, b):
    """where() on single lanes with static shortcuts."""
    if isinstance(c, bool):
        return a if c else b
    if isinstance(a, (int, bool)) and isinstance(b, (int, bool)) and a == b:
        return a
    return bnp.where(c, a, b)


def _npbool(x):
    return bool(x) if isinstance(x, np.bool_) else x


def _land(a, b):
    a, b = _npbool(a), _npbool(b)
    if a is True:
        return b
    if b is True:
        return a
    if a is False or b is False:
        return False
    return bnp.logical_and(a, b)


def _lor(a, b):
    a, b = _npbool(a), _npbool(b)
    if a is False:
        return b
    if b is False:
        return a
    if a is True or b is True:
        return True
    return bnp.logical_or(a, b)


def _lnot(a):
    a = _npbool(a)
    return (not a) if isinstance(a, bool) else bnp.logical_not(a)


def _eq_lane(a, b):
    if not _is_traced(a) and not _is_traced(b):
        return a == b
    return bnp.equal(a, b)


class KernelCtx:
    """Compilation context for one model."""

    def __init__(self, model: Model, layout, bounds: Bounds):
        self.model = model
        self.layout = layout
        self.uni: EnumUniverse = layout.uni
        self.bounds = bounds
        self.iset_cap = max([bounds.seq_cap] +
                            [s.cap for s in layout.specs.values()
                             if s.kind == "seq"])
        # per-operator unroll depth: a RECURSIVE operator on
        # symbolic arguments unrolls forever at trace time. Catching it
        # as a Python RecursionError loses the culprit's name; this
        # counter trips FIRST and raises a CompileError that NAMES the
        # recursing operator — the per-arm demotion reason table then
        # says "Serializable diverges", not just "RecursionError".
        # Same-name re-entry 64 deep is legitimate only for concrete
        # (terminating) recursion far larger than any corpus model uses
        # (JAXMC_OP_UNROLL_LIMIT raises it).
        self.op_depth: Dict[str, int] = {}
        self.op_unroll_limit = int(
            os.environ.get("JAXMC_OP_UNROLL_LIMIT", "64"))
        # LIFTED CONSTANTS: name -> traced int32 scalar.
        # When a name is present here, identifier resolution returns the
        # traced lane instead of baking the model's concrete value into
        # the kernel — the same compiled program then serves every
        # layout-compatible model, with per-model CONSTANT values fed in
        # as batch-axis inputs (backend/batch.py).  Installed at TRACE
        # time by the engine (bfs.py installs the tracers at the top of
        # each jitted step / forced abstract trace), empty otherwise.
        # A lifted constant used where compilation needs a STATIC value
        # (a quantifier domain bound, a container cap) raises the usual
        # CompileError at trace time — the batch planner treats that as
        # "not batchable", never as a wrong kernel.
        self.const_lanes: Dict[str, Any] = {}


class Frame:
    """Per-expression evaluation frame."""
    __slots__ = ("kc", "bound", "state", "primes", "overflow", "strict",
                 "guard", "demo", "memo")

    def __init__(self, kc: KernelCtx, bound, state, primes, overflow,
                 strict=False, guard=True, demo=None, memo=None):
        self.kc = kc
        self.bound = bound      # name -> SymV | static python value
        self.state = state      # var -> SymV
        self.primes = primes    # var -> SymV
        self.overflow = overflow  # list with one traced/py bool cell
        # strict frames (compiled predicates) may not use overflow-guarded
        # recovery: a wrong False from an invariant would be a spurious
        # violation, a wrong True a missed one — fail the compile instead
        self.strict = strict
        # liveness of the current evaluation context: bodies evaluated for
        # dead quantifier/set members (mask false) must not abort the run
        self.guard = guard
        # DEMOTION cell (may be None): flags from `except CompileError`
        # recovery sites — compiler limitations the hybrid engine can fix
        # by demoting the arm to the interpreter — land here, separate
        # from genuine capacity overflows (see flag_demoted)
        self.demo = demo
        # STRICT-frame symbolic-value memo (sym_eval2): predicates carry
        # no overflow flags (they raise instead) and guard never affects
        # VALUES, so identical (expr, relevant-bound) subterms can share
        # one traced result — this collapses exponential unrolls
        # (MCVoting's mutually recursive VotesSafeAt) into a DAG
        self.memo = memo

    def with_bound(self, extra):
        return Frame(self.kc, {**self.bound, **extra}, self.state,
                     self.primes, self.overflow, self.strict, self.guard,
                     self.demo, self.memo)

    def with_guard(self, g):
        return Frame(self.kc, self.bound, self.state, self.primes,
                     self.overflow, self.strict, _land(self.guard, g),
                     self.demo, self.memo)

    def flag_overflow(self, cond, why=None):
        """A genuine capacity/spec overflow: a value outgrew its lanes
        (the fix is a larger --seq-cap/--kv-cap/--grow-cap)."""
        cond = _land(self.guard, _npbool(cond))
        if self.strict and cond is not False:
            raise CompileError(
                "uncompilable subterm in a predicate (no overflow "
                "recovery in invariants)"
                + (f": {why}" if why else ""))
        self.overflow[0] = _lor(self.overflow[0], cond)

    def flag_demoted(self, cond, why=None):
        """A compile-limitation recovery (an `except CompileError` site):
        the compiled guard/value deviates from TLC unless the run aborts
        when cond holds. Kept in a separate cell so the hybrid engine can
        demote the arm to exact interpreter enumeration and restart,
        instead of reporting a spurious capacity overflow.  `why` (the
        recovered CompileError's message) survives into the strict-mode
        refusal so a demoted PREDICATE's reason still names the real
        culprit (e.g. which recursive operator diverged)."""
        cond = _land(self.guard, _npbool(cond))
        if self.strict and cond is not False:
            raise CompileError(
                "uncompilable subterm in a predicate (no overflow "
                "recovery in invariants)"
                + (f": {why}" if why else ""))
        cell = self.demo if self.demo is not None else self.overflow
        cell[0] = _lor(cell[0], cond)


def static_to_symv(v, kc: KernelCtx, spec: Optional[VS] = None) -> SymV:
    """Encode a concrete interpreter value as lanes."""
    if spec is None:
        from .vspec import infer
        spec = infer(v, kc.uni)
        from .vspec import apply_bounds
        spec = apply_bounds(spec, kc.bounds)
    out: List[int] = []
    vs_encode(v, spec, kc.uni, out)
    return SymV(spec, np.asarray(out, np.int32))


def coerce(v: SymV, spec: VS, fr: Frame) -> SymV:
    """Re-encode v's lanes under a (merged, wider) spec."""
    if v.spec == spec:
        return v
    return SymV(spec, _coerce_lanes(v.spec, spec, v.lanes, fr))


def _coerce_lanes(src: VS, dst: VS, lanes, fr: Frame):
    """Re-encode a lane array from spec src to spec dst (array in/out)."""
    if src == dst:
        return lanes
    uni = fr.kc.uni
    sk, dk = src.kind, dst.kind
    if sk == "justempty":
        if dk == "seq":
            return _zeros(dst.width)
        if dk == "kvtable":
            return _cat([_zeros(1), _fill(dst.width - 1, SENTINEL_LANE)])
        if dk == "pfcn":
            return _zeros(dst.width)
        if dk == "fcn":
            fr.flag_overflow(len(dst.dom) > 0)
            return _zeros(dst.width)
        raise CompileError(f"cannot coerce empty function to {dk}")
    if dk == "justempty":
        # storing into an only-ever-empty layout slot: exact as long as the
        # value is empty at runtime; otherwise the overflow flag aborts
        if sk in ("seq", "kvtable"):
            fr.flag_overflow(_lnot(_eq_lane(lanes[0], 0)))
            return _zeros(0)
        if sk == "pfcn":
            off = 0
            for kk, es in zip(src.dom, src.elems):
                fr.flag_overflow(_eq_lane(lanes[off], 1))
                off += 1 + es.width
            return _zeros(0)
        if sk == "fcn":
            fr.flag_overflow(len(src.dom) > 0)
            return _zeros(0)
    if sk == "emptyset" or (sk == "set" and not src.dom):
        if dk == "set":
            return _zeros(len(dst.dom))
        if dk == "growset":
            return _cat([_zeros(1), _fill(dst.width - 1, SENTINEL_LANE)])
        if dk == "iset":
            return _zeros(len(dst.dom))
        raise CompileError(f"cannot coerce empty set to {dk}")
    if sk == dk == "seq":
        if dst.cap < src.cap:
            # shrinking is sound when the runtime length fits; otherwise
            # the overflow flag aborts the run (universe-sized constructor
            # results coerce into tighter layout slots)
            fr.flag_overflow(_ge_lane(lanes[0], dst.cap + 1))
        segs = [lanes[0:1]]
        for i in range(min(src.cap, dst.cap)):
            segs.append(_coerce_lanes(
                src.elem, dst.elem,
                lanes[1 + i * src.elem.width:
                      1 + (i + 1) * src.elem.width], fr))
        if dst.cap > src.cap:
            segs.append(_zeros((dst.cap - src.cap) * dst.elem.width))
        return _cat(segs)
    if sk == dk == "set":
        pos = {m: i for i, m in enumerate(src.dom)}
        if set(src.dom) - set(dst.dom):
            raise CompileError("set coercion drops members")
        segs = [lanes[pos[m]:pos[m] + 1] if m in pos else _zeros(1)
                for m in dst.dom]
        return _cat(segs)
    if sk == dk == "iset" or (sk == "set" and dk == "iset"):
        pos = {m: i for i, m in enumerate(src.dom)}
        if set(src.dom) - set(dst.dom):
            raise CompileError("iset coercion drops members")
        segs = [lanes[pos[m]:pos[m] + 1] if m in pos else _zeros(1)
                for m in dst.dom]
        return _cat(segs)
    if sk == dk == "growset":
        if src.elem != dst.elem:
            raise CompileError("growset element coercion unsupported")
        if dst.cap < src.cap:
            raise CompileError("growset coercion would shrink capacity")
        return _cat([lanes,
                     _fill((dst.cap - src.cap) * dst.elem.width,
                           SENTINEL_LANE)])
    if sk == dk == "kvtable":
        if src.elem != dst.elem or src.val != dst.val:
            raise CompileError("kvtable element coercion unsupported")
        if dst.cap < src.cap:
            raise CompileError("kvtable coercion would shrink capacity")
        pad = dst.elem.width + dst.val.width
        return _cat([lanes, _fill((dst.cap - src.cap) * pad,
                                  SENTINEL_LANE)])
    if sk == "fcn" and dk == "union":
        names = tuple(k for k in src.dom)
        for tag, (vnames, vfields) in enumerate(dst.variants):
            if vnames == names:
                segs = [np.asarray([tag], np.int32)]
                off = 0
                w = 1
                for (kk, es), fs in zip(zip(src.dom, src.elems), vfields):
                    seg = _coerce_lanes(es, fs,
                                        lanes[off:off + es.width], fr)
                    segs.append(seg)
                    off += es.width
                    w += fs.width
                segs.append(_zeros(dst.width - w))
                return _cat(segs)
        raise CompileError(f"record {names} not a variant of the union")
    if sk in ("int", "bool", "enum") and dk == "union":
        # scalar into a tagged union (buf[p] := NoVal alongside request
        # records — the CachingMemory shape)
        want = (f"$scalar:{sk}",)
        for tag, (vnames, vfields) in enumerate(dst.variants):
            if vnames == want:
                return _cat([np.asarray([tag], np.int32),
                             _as_seg(lanes, 1),
                             _zeros(dst.width - 2)])
        raise CompileError(f"scalar {sk} not a variant of the union")
    if sk == "union" and dk == "union" and src != dst:
        # re-tag into a superset union (a sub-union value constructed in
        # an expression lands in the var's merged layout union)
        smap = {names: (t, fields)
                for t, (names, fields) in enumerate(src.variants)}
        dmap = {names: (t, fields)
                for t, (names, fields) in enumerate(dst.variants)}
        for names in smap:
            if names not in dmap:
                raise CompileError(
                    f"union variant {names} not in the target union")
        tag_l = lanes[0]
        acc_tag = None
        acc_pay = None
        for names, (stag, sfields) in smap.items():
            dtag, dfields = dmap[names]
            off = 1
            segs = []
            w = 0
            for sf, df in zip(sfields, dfields):
                segs.append(_coerce_lanes(
                    sf, df, lanes[off:off + sf.width], fr))
                off += sf.width
                w += df.width
            segs.append(_zeros(dst.width - 1 - w))
            pay = _cat(segs)
            cond = _eq_lane(tag_l, stag)
            dt = np.asarray([dtag], np.int32)
            acc_tag = dt if acc_tag is None else _select_lanes(
                cond, dt, acc_tag)
            acc_pay = pay if acc_pay is None else _select_lanes(
                cond, pay, acc_pay)
        return _cat([_as_seg(acc_tag, 1), acc_pay])
    if sk == "fcn" and dk == "pfcn":
        srcmap = {}
        off = 0
        for kk, es in zip(src.dom, src.elems):
            srcmap[kk] = (es, lanes[off:off + es.width])
            off += es.width
        if set(srcmap) - set(dst.dom):
            raise CompileError("pfcn coercion drops keys")
        segs = []
        for kk, es in zip(dst.dom, dst.elems):
            if kk in srcmap:
                ses, sl = srcmap[kk]
                segs.append(np.asarray([1], np.int32))
                segs.append(_coerce_lanes(ses, es, sl, fr))
            else:
                segs.append(_zeros(1 + es.width))
        return _cat(segs)
    if sk == "fcn" and dk == "seq":
        if not all(isinstance(k, int) for k in src.dom):
            raise CompileError("cannot coerce non-int function to sequence")
        n = len(src.dom)
        if n > dst.cap:
            raise CompileError("sequence literal exceeds capacity")
        segs = [np.asarray([n], np.int32)]
        off = 0
        for kk, es in zip(src.dom, src.elems):
            segs.append(_coerce_lanes(es, dst.elem,
                                      lanes[off:off + es.width], fr))
            off += es.width
        segs.append(_zeros((dst.cap - n) * dst.elem.width))
        return _cat(segs)
    if sk == "fcn" and dk == "kvtable":
        rows = []
        off = 0
        for kk, es in zip(src.dom, src.elems):
            kb: List[int] = []
            vs_encode(kk, dst.elem, uni, kb)
            vlanes = _coerce_lanes(es, dst.val,
                                   lanes[off:off + es.width], fr)
            rows.append((kb, vlanes))
            off += es.width
        rows.sort(key=lambda r: r[0])
        if len(rows) > dst.cap:
            raise CompileError("table literal exceeds capacity")
        segs = [np.asarray([len(rows)], np.int32)]
        for kb, vl in rows:
            segs.append(np.asarray(kb, np.int32))
            segs.append(vl)
        pad = dst.elem.width + dst.val.width
        segs.append(_fill((dst.cap - len(rows)) * pad, SENTINEL_LANE))
        return _cat(segs)
    if sk == "fcn" and dk == "fcn":
        if tuple(src.dom) != tuple(dst.dom):
            raise CompileError("function domains differ in coercion")
        segs = []
        off = 0
        for (kk, ses), des in zip(zip(src.dom, src.elems), dst.elems):
            segs.append(_coerce_lanes(ses, des,
                                      lanes[off:off + ses.width], fr))
            off += ses.width
        return _cat(segs)
    if sk == "pfcn" and dk == "fcn":
        # sound when every dst key is present; absent keys flag overflow
        srcmap = {}
        off = 0
        for kk, es in zip(src.dom, src.elems):
            srcmap[kk] = (lanes[off], es, lanes[off + 1:off + 1 + es.width])
            off += 1 + es.width
        segs = []
        for kk, es in zip(dst.dom, dst.elems):
            if kk not in srcmap:
                raise CompileError("pfcn->fcn coercion missing key")
            pres, ses, sl = srcmap[kk]
            fr.flag_overflow(_eq_lane(pres, 0))
            segs.append(_coerce_lanes(ses, es, sl, fr))
        return _cat(segs)
    if sk == "pfcn" and dk == "pfcn":
        srcmap = {}
        off = 0
        for kk, es in zip(src.dom, src.elems):
            srcmap[kk] = (lanes[off:off + 1], es,
                          lanes[off + 1:off + 1 + es.width])
            off += 1 + es.width
        segs = []
        for kk, es in zip(dst.dom, dst.elems):
            if kk in srcmap:
                pres, ses, sl = srcmap[kk]
                segs.append(pres)
                segs.append(_coerce_lanes(ses, es, sl, fr))
            else:
                segs.append(_zeros(1 + es.width))
        return _cat(segs)
    if sk == "iset" and dk == "set":
        raise CompileError("cannot view integer set as enum set")
    raise CompileError(f"cannot coerce {sk} to {dk}")


def unify(a: SymV, b: SymV, fr: Frame) -> Tuple[SymV, SymV]:
    if a.spec == b.spec:
        return a, b
    m = vs_merge(a.spec, b.spec)
    from .vspec import apply_bounds
    m = apply_bounds(m, fr.kc.bounds)
    return coerce(a, m, fr), coerce(b, m, fr)


def sym_eq(a: SymV, b: SymV, fr: Frame):
    a, b = unify(a, b, fr)
    if a.static and b.static:
        return bool(np.array_equal(a.lanes, b.lanes))
    if len(a.lanes) == 0:
        return True
    return bnp.all(bnp.asarray(a.lanes) == bnp.asarray(b.lanes))


def _rows_lex_lt(rows, x):
    """Vectorized lexicographic rows[i] < x over a [n, w] matrix: decided
    at each row's first differing lane. w == 0 rows compare equal."""
    if rows.shape[1] == 0:
        return bnp.zeros(rows.shape[0], bnp.bool_)
    neq = rows != x[None, :]
    first = bnp.argmax(neq, axis=1)
    srow = bnp.take_along_axis(rows, first[:, None], axis=1)[:, 0]
    return bnp.where(bnp.any(neq, axis=1), srow < x[first], False)


# ---------------------------------------------------------------------------
# symbolic evaluation
# ---------------------------------------------------------------------------

def as_bool(v, fr: Frame):
    if isinstance(v, bool):
        return v
    if isinstance(v, SymV):
        if v.spec.kind != "bool":
            raise CompileError(f"expected boolean, got {v.spec.kind}")
        x = v.lanes[0]
        if v.static:
            return bool(x)
        return x != 0
    if _is_traced(v):
        return v if v.dtype == bnp.bool_ else v != 0
    raise CompileError(f"expected boolean, got {v!r}")


def as_int_lane(v):
    if isinstance(v, SymV):
        if v.spec.kind != "int":
            raise CompileError(f"expected integer, got {v.spec.kind}")
        x = v.lanes[0]
        return int(x) if v.static else x
    if isinstance(v, bool):
        raise CompileError("boolean used as integer")
    if isinstance(v, int) or _is_traced(v):
        return v
    if isinstance(v, np.integer):
        return int(v)
    raise CompileError(f"expected integer, got {v!r}")


def mk_bool(x) -> SymV:
    return SymV(BOOL, [x])


def mk_int(x) -> SymV:
    return SymV(INT, [x])


def _lift(v, fr: Frame) -> SymV:
    """Lift a static python value to SymV."""
    if isinstance(v, SymV):
        return v
    if isinstance(v, bool):
        return SymV(BOOL, [v])
    if isinstance(v, int):
        return SymV(INT, [v])
    return static_to_symv(v, fr.kc)


def _seq_elem(v: SymV, i: int):
    ew = v.spec.elem.width
    return v.lanes[1 + i * ew: 1 + (i + 1) * ew]


def _slots_matrix(lanes, off, cap, w):
    """View lanes[off : off+cap*w] as a [cap, w] matrix (one reshape)."""
    seg = lanes[off:off + cap * w]
    if isinstance(seg, np.ndarray):
        return seg.reshape(cap, w)
    return bnp.reshape(seg, (cap, w))


def _select_lanes(cond, a, b):
    """Lane-block select: one XLA where over the whole segment."""
    if isinstance(cond, bool):
        return a if cond else b
    a = a if not isinstance(a, (list, tuple)) else \
        _cat([_as_lane_arr(x) for x in a])
    b = b if not isinstance(b, (list, tuple)) else \
        _cat([_as_lane_arr(x) for x in b])
    return bnp.where(cond, a, b)


def sym_apply(f, args: List, fr: Frame) -> Any:
    """Function application f[k]."""
    if not isinstance(f, SymV):
        # static python Fcn with possibly-symbolic argument
        if isinstance(f, Fcn):
            f = _lift(f, fr)
        else:
            raise CompileError(f"cannot apply {f!r}")
    key = args[0] if len(args) == 1 else None
    if key is None:
        # f[a, b] == f[<<a, b>>]
        raise CompileError("multi-argument application not supported yet")
    sp = f.spec
    if sp.kind == "fcn":
        if isinstance(key, SymV) and key.static or not isinstance(key, SymV):
            kk = _static_key_value(key, fr)
            off = 0
            for dk, es in zip(sp.dom, sp.elems):
                if _keys_equal(dk, kk):
                    return SymV(es, f.lanes[off:off + es.width])
                off += es.width
            raise CompileError(f"application outside static domain: {kk!r}")
        # symbolic key: select across domain entries
        ks = key
        acc = None
        off = 0
        for dk, es in zip(sp.dom, sp.elems):
            dk_s = static_to_symv(dk, fr.kc)
            cond = sym_eq(ks, dk_s, fr)
            cur = f.lanes[off:off + es.width]
            acc = cur if acc is None else _select_lanes(cond, cur, acc)
            off += es.width
        espec = sp.elems[0]
        for e in sp.elems[1:]:
            if e != espec:
                raise CompileError("symbolic application over heterogeneous "
                                   "function")
        return SymV(espec, acc)
    if sp.kind == "pfcn":
        kk = None
        if not isinstance(key, SymV) or key.static:
            kk = _static_key_value(key, fr)
        off = 0
        for dk, es in zip(sp.dom, sp.elems):
            if kk is not None and _keys_equal(dk, kk):
                # TLC errors on applying outside DOMAIN; compiled path
                # returns the (zeroed-when-absent) value — guards in the
                # spec keep this sound, as with TLC's lazy evaluation
                return SymV(es, f.lanes[off + 1:off + 1 + es.width])
            off += 1 + es.width
        if kk is not None:
            raise CompileError(f"pfcn key outside universe: {kk!r}")
        acc = None
        off = 0
        espec = sp.elems[0]
        for dk, es in zip(sp.dom, sp.elems):
            cond = sym_eq(key, static_to_symv(dk, fr.kc), fr)
            cur = f.lanes[off + 1:off + 1 + es.width]
            acc = cur if acc is None else _select_lanes(cond, cur, acc)
            off += 1 + es.width
        return SymV(espec, acc)
    if sp.kind == "seq":
        idx = as_int_lane(key)
        if isinstance(idx, int):
            if not 1 <= idx <= sp.cap:
                raise CompileError(f"static sequence index {idx} out of "
                                   f"capacity {sp.cap}")
            return SymV(sp.elem, _seq_elem(f, idx - 1))
        elems = bnp.asarray(_slots_matrix(f.lanes, 1, sp.cap,
                                          sp.elem.width))
        safe = bnp.clip(idx - 1, 0, sp.cap - 1)
        return SymV(sp.elem, elems[safe])
    if sp.kind == "kvtable":
        # msgs[m]: one vectorized key match + select
        kw, vw = sp.elem.width, sp.val.width
        kv = coerce(key if isinstance(key, SymV) else _lift(key, fr),
                    sp.elem, fr)
        rows = bnp.asarray(_slots_matrix(f.lanes, 1, sp.cap, kw + vw))
        match = bnp.all(rows[:, :kw] ==
                        bnp.asarray(_as_seg(kv.lanes, kw))[None, :], axis=1)
        sel = bnp.where(match[:, None], rows[:, kw:], 0)
        return SymV(sp.val, bnp.sum(sel, axis=0).astype(bnp.int32))
    if sp.kind == "union":
        raise CompileError("cannot apply a record value")
    if sp.kind == "justempty":
        raise CompileError("application of an always-empty function")
    raise CompileError(f"cannot apply value of kind {sp.kind}")


def _static_key_value(key, fr: Frame):
    if isinstance(key, SymV):
        if key.spec.kind == "int":
            return int(key.lanes[0])
        if key.spec.kind == "enum":
            return fr.kc.uni.value(int(key.lanes[0]))
        if key.spec.kind == "bool":
            return bool(key.lanes[0])
        raise CompileError(f"unsupported static key kind {key.spec.kind}")
    if isinstance(key, np.integer):
        return int(key)
    return key


def _keys_equal(a, b) -> bool:
    if isinstance(a, ModelValue) or isinstance(b, ModelValue):
        return a is b
    if isinstance(a, np.integer):
        a = int(a)
    if isinstance(b, np.integer):
        b = int(b)
    if type(a) is not type(b) and not (isinstance(a, int)
                                       and isinstance(b, int)):
        return False
    return a == b


def sym_dot(v, fld: str, fr: Frame) -> SymV:
    if not isinstance(v, SymV):
        v = _lift(v, fr)
    sp = v.spec
    if sp.kind == "fcn":
        return sym_apply(v, [fld], fr)
    if sp.kind == "union":
        acc = None
        espec = None
        for tag, (names, fields) in enumerate(sp.variants):
            if fld not in names:
                continue
            off = 1
            for nm, fs in zip(names, fields):
                if nm == fld:
                    cur = v.lanes[off:off + fs.width]
                    espec = fs if espec is None else espec
                    if fs != espec:
                        cur = _coerce_lanes(fs, espec, cur, fr)
                    cond = _eq_lane(v.lanes[0], tag)
                    acc = cur if acc is None else _select_lanes(cond, cur,
                                                                acc)
                    break
                off += fs.width
        if acc is None:
            raise CompileError(f"no union variant has field {fld}")
        return SymV(espec, acc)
    raise CompileError(f"field access .{fld} on {sp.kind}")


# ---- sets ----

def _set_of(v, fr: Frame):
    """Normalize to ('static', frozenset) | ('sym', SymV with set/iset/
    growset spec)."""
    if isinstance(v, frozenset):
        return ("static", v)
    if isinstance(v, SymV) and v.spec.kind in ("set", "iset", "growset",
                                               "emptyset"):
        return ("sym", v)
    if isinstance(v, InfiniteSet):
        return ("inf", v)
    raise CompileError(f"expected a set, got {v!r}")


def sym_in(x, s, fr: Frame):
    kind, sv = _set_of(s, fr)
    if kind == "inf":
        if not isinstance(x, SymV):
            # static value against an infinite set: the interpreter rule
            return in_set(x, sv)
        # membership in Nat/Int/Seq(S): type-level for compiled values
        if isinstance(x, SymV):
            if sv.kind == "Nat":
                return bnp.greater_equal(as_int_lane(x), 0) \
                    if _is_traced(as_int_lane(x)) else as_int_lane(x) >= 0
            if sv.kind == "Int":
                return True
            if sv.kind == "Seq":
                # q \in Seq(S): every used element in S (TypeInvariant,
                # InnerFIFO.tla) — vacuous beyond the length
                if x.spec.kind == "justempty":
                    return True
                if x.spec.kind == "seq":
                    acc = True
                    n = x.lanes[0]
                    for i in range(x.spec.cap):
                        el = SymV(x.spec.elem, _seq_elem(x, i))
                        inn = _generic_in(el, sv.param, fr)
                        unused = _ge_lane(i, n)
                        acc = _land(acc, _lor(unused, inn))
                    return acc
                if x.spec.kind == "fcn" and all(
                        isinstance(k, int) for k in x.spec.dom) and \
                        tuple(x.spec.dom) == tuple(
                            range(1, len(x.spec.dom) + 1)):
                    # heterogeneous tuple encoded as int-keyed record
                    acc = True
                    off = 0
                    for kk, es in zip(x.spec.dom, x.spec.elems):
                        el = SymV(es, x.lanes[off:off + es.width])
                        acc = _land(acc, _generic_in(el, sv.param, fr))
                        off += es.width
                    return acc
                return False
        raise CompileError(f"membership in {sv!r} not compilable")
    if kind == "static":
        if not isinstance(x, SymV) or x.static:
            xv = x if not isinstance(x, SymV) else _decode_static(x, fr)
            return in_set(xv, sv)
        acc = False
        for m in sorted(sv, key=sort_key):
            acc = _lor(acc, sym_eq(x, static_to_symv(m, fr.kc), fr))
        return acc
    sp = sv.spec
    if sp.kind in ("set", "iset"):
        acc = False
        for i, m in enumerate(sp.dom):
            memb = sv.lanes[i]
            acc = _lor(acc, _land(
                memb if isinstance(memb, bool) else _eq_lane(memb, 1),
                as_bool(sym_eq(_lift(x, fr), static_to_symv(m, fr.kc), fr),
                        fr)))
        return acc
    if sp.kind == "growset":
        xe = coerce(_lift(x, fr), sp.elem, fr)
        ew = sp.elem.width
        slots = _slots_matrix(sv.lanes, 1, sp.cap, ew)
        used = bnp.arange(sp.cap) < sv.lanes[0]
        hits = bnp.all(bnp.asarray(slots) == bnp.asarray(xe.lanes)[None, :],
                       axis=1) & used
        return bnp.any(hits)
    raise CompileError(f"membership in {sp.kind} not supported")


def _lt_lane(a, b):
    if not _is_traced(a) and not _is_traced(b):
        return a < b
    return bnp.less(a, b)


def _decode_static(v: SymV, fr: Frame):
    from .vspec import decode
    val, _ = decode([int(x) for x in v.lanes], 0, v.spec, fr.kc.uni)
    return val


def set_elements(s, fr: Frame):
    """Iterate a set as (guard, element) pairs — guards may be traced."""
    kind, sv = _set_of(s, fr)
    if kind == "static":
        for m in sorted(sv, key=sort_key):
            yield True, m
        return
    if kind == "inf":
        raise CompileError(cannot_enumerate_message(sv))
    sp = sv.spec
    if sp.kind in ("set", "iset"):
        for i, m in enumerate(sp.dom):
            memb = sv.lanes[i]
            yield (memb if isinstance(memb, bool)
                   else _eq_lane(memb, 1)), m
        return
    if sp.kind == "growset":
        ew = sp.elem.width
        for slot in range(sp.cap):
            base = 1 + slot * ew
            used = _lt_lane(slot, sv.lanes[0])
            yield used, SymV(sp.elem, sv.lanes[base:base + ew])
        return
    raise CompileError(f"cannot enumerate {sp.kind}")


def grow_insert(s: SymV, x: SymV, fr: Frame) -> SymV:
    """s \\cup {x} on a growset — sorted insertion, canonical, vectorized
    over the slot matrix."""
    sp = s.spec
    xe = coerce(x, sp.elem, fr)
    ew = sp.elem.width
    cnt = s.lanes[0]
    if ew == 0:
        # zero-width elements (a growset of always-empty values) are all
        # indistinguishable: the set is {} or a singleton
        newcnt = bnp.maximum(bnp.asarray(cnt), 1)
        return SymV(sp, bnp.reshape(newcnt, (1,)).astype(bnp.int32))
    slots = bnp.asarray(_slots_matrix(s.lanes, 1, sp.cap, ew))
    xl = bnp.asarray(xe.lanes)
    used = bnp.arange(sp.cap) < cnt
    present = bnp.any(bnp.all(slots == xl[None, :], axis=1) & used)
    lt = _rows_lex_lt(slots, xl)
    pos = bnp.sum(used & lt)
    fr.flag_overflow(bnp.logical_and(bnp.logical_not(present),
                                     _ge_lane(cnt, sp.cap)))
    idx = bnp.arange(sp.cap)
    prev = bnp.concatenate([bnp.zeros((1, ew), bnp.int32), slots[:-1]])
    ins = bnp.where((idx < pos)[:, None], slots,
                    bnp.where((idx == pos)[:, None], xl[None, :], prev))
    out_slots = bnp.where(present, slots, ins)
    newcnt = bnp.where(present, cnt, cnt + 1)
    lanes = bnp.concatenate([bnp.reshape(newcnt, (1,)).astype(bnp.int32),
                             out_slots.reshape(-1)])
    return SymV(sp, lanes)


def _ge_lane(a, b):
    if not _is_traced(a) and not _is_traced(b):
        return a >= b
    return bnp.greater_equal(a, b)


def set_union(a, b, fr: Frame):
    """a \\cup b with symbolic support."""
    if isinstance(a, frozenset) and isinstance(b, frozenset):
        return a | b
    # growset target: insert the other side's (guarded) elements
    if isinstance(a, SymV) and a.spec.kind == "growset":
        out = a
        for g, e in _elements(b, fr):
            ev = _lift(e, fr) if not isinstance(e, SymV) else e
            ins = grow_insert(out, ev, fr)
            gb = g if isinstance(g, bool) else g
            out = ins if gb is True else SymV(
                out.spec, _select_lanes(gb, ins.lanes, out.lanes))
        return out
    if isinstance(b, SymV) and b.spec.kind == "growset":
        return set_union(b, a, fr)
    if isinstance(a, Elems) or isinstance(b, Elems):
        # fold symbolic elements into a mask set when the other side is
        # one (votesGranted[i] \cup {j} with slot-bound j, raft.tla:372)
        other = b if isinstance(a, Elems) else a
        el = a if isinstance(a, Elems) else b
        try:
            mask = _to_mask_set(other, fr)
        except UnrollLimitError:
            raise
        except CompileError:
            items = list(_elements(a, fr)) + list(_elements(b, fr))
            return Elems(items)
        lanes = list(mask.lanes)
        for g, e in el.items:
            ev = _lift(e, fr) if not isinstance(e, (SymV, frozenset, Fcn)) \
                else e
            for i, m in enumerate(mask.spec.dom):
                hit = _land(g, as_bool(mk_bool(_generic_eq(
                    ev, _lift(m, fr) if not isinstance(m, (frozenset, Fcn))
                    else m, fr)), fr))
                cur = lanes[i]
                cb = cur if isinstance(cur, bool) else _eq_lane(cur, 1)
                r = _lor(cb, hit)
                lanes[i] = _ite(r, 1, 0) if not isinstance(r, bool) \
                    else (1 if r else 0)
        return SymV(mask.spec, lanes)
    # enum/int mask sets
    sa = _to_mask_set(a, fr)
    sb = _to_mask_set(b, fr)
    sa, sb = unify(sa, sb, fr)
    lanes = [_lor(_eq_lane(x, 1) if not isinstance(x, bool) else x,
                  _eq_lane(y, 1) if not isinstance(y, bool) else y)
             for x, y in zip(sa.lanes, sb.lanes)]
    return SymV(sa.spec, [_ite(l, 1, 0) if not isinstance(l, bool)
                          else (1 if l else 0) for l in lanes])


def _to_mask_set(v, fr: Frame) -> SymV:
    kind, sv = _set_of(v, fr)
    if kind == "sym":
        if sv.spec.kind in ("set", "iset"):
            return sv
        raise CompileError("growset in mask-set position")
    members = sorted(sv, key=sort_key)
    if all(isinstance(m, (str, ModelValue)) for m in members):
        return static_to_symv(sv, fr.kc, VS("set", dom=tuple(members)))
    if all(isinstance(m, int) and not isinstance(m, bool) for m in members):
        return SymV(VS("iset", dom=tuple(members)), [1] * len(members))
    raise CompileError("heterogeneous static set")


def interval_iset(lo, hi, fr: Frame) -> SymV:
    """a..b with traced bounds -> iset over 1..iset_cap universe."""
    lo_l = as_int_lane(lo)
    hi_l = as_int_lane(hi)
    cap = fr.kc.iset_cap
    uni_members = tuple(range(0, cap + 2))
    ms = bnp.arange(0, cap + 2)
    lanes = ((ms >= lo_l) & (ms <= hi_l)).astype(bnp.int32)
    # overflow if the interval reaches beyond the universe
    fr.flag_overflow(_land(_ge_lane(hi_l, cap + 2),
                           _ge_lane(hi_l, lo_l)))
    return SymV(VS("iset", dom=uni_members), lanes)


# ---- sequences ----

def seq_len(v: SymV) -> SymV:
    if v.spec.kind == "seq":
        return mk_int(v.lanes[0])
    if v.spec.kind == "justempty":
        return mk_int(0)
    raise CompileError(f"Len of {v.spec.kind}")


def seq_append(v: SymV, x, fr: Frame) -> SymV:
    if v.spec.kind == "justempty":
        # promote to a sequence of the appended element's shape; if the
        # layout truly has no room the target coercion raises cleanly
        xe = _lift(x, fr)
        from .vspec import apply_bounds
        sp = apply_bounds(VS("seq", cap=1, elem=xe.spec), fr.kc.bounds)
        v = SymV(sp, _zeros(sp.width))
    sp = v.spec
    xe = coerce(_lift(x, fr), sp.elem, fr)
    if v.static and xe.static:
        # static fast path: fold on python values so constants stay static
        from ..sem.values import mk_seq as _mk_seq
        sv = _decode_static(v, fr)
        xv = _decode_static(xe, fr)
        return static_to_symv(_mk_seq(sv.as_list() + [xv]), fr.kc)
    ew = sp.elem.width
    n = v.lanes[0]
    fr.flag_overflow(_ge_lane(n, sp.cap))
    elems = bnp.asarray(_slots_matrix(v.lanes, 1, sp.cap, ew))
    at = (bnp.arange(sp.cap) == n)[:, None]
    out = bnp.where(at, bnp.asarray(xe.lanes)[None, :], elems)
    lanes = bnp.concatenate([
        bnp.reshape(n + 1, (1,)).astype(bnp.int32), out.reshape(-1)])
    return SymV(sp, lanes)


def seq_subseq(v: SymV, m, n, fr: Frame) -> SymV:
    """SubSeq(v, m, n) with traced bounds; empty when m > n. One gather."""
    if v.spec.kind == "justempty":
        ml, nl = as_int_lane(m), as_int_lane(n)
        fr.flag_overflow(_ge_lane(nl, ml))
        return v
    sp = v.spec
    ml = as_int_lane(m)
    nl = as_int_lane(n)
    ew = sp.elem.width
    outlen = bnp.maximum(nl - ml + 1, 0)
    elems = bnp.asarray(_slots_matrix(v.lanes, 1, sp.cap, ew))
    src = ml - 1 + bnp.arange(sp.cap)          # 0-based source indices
    gathered = bnp.take(elems, bnp.clip(src, 0, sp.cap - 1), axis=0)
    keep = (bnp.arange(sp.cap) < outlen)[:, None]
    out = bnp.where(keep, gathered, 0)
    lanes = bnp.concatenate([
        bnp.reshape(outlen, (1,)).astype(bnp.int32), out.reshape(-1)])
    return SymV(sp, lanes)


def seq_concat(a: SymV, b: SymV, fr: Frame) -> SymV:
    if a.spec.kind == "justempty":
        return b
    if b.spec.kind == "justempty":
        return a
    sp = vs_merge(a.spec, b.spec)
    from .vspec import apply_bounds
    sp = apply_bounds(sp, fr.kc.bounds)
    a = coerce(a, sp, fr)
    b = coerce(b, sp, fr)
    ew = sp.elem.width
    na, nb = a.lanes[0], b.lanes[0]
    total = na + nb
    fr.flag_overflow(_ge_lane(total, sp.cap + 1))
    ea = bnp.asarray(_slots_matrix(a.lanes, 1, sp.cap, ew))
    eb = bnp.asarray(_slots_matrix(b.lanes, 1, sp.cap, ew))
    idx = bnp.arange(sp.cap)
    bsrc = bnp.clip(idx - na, 0, sp.cap - 1)
    from_b = bnp.take(eb, bsrc, axis=0)
    out = bnp.where((idx < na)[:, None], ea, from_b)
    out = bnp.where((idx < total)[:, None], out, 0)
    lanes = bnp.concatenate([
        bnp.reshape(total, (1,)).astype(bnp.int32), out.reshape(-1)])
    return SymV(sp, lanes)


# ---- EXCEPT ----

def _splice(lanes, off, width, new_seg):
    """lanes with [off:off+width] replaced by new_seg (3 segments, O(1) ops)."""
    return _cat([lanes[:off], _as_seg(new_seg, width), lanes[off + width:]])


def _as_seg(x, width):
    if isinstance(x, (list, tuple)):
        return _cat([_as_lane_arr(i) for i in x])
    if _is_traced(x) and x.ndim == 0:
        return bnp.reshape(x, (1,))
    if isinstance(x, np.ndarray) and x.ndim == 0:
        return x.reshape(1)
    if isinstance(x, (int, bool)):
        return _as_lane_arr(x)
    return x


def sym_except(f: SymV, path, rhs_eval, fr: Frame) -> SymV:
    """[f EXCEPT !path = rhs]; rhs_eval(old: SymV) -> value."""
    sp = f.spec
    kind, arg = path[0]
    if sp.kind == "fcn":
        key = arg if kind == "dot" else None
        keysym = None
        if key is None:
            if isinstance(arg, list):
                if len(arg) != 1:
                    raise CompileError("multi-key EXCEPT not supported")
                kv = arg[0]
            else:
                kv = arg
            if not isinstance(kv, SymV) or kv.static:
                key = _static_key_value(kv, fr)
            else:
                keysym = kv
        if key is not None:
            off = 0
            for dk, es in zip(sp.dom, sp.elems):
                if _keys_equal(dk, key):
                    old = SymV(es, f.lanes[off:off + es.width])
                    new = _apply_rest(old, path[1:], rhs_eval, fr)
                    new = coerce(_lift(new, fr), es, fr)
                    return SymV(sp, _splice(f.lanes, off, es.width,
                                            new.lanes))
                off += es.width
            raise CompileError(f"EXCEPT key {key!r} outside domain")
        # symbolic key over (usually homogeneous) fcn: guarded per-key
        # segments, concatenated once
        segs = []
        off = 0
        for dk, es in zip(sp.dom, sp.elems):
            cond = as_bool(mk_bool(sym_eq(
                keysym, static_to_symv(dk, fr.kc), fr)), fr)
            old = SymV(es, f.lanes[off:off + es.width])
            new = coerce(_lift(_apply_rest(old, path[1:], rhs_eval, fr),
                               fr), es, fr)
            segs.append(_as_seg(_select_lanes(
                cond, new.lanes, f.lanes[off:off + es.width]), es.width))
            off += es.width
        return SymV(sp, _cat(segs))
    if sp.kind == "seq":
        kv = arg[0] if kind == "idx" else arg
        idx = as_int_lane(kv)
        ew = sp.elem.width
        # old element: one gather; new: one masked scatter over the matrix
        elems = bnp.asarray(_slots_matrix(f.lanes, 1, sp.cap, ew))
        safe = bnp.clip(idx - 1, 0, sp.cap - 1)
        old = SymV(sp.elem, elems[safe])
        new = coerce(_lift(_apply_rest(old, path[1:], rhs_eval, fr), fr),
                     sp.elem, fr)
        at = (bnp.arange(sp.cap) == (idx - 1))[:, None]
        out = bnp.where(at, bnp.asarray(_as_seg(new.lanes, ew))[None, :],
                        elems)
        lanes = bnp.concatenate([bnp.reshape(f.lanes[0], (1,)).astype(
            bnp.int32), out.reshape(-1)])
        return SymV(sp, lanes)
    if sp.kind == "kvtable":
        kv = arg[0] if kind == "idx" else arg
        kl = coerce(_lift(kv, fr), sp.elem, fr)
        kw, vw = sp.elem.width, sp.val.width
        rows = bnp.asarray(_slots_matrix(f.lanes, 1, sp.cap, kw + vw))
        match = bnp.all(rows[:, :kw] == bnp.asarray(kl.lanes)[None, :],
                        axis=1)
        # old value: the matching row's value lanes (or zeros)
        mpos = bnp.argmax(match)
        old = SymV(sp.val, rows[mpos, kw:])
        new = coerce(_lift(_apply_rest(old, path[1:], rhs_eval, fr), fr),
                     sp.val, fr)
        newvals = bnp.where(match[:, None],
                            bnp.asarray(_as_seg(new.lanes, vw))[None, :],
                            rows[:, kw:])
        out = bnp.concatenate([rows[:, :kw], newvals], axis=1)
        lanes = bnp.concatenate([bnp.reshape(f.lanes[0], (1,)).astype(
            bnp.int32), out.reshape(-1)])
        return SymV(sp, lanes)
    if sp.kind == "pfcn":
        kv = arg[0] if kind == "idx" else arg
        if isinstance(kv, SymV) and not kv.static and kind == "idx":
            # traced key: guarded per-key segments, concatenated once
            segs = []
            off = 0
            for dk, es in zip(sp.dom, sp.elems):
                cond = as_bool(mk_bool(sym_eq(
                    kv, static_to_symv(dk, fr.kc), fr)), fr)
                old = SymV(es, f.lanes[off + 1:off + 1 + es.width])
                new = coerce(_lift(_apply_rest(old, path[1:], rhs_eval,
                                               fr), fr), es, fr)
                pres = _ite(cond, 1, f.lanes[off])
                sel = _select_lanes(cond, new.lanes,
                                    f.lanes[off + 1:off + 1 + es.width])
                segs.append(_as_lane_arr(pres))
                segs.append(_as_seg(sel, es.width))
                off += 1 + es.width
            return SymV(sp, _cat(segs))
        key = _static_key_value(kv, fr) if kind == "idx" else arg
        off = 0
        for dk, es in zip(sp.dom, sp.elems):
            if _keys_equal(dk, key):
                old = SymV(es, f.lanes[off + 1:off + 1 + es.width])
                new = coerce(_lift(_apply_rest(old, path[1:], rhs_eval,
                                               fr), fr), es, fr)
                return SymV(sp, _splice(
                    f.lanes, off, 1 + es.width,
                    _cat([np.asarray([1], np.int32),
                          _as_seg(new.lanes, es.width)])))
            off += 1 + es.width
        raise CompileError(f"EXCEPT key {key!r} outside pfcn universe")
    raise CompileError(f"EXCEPT on {sp.kind}")


def _apply_rest(old: SymV, rest, rhs_eval, fr: Frame):
    if not rest:
        return rhs_eval(old)
    return sym_except(old, rest, rhs_eval, fr)


def kv_merge_insert(f: SymV, key: SymV, val: SymV, fr: Frame) -> SymV:
    """f @@ (key :> val): insert if key absent (f wins on overlap),
    keeping the table sorted by key lanes — vectorized."""
    sp = f.spec
    kl = coerce(key, sp.elem, fr)
    vl = coerce(val, sp.val, fr)
    kw, vw = sp.elem.width, sp.val.width
    cnt = f.lanes[0]
    rows = bnp.asarray(_slots_matrix(f.lanes, 1, sp.cap, kw + vw))
    keys = rows[:, :kw]
    xl = bnp.asarray(_as_seg(kl.lanes, kw))
    used = bnp.arange(sp.cap) < cnt
    if kw == 0:
        present = cnt > 0 if isinstance(cnt, int) else bnp.asarray(cnt) > 0
    else:
        present = bnp.any(bnp.all(keys == xl[None, :], axis=1) & used)
    lt = _rows_lex_lt(keys, xl)
    pos = bnp.sum(used & lt)
    fr.flag_overflow(bnp.logical_and(bnp.logical_not(present),
                                     _ge_lane(cnt, sp.cap)))
    newrow = bnp.concatenate([xl, bnp.asarray(_as_seg(vl.lanes, vw))])
    idx = bnp.arange(sp.cap)
    prev = bnp.concatenate([bnp.zeros((1, kw + vw), bnp.int32), rows[:-1]])
    ins = bnp.where((idx < pos)[:, None], rows,
                    bnp.where((idx == pos)[:, None], newrow[None, :], prev))
    out = bnp.where(present, rows, ins)
    newcnt = bnp.where(present, cnt, cnt + 1)
    lanes = bnp.concatenate([bnp.reshape(newcnt, (1,)).astype(bnp.int32),
                             out.reshape(-1)])
    return SymV(sp, lanes)


def kv_domain_slots(f: SymV):
    """(used_guard, key SymV, val SymV) per slot of a kvtable."""
    sp = f.spec
    kw, vw = sp.elem.width, sp.val.width
    cnt = f.lanes[0]
    for s in range(sp.cap):
        base = 1 + s * (kw + vw)
        used = _lt_lane(s, cnt)
        yield used, SymV(sp.elem, f.lanes[base:base + kw]), \
            SymV(sp.val, f.lanes[base + kw:base + kw + vw])


# ---------------------------------------------------------------------------
# the expression evaluator
# ---------------------------------------------------------------------------

_ARITH = {"+", "-", "*", "\\div", "%", "^"}
_CMP = {"<", ">", "<=", ">=", "=<", "\\leq", "\\geq"}

# action-kernel overflow codes (the `ov` output of CompiledAction2.fn):
# 0 = none; OV_CAPACITY = a value outgrew its lanes (fix: raise caps);
# OV_PACK = a value escaped its packed lane's profiled bit range (fix:
# deepen sampling or JAXMC_PACK=0 — raised by the ENGINES' pack step,
# compile/pack.py, never by a kernel);
# OV_DEMOTED = an `except CompileError` recovery fired (fix: the hybrid
# engine demotes the arm to the interpreter and restarts)
OV_CAPACITY = 1
OV_DEMOTED = 2
OV_PACK = 3


class Elems:
    """A set given extensionally as guarded symbolic elements — the result
    of {e : x \\in S} (SetMap) before it lands in a union/membership."""
    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items  # list of (guard, SymV | static)


_IDENT_NAMES_CACHE: Dict[int, Tuple[Any, frozenset]] = {}


def _ident_names(e) -> frozenset:
    """Every name under e that a symbolic evaluation may look up in
    fr.bound: Ident names, OpApp operator names (LET-bound operators
    resolve through bound), and "@" for EXCEPT's A.At. A cheap
    over-approximation of the free variables, memoized by node identity
    — the node object is pinned in the cache value so ids cannot be
    recycled. The cache is size-capped: a long-lived process sweeping
    many models must not pin every AST it ever compiled."""
    hit = _IDENT_NAMES_CACHE.get(id(e))
    if hit is not None and hit[0] is e:
        return hit[1]
    out = set()

    def walk(x):
        if isinstance(x, A.Ident):
            out.add(x.name)
        elif isinstance(x, A.OpApp):
            out.add(x.name)
        elif isinstance(x, A.At):
            out.add("@")
        if isinstance(x, A.Node):
            for fname in getattr(x, "__dataclass_fields__", {}):
                walk(getattr(x, fname))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(e)
    ns = frozenset(out)
    if len(_IDENT_NAMES_CACHE) > 400_000:
        _IDENT_NAMES_CACHE.clear()
    _IDENT_NAMES_CACHE[id(e)] = (e, ns)
    return ns


_MEMO_TYPES = (A.OpApp, A.Quant, A.Let, A.If, A.Choose, A.Dot,
               A.FnApp, A.SetFilter, A.SetMap)
_CASE_CHAIN_CACHE: Dict[int, Tuple[Any, Any]] = {}
_MISS = object()


def sym_eval2(e: A.Node, fr: Frame):
    memo = fr.memo
    # memoize only under a statically-True guard: in strict frames a
    # statically-False guard SUPPRESSES the CompileError that
    # flag_overflow/flag_demoted would raise, so a recovery value cached
    # in a guarded-out context must never replay into a live one
    if memo is not None and fr.guard is True \
            and isinstance(e, _MEMO_TYPES):
        # the key covers (expr id, bound-value ids) but NOT fr.state or
        # fr.primes — sound only because memos are created fresh per
        # compile_predicate2 trace, where state is a single fixed tuple
        # and primes stays empty. Fail loudly if a future caller ever
        # hands a memo to action frames whose primes mutate mid-trace
        assert not fr.primes, \
            "sym_eval2 memo used in a frame with primes (stale replay)"
        names = _ident_names(e)
        bound = fr.bound
        rel = tuple(sorted((n, id(bound[n]))
                           for n in names if n in bound))
        key = (id(e), rel)
        hit = memo.get(key, _MISS)
        if hit is not _MISS:
            return hit[1]
        r = _sym_eval2_inner(e, fr)
        # the entry PINS the bound values: their ids appear in the key,
        # so they must stay alive as long as the entry does (CPython id
        # recycling would otherwise alias a later binding to this one)
        memo[key] = (tuple(bound[n] for n in names if n in bound), r)
        return r
    return _sym_eval2_inner(e, fr)


def _sym_eval2_inner(e: A.Node, fr: Frame):
    t = type(e)
    kc = fr.kc
    if t is A.Num:
        return mk_int(e.val)
    if t is A.Bool:
        return SymV(BOOL, [e.val])
    if t is A.Str:
        if e.val in kc.uni.to_idx:
            return SymV(ENUM, [kc.uni.index(e.val)])
        return e.val
    if t is A.Ident:
        name = e.name
        if name in fr.bound:
            v = fr.bound[name]
            if isinstance(v, tuple) and v:
                if v[0] == "$letexpr":
                    return sym_eval2(v[1], fr)
                if v[0] == "$slot":
                    raise CompileError("unresolved dynamic-set binding")
                if v[0] == "$op":
                    raise CompileError(f"operator {name} used as value")
            return v
        if name in fr.state:
            return fr.state[name]
        if kc.const_lanes and name in kc.const_lanes:
            # lifted CONSTANT: a traced per-model lane, not
            # the baked concrete value
            return mk_int(kc.const_lanes[name])
        d = kc.model.defs.get(name)
        if isinstance(d, OpClosure):
            if d.params:
                raise CompileError(f"operator {name} used as a value")
            if isinstance(d.body, A.FnConstrDef):
                raise CompileError("recursive functions not compilable")
            return sym_eval2(d.body, fr)
        if d is None:
            raise CompileError(f"unknown identifier {name}")
        return _static_const(d, fr)
    if t is A.Prime:
        if not isinstance(e.expr, A.Ident):
            raise CompileError("primed non-variable")
        nm = e.expr.name
        if nm not in fr.primes:
            raise CompileError(f"{nm}' read before assignment")
        return fr.primes[nm]
    if t is A.OpApp:
        return _sym_opapp2(e, fr)
    if t is A.FnApp:
        f = sym_eval2(e.fn, fr)
        args = [sym_eval2(a, fr) for a in e.args]
        return sym_apply(f, args, fr)
    if t is A.Dot:
        return sym_dot(sym_eval2(e.expr, fr), e.fld, fr)
    if t is A.If:
        c = as_bool(sym_eval2(e.cond, fr), fr)
        if isinstance(c, bool):
            return sym_eval2(e.then if c else e.els, fr)
        # traced condition: if one branch is uncompilable (e.g. applies an
        # always-empty function), keep the other and flag overflow when the
        # failing branch would have been taken — exactness preserved
        try:
            a = sym_eval2(e.then, fr)
        except UnrollLimitError:
            raise
        except CompileError as ex:
            fr.flag_demoted(c, why=str(ex))
            return sym_eval2(e.els, fr)
        try:
            b = sym_eval2(e.els, fr)
        except UnrollLimitError:
            raise
        except CompileError as ex:
            fr.flag_demoted(_lnot(c), why=str(ex))
            return a
        return _merge_values(c, a, b, fr)
    if t is A.Case:
        # cache the If-chain rewrite per Case node: fresh allocations on
        # every evaluation would defeat the memo (new ids each time) and
        # churn _IDENT_NAMES_CACHE with one-shot pinned entries
        hit = _CASE_CHAIN_CACHE.get(id(e))
        if hit is not None and hit[0] is e:
            node = hit[1]
        else:
            node = None
            for g, b in reversed(e.arms):
                if node is None:
                    node = A.If(g, b, e.other) if e.other is not None \
                        else b
                else:
                    node = A.If(g, b, node)
            # capped like _IDENT_NAMES_CACHE: a long-lived process
            # sweeping many models must not pin every Case AST forever
            if len(_CASE_CHAIN_CACHE) > 100_000:
                _CASE_CHAIN_CACHE.clear()
            _CASE_CHAIN_CACHE[id(e)] = (e, node)
        return sym_eval2(node, fr)
    if t is A.TupleExpr:
        items = [sym_eval2(x, fr) for x in e.items]
        return _tuple_symv(items, fr)
    if t is A.SetEnum:
        items = [sym_eval2(x, fr) for x in e.items]
        conc = _try_concrete(items, fr)
        if conc is not None:
            return frozenset(conc)
        return Elems([(True, x) for x in items])
    if t is A.RecordExpr:
        fields = sorted(((k, sym_eval2(v, fr)) for k, v in e.fields),
                        key=lambda kv: kv[0])
        lanes: List = []
        specs = []
        for k, v in fields:
            sv = _lift(v, fr)
            specs.append(sv.spec)
            lanes.extend(sv.lanes)
        return SymV(VS("fcn", dom=tuple(k for k, _ in fields),
                       elems=tuple(specs)), lanes)
    if t is A.Except:
        f = _lift(sym_eval2(e.fn, fr), fr)
        for path, rhs in e.updates:
            epath = []
            for k, arg in path:
                if k == "idx":
                    epath.append(("idx", [sym_eval2(a, fr) for a in arg]))
                else:
                    epath.append(("dot", arg))

            def rhs_eval(old, rhs=rhs):
                return sym_eval2(rhs, fr.with_bound({"@": old}))
            f = sym_except(f, epath, rhs_eval, fr)
        return f
    if t is A.At:
        if "@" not in fr.bound:
            raise CompileError("@ outside EXCEPT")
        return fr.bound["@"]
    if t is A.FnDef:
        return _sym_fndef(e, fr)
    if t is A.SetFilter:
        return _sym_setfilter(e, fr)
    if t is A.SetMap:
        return _sym_setmap(e, fr)
    if t is A.Quant:
        acc = True if e.kind == "A" else False
        for b in _binder_combos(e.binders, fr):
            guard, bound = b
            v = as_bool(sym_eval2(
                e.body, fr.with_bound(bound).with_guard(guard)), fr)
            if e.kind == "A":
                acc = _land(acc, _lor(_lnot(guard), v))
            else:
                acc = _lor(acc, _land(guard, v))
        return mk_bool(acc)
    if t is A.Choose:
        return _sym_choose(e, fr)
    if t is A.Let:
        defs = {}
        frame = fr
        for d in e.defs:
            if isinstance(d, A.OpDef) and not d.params:
                defs[d.name] = sym_eval2(d.body, frame.with_bound(defs))
            elif isinstance(d, A.OpDef):
                defs[d.name] = ("$op", d, dict(defs))
            else:
                raise CompileError("unsupported LET body in compiled expr")
        return sym_eval2(e.body, fr.with_bound(defs))
    if t is A.RecordSet:
        # [a: S, b: T] — static record sets materialize like SUBSET
        from ..sem.values import mk_record
        fields = []
        for k, sexpr in e.fields:
            sval = sym_eval2(sexpr, fr)
            if not isinstance(sval, frozenset):
                raise CompileError("record set over symbolic field set")
            fields.append((k, sorted(sval, key=sort_key)))
        out = []
        for combo in itertools.product(*[vs for _, vs in fields]):
            out.append(mk_record({k: v for (k, _), v
                                  in zip(fields, combo)}))
        return frozenset(out)
    if t is A.FnSet:
        dom = sym_eval2(e.dom, fr)
        rng = sym_eval2(e.rng, fr)
        if isinstance(dom, frozenset) and isinstance(rng, frozenset):
            from ..sem.values import FcnSetV
            return frozenset(FcnSetV(dom, rng).materialize())
        raise CompileError("function set over symbolic operands")
    if t is A.Unchanged:
        raise CompileError("UNCHANGED in expression position")
    raise CompileError(f"cannot compile {t.__name__}")


def _static_const(d, fr: Frame):
    """A cfg-bound constant or plain value from the defs table."""
    if isinstance(d, (int, bool, str, ModelValue, frozenset, Fcn)):
        if isinstance(d, (frozenset, Fcn)) or isinstance(d, InfiniteSet):
            return d
        return _lift(d, fr)
    if isinstance(d, InfiniteSet):
        return d
    raise CompileError(f"cannot compile constant {d!r}")


def _tuple_symv(items, fr: Frame) -> SymV:
    espec = None
    lifted = []
    hetero = False
    for x in items:
        sv = _lift(x, fr)
        lifted.append(sv)
        try:
            espec = sv.spec if espec is None else vs_merge(espec, sv.spec)
        except CompileError:
            hetero = True
    if espec is None and not hetero:
        return SymV(VS("justempty"), [])
    if hetero:
        # heterogeneous tuple: fixed int-keyed record
        return SymV(VS("fcn", dom=tuple(range(1, len(lifted) + 1)),
                       elems=tuple(sv.spec for sv in lifted)),
                    _cat([_as_seg(sv.lanes, sv.spec.width)
                          for sv in lifted]))
    from .vspec import apply_bounds
    espec = apply_bounds(espec, fr.kc.bounds)
    n = len(lifted)
    lanes = [n]
    for sv in lifted:
        lanes.extend(coerce(sv, espec, fr).lanes)
    cap = max(n, 1)
    return SymV(VS("seq", cap=cap, elem=espec), lanes)


def _merge_values(c, a, b, fr: Frame):
    if isinstance(a, Elems) or isinstance(b, Elems):
        raise CompileError("IF over extensional sets")
    if not isinstance(a, SymV) and not isinstance(b, SymV) \
            and isinstance(a, frozenset) and isinstance(b, frozenset):
        a = _to_mask_set(a, fr) if a or b else a
        if isinstance(a, frozenset):
            return a  # both empty
        b = _to_mask_set(b, fr)
    a = _lift(a, fr)
    b = _lift(b, fr)
    a, b = unify(a, b, fr)
    return SymV(a.spec, _select_lanes(c, a.lanes, b.lanes))


def _binder_combos(binders, fr: Frame):
    """Yield (guard, bound-dict) combinations for quantifier binders."""
    groups = []
    for names, sexpr in binders:
        if sexpr is None:
            raise CompileError(UNBOUNDED_QUANTIFIER_MSG)
        sval = sym_eval2(sexpr, fr)
        elems = list(_elements(sval, fr))
        for pat in names:
            groups.append((pat, elems))
    for combo in itertools.product(*[g[1] for g in groups]):
        guard = True
        bound = {}
        for (pat, _), (g, v) in zip(groups, combo):
            guard = _land(guard, g)
            if isinstance(pat, tuple):
                if isinstance(v, SymV):
                    if v.spec.kind != "seq" or len(pat) > v.spec.cap:
                        raise CompileError("cannot destructure value")
                    for i, nm in enumerate(pat):
                        bound[nm] = SymV(v.spec.elem, _seq_elem(v, i))
                else:
                    bound.update(bind_pattern(pat, v))
            else:
                bound[pat] = v
        yield guard, bound


def _elements(sval, fr: Frame):
    if isinstance(sval, Elems):
        for g, v in sval.items:
            yield g, v
        return
    yield from set_elements(sval, fr)


def _sym_fndef(e: A.FnDef, fr: Frame) -> SymV:
    if len(e.binders) != 1 or len(e.binders[0][0]) != 1:
        raise CompileError("multi-binder function constructor")
    pat, sexpr = e.binders[0][0][0], e.binders[0][1]
    sval = sym_eval2(sexpr, fr)
    if isinstance(sval, frozenset) and not sval:
        # [j \in {} |-> ...] — voterLog resets, raft.tla:190
        return SymV(VS("justempty"), [])
    if isinstance(sval, frozenset):
        keys = sorted(sval, key=sort_key)
        vals = []
        specs = []
        for k in keys:
            b = bind_pattern(pat, k) if isinstance(pat, tuple) else {pat: k}
            b = {nm: (_lift(v, fr) if not isinstance(v, (frozenset, Fcn))
                      else v) for nm, v in b.items()}
            v = _lift(sym_eval2(e.body, fr.with_bound(b)), fr)
            vals.append(v)
            specs.append(v.spec)
        if all(isinstance(k, int) for k in keys) \
                and list(keys) == list(range(1, len(keys) + 1)):
            espec = specs[0]
            for s in specs[1:]:
                espec = vs_merge(espec, s)
            from .vspec import apply_bounds
            espec = apply_bounds(espec, fr.kc.bounds)
            lanes = [len(keys)]
            for v in vals:
                lanes.extend(coerce(v, espec, fr).lanes)
            return SymV(VS("seq", cap=len(keys), elem=espec), lanes)
        lanes = []
        for v in vals:
            lanes.extend(v.lanes)
        return SymV(VS("fcn", dom=tuple(keys), elems=tuple(specs)), lanes)
    if isinstance(sval, SymV) and sval.spec.kind == "iset":
        # [j \in 1..newCommitIndex |-> log[i][j]] -> a sequence
        members = sval.spec.dom
        ints = [m for m in members if isinstance(m, int) and m >= 1]
        vals = []
        length = 0
        for m in sorted(ints):
            idx = members.index(m)
            g = sval.lanes[idx]
            gb = g if isinstance(g, bool) else _eq_lane(g, 1)
            b = {pat: mk_int(m)}
            try:
                v = _lift(sym_eval2(e.body,
                                    fr.with_bound(b).with_guard(gb)), fr)
            except UnrollLimitError:
                raise
            except CompileError as ex:
                # body uncompilable for this universe member (q[j+1] past
                # the sequence capacity for dead j): zeros, and abort the
                # run if the member is ever actually in the set
                fr.flag_demoted(gb, why=str(ex))
                if vals:
                    v = SymV(vals[0][1].spec, _zeros(vals[0][1].spec.width))
                else:
                    continue
            vals.append((gb, v))
            length = length + (_ite(gb, 1, 0) if not isinstance(gb, bool)
                               else (1 if gb else 0))
        if not vals:
            raise CompileError("empty iset function constructor")
        espec = vals[0][1].spec
        for _, v in vals[1:]:
            espec = vs_merge(espec, v.spec)
        from .vspec import apply_bounds
        espec = apply_bounds(espec, fr.kc.bounds)
        lanes = [length]
        # contiguity: iset from 1..k is a prefix, so position = value - 1
        for gb, v in vals:
            cv = coerce(v, espec, fr)
            lanes.extend(_select_lanes(gb, cv.lanes, [0] * espec.width))
        return SymV(VS("seq", cap=len(vals), elem=espec), lanes)
    raise CompileError("function constructor over non-static domain")


def _sym_setfilter(e: A.SetFilter, fr: Frame):
    sval = sym_eval2(e.set, fr)
    if isinstance(sval, frozenset):
        # static domain, possibly symbolic predicate -> mask set
        members = sorted(sval, key=sort_key)
        all_static = True
        lanes = []
        kept = []
        for m in members:
            b = bind_pattern(e.var, m) if isinstance(e.var, tuple) \
                else {e.var: m}
            b = {nm: (_lift(v, fr) if not isinstance(v, (frozenset, Fcn))
                      else v) for nm, v in b.items()}
            p = as_bool(sym_eval2(e.pred, fr.with_bound(b)), fr)
            if isinstance(p, bool):
                if p:
                    kept.append(m)
                lanes.append(1 if p else 0)
            else:
                all_static = False
                lanes.append(_ite(p, 1, 0))
        if all_static:
            return frozenset(kept)
        if all(isinstance(m, (str, ModelValue)) for m in members):
            return SymV(VS("set", dom=tuple(members)), lanes)
        if all(isinstance(m, int) for m in members):
            return SymV(VS("iset", dom=tuple(members)), lanes)
        raise CompileError("symbolic filter over heterogeneous set")
    if isinstance(sval, SymV) and sval.spec.kind in ("set", "iset"):
        lanes = []
        for i, m in enumerate(sval.spec.dom):
            b = {e.var: _lift(m, fr) if not isinstance(m, (frozenset, Fcn))
                 else m} if not isinstance(e.var, tuple) else None
            if b is None:
                raise CompileError("pattern filter over mask set")
            p = as_bool(sym_eval2(e.pred, fr.with_bound(b)), fr)
            memb = sval.lanes[i]
            mb = memb if isinstance(memb, bool) else _eq_lane(memb, 1)
            both = _land(mb, p)
            lanes.append(_ite(both, 1, 0) if not isinstance(both, bool)
                         else (1 if both else 0))
        return SymV(sval.spec, lanes)
    if isinstance(sval, Elems) or (isinstance(sval, SymV)
                                   and sval.spec.kind == "growset"):
        out = []
        for g, v in _elements(sval, fr):
            b = {e.var: v}
            p = as_bool(sym_eval2(e.pred, fr.with_bound(b)), fr)
            out.append((_land(g, p), v))
        return Elems(out)
    raise CompileError("unsupported set filter")


def _sym_setmap(e: A.SetMap, fr: Frame):
    out = []
    for guard, bound in _binder_combos(e.binders, fr):
        v = sym_eval2(e.expr, fr.with_bound(bound).with_guard(guard))
        out.append((guard, v))
    if all(g is True for g, _ in out):
        conc = _try_concrete([v for _, v in out], fr)
        if conc is not None:
            return frozenset(conc)
    return Elems(out)


def _try_concrete(items, fr: Frame):
    """If every item is static, give back concrete python values."""
    conc = []
    for x in items:
        if isinstance(x, SymV):
            if not x.static:
                return None
            conc.append(_decode_static(x, fr))
        elif isinstance(x, Elems):
            return None
        else:
            conc.append(x)
    return conc


def _sym_choose(e: A.Choose, fr: Frame):
    """CHOOSE x \\in S : P. Static sets resolve statically; the Min/Max
    idiom (raft.tla:151-154) over symbolic int sets compiles to masked
    min/max."""
    if e.set is None:
        raise CompileError("unbounded CHOOSE")
    sval = sym_eval2(e.set, fr)
    if isinstance(sval, frozenset):
        for m in sorted(sval, key=sort_key):
            b = bind_pattern(e.var, m) if isinstance(e.var, tuple) \
                else {e.var: m}
            b = {nm: (_lift(v, fr) if not isinstance(v, (frozenset, Fcn))
                      else v) for nm, v in b.items()}
            p = as_bool(sym_eval2(e.pred, fr.with_bound(b)), fr)
            if not isinstance(p, bool):
                raise CompileError("CHOOSE with traced predicate over "
                                   "static set")
            if p:
                return _lift(m, fr) if not isinstance(m, (frozenset, Fcn)) \
                    else m
        raise CompileError(f"CHOOSE: no witness in static set {sval!r} (var {e.var}, pred {e.pred})")
    mode = _minmax_pattern(e)
    if mode and isinstance(sval, Elems):
        # Min({Len(log[i]), nextIndex[i][j]}) — fold over guarded items
        # (raft.tla:229)
        best = None
        for g, v in sval.items:
            x = as_int_lane(_lift(v, fr))
            masked = _ite(as_bool(mk_bool(g), fr) if not isinstance(g, bool)
                          else g, x, -10**6 if mode == "max" else 10**6)
            if best is None:
                best = masked
            else:
                best = bnp.maximum(best, masked) if mode == "max" \
                    else bnp.minimum(best, masked)
        if best is None:
            raise CompileError("CHOOSE over empty extensional set")
        return mk_int(best)
    if mode and isinstance(sval, SymV) and sval.spec.kind == "iset":
        # masked min/max over the int universe; value is unspecified when
        # the set is empty (the spec guards emptiness, as TLC does lazily)
        best = None
        for i, m in enumerate(sval.spec.dom):
            memb = sval.lanes[i]
            mb = memb if isinstance(memb, bool) else _eq_lane(memb, 1)
            if best is None:
                best = _ite(mb, m, -10**6 if mode == "max" else 10**6)
            else:
                cand = _ite(mb, m, -10**6 if mode == "max" else 10**6)
                best = bnp.maximum(best, cand) if mode == "max" \
                    else bnp.minimum(best, cand)
        return mk_int(best)
    raise CompileError("CHOOSE over symbolic set (not a Min/Max pattern)")


def _minmax_pattern(e: A.Choose) -> Optional[str]:
    """Min(s): CHOOSE x \\in s : \\A y \\in s : x <= y (raft.tla:151-154)."""
    p = e.pred
    if not (isinstance(p, A.Quant) and p.kind == "A" and len(p.binders) == 1
            and isinstance(p.body, A.OpApp)):
        return None
    op = p.body.name
    if op in ("<=", "=<", "\\leq"):
        return "min"
    if op in (">=", "\\geq"):
        return "max"
    return None


def _sym_opapp2(e: A.OpApp, fr: Frame):
    name = e.name
    kc = fr.kc
    if e.path:
        raise CompileError("instance paths not compilable yet")
    if name == "/\\":
        # lazy like TLC: a statically-false left guard protects the right
        # (IF agreeIndexes /= {} /\ log[i][Max(agreeIndexes)]...,
        # raft.tla:288-295); with a TRACED guard, an uncompilable right
        # side is recovered by flagging overflow where it would be needed
        a = as_bool(sym_eval2(e.args[0], fr), fr)
        if a is False:
            return mk_bool(False)
        try:
            b = as_bool(sym_eval2(e.args[1], fr), fr)
        except UnrollLimitError:
            raise
        except CompileError as ex:
            if a is True:
                raise
            fr.flag_demoted(a, why=str(ex))
            return mk_bool(False)
        return mk_bool(_land(a, b))
    if name == "\\/":
        a = as_bool(sym_eval2(e.args[0], fr), fr)
        if a is True:
            return mk_bool(True)
        try:
            b = as_bool(sym_eval2(e.args[1], fr), fr)
        except UnrollLimitError:
            raise
        except CompileError as ex:
            if a is False:
                raise
            fr.flag_demoted(_lnot(a), why=str(ex))
            return mk_bool(a)
        return mk_bool(_lor(a, b))
    if name == "~":
        return mk_bool(_lnot(as_bool(sym_eval2(e.args[0], fr), fr)))
    if name == "=>":
        a = as_bool(sym_eval2(e.args[0], fr), fr)
        if a is False:
            return mk_bool(True)
        return mk_bool(_lor(_lnot(a),
                            as_bool(sym_eval2(e.args[1], fr), fr)))
    if name in ("<=>", "\\equiv"):
        a = as_bool(sym_eval2(e.args[0], fr), fr)
        b = as_bool(sym_eval2(e.args[1], fr), fr)
        if isinstance(a, bool) and isinstance(b, bool):
            return mk_bool(a == b)
        return mk_bool(bnp.equal(a, b))
    if name in ("=", "/=", "#"):
        a = sym_eval2(e.args[0], fr)
        b = sym_eval2(e.args[1], fr)
        r = _generic_eq(a, b, fr)
        return mk_bool(r if name == "=" else _lnot(r))
    if name in ("\\in", "\\notin"):
        x = sym_eval2(e.args[0], fr)
        s = sym_eval2(e.args[1], fr)
        r = _generic_in(x, s, fr)
        return mk_bool(r if name == "\\in" else _lnot(r))
    if name in _ARITH:
        a = as_int_lane(sym_eval2(e.args[0], fr))
        b = as_int_lane(sym_eval2(e.args[1], fr))
        if isinstance(a, int) and isinstance(b, int):
            return mk_int({"+": a + b, "-": a - b, "*": a * b,
                           "\\div": a // b if b else 0,
                           "%": a % b if b else 0,
                           "^": a ** b}[name])
        ops = {"+": bnp.add, "-": bnp.subtract, "*": bnp.multiply,
               "\\div": bnp.floor_divide, "%": bnp.mod,
               "^": bnp.power}
        return mk_int(ops[name](a, b))
    if name in _CMP:
        a = as_int_lane(sym_eval2(e.args[0], fr))
        b = as_int_lane(sym_eval2(e.args[1], fr))
        if isinstance(a, int) and isinstance(b, int):
            return mk_bool({"<": a < b, ">": a > b}.get(
                name, a <= b if name in ("<=", "=<", "\\leq") else a >= b))
        ops = {"<": bnp.less, ">": bnp.greater}
        f = ops.get(name, bnp.less_equal if name in ("<=", "=<", "\\leq")
                    else bnp.greater_equal)
        return mk_bool(f(a, b))
    if name == "-.":
        a = as_int_lane(sym_eval2(e.args[0], fr))
        return mk_int(-a if isinstance(a, int) else bnp.negative(a))
    if name == "..":
        a = sym_eval2(e.args[0], fr)
        b = sym_eval2(e.args[1], fr)
        al, bl = as_int_lane(a), as_int_lane(b)
        if isinstance(al, int) and isinstance(bl, int):
            return frozenset(range(al, bl + 1))
        return interval_iset(al, bl, fr)
    if name in ("\\cup", "\\union"):
        return set_union(sym_eval2(e.args[0], fr),
                         sym_eval2(e.args[1], fr), fr)
    if name in ("\\cap", "\\intersect", "\\"):
        a = sym_eval2(e.args[0], fr)
        b = sym_eval2(e.args[1], fr)
        if isinstance(a, frozenset) and isinstance(b, frozenset):
            return a & b if name != "\\" else a - b
        ma, mb = _to_mask_set(a, fr), _to_mask_set(b, fr)
        ma, mb = unify(ma, mb, fr)
        out = []
        for x, y in zip(ma.lanes, mb.lanes):
            xb = x if isinstance(x, bool) else _eq_lane(x, 1)
            yb = y if isinstance(y, bool) else _eq_lane(y, 1)
            r = _land(xb, yb) if name != "\\" else _land(xb, _lnot(yb))
            out.append(_ite(r, 1, 0) if not isinstance(r, bool)
                       else (1 if r else 0))
        return SymV(ma.spec, out)
    if name == "\\subseteq":
        a = sym_eval2(e.args[0], fr)
        b = sym_eval2(e.args[1], fr)
        acc = True
        for g, m in _elements(a, fr):
            inn = _generic_in(m, b, fr)
            acc = _land(acc, _lor(_lnot(g), inn))
        return mk_bool(acc)
    if name == "Cardinality":
        s = sym_eval2(e.args[0], fr)
        if isinstance(s, frozenset):
            return mk_int(len(s))
        n = 0
        for g, _ in _elements(s, fr):
            n = n + (_ite(g, 1, 0) if not isinstance(g, bool)
                     else (1 if g else 0))
        return mk_int(n)
    if name == "SUBSET":
        s = sym_eval2(e.args[0], fr)
        if isinstance(s, frozenset):
            out = []
            ms = sorted(s, key=sort_key)
            for r in range(len(ms) + 1):
                for c in itertools.combinations(ms, r):
                    out.append(frozenset(c))
            return frozenset(out)
        raise CompileError(SUBSET_SYMBOLIC_MSG)
    if name == "UNION":
        s = sym_eval2(e.args[0], fr)
        if isinstance(s, frozenset):
            out = frozenset()
            for m in s:
                out = out | m
            return out
        raise CompileError("UNION of symbolic set")
    if name == "DOMAIN":
        f = sym_eval2(e.args[0], fr)
        if isinstance(f, Fcn):
            return f.domain()
        if isinstance(f, SymV):
            sp = f.spec
            if sp.kind == "fcn":
                return frozenset(sp.dom)
            if sp.kind == "seq":
                return interval_iset(mk_int(1), seq_len(f), fr)
            if sp.kind == "kvtable":
                return Elems([(g, k) for g, k, _ in kv_domain_slots(f)])
            if sp.kind == "pfcn":
                lanes = []
                off = 0
                for dk, es in zip(sp.dom, sp.elems):
                    lanes.append(f.lanes[off])
                    off += 1 + es.width
                if all(isinstance(m, (str, ModelValue)) for m in sp.dom):
                    return SymV(VS("set", dom=sp.dom), lanes)
                return SymV(VS("iset", dom=sp.dom), lanes)
        raise CompileError("DOMAIN of non-function")
    if name == "Len":
        return seq_len(_lift(sym_eval2(e.args[0], fr), fr))
    if name == "Append":
        return seq_append(_lift(sym_eval2(e.args[0], fr), fr),
                          sym_eval2(e.args[1], fr), fr)
    if name == "SubSeq":
        return seq_subseq(_lift(sym_eval2(e.args[0], fr), fr),
                          sym_eval2(e.args[1], fr),
                          sym_eval2(e.args[2], fr), fr)
    if name in ("\\o", "\\circ"):
        return seq_concat(_lift(sym_eval2(e.args[0], fr), fr),
                          _lift(sym_eval2(e.args[1], fr), fr), fr)
    if name == "Head":
        return sym_apply(_lift(sym_eval2(e.args[0], fr), fr), [mk_int(1)],
                         fr)
    if name == "Tail":
        v = _lift(sym_eval2(e.args[0], fr), fr)
        if v.spec.kind != "seq":
            raise CompileError("Tail of non-sequence")
        # the interpreter raises on Tail(<<>>); a reachable empty-Tail is
        # a spec error, so the overflow flag aborts equivalently
        fr.flag_overflow(_eq_lane(v.lanes[0], 0))
        return seq_subseq(v, mk_int(2), seq_len(v), fr)
    if name == ":>":
        k = _lift(sym_eval2(e.args[0], fr), fr)
        v = _lift(sym_eval2(e.args[1], fr), fr)
        return ("$single", k, v)
    if name == "@@":
        f = sym_eval2(e.args[0], fr)
        g = sym_eval2(e.args[1], fr)
        if isinstance(g, tuple) and g and g[0] == "$single":
            f = _lift(f, fr)
            if f.spec.kind == "kvtable":
                return kv_merge_insert(f, g[1], g[2], fr)
            if f.spec.kind == "pfcn":
                def same(old):
                    return g[2]
                return sym_except(f, [("idx", [g[1]])], lambda old: g[2],
                                  fr)
        raise CompileError("@@ outside table-insert idiom")
    if name in ("\\X", "\\times"):
        args = [sym_eval2(a, fr) for a in e.args]
        if all(isinstance(a, frozenset) for a in args):
            from ..sem.values import mk_seq as _mkseq
            out = []
            for combo in itertools.product(
                    *[sorted(a, key=sort_key) for a in args]):
                out.append(_mkseq(list(combo)))
            return frozenset(out)
        raise CompileError("cartesian product over symbolic sets")
    if name == "Seq":
        sv = sym_eval2(e.args[0], fr)
        if isinstance(sv, frozenset):
            return InfiniteSet("Seq", sv)
        raise CompileError("Seq over symbolic set")
    if name == "Assert":
        raise CompileError("Assert in expression position")
    if name == "!sel":
        base, num = e.args
        if isinstance(base, A.Ident):
            d = kc.model.defs.get(base.name)
            if isinstance(d, OpClosure):
                conjs = _flatten_conj(d.body)
                if 1 <= num.val <= len(conjs):
                    return sym_eval2(conjs[num.val - 1], fr)
        raise CompileError("!sel not resolvable")
    # user-defined operators
    d = fr.bound.get(name)
    if d is None:
        d = kc.model.defs.get(name)
    if isinstance(d, tuple) and d and d[0] == "$op":
        od, captured = d[1], d[2]
        args = [sym_eval2(a, fr) for a in e.args]
        with _op_unroll(kc, name):
            return sym_eval2(od.body, fr.with_bound(
                {**captured, **dict(zip(od.params, args))}))
    if isinstance(d, OpClosure):
        args = [sym_eval2(a, fr) for a in e.args]
        with _op_unroll(kc, name):
            return sym_eval2(d.body,
                             fr.with_bound(dict(zip(d.params, args))))
    if d is not None and not e.args:
        if kc.const_lanes and name in kc.const_lanes:
            return mk_int(kc.const_lanes[name])  # lifted CONSTANT
        if isinstance(d, (SymV, frozenset, Fcn, Elems)):
            return d
        return _static_const(d, fr)
    raise CompileError(f"cannot compile operator {name}")


class UnrollLimitError(CompileError):
    """A RECURSIVE operator exceeded the compile-time unroll limit.
    Deliberately NON-RECOVERABLE: the `except CompileError` recovery
    sites re-raise it, because recovering would retry the sibling
    branch of every unroll frame — exponential recursion (Fib) would
    turn one failed trace into ~2^limit recovery attempts.  The arm (or
    predicate) demotes whole, with the operator's name in the reason."""


# shared demotion-reason wording: jaxmc/analyze/verdicts.py
# predicts these demotions BEFORE any build, and the predicted verdict
# must carry the exact string the build-time path reports — both sides
# read the one constant, so the wording cannot diverge
SUBSET_SYMBOLIC_MSG = "SUBSET of symbolic set"

# taxonomy additions: a quantifier with no domain at all, and
# a quantifier/enumeration over an infinite constant set (Nat, Int,
# STRING, Seq(S)) — both certain demotions the predictor can name
# before any build
UNBOUNDED_QUANTIFIER_MSG = "unbounded quantifier"


def cannot_enumerate_message(sv) -> str:
    return f"cannot enumerate {sv!r}"


def unroll_limit_message(name: str, limit: int) -> str:
    return (f"recursive operator {name} exceeds the compile-time "
            f"unroll limit ({limit}; raise with JAXMC_OP_UNROLL_LIMIT) "
            f"— its expansion diverges on symbolic arguments")


class _op_unroll:
    """Same-name re-entry counter around user-operator expansion: trips
    BEFORE Python's recursion limit so a diverging RECURSIVE operator
    demotes with its NAME in the CompileError (the per-arm demotion
    reason table) instead of an anonymous RecursionError."""
    __slots__ = ("kc", "name")

    def __init__(self, kc: KernelCtx, name: str):
        self.kc = kc
        self.name = name
        depth = kc.op_depth.get(name, 0)
        if depth >= kc.op_unroll_limit:
            raise UnrollLimitError(
                unroll_limit_message(name, kc.op_unroll_limit))
        kc.op_depth[name] = depth + 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kc.op_depth[self.name] -= 1
        return False


def _flatten_conj(e):
    if isinstance(e, A.OpApp) and e.name == "/\\":
        return _flatten_conj(e.args[0]) + _flatten_conj(e.args[1])
    return [e]


def _generic_eq(a, b, fr: Frame):
    if isinstance(a, Elems) or isinstance(b, Elems):
        raise CompileError("equality over extensional sets")
    if not isinstance(a, SymV) and not isinstance(b, SymV):
        try:
            return tla_eq(a, b)
        except EvalError as ex:
            raise CompileError(str(ex))
    if isinstance(a, frozenset) or isinstance(b, frozenset):
        # set vs symbolic set: subset both ways
        st = a if isinstance(a, frozenset) else b
        sy = b if isinstance(a, frozenset) else a
        if isinstance(sy, SymV) and sy.spec.kind in ("set", "iset"):
            acc = True
            for i, m in enumerate(sy.spec.dom):
                memb = sy.lanes[i]
                mb = memb if isinstance(memb, bool) else _eq_lane(memb, 1)
                want = in_set(m, st)
                acc = _land(acc, mb if want else _lnot(mb))
            extra = st - frozenset(sy.spec.dom)
            if extra:
                return False
            return acc
        if isinstance(sy, SymV) and sy.spec.kind == "growset":
            return sym_eq(sy, static_to_symv(st, fr.kc, sy.spec), fr)
        raise CompileError("set equality with unsupported operand")
    a = _lift(a, fr)
    b = _lift(b, fr)
    return sym_eq(a, b, fr)


def _generic_in(x, s, fr: Frame):
    if isinstance(s, Elems):
        acc = False
        for g, v in s.items:
            acc = _lor(acc, _land(g, _generic_eq(x, v, fr)))
        return acc
    return sym_in(x, s, fr)


# ---------------------------------------------------------------------------
# layout + action compilation
# ---------------------------------------------------------------------------

class Layout2:
    """vspec-based state layout (replaces compile.ground.StateLayout).

    Carries the bit-packed LanePlan (compile/pack.py) alongside the
    unpacked lane specs: kernels compute on unpacked lanes, while the
    engines store frontier/seen/trace rows packed.  A Layout2 built
    outside build_layout2 (tests) lazily defaults to the identity plan
    (packed == unpacked)."""

    def __init__(self, vars: Tuple[str, ...], specs: Dict[str, VS],
                 uni: EnumUniverse):
        self.vars = vars
        self.specs = specs
        self.uni = uni
        self.width = sum(specs[v].width for v in vars)
        self.offsets = {}
        off = 0
        for v in vars:
            self.offsets[v] = off
            off += specs[v].width
        self._plan = None

    @property
    def plan(self):
        if self._plan is None:
            from .pack import identity_plan
            self._plan = identity_plan(self.width)
        return self._plan

    @plan.setter
    def plan(self, p):
        self._plan = p

    @property
    def packed_width(self) -> int:
        return self.plan.packed_width

    def encode(self, state: Dict[str, Any]):
        import numpy as np
        out: List[int] = []
        for v in self.vars:
            vs_encode(state[v], self.specs[v], self.uni, out)
        return np.asarray(out, dtype=np.int32)

    def decode(self, row) -> Dict[str, Any]:
        from .vspec import decode as vs_decode
        st = {}
        i = 0
        for v in self.vars:
            st[v], i = vs_decode(row, i, self.specs[v], self.uni)
        return st

    # ---- packed-row boundary helpers (engine storage format) ----

    def pack_np(self, rows):
        import numpy as np
        rows = np.asarray(rows, np.int32)
        if rows.ndim == 1:
            return self.plan.pack_np(rows[None, :])[0]
        return self.plan.pack_np(rows)

    def unpack_np(self, packed):
        import numpy as np
        packed = np.asarray(packed, np.int32)
        if packed.ndim == 1:
            return self.plan.unpack_np(packed[None, :])[0]
        return self.plan.unpack_np(packed)

    def encode_packed(self, state: Dict[str, Any]):
        return self.pack_np(self.encode(state))

    def decode_packed(self, packed_row) -> Dict[str, Any]:
        return self.decode(self.unpack_np(packed_row))


def build_layout2(model: Model, sampled_states: List[Dict[str, Any]],
                  bounds: Bounds,
                  static_bounds: Optional[Dict[str, Tuple[int, int]]]
                  = None) -> Layout2:
    from .vspec import (apply_bounds, collect_enums_from_value, infer)
    from .. import obs
    uni = EnumUniverse()
    # enum universe: every sampled value + every string literal in the
    # module AST + cfg model values (guards may compare against literals
    # no sampled state contains)
    for st in sampled_states:
        for v in st.values():
            collect_enums_from_value(v, uni)
    for d in model.defs.values():
        if not isinstance(d, OpClosure):
            collect_enums_from_value(d, uni)
    _collect_ast_strings(model, uni)
    specs: Dict[str, VS] = {}
    for var in model.vars:
        sp = None
        for st in sampled_states:
            s2 = infer(st[var], uni)
            sp = s2 if sp is None else vs_merge(sp, s2)
        specs[var] = apply_bounds(sp, bounds)
    lay = Layout2(tuple(model.vars), specs, uni)
    # bit-packed lane plan: structural bounds + observed int
    # ranges over the encoded sample rows decide per-lane bit widths
    from .pack import build_lane_plan
    sample_rows = []
    for st in sampled_states:
        try:
            sample_rows.append(lay.encode(st))
        except (CompileError, EvalError):
            # a sampled state the merged layout cannot encode would have
            # failed the search anyway; the plan just profiles without it
            continue
    lay.plan = build_lane_plan(lay, sample_rows, static_bounds)
    tel = obs.current()
    tel.gauge("layout.enum_universe", len(uni.values))
    tel.gauge("layout.samples", len(sampled_states))
    tel.gauge("layout.packed_width_lanes", lay.plan.packed_width)
    tel.gauge("layout.bits_per_state", lay.plan.bits_per_state)
    tel.gauge("layout.pack_ratio",
              round(lay.plan.packed_width / max(lay.width, 1), 4))
    tel.gauge("layout.pack_guarded_lanes", lay.plan.guarded_lanes)
    # statically-proven int lanes: previously observed-range
    # guarded lanes whose width now comes from the bounds analyzer —
    # read against layout.pack_guarded_lanes (the two are disjoint)
    tel.gauge("analyze.proven_lanes", lay.plan.proven_lanes)
    return lay


def _collect_ast_strings(model: Model, uni: EnumUniverse):
    def walk(e):
        if isinstance(e, A.Str):
            uni.add(e.val)
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Node):
                walk(v)
            elif isinstance(v, tuple):
                _walk_tuple(v)

    def _walk_tuple(t):
        for x in t:
            if isinstance(x, A.Node):
                walk(x)
            elif isinstance(x, tuple):
                _walk_tuple(x)

    for d in model.defs.values():
        if isinstance(d, OpClosure) and isinstance(d.body, A.Node):
            walk(d.body)


@dataclass
class CompiledAction2:
    label: str
    fn: Callable  # (rows[N, W][, slot]) -> (en[N], aok[N], ov[N], succ[N, W])
    n_slots: int = 0  # >0: fn takes a slot index (Python int) in [0, n_slots)
    # guard conjuncts the compiler DEMOTED (recovered as `False` +
    # runtime overflow flag) during tracing: a kernel with demoted
    # guards under-approximates the transition relation behind an abort
    # guard — the hybrid engine prefers to fall the whole arm back to
    # the interpreter instead (filled in at trace time, so only
    # populated after the fn has been evaluated once, as the engine's
    # build-time check does)
    demoted_guards: list = field(default_factory=list)


def _slotv_markers(ga) -> dict:
    """The distinct $slotv binder markers in a grounded action, keyed by
    identity (a binder's marker tuple is shared by reference across items),
    each mapped to one bound_env it appears in (for slot-count probing)."""
    markers = {}
    for item in ga.items:
        _, bound_env = item
        for v in bound_env.values():
            if isinstance(v, tuple) and len(v) == 2 and v[0] == "$slotv":
                markers[id(v)] = (v, bound_env)
    return markers


def _probe_slot_count(kc: KernelCtx, sexpr: A.Node, bound_env) -> int:
    """Structural slot count of a dynamic \\E set: evaluate the set
    expression over a one-row block and count its element slots —
    the same enumeration _slot_bind_traced performs inside the kernel, so
    the count is exact per action instead of the global kv_cap ceiling."""
    layout = kc.layout
    clean = {k: v for k, v in bound_env.items()
             if not (isinstance(v, tuple) and len(v) == 2
                     and v[0] == "$slotv")}
    row = bnp.BL(_zero_rows(layout.width))
    state = {}
    off = 0
    for v in layout.vars:
        sp = layout.specs[v]
        state[v] = SymV(sp, row[off:off + sp.width])
        off += sp.width
    fr = Frame(kc, _lift_bound(clean, kc), state, {}, [False])
    sval = sym_eval2(sexpr, fr)
    return len(list(_elements(sval, fr)))


def _zero_rows(width: int):
    import torch
    return torch.zeros((1, width), dtype=torch.int32)


def compile_action2(kc: KernelCtx, ga) -> CompiledAction2:
    layout = kc.layout
    vars = layout.vars
    markers = _slotv_markers(ga)
    if len(markers) > 1:
        # every $slotv resolves through the ONE traced slot index, so two
        # distinct dynamic binders (nested or /\-conjoined sibling \E)
        # would only explore equal-index pairs — reject rather than
        # silently drop off-diagonal transitions (ground.py catches the
        # nested form early; this catches the rest)
        raise CompileError(
            f"action {ga.label}: multiple dynamic \\E binders not "
            f"supported (one slot axis per action)")
    slotted = bool(markers)
    n_slots = 0
    if slotted:
        (marker, benv), = markers.values()
        try:
            n_slots = _probe_slot_count(kc, marker[1], benv)
        except Exception as ex:
            # an unsized slot axis could silently drop transitions —
            # reject (interp backend still checks the model)
            raise CompileError(
                f"action {ga.label}: cannot size the dynamic \\E slot "
                f"axis ({ex})") from ex
        if n_slots == 0:
            # structurally empty dynamic set: the action can never fire
            n_slots = 1  # keep one (always-disabled) instance

    demoted_guards: List[str] = []

    def fn(rows, slot=None):
        with bnp.on_device(rows.device):
            return _action_body(rows, slot)

    def _action_body(rows, slot):
        n = rows.shape[0]
        row = bnp.BL(rows)
        state = {}
        off = 0
        for v in vars:
            sp = layout.specs[v]
            state[v] = SymV(sp, row[off:off + sp.width])
            off += sp.width
        primes: Dict[str, SymV] = {}
        # THREE overflow cells:
        #   succ_ovf  — successor-VALUE capacity overflows: only matter
        #               on taken transitions, masked by the final `en`;
        #   guard_ovf — capacity overflows inside GUARD evaluation: the
        #               guard's value may be wrong whenever they fire, so
        #               they are NEVER masked by `en` (en itself may be
        #               the wrong value — the round-3 MCPaxos bug);
        #   demo      — `except CompileError` recovery flags (demoted
        #               conjuncts, IF/SetMap/lazy-conj recoveries, prime
        #               RHS recovery): compiler limitations the hybrid
        #               engine fixes by demoting the arm to the
        #               interpreter and restarting — reported as overflow
        #               code 2 so the engine can tell them from genuine
        #               capacity overflows (code 1, fix = raise caps).
        succ_ovf = [False]
        guard_ovf = [False]
        demo = [False]
        enabled = True
        assert_ok = True

        for item in ga.items:
            if isinstance(item, tuple) and len(item) == 2 \
                    and isinstance(item[0], A.Node):
                expr, bound_env = item
            else:
                raise CompileError(f"bad grounded item {item!r}")
            # TLC evaluates conjuncts left-to-right: an error (here, a
            # recovery overflow) in conjunct j only surfaces when the
            # conjuncts before it hold — thread enabled-so-far as the
            # frame guard so recovery flags inside this item are masked
            # by the prior conjuncts, exactly TLC's laziness
            fr = Frame(kc, _lift_bound(bound_env, kc), state, primes,
                       guard_ovf, guard=enabled, demo=demo)
            # dynamic-\E slot binding guards (traced slot index)
            slot_guards = []
            bound2 = dict(fr.bound)
            for nm, bv in list(bound2.items()):
                if isinstance(bv, tuple) and len(bv) == 2 \
                        and bv[0] == "$slotv":
                    g, val = _slot_bind_traced(bv[1], slot, fr, n_slots)
                    slot_guards.append(g)
                    bound2[nm] = val
            if slot_guards:
                for g in slot_guards:
                    enabled = _land(enabled, g)
                fr = Frame(kc, bound2, state, primes, guard_ovf,
                           guard=enabled, demo=demo)

            tgt = _prime_target2(expr, vars)
            if tgt is not None:
                var, rhs = tgt
                frv = Frame(kc, fr.bound, state, primes, succ_ovf,
                            guard=enabled, demo=demo)
                try:
                    val = _lift(sym_eval2(rhs, frv), frv)
                    val = coerce(val, layout.specs[var], frv)
                except UnrollLimitError:
                    raise
                except CompileError as ex:
                    if enabled is True:
                        raise
                    # uncompilable only along paths the guards exclude:
                    # demotion-abort if the action is ever enabled
                    frv.flag_demoted(enabled, why=str(ex))
                    val = SymV(layout.specs[var],
                               [0] * layout.specs[var].width)
                if var in primes:
                    enabled = _land(enabled, sym_eq(primes[var], val, fr))
                else:
                    primes[var] = val
                continue
            if isinstance(expr, A.Unchanged):
                _unchanged2(expr.expr, kc, state, primes, vars)
                continue
            if isinstance(expr, A.OpApp) and expr.name == "Assert":
                cond = as_bool(sym_eval2(expr.args[0], fr), fr)
                if cond is not True:
                    bad = _land(enabled, _lnot(cond))
                    assert_ok = _land(assert_ok, _lnot(bad))
                continue
            try:
                g = as_bool(sym_eval2(expr, fr), fr)
            except UnrollLimitError:
                raise
            except CompileError as gex:
                if enabled is True:
                    raise
                # demoted conjunct: False + abort-if-reached, recorded so
                # the hybrid engine can prefer interp enumeration of the
                # whole arm over an abort-guarded under-approximation
                fr.flag_demoted(enabled, why=str(gex))
                if not any(r == str(gex) for r in demoted_guards):
                    demoted_guards.append(str(gex))
                g = False
            enabled = _land(enabled, g)

        missing = [v for v in vars if v not in primes]
        if missing:
            raise CompileError(f"action {ga.label} leaves {missing} "
                               f"unassigned")
        succ = bnp.concatenate(
            [bnp.asarray(primes[v].lanes, dtype=bnp.int32)
             for v in vars]) if vars else bnp.zeros(0)
        en = enabled if _is_traced(enabled) else bnp.asarray(bool(enabled))
        ak = assert_ok if _is_traced(assert_ok) \
            else bnp.asarray(bool(assert_ok))
        sov = succ_ovf[0] if _is_traced(succ_ovf[0]) \
            else bnp.asarray(bool(succ_ovf[0]))
        gov = guard_ovf[0] if _is_traced(guard_ovf[0]) \
            else bnp.asarray(bool(guard_ovf[0]))
        dmo = demo[0] if _is_traced(demo[0]) \
            else bnp.asarray(bool(demo[0]))
        if demo[0] is not False and \
                "expression recovery engaged" not in demoted_guards:
            # structural marker, set at evaluation time: the hybrid
            # engine only restart-demotes arms whose kernels CAN demote
            demoted_guards.append("expression recovery engaged")
        # successor-value capacity overflow only matters on taken
        # transitions; guard capacity overflow always aborts; demotion
        # flags win the code so the engine can demote-and-restart
        cap = bnp.logical_or(bnp.logical_and(en, sov), gov)
        ov = bnp.where(dmo, OV_DEMOTED,
                       bnp.where(cap, OV_CAPACITY, 0)).astype(bnp.int32)
        en, ak, ov, succ = (bnp.rows_of(en, n), bnp.rows_of(ak, n),
                            bnp.rows_of(ov, n), bnp.rows_of(succ, n))
        return en, ak, ov, succ

    from .. import obs
    obs.current().counter("compile.kernels_built")
    if slotted:
        obs.current().counter("compile.slotted_instances", n_slots)
        return CompiledAction2(ga.label, fn, n_slots=n_slots,
                               demoted_guards=demoted_guards)
    return CompiledAction2(ga.label, lambda rows: fn(rows, None),
                           demoted_guards=demoted_guards)


def _lift_bound(bound_env: Dict[str, Any], kc: KernelCtx) -> Dict[str, Any]:
    out = {}
    for k, v in bound_env.items():
        if isinstance(v, (frozenset, Fcn, InfiniteSet)) or \
                (isinstance(v, tuple) and v and v[0] == "$slot"):
            out[k] = v
        elif isinstance(v, (int, bool, str, ModelValue)):
            if isinstance(v, bool):
                out[k] = SymV(BOOL, [v])
            elif isinstance(v, int):
                out[k] = SymV(INT, [v])
            else:
                out[k] = SymV(ENUM, [kc.uni.index(v)])
        else:
            out[k] = v
    return out


def _slot_bind_traced(setexpr: A.Node, slot: int, fr: Frame, n_slots: int):
    """Bind the slot-th element of a dynamic set.  The slot index is a
    Python int (the engine loops over the static n_slots), so this picks
    the slot's guarded element directly where the reference selected it
    with a traced index; slots past the set's potential elements are
    disabled."""
    sval = sym_eval2(setexpr, fr)
    items = list(_elements(sval, fr))
    if len(items) > n_slots:
        # the engine only expands n_slots slot indices (probed by
        # _probe_slot_count from this same enumeration) — a divergence
        # here would silently drop the elements beyond the probe
        raise CompileError(
            f"dynamic \\E set has {len(items)} potential elements but "
            f"the probed slot axis has {n_slots}")
    if not items:
        return False, None
    first = items[0][1]
    if not isinstance(first, SymV):
        first = _lift(first, fr)
    spec = first.spec
    # every item is coerced (its capacity flags fire whichever slot is
    # bound), the guard stays a traced value as in the reference, and a
    # slot past the items binds the last item, disabled
    mats = []
    for g, v in items:
        sv = v if isinstance(v, SymV) else _lift(v, fr)
        mats.append(coerce(sv, spec, fr))
    safe = min(max(slot, 0), len(items) - 1)
    g = items[safe][0] if slot < len(items) else False
    return bnp.asarray(g) if not _is_traced(g) else g, mats[safe]


def _prime_target2(e: A.Node, vars):
    if isinstance(e, A.OpApp) and e.name == "=" and \
            isinstance(e.args[0], A.Prime) and \
            isinstance(e.args[0].expr, A.Ident) and \
            e.args[0].expr.name in vars:
        return e.args[0].expr.name, e.args[1]
    return None


def _unchanged2(e: A.Node, kc: KernelCtx, state, primes, vars):
    if isinstance(e, A.Ident):
        if e.name in vars:
            if e.name not in primes:
                primes[e.name] = state[e.name]
            return
        d = kc.model.defs.get(e.name)
        if isinstance(d, OpClosure) and not d.params:
            _unchanged2(d.body, kc, state, primes, vars)
            return
        raise CompileError(f"UNCHANGED of non-variable {e.name}")
    if isinstance(e, A.TupleExpr):
        for x in e.items:
            _unchanged2(x, kc, state, primes, vars)
        return
    raise CompileError(f"unsupported UNCHANGED {e!r}")


def compile_value2(kc: KernelCtx, expr: A.Node) -> Callable:
    """Compile an expression to its encoded VALUE lanes: fn(rows[N, W])
    -> [N, w] i32 lane tensor.  Used for cfg VIEW in the reference
.  Strict frame like predicates: an uncompilable view
    raises CompileError when first evaluated."""
    layout = kc.layout

    def fn(rows):
        with bnp.on_device(rows.device):
            row = bnp.BL(rows)
            state = {}
            off = 0
            for v in layout.vars:
                sp = layout.specs[v]
                state[v] = SymV(sp, row[off:off + sp.width])
                off += sp.width
            fr = Frame(kc, {}, state, {}, [False], strict=True, memo={})
            val = _lift(sym_eval2(expr, fr), fr)
            # a row-independent view (constant value) is still a valid
            # partition — every state shares one key
            return bnp.rows_of(bnp.asarray(val.lanes, bnp.int32),
                               rows.shape[0])

    return fn


def compile_predicate2(kc: KernelCtx, expr: A.Node) -> Callable:
    """fn(rows[N, W]) -> [N] bool tensor."""
    layout = kc.layout

    def fn(rows):
        with bnp.on_device(rows.device):
            row = bnp.BL(rows)
            state = {}
            off = 0
            for v in layout.vars:
                sp = layout.specs[v]
                state[v] = SymV(sp, row[off:off + sp.width])
                off += sp.width
            fr = Frame(kc, {}, state, {}, [False], strict=True, memo={})
            r = as_bool(sym_eval2(expr, fr), fr)
            r = r if _is_traced(r) else bnp.asarray(bool(r))
            return bnp.rows_of(r, rows.shape[0])

    return fn
