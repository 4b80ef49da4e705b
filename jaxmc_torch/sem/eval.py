r"""Reference evaluator for TLA+ expressions.

Slow, exact Python semantics — oracle #2 next to TLC (SURVEY.md §7.2) and the
fallback executor for constructs the TPU kernel compiler rejects. Evaluates
constant/state/action-level expressions; state enumeration (Init/Next walking)
lives in sem/enumerate.py and reuses this evaluator for guards and RHSs.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..front import tla_ast as A
from .values import (EvalError, Fcn, FcnSetV, ModelValue,
                     enumerate_set, fmt, in_set, mk_record, mk_seq,
                     tla_eq, check_set_mix)


class TLCAssertFailure(EvalError):
    """Raised by Assert(FALSE, msg) — surfaces as a violation with trace."""

    def __init__(self, msg):
        super().__init__(msg)
        self.out = msg


@dataclass
class OpClosure:
    """A (possibly parameterless) definition together with its captured
    binding environment (LET bodies close over bound vars)."""
    name: str
    params: Tuple[str, ...]
    body: A.Node
    bound: Dict[str, Any] = field(default_factory=dict)
    defs: Optional[Dict[str, Any]] = None  # module defs snapshot (instances)
    # True only for module-level definitions built once per loaded module
    # (Loader.build) — the closures eligible for memoization (sem/memo.py)
    stable: bool = field(default=False, compare=False)


@dataclass
class BuiltinOp:
    """A standard-module operator passed as a value (higher-order use,
    e.g. SelectSeq(s, SomeBuiltin)). fn takes (args, ctx)."""
    name: str
    fn: Callable


class Ctx:
    """Evaluation context: definition table, bound variables, state."""
    __slots__ = ("defs", "bound", "state", "primes", "vars", "on_print",
                 "memo")

    def __init__(self, defs, bound=None, state=None, primes=None, vars=(),
                 on_print=None, memo=None):
        self.defs = defs          # name -> OpClosure | BuiltinOp | value
        self.bound = bound or {}  # name -> value (quantifier/param bindings)
        self.state = state        # name -> value, None outside behaviors
        self.primes = primes      # name -> value (partial during enumeration)
        self.vars = vars          # declared VARIABLE names
        self.on_print = on_print  # callback for TLC Print
        self.memo = memo          # per-model MemoStore (sem/memo.py) or None

    def with_bound(self, extra: Dict[str, Any]) -> "Ctx":
        c = Ctx(self.defs, {**self.bound, **extra}, self.state, self.primes,
                self.vars, self.on_print, self.memo)
        return c

    def with_defs(self, extra: Dict[str, Any]) -> "Ctx":
        c = Ctx({**self.defs, **extra}, self.bound, self.state, self.primes,
                self.vars, self.on_print, self.memo)
        return c


class UnassignedPrime(EvalError):
    def __init__(self, var):
        super().__init__(f"primed variable {var}' read before assignment")
        self.var = var


class RecFcn(Fcn):
    """Lazily-evaluated recursive function constructor f[x \\in S] == body
    (e.g. vmem, tla-rust examples/SpecifyingSystems/CachingMemory/
    WriteThroughCache.tla:54-61). Entries are memoized on demand so the
    recursion terminates; equality/hash force full evaluation."""
    __slots__ = ("_dom_list", "_fn", "_forced", "_inprog")

    def __init__(self, dom_list, fn):
        super().__init__({})
        self._dom_list = dom_list
        self._fn = fn
        self._forced = False
        self._inprog = set()

    def apply(self, arg):
        if arg in self._d:
            return self._d[arg]
        if not any(tla_eq(arg, k) for k in self._dom_list):
            raise EvalError(f"recursive function applied outside domain: "
                            f"{fmt(arg)}")
        karg = arg
        if karg in self._inprog:
            raise EvalError("recursive function definition does not terminate")
        self._inprog.add(karg)
        try:
            v = self._fn(arg)
        finally:
            self._inprog.discard(karg)
        self._d[karg] = v
        return v

    def _force_all(self):
        if not self._forced:
            for k in self._dom_list:
                self.apply(k)
            self._forced = True
            self._hash = None

    def _materialized_items(self):
        self._force_all()
        return self._d.items()

    def domain(self):
        return frozenset(self._dom_list)

    def __len__(self):
        return len(self._dom_list)

    def __eq__(self, other):
        if not isinstance(other, Fcn):
            return NotImplemented
        self._force_all()
        if isinstance(other, RecFcn):
            other._force_all()
        return self._d == other._d

    def __hash__(self):
        self._force_all()
        return hash(frozenset(self._d.items()))

    def is_seq(self):
        self._force_all()
        return super().is_seq()

    def is_record(self):
        self._force_all()
        return super().is_record()

    def as_list(self):
        self._force_all()
        return super().as_list()

    @property
    def d(self):
        self._force_all()
        return self._d


def _bool(v, what="expression"):
    if isinstance(v, bool):
        return v
    raise EvalError(f"{what} evaluated to non-boolean {fmt(v)}")


def bind_pattern(pat, value) -> Dict[str, Any]:
    """Bind a binder name or tuple pattern <<a, b>> against a value."""
    if isinstance(pat, str):
        return {pat: value}
    if not isinstance(value, Fcn) or not (len(value) == 0 or value.is_seq()) \
            or len(value) != len(pat):
        raise EvalError(f"cannot destructure {fmt(value)} as <<{', '.join(pat)}>>")
    return dict(zip(pat, value.as_list()))


def iter_binders(binders, ctx, ev) -> "itertools.product":
    """Yield bound-dicts for quantifier/setmap/fndef binder lists.
    Each binder: ((name_or_pat, ...), set_expr)."""
    groups = []
    for names, sexpr in binders:
        if sexpr is None:
            raise EvalError("unbounded quantifier not supported")
        sval = ev(sexpr, ctx)
        elems = enumerate_set(sval)
        for pat in names:
            groups.append((pat, elems))
    keys = [g[0] for g in groups]
    for combo in itertools.product(*[g[1] for g in groups]):
        b: Dict[str, Any] = {}
        for pat, v in zip(keys, combo):
            b.update(bind_pattern(pat, v))
        yield b


# ---------------------------------------------------------------------------

def eval_expr(e: A.Node, ctx: Ctx) -> Any:
    t = type(e)
    fn = _DISPATCH.get(t)
    if fn is None:
        raise EvalError(f"cannot evaluate {t.__name__} node: {e!r}")
    return fn(e, ctx)


def _ev_num(e, ctx):
    return e.val


def _ev_str(e, ctx):
    return e.val


def _ev_bool(e, ctx):
    return e.val


# stdlib/memo are import cycles with this module; resolve them once on
# first use instead of re-running the import machinery on the hot path
# (the `from .stdlib import BUILTIN_OPS` in _resolve showed up as ~250k
# importlib calls per 40k generated states)
_BUILTIN_OPS = None
_memo_key = None


def _get_builtin_ops():
    global _BUILTIN_OPS
    if _BUILTIN_OPS is None:
        from .stdlib import BUILTIN_OPS
        _BUILTIN_OPS = BUILTIN_OPS
    return _BUILTIN_OPS


def _get_memo_key():
    global _memo_key
    if _memo_key is None:
        from .memo import memo_key
        _memo_key = memo_key
    return _memo_key


def _resolve(name: str, ctx: Ctx):
    if name in ctx.bound:
        return ctx.bound[name]
    if ctx.state is not None and name in ctx.vars:
        if name not in ctx.state:
            raise EvalError(f"variable {name} unassigned")
        return ctx.state[name]
    if name in ctx.defs:
        return ctx.defs[name]
    ops = _BUILTIN_OPS if _BUILTIN_OPS is not None else _get_builtin_ops()
    if name in ops:
        return BuiltinOp(name, ops[name])
    raise EvalError(f"unknown identifier {name}")


_MISS = object()


def _force(v, ctx, name=""):
    """Resolve a definition reference to a value (apply zero-arg closures)."""
    if isinstance(v, OpClosure):
        if v.params:
            return v  # operator value (can be passed higher-order)
        store = ctx.memo
        if store is not None and v.stable and not v.bound \
                and v.defs is None:
            memo_key = _memo_key if _memo_key is not None \
                else _get_memo_key()
            key = memo_key(store, v, ctx.defs, ctx)
            if key is not None:
                hit = store.vals.get(key, _MISS)
                if hit is not _MISS:
                    store.hits += 1
                    return hit
                store.misses += 1
                val = eval_expr(v.body, ctx)
                store.put(key, val)
                return val
        inner = ctx if v.defs is None else Ctx(v.defs, ctx.bound, ctx.state,
                                               ctx.primes, ctx.vars,
                                               ctx.on_print, ctx.memo)
        if v.bound:
            inner = inner.with_bound(v.bound)
        if isinstance(v.body, A.FnConstrDef):
            return _build_rec_fcn(v.body, inner)
        return eval_expr(v.body, inner)
    if isinstance(v, BuiltinOp):
        return v
    return v


def _build_rec_fcn(d: A.FnConstrDef, ctx: Ctx) -> "RecFcn":
    """Build the lazily-memoized function for f[x \\in S] == body."""
    if len(d.binders) != 1 or len(d.binders[0][0]) != 1:
        raise EvalError("recursive function constructors support a single "
                        "binder only")
    pat, sexpr = d.binders[0][0][0], d.binders[0][1]
    dom = enumerate_set(eval_expr(sexpr, ctx))
    holder = {}

    def compute(x):
        inner = ctx.with_defs({d.name: holder["rf"]})
        return eval_expr(d.body, inner.with_bound(bind_pattern(pat, x)))

    rf = RecFcn(dom, compute)
    holder["rf"] = rf
    return rf


def _ev_ident(e, ctx):
    return _force(_resolve(e.name, ctx), ctx, e.name)


def _ev_prime(e, ctx):
    if not isinstance(e.expr, A.Ident):
        # prime distributes over state expressions; evaluate in primed context
        if ctx.primes is None:
            raise EvalError("primed expression outside an action")
        sub = Ctx(ctx.defs, ctx.bound, ctx.primes, None, ctx.vars,
                  ctx.on_print, ctx.memo)
        return eval_expr(e.expr, sub)
    name = e.expr.name
    if ctx.primes is None:
        raise EvalError(f"{name}' used outside an action")
    if name in ctx.vars or name in ctx.primes:
        if name not in ctx.primes:
            raise UnassignedPrime(name)
        return ctx.primes[name]
    # primed DEFINITION (opId', InnerSerial.tla:6): evaluate its body with
    # the primed state as the state
    sub = Ctx(ctx.defs, ctx.bound, ctx.primes, None, ctx.vars, ctx.on_print,
              ctx.memo)
    return eval_expr(e.expr, sub)


def apply_op(opv, args: List[Any], ctx: Ctx):
    if isinstance(opv, BuiltinOp):
        return opv.fn(args, ctx)
    if isinstance(opv, OpClosure):
        if len(opv.params) != len(args):
            raise EvalError(f"{opv.name} expects {len(opv.params)} args, "
                            f"got {len(args)}")
        store = ctx.memo
        if store is not None and opv.stable and not opv.bound and args \
                and opv.defs is None:
            memo_key = _memo_key if _memo_key is not None \
                else _get_memo_key()
            key = memo_key(store, opv, ctx.defs, ctx, tuple(args))
            if key is not None:
                hit = store.vals.get(key, _MISS)
                if hit is not _MISS:
                    store.hits += 1
                    return hit
                store.misses += 1
                inner = ctx.with_bound(dict(zip(opv.params, args)))
                val = eval_expr(opv.body, inner)
                store.put(key, val)
                return val
        base = ctx if opv.defs is None else Ctx(opv.defs, ctx.bound, ctx.state,
                                                ctx.primes, ctx.vars,
                                                ctx.on_print, ctx.memo)
        inner = base.with_bound({**opv.bound, **dict(zip(opv.params, args))})
        return eval_expr(opv.body, inner)
    raise EvalError(f"value {fmt(opv)} is not an operator")


def _arg_value(a: A.Node, ctx: Ctx):
    """Evaluate an operator argument; a bare name referring to an operator
    definition passes the operator itself (higher-order TLA+)."""
    if isinstance(a, A.Ident):
        v = _resolve(a.name, ctx)
        if isinstance(v, OpClosure) and v.params:
            return v
        if isinstance(v, BuiltinOp):
            return v
        return _force(v, ctx, a.name)
    if isinstance(a, A.Lambda):
        return OpClosure("LAMBDA", a.params, a.body, dict(ctx.bound))
    return eval_expr(a, ctx)


def _flatten_junction(e: A.Node, op: str):
    if isinstance(e, A.OpApp) and e.name == op and len(e.args) == 2:
        return _flatten_junction(e.args[0], op) + _flatten_junction(e.args[1], op)
    return [e]


def _ev_opapp(e: A.OpApp, ctx: Ctx):
    name = e.name
    # instance path: resolve qualifier chain
    if e.path:
        return _eval_instance_path(e, ctx)
    if name == "!sel":
        # Inv!2 — second conjunct of Inv's definition (MCPaxos.tla:41-43)
        base, num = e.args
        if not isinstance(base, A.Ident):
            raise EvalError("!sel on non-identifier")
        d = _resolve(base.name, ctx)
        if not isinstance(d, OpClosure):
            raise EvalError(f"!sel target {base.name} is not a definition")
        conjs = _flatten_junction(d.body, "/\\")
        idx = num.val
        if not 1 <= idx <= len(conjs):
            raise EvalError(f"{base.name}!{idx} out of range")
        return eval_expr(conjs[idx - 1], ctx)

    # short-circuit logical forms first
    if name == "/\\":
        return _bool(eval_expr(e.args[0], ctx), "conjunct") and \
            _bool(eval_expr(e.args[1], ctx), "conjunct")
    if name == "\\/":
        return _bool(eval_expr(e.args[0], ctx), "disjunct") or \
            _bool(eval_expr(e.args[1], ctx), "disjunct")
    if name == "=>":
        return (not _bool(eval_expr(e.args[0], ctx))) or \
            _bool(eval_expr(e.args[1], ctx))
    if name in ("<=>", "\\equiv"):
        return _bool(eval_expr(e.args[0], ctx)) == _bool(eval_expr(e.args[1], ctx))
    if name == "~":
        return not _bool(eval_expr(e.args[0], ctx))
    if name == "=":
        return tla_eq(eval_expr(e.args[0], ctx), eval_expr(e.args[1], ctx))
    if name in ("/=", "#"):
        return not tla_eq(eval_expr(e.args[0], ctx), eval_expr(e.args[1], ctx))
    if name == "\\in":
        return in_set(eval_expr(e.args[0], ctx), eval_expr(e.args[1], ctx))
    if name == "\\notin":
        return not in_set(eval_expr(e.args[0], ctx), eval_expr(e.args[1], ctx))

    # user definitions shadow builtins (e.g. a module redefining \o)
    target = None
    if name in ctx.bound:
        target = ctx.bound[name]
    elif name in ctx.defs:
        target = ctx.defs[name]
    if target is not None and isinstance(target, (OpClosure, BuiltinOp)):
        args = [_arg_value(a, ctx) for a in e.args]
        return apply_op(target, args, ctx)
    if target is not None and not e.args:
        return _force(target, ctx, name)

    ops = _BUILTIN_OPS if _BUILTIN_OPS is not None else _get_builtin_ops()
    b = ops.get(name)
    if b is not None:
        args = [_arg_value(a, ctx) for a in e.args]
        return b(args, ctx)
    raise EvalError(f"unknown operator {name}")


def _eval_instance_path(e: A.OpApp, ctx: Ctx):
    """V!Op(args) — look up Op inside instance V's substituted namespace."""
    cur = ctx
    for inst_name, inst_args in e.path:
        inst = _resolve(inst_name, cur)
        from .modules import InstanceNamespace  # late import
        if isinstance(inst, OpClosure) and isinstance(inst.body, InstanceNamespace):
            ns = inst.body
        elif isinstance(inst, InstanceNamespace):
            ns = inst
        else:
            raise EvalError(f"{inst_name} is not an instance")
        argvals = [_arg_value(a, cur) for a in inst_args]
        cur = ns.enter(cur, argvals)
    inner = A.OpApp(e.name, e.args) if e.args else A.Ident(e.name)
    # evaluate the op inside the instance context, but with outer bound args
    return eval_expr(inner, cur)


def _ev_fnapp(e: A.FnApp, ctx: Ctx):
    f = eval_expr(e.fn, ctx)
    args = [eval_expr(a, ctx) for a in e.args]
    if isinstance(f, Fcn):
        if len(args) == 1:
            return f.apply(args[0])
        return f.apply(mk_seq(args))  # f[a, b] == f[<<a, b>>]
    if isinstance(f, (OpClosure, BuiltinOp)):
        return apply_op(f, args, ctx)
    raise EvalError(f"cannot apply non-function {fmt(f)}")


def _ev_dot(e: A.Dot, ctx: Ctx):
    r = eval_expr(e.expr, ctx)
    if isinstance(r, Fcn):
        return r.apply(e.fld)
    raise EvalError(f"field access .{e.fld} on non-record {fmt(r)}")


def _ev_tuple(e: A.TupleExpr, ctx: Ctx):
    return mk_seq([eval_expr(x, ctx) for x in e.items])


def _ev_setenum(e: A.SetEnum, ctx: Ctx):
    vals = [eval_expr(x, ctx) for x in e.items]
    # TLC comparability: {TRUE, 1} is an error, not a True==1 collapse
    check_set_mix(vals)
    return frozenset(vals)


def _ev_setfilter(e: A.SetFilter, ctx: Ctx):
    s = eval_expr(e.set, ctx)
    out = []
    for v in enumerate_set(s):
        b = bind_pattern(e.var, v)
        if _bool(eval_expr(e.pred, ctx.with_bound(b)), "set filter"):
            out.append(v)
    return frozenset(out)


def _ev_setmap(e: A.SetMap, ctx: Ctx):
    out = []
    for b in iter_binders(e.binders, ctx, eval_expr):
        out.append(eval_expr(e.expr, ctx.with_bound(b)))
    check_set_mix(out)
    return frozenset(out)


def _ev_fndef(e: A.FnDef, ctx: Ctx):
    # [x \in S, y \in T |-> body]: multi-binder functions take tuple args
    entries = {}
    binder_list = []
    for names, sexpr in e.binders:
        sval = eval_expr(sexpr, ctx)
        for pat in names:
            binder_list.append((pat, enumerate_set(sval)))
    single = len(binder_list) == 1
    for combo in itertools.product(*[els for _, els in binder_list]):
        b = {}
        for (pat, _), v in zip(binder_list, combo):
            b.update(bind_pattern(pat, v))
        key = combo[0] if single else mk_seq(combo)
        entries[key] = eval_expr(e.body, ctx.with_bound(b))
    return Fcn(entries)


def _ev_fnset(e: A.FnSet, ctx: Ctx):
    from .values import FcnSetV
    dom = eval_expr(e.dom, ctx)
    rng = eval_expr(e.rng, ctx)
    return FcnSetV(dom, rng)


def _ev_record(e: A.RecordExpr, ctx: Ctx):
    return mk_record({k: eval_expr(v, ctx) for k, v in e.fields})


def _ev_recordset(e: A.RecordSet, ctx: Ctx):
    keys = [k for k, _ in e.fields]
    sets = [enumerate_set(eval_expr(s, ctx)) for _, s in e.fields]
    out = []
    for combo in itertools.product(*sets):
        out.append(mk_record(dict(zip(keys, combo))))
    return frozenset(out)


def _except_update(val, path, rhs_expr, ctx):
    """Apply one EXCEPT update along path; @ refers to the old value."""
    if not path:
        old = val
        return eval_expr(rhs_expr, ctx.with_bound({"@": old}))
    kind, arg = path[0]
    if not isinstance(val, Fcn):
        raise EvalError(f"EXCEPT into non-function {fmt(val)}")
    if kind == "idx":
        keys = [eval_expr(a, ctx) for a in arg]
        key = keys[0] if len(keys) == 1 else mk_seq(keys)
    else:
        key = arg
    old = val.apply(key)
    new = _except_update(old, path[1:], rhs_expr, ctx)
    d = dict(val.d)
    d[key] = new
    return Fcn(d)


def _ev_except(e: A.Except, ctx: Ctx):
    val = eval_expr(e.fn, ctx)
    for path, rhs in e.updates:
        val = _except_update(val, list(path), rhs, ctx)
    return val


def _ev_at(e: A.At, ctx: Ctx):
    if "@" not in ctx.bound:
        raise EvalError("@ used outside EXCEPT")
    return ctx.bound["@"]


def _ev_if(e: A.If, ctx: Ctx):
    c = _bool(eval_expr(e.cond, ctx), "IF condition")
    return eval_expr(e.then if c else e.els, ctx)


def _ev_case(e: A.Case, ctx: Ctx):
    for g, b in e.arms:
        if _bool(eval_expr(g, ctx), "CASE guard"):
            return eval_expr(b, ctx)
    if e.other is not None:
        return eval_expr(e.other, ctx)
    raise EvalError("CASE: no guard matched and no OTHER")


def make_let_defs(defs, ctx: Ctx) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    bound_snapshot = dict(ctx.bound)
    for d in defs:
        if isinstance(d, A.OpDef):
            out[d.name] = OpClosure(d.name, d.params, d.body, bound_snapshot)
        elif isinstance(d, A.FnConstrDef):
            # f[x \in S] == body — possibly recursive; built lazily by _force
            out[d.name] = OpClosure(d.name, (), d, bound_snapshot)
        elif isinstance(d, A.RecursiveDecl):
            continue  # names become visible through the defs dict itself
        else:
            raise EvalError(f"unsupported LET definition {d!r}")
    return out


def _ev_let(e: A.Let, ctx: Ctx):
    new = make_let_defs(e.defs, ctx)
    inner = ctx.with_defs(new)
    # recursive LET defs must resolve through the extended table
    for v in new.values():
        if isinstance(v, OpClosure):
            v.defs = inner.defs
    return eval_expr(e.body, inner)


def _ev_quant(e: A.Quant, ctx: Ctx):
    if e.kind == "A":
        for b in iter_binders(e.binders, ctx, eval_expr):
            if not _bool(eval_expr(e.body, ctx.with_bound(b)), "\\A body"):
                return False
        return True
    for b in iter_binders(e.binders, ctx, eval_expr):
        if _bool(eval_expr(e.body, ctx.with_bound(b)), "\\E body"):
            return True
    return False


_FRESH_CHOOSE: Dict[A.Node, ModelValue] = {}


def _ev_choose(e: A.Choose, ctx: Ctx):
    if e.set is None:
        # TLC's special case: CHOOSE x : x \notin S evaluates to an
        # arbitrary value outside S — a fresh model value, deterministic
        # per CHOOSE expression (textbookSnapshotIsolation.tla:32 NoLock,
        # InnerSerial.tla:9 InitWr). Anything else unbounded is rejected,
        # as in TLC.
        if isinstance(e.pred, A.OpApp) and e.pred.name == "\\notin" \
                and isinstance(e.pred.args[0], A.Ident) \
                and isinstance(e.var, str) \
                and e.pred.args[0].name == e.var:
            mv = _FRESH_CHOOSE.get(e)
            if mv is None:
                import hashlib
                tag = hashlib.md5(repr(e).encode()).hexdigest()[:8]
                mv = ModelValue(f"$fresh_{tag}")
                _FRESH_CHOOSE[e] = mv
            return mv
        raise EvalError("unbounded CHOOSE not supported (except the "
                        "CHOOSE x : x \\notin S fresh-value idiom)")
    s = eval_expr(e.set, ctx)
    for v in enumerate_set(s):
        b = bind_pattern(e.var, v)
        if _bool(eval_expr(e.pred, ctx.with_bound(b)), "CHOOSE body"):
            return v
    raise EvalError(f"CHOOSE: no value in {fmt(s)} satisfies predicate")


def _ev_unchanged(e: A.Unchanged, ctx: Ctx):
    # as a boolean expression: vars' = vars
    return tla_eq(eval_expr(A.Prime(e.expr), ctx), eval_expr(e.expr, ctx))


def _ev_fair(e: A.Fair, ctx: Ctx):
    raise EvalError("fairness formulas are temporal; not state-evaluable")


def _ev_boxaction(e, ctx):
    raise EvalError("[A]_v is action-level; not state-evaluable")


def _ev_enabled(e: A.Enabled, ctx: Ctx):
    from .enumerate import action_enabled  # late import
    return action_enabled(e.expr, ctx)


_DISPATCH: Dict[type, Callable] = {
    A.Num: _ev_num,
    A.Str: _ev_str,
    A.Bool: _ev_bool,
    A.Ident: _ev_ident,
    A.Prime: _ev_prime,
    A.OpApp: _ev_opapp,
    A.FnApp: _ev_fnapp,
    A.Dot: _ev_dot,
    A.TupleExpr: _ev_tuple,
    A.SetEnum: _ev_setenum,
    A.SetFilter: _ev_setfilter,
    A.SetMap: _ev_setmap,
    A.FnDef: _ev_fndef,
    A.FnSet: _ev_fnset,
    A.RecordExpr: _ev_record,
    A.RecordSet: _ev_recordset,
    A.Except: _ev_except,
    A.At: _ev_at,
    A.If: _ev_if,
    A.Case: _ev_case,
    A.Let: _ev_let,
    A.Quant: _ev_quant,
    A.Choose: _ev_choose,
    A.Unchanged: _ev_unchanged,
    A.Fair: _ev_fair,
    A.BoxAction: _ev_boxaction,
    A.Enabled: _ev_enabled,
}
