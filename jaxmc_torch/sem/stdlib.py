r"""Native implementations of the TLA+ standard modules.

Semantic definitions these implement (SURVEY.md §1 L2):
  Naturals/Integers: tla-rust examples/SpecifyingSystems/Standard/
    Naturals.tla:4-16, Integers.tla:5-6 (+ - * ^ <= < .. \div % Int unary -)
  Sequences: Sequences.tla:14-58 (Seq Len \o Append Head Tail SubSeq SelectSeq)
  FiniteSets: FiniteSets.tla:9-22 (IsFiniteSet Cardinality)
  Bags: Bags.tla:4-45 (multiset ops — raft encodes its bag manually)
  TLC: TLC/TLC.tla (Print/Assert :5-6, :> and @@ :10-12, Permutations :13-14,
    SortSeq :20-23)

Each entry takes (args, ctx) — the evaluator resolves user redefinitions first,
so a module shadowing an operator wins.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict

from .values import (EvalError, Fcn, InfiniteSet, EMPTY_FCN,
                     enumerate_set, fmt, in_set, mk_seq,
                     tla_eq, check_set_mix)
from .eval import TLCAssertFailure, apply_op


def _int(v, op):
    if isinstance(v, bool) or not isinstance(v, int):
        raise EvalError(f"{op} applied to non-integer {fmt(v)}")
    return v


def _set(v, op):
    if isinstance(v, frozenset):
        return v
    from .values import FcnSetV
    if isinstance(v, FcnSetV):
        return v.materialize()
    raise EvalError(f"{op} applied to non-enumerable-set {fmt(v)}")


def _seq(v, op):
    if isinstance(v, Fcn) and (len(v) == 0 or v.is_seq()):
        return v
    raise EvalError(f"{op} applied to non-sequence {fmt(v)}")


def _arith(name):
    def f(args, ctx):
        a, b = (_int(x, name) for x in args)
        if name == "+":
            return a + b
        if name == "-":
            return a - b
        if name == "*":
            return a * b
        if name == "^":
            return a ** b
        if name == "\\div":
            if b == 0:
                raise EvalError("division by zero")
            return a // b
        if name == "%":
            if b == 0:
                raise EvalError("modulo by zero")
            return a % b
        raise AssertionError(name)
    return f


def _cmp(name):
    def f(args, ctx):
        a, b = (_int(x, name) for x in args)
        return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[name]
    return f


def _interval(args, ctx):
    a, b = (_int(x, "..") for x in args)
    return frozenset(range(a, b + 1))


def _setop(name):
    def f(args, ctx):
        a = _set(args[0], name)
        b = _set(args[1], name)
        # check the OPERANDS' members for every set operator: True == 1
        # collapses inside `a | b` / `a & b` / `a - b` itself, so the
        # result would hide the mix ({TRUE} \cap {1} -> {1}, {TRUE} \ {1}
        # -> {}) where TLC raises a comparability error
        check_set_mix(itertools.chain(a, b))
        if name in ("\\cup", "\\union"):
            return a | b
        if name in ("\\cap", "\\intersect"):
            return a & b
        if name == "\\":
            return a - b
        raise AssertionError(name)
    return f


def _subseteq(args, ctx):
    a = _set(args[0], "\\subseteq")
    return all(in_set(x, args[1]) for x in a)


def _subset_proper(args, ctx):
    return _subseteq(args, ctx) and not tla_eq(args[0], args[1])


def _powerset(args, ctx):
    elems = enumerate_set(args[0])
    out = []
    for r in range(len(elems) + 1):
        for combo in itertools.combinations(elems, r):
            out.append(frozenset(combo))
    return frozenset(out)


def _union(args, ctx):
    out = []
    for s in enumerate_set(args[0]):
        out.extend(_set(s, "UNION"))
    check_set_mix(out)
    return frozenset(out)


def _domain(args, ctx):
    v = args[0]
    if isinstance(v, Fcn):
        return v.domain()
    raise EvalError(f"DOMAIN of non-function {fmt(v)}")


def _cardinality(args, ctx):
    return len(_set(args[0], "Cardinality"))


def _is_finite_set(args, ctx):
    return isinstance(args[0], frozenset)


def _cartprod(args, ctx):
    sets = [enumerate_set(s) for s in args]
    return frozenset(mk_seq(list(c)) for c in itertools.product(*sets))


# ---- Sequences ----

def _len(args, ctx):
    return len(_seq(args[0], "Len"))


def _concat(args, ctx):
    a, b = _seq(args[0], "\\o"), _seq(args[1], "\\o")
    return mk_seq(a.as_list() + b.as_list())


def _append(args, ctx):
    s = _seq(args[0], "Append")
    return mk_seq(s.as_list() + [args[1]])


def _head(args, ctx):
    s = _seq(args[0], "Head")
    if len(s) == 0:
        raise EvalError("Head of empty sequence")
    return s.apply(1)


def _tail(args, ctx):
    s = _seq(args[0], "Tail")
    if len(s) == 0:
        raise EvalError("Tail of empty sequence")
    return mk_seq(s.as_list()[1:])


def _subseq(args, ctx):
    s = _seq(args[0], "SubSeq")
    m, n = _int(args[1], "SubSeq"), _int(args[2], "SubSeq")
    lst = s.as_list()
    if m < 1 or n > len(lst):
        if m > n:  # empty result allowed for m > n even out of range
            return EMPTY_FCN
        raise EvalError(f"SubSeq({fmt(args[0])}, {m}, {n}) out of range")
    return mk_seq(lst[m - 1:n])


def _selectseq(args, ctx):
    s = _seq(args[0], "SelectSeq")
    test = args[1]
    out = [v for v in s.as_list()
           if apply_op(test, [v], ctx) is True]
    return mk_seq(out)


def _seq_set(args, ctx):
    return InfiniteSet("Seq", args[0])


# ---- Bags (Standard/Bags.tla:4-45) ----

def _is_bag(v):
    return isinstance(v, Fcn) and all(
        isinstance(c, int) and not isinstance(c, bool) and c > 0
        for c in v.d.values())


def _bag_add(args, ctx):
    a, b = args
    if not (isinstance(a, Fcn) and isinstance(b, Fcn)):
        raise EvalError("(+) applied to non-bags")
    d = dict(a.d)
    for k, c in b.d.items():
        d[k] = d.get(k, 0) + c
    return Fcn(d)


def _bag_sub(args, ctx):
    a, b = args
    if not (isinstance(a, Fcn) and isinstance(b, Fcn)):
        raise EvalError("(-) applied to non-bags")
    d = {}
    for k, c in a.d.items():
        nc = c - b.d.get(k, 0)
        if nc > 0:
            d[k] = nc
    return Fcn(d)


def _bag_in(args, ctx):
    e, b = args
    return isinstance(b, Fcn) and e in b.d and b.d[e] > 0


def _bag_to_set(args, ctx):
    return frozenset(k for k, c in args[0].d.items() if c > 0)


def _set_to_bag(args, ctx):
    return Fcn({k: 1 for k in enumerate_set(args[0])})


def _copies_in(args, ctx):
    e, b = args
    return b.d.get(e, 0) if isinstance(b, Fcn) else 0


def _bag_union(args, ctx):
    out: Dict[Any, int] = {}
    for b in enumerate_set(args[0]):
        for k, c in b.d.items():
            out[k] = out.get(k, 0) + c
    return Fcn(out)


def _bag_cardinality(args, ctx):
    return sum(args[0].d.values())


def _sub_bag(args, ctx):
    b = args[0]
    items = list(b.d.items())
    out = []
    for counts in itertools.product(*[range(c + 1) for _, c in items]):
        out.append(Fcn({k: n for (k, _), n in zip(items, counts) if n > 0}))
    return frozenset(out)


def _bag_of_all(args, ctx):
    op, b = args
    out: Dict[Any, int] = {}
    for k, c in b.d.items():
        nk = apply_op(op, [k], ctx)
        out[nk] = out.get(nk, 0) + c
    return Fcn(out)


# ---- TLC module ----

def _print(args, ctx):
    out, val = args
    if ctx.on_print is not None:
        ctx.on_print(out)
    else:
        print(fmt(out) if not isinstance(out, str) else out)
    return val


def _print_t(args, ctx):
    return _print([args[0], True], ctx)


def _assert(args, ctx):
    val, out = args
    if val is not True:
        raise TLCAssertFailure(out)
    return True


def _colon_gt(args, ctx):
    return Fcn({args[0]: args[1]})


def _at_at(args, ctx):
    f, g = args
    if not (isinstance(f, Fcn) and isinstance(g, Fcn)):
        raise EvalError("@@ applied to non-functions")
    d = dict(g.d)
    d.update(f.d)  # f wins on overlap, per TLC.tla:11-12
    return Fcn(d)


def _permutations(args, ctx):
    s = enumerate_set(args[0])
    out = []
    for perm in itertools.permutations(s):
        out.append(Fcn(dict(zip(s, perm))))
    return frozenset(out)


def _sort_seq(args, ctx):
    s, op = args
    lst = _seq(s, "SortSeq").as_list()
    import functools

    def cmp(a, b):
        if apply_op(op, [a, b], ctx) is True:
            return -1
        if apply_op(op, [b, a], ctx) is True:
            return 1
        return 0
    return mk_seq(sorted(lst, key=functools.cmp_to_key(cmp)))


def _tlc_eval(args, ctx):
    return args[0]


_RAW_OPS = {
    "+": _arith("+"), "-": _arith("-"), "*": _arith("*"), "^": _arith("^"),
    "\\div": _arith("\\div"), "%": _arith("%"), "\\mod": _arith("%"),
    "<": _cmp("<"), ">": _cmp(">"),
    "<=": _cmp("<="), "=<": _cmp("<="), "\\leq": _cmp("<="),
    ">=": _cmp(">="), "\\geq": _cmp(">="),
    "..": _interval,
    "-.": lambda args, ctx: -_int(args[0], "-"),
    "\\cup": _setop("\\cup"), "\\union": _setop("\\cup"),
    "\\cap": _setop("\\cap"), "\\intersect": _setop("\\cap"),
    "\\": _setop("\\"),
    "\\subseteq": _subseteq,
    "\\subset": _subset_proper,
    "\\supseteq": lambda args, ctx: _subseteq([args[1], args[0]], ctx),
    "\\supset": lambda args, ctx: _subset_proper([args[1], args[0]], ctx),
    "SUBSET": _powerset,
    "UNION": _union,
    "DOMAIN": _domain,
    "\\X": _cartprod,
    "Cardinality": _cardinality,
    "IsFiniteSet": _is_finite_set,
    "Len": _len,
    "\\o": _concat, "\\circ": _concat,
    "Append": _append,
    "Head": _head,
    "Tail": _tail,
    "SubSeq": _subseq,
    "SelectSeq": _selectseq,
    "Seq": _seq_set,
    "(+)": _bag_add, "(-)": _bag_sub,
    "BagIn": _bag_in,
    "BagToSet": _bag_to_set,
    "SetToBag": _set_to_bag,
    "CopiesIn": _copies_in,
    "BagUnion": _bag_union,
    "BagCardinality": _bag_cardinality,
    "SubBag": _sub_bag,
    "BagOfAll": _bag_of_all,
    "EmptyBag": lambda args, ctx: EMPTY_FCN,
    "IsABag": lambda args, ctx: _is_bag(args[0]),
    "Print": _print,
    "PrintT": _print_t,
    "Assert": _assert,
    ":>": _colon_gt,
    "@@": _at_at,
    "Permutations": _permutations,
    "SortSeq": _sort_seq,
    "TLCEval": _tlc_eval,
    "ToString": lambda args, ctx: fmt(args[0]),
}

BUILTIN_OPS = dict(_RAW_OPS)
