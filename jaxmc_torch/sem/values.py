r"""TLA+ value domain for the reference interpreter.

Python natives carry most of the weight: int, bool, str, frozenset. Functions
(which subsume sequences, tuples, records, and bags — e.g. raft's message bag
is a function Message -> Nat, tla-rust examples/raft.tla:33-36) are the
immutable Fcn class. Model values come from cfg CONSTANT bindings.

A total deterministic order over all values (sort_key) fixes CHOOSE witnesses
and canonical display order, mirroring TLC's deterministic enumeration.

Known deviation: Python's True == 1 could collapse BOOLEAN/0/1-int mixes.
TLC raises a comparability error on such mixes; specs that TLC accepts
without error never hit this. Guarded (raises like TLC): tla_eq on direct
bool-int comparison, in_set membership, set-operator operands
(\cup/\cap/\/UNION/enumeration/comprehension via check_set_mix), and —
since round 4 — NESTED mixes wherever a collapse could occur: two values
that are Python-equal only via a nested True==1 conflation (e.g. {{TRUE}}
vs {{1}}, <<TRUE>> vs <<1>>) raise at the comparison/construction site
(_assert_no_collapse, gated by the cheap _has_boolish scan). Residual
deviation (answer-preserving): TLC also raises when comparing nested
values that are NOT Python-equal, e.g. {{TRUE}} = {{2}} — we return
FALSE where TLC errors; no wrong answer is produced, only a missing
error report on specs TLC would reject anyway.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple


class EvalError(Exception):
    pass


class ModelValue:
    """An uninterpreted model value (cfg `Ident = Ident`). Compares unequal
    to every other value, equal only to itself."""
    __slots__ = ("name",)
    _interned: Dict[str, "ModelValue"] = {}

    def __new__(cls, name: str):
        mv = cls._interned.get(name)
        if mv is None:
            mv = object.__new__(cls)
            mv.name = name
            cls._interned[name] = mv
        return mv

    def __reduce__(self):
        # re-intern on unpickle (checkpoint/resume); default pickling
        # would call __new__ with no args and break identity equality
        return (ModelValue, (self.name,))

    def __repr__(self):
        return self.name

    def __hash__(self):
        return hash(("$mv", self.name))

    def __eq__(self, other):
        return self is other


class Fcn:
    """Immutable TLA+ function. Sequences are functions with domain 1..n,
    records functions with string domain — all compare uniformly."""
    __slots__ = ("_d", "_hash", "_sk", "_hb")

    def __init__(self, mapping: Iterable):
        d = dict(mapping)
        self._d = d
        self._hash = None
        self._sk = None  # cached sort_key (never pickled — see __reduce__)
        self._hb = None  # cached _has_bool (rebuilt on unpickle too)

    @property
    def d(self) -> dict:
        return self._d

    def domain(self) -> frozenset:
        return frozenset(self._d.keys())

    def apply(self, arg):
        try:
            return self._d[arg]
        except KeyError:
            raise EvalError(f"function applied outside domain: {fmt(arg)} "
                            f"not in {fmt(self.domain())}")
        except TypeError:
            raise EvalError(f"unhashable function argument {arg!r}")

    def is_seq(self) -> bool:
        n = len(self._d)
        return all(isinstance(k, int) for k in self._d) and \
            set(self._d.keys()) == set(range(1, n + 1))

    def is_record(self) -> bool:
        return len(self._d) > 0 and all(isinstance(k, str) for k in self._d)

    def as_list(self) -> List[Any]:
        n = len(self._d)
        return [self._d[i] for i in range(1, n + 1)]

    def __len__(self):
        return len(self._d)

    def __eq__(self, other):
        if not isinstance(other, Fcn):
            return NotImplemented
        return self._d == other._d

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(frozenset(self._d.items()))
        return self._hash

    def __reduce__(self):
        # never pickle the cached hash: str/frozenset hashes are
        # per-process (PYTHONHASHSEED), so a checkpointed hash is wrong
        # in the resuming process and set/dict membership silently breaks.
        # Rebuilding via __init__ also forces lazy subclasses (RecFcn)
        # to a plain materialized Fcn, whose closures cannot pickle
        return (Fcn, (list(self._materialized_items()),))

    def _materialized_items(self):
        return self._d.items()

    def __repr__(self):
        return fmt(self)


EMPTY_FCN = Fcn({})


def mk_seq(items: Iterable) -> Fcn:
    return Fcn({i + 1: v for i, v in enumerate(items)})


def mk_record(fields: Dict[str, Any]) -> Fcn:
    return Fcn(fields)


class InfiniteSet:
    """Sentinel for Nat, Int, STRING, Seq(S): supports membership, refuses
    enumeration (TLC behaves the same way)."""
    __slots__ = ("kind", "param")

    def __init__(self, kind: str, param=None):
        self.kind = kind
        self.param = param

    def contains(self, v) -> bool:
        if self.kind == "Nat":
            return isinstance(v, int) and not isinstance(v, bool) and v >= 0
        if self.kind == "Int":
            return isinstance(v, int) and not isinstance(v, bool)
        if self.kind == "STRING":
            return isinstance(v, str)
        if self.kind == "Seq":
            return isinstance(v, Fcn) and (len(v) == 0 or v.is_seq()) and \
                all(in_set(x, self.param) for x in v.as_list())
        if self.kind == "Real":
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        raise EvalError(f"unknown infinite set {self.kind}")

    def __repr__(self):
        return self.kind if self.param is None else f"Seq({fmt(self.param)})"

    def __eq__(self, other):
        return isinstance(other, InfiniteSet) and self.kind == other.kind \
            and self.param == other.param

    def __hash__(self):
        return hash(("$inf", self.kind, self.param))


class FcnSetV:
    """Lazy [S -> T]: membership without materialization, so TypeOK-style
    checks like opQ \\in [Proc -> Seq(opVal)] work with infinite ranges
    (AdvancedExamples/InnerSerial.tla:24). Enumeration materializes."""
    __slots__ = ("dom", "rng", "_mat")

    def __init__(self, dom, rng):
        self.dom = dom
        self.rng = rng
        self._mat = None

    def contains(self, v) -> bool:
        if not isinstance(v, Fcn):
            return False
        if v.domain() != (self.dom if isinstance(self.dom, frozenset)
                          else frozenset(enumerate_set(self.dom))):
            return False
        return all(in_set(x, self.rng) for x in v.d.values())

    def materialize(self) -> frozenset:
        if self._mat is None:
            import itertools
            delems = enumerate_set(self.dom)
            relems = enumerate_set(self.rng)
            self._mat = frozenset(
                Fcn(dict(zip(delems, combo)))
                for combo in itertools.product(relems, repeat=len(delems)))
        return self._mat

    def __eq__(self, other):
        if isinstance(other, FcnSetV):
            return self.dom == other.dom and self.rng == other.rng
        if isinstance(other, frozenset):
            return self.materialize() == other
        return NotImplemented

    def __hash__(self):
        return hash(self.materialize())

    def __repr__(self):
        return f"[{fmt(self.dom)} -> {fmt(self.rng)}]"


NAT = InfiniteSet("Nat")
INT = InfiniteSet("Int")
REAL = InfiniteSet("Real")
STRING_SET = InfiniteSet("STRING")
BOOLEAN_SET = frozenset({True, False})


def in_set(v, s) -> bool:
    if isinstance(s, FcnSetV):
        return s.contains(v)
    if isinstance(s, frozenset):
        # Python's True == 1 must not leak into TLA+ semantics where
        # TRUE /= 1: disambiguate bool/int hash collisions by scan.
        if isinstance(v, bool):
            if not _has_bool(s):
                return False  # no bool anywhere in s; a hash hit is 0/1
            return any(x is v for x in s)
        if isinstance(v, int) and v in (0, 1):
            if not _has_bool(s):
                return v in s  # every hash-equal member is an int
            return any(x == v and not isinstance(x, bool) for x in s)
        if isinstance(v, (frozenset, Fcn)) and (_has_bool(v)
                                                or _has_bool(s)):
            # container membership can match only via a nested True==1
            # conflation ({1} \in {{TRUE}}), which needs a bool on one
            # side: hash-check first (a miss can't collapse), and only on
            # a hit scan for the Python-equal member to raise like TLC
            if v not in s:
                return False
            for x in s:
                if x == v:
                    _assert_no_collapse(v, x)
                    return True
            return True  # unreachable: the hash hit guarantees a match
        return v in s
    if isinstance(s, InfiniteSet):
        return s.contains(v)
    raise EvalError(f"\\in applied to non-set {fmt(s)}")


_ENUM_CACHE: Dict[Any, List[Any]] = {}
_ENUM_CACHE_CAP = 1 << 16


def _enum_key(s: frozenset):
    # Python conflates True==1 / False==0, so {0, 1} and {FALSE, TRUE}
    # are EQUAL frozensets — TLA+ distinguishes them (sort_key ranks bool
    # before int). Tag the key with the exact bool subset: two Python-
    # equal sets can only differ in which of 0/1 are booleans, and the
    # bool subset pins that down ({0, TRUE} vs {1, FALSE} get distinct
    # keys), so the cache never serves ints as booleans or vice versa.
    bools = frozenset(x for x in s if type(x) is bool)
    return (s, bools)


def enumerate_set(s) -> List[Any]:
    """Deterministically ordered elements; raises on infinite sets.

    Results for frozensets are cached (values are immutable and equal sets
    enumerate identically) — callers must NOT mutate the returned list."""
    if isinstance(s, FcnSetV):
        return sorted(s.materialize(), key=sort_key)
    if isinstance(s, frozenset):
        key = _enum_key(s)
        hit = _ENUM_CACHE.get(key)
        if hit is None:
            if len(_ENUM_CACHE) >= _ENUM_CACHE_CAP:
                _ENUM_CACHE.clear()
            hit = sorted(s, key=sort_key)
            _ENUM_CACHE[key] = hit
        return hit
    if isinstance(s, InfiniteSet):
        raise EvalError(f"cannot enumerate infinite set {s!r}")
    raise EvalError(f"expected a set, got {fmt(s)}")


_TYPE_RANK = {bool: 0, int: 1, str: 2, ModelValue: 3, frozenset: 4, Fcn: 5,
              InfiniteSet: 6}


def sort_key(v):
    t = type(v)
    if t is bool:
        return (0, v)
    if t is int:
        return (1, v)
    if t is str:
        return (2, v)
    if t is ModelValue:
        return (3, v.name)
    if t is frozenset:
        return (4, len(v), tuple(sort_key(x) for x in enumerate_set(v)))
    if t is Fcn:
        sk = v._sk
        if sk is None:
            items = sorted(v.d.items(), key=lambda kv: sort_key(kv[0]))
            sk = (5, len(items),
                  tuple((sort_key(k), sort_key(x)) for k, x in items))
            v._sk = sk
        return sk
    if t is InfiniteSet:
        return (6, v.kind)
    if t is FcnSetV:
        return sort_key(v.materialize())
    if t is tuple:
        # engine-level state tuples (symmetry canonicalization)
        return tuple(sort_key(x) for x in v)
    raise EvalError(f"unorderable value {v!r}")


def _has_boolish(v) -> bool:
    """Could v participate in a True==1 collapse from EITHER side? True iff
    it contains a bool or a 0/1 integer anywhere. Used only at set
    CONSTRUCTION sites (check_set_mix), where pure-int members must still
    enter the nested-dedup dict so a later bool-bearing member can collide
    with them ({1} before {TRUE})."""
    if isinstance(v, bool):
        return True
    if isinstance(v, int):
        return v in (0, 1)
    if isinstance(v, frozenset):
        return any(_has_boolish(x) for x in v)
    if isinstance(v, Fcn):
        return any(_has_boolish(k) or _has_boolish(x)
                   for k, x in v.d.items())
    return False


_HAS_BOOL_CACHE: Dict[int, Tuple[Any, bool]] = {}
_HAS_BOOL_CACHE_CAP = 1 << 16


def _has_bool(v) -> bool:
    """Does v contain an ACTUAL bool anywhere? A True==1 conflation needs a
    bool on at least one side (int-vs-int positions never raise), so for a
    PAIR of Python-equal values `_has_bool(a) or _has_bool(b)` is the exact
    gate for _assert_no_collapse — unlike _has_boolish, a pure-int sequence
    or record (domain keys 1..n, 0/1 payloads) gates False and the hot
    equality/membership paths stay single-pass. Cached per container object
    (Fcn slot; id-keyed strong-ref table for frozensets)."""
    if isinstance(v, bool):
        return True
    if isinstance(v, Fcn):
        hb = v._hb
        if hb is None:
            # _materialized_items (not ._d) so a lazy RecFcn is forced
            # BEFORE the scan — scanning a partially-evaluated memo dict
            # would cache a stale False and silently equate a later
            # True==1 conflation instead of raising
            hb = any(_has_bool(k) or _has_bool(x)
                     for k, x in v._materialized_items())
            v._hb = hb
        return hb
    if isinstance(v, frozenset):
        e = _HAS_BOOL_CACHE.get(id(v))
        if e is not None and e[0] is v:
            return e[1]
        r = any(_has_bool(x) for x in v)
        if len(_HAS_BOOL_CACHE) >= _HAS_BOOL_CACHE_CAP:
            _HAS_BOOL_CACHE.clear()
        _HAS_BOOL_CACHE[id(v)] = (v, r)
        return r
    return False


def _assert_no_collapse(a, b) -> None:
    """Given a == b under PYTHON equality, raise EvalError if that
    equality rides a True==1 conflation anywhere inside — TLC treats
    BOOLEAN and integers as incomparable at every depth, so {{TRUE}}
    vs {{1}} is a comparability error there, never an equality."""
    if isinstance(a, bool) != isinstance(b, bool):
        raise EvalError(
            f"attempted to compare {fmt(a)} with {fmt(b)} (BOOLEAN vs "
            "integer, incomparable in TLA+; TLC raises here too)")
    if isinstance(a, frozenset) and isinstance(b, frozenset):
        bd = {x: x for x in b}
        for m in a:
            _assert_no_collapse(m, bd[m])
    elif isinstance(a, Fcn) and isinstance(b, Fcn):
        bkeys = {k: k for k in b.d}
        for k, v in a.d.items():
            bk = bkeys[k]
            _assert_no_collapse(k, bk)
            _assert_no_collapse(v, b.d[bk])


def check_set_mix(vals) -> None:
    """TLC comparability: a set holding both BOOLEAN and integer members
    is an error, never a silent True==1 collapse (the documented
    deviation above). Called by the set CONSTRUCTION sites — enumeration,
    comprehension, union-family operators (sem/eval.py, sem/stdlib.py).
    Also catches NESTED collapses: two members that are Python-equal only
    via an inner True==1 conflation ({{TRUE}, {1}} would silently dedup
    to a 1-element set before any downstream check could see it)."""
    has_bool = has_int = False
    nested = None
    for v in vals:
        if isinstance(v, bool):
            has_bool = True
        elif isinstance(v, int):
            has_int = True
        elif isinstance(v, (frozenset, Fcn)) and _has_boolish(v):
            if nested is None:
                nested = {}
            prev = nested.setdefault(v, v)
            if prev is not v:
                _assert_no_collapse(prev, v)
        if has_bool and has_int:
            raise EvalError(
                "set mixes BOOLEAN and integer values (incomparable in "
                "TLA+; TLC raises here too)")


def values_comparable(a, b) -> bool:
    """TLC-style comparability: model values compare (unequal) with anything;
    otherwise kinds must match."""
    if isinstance(a, ModelValue) or isinstance(b, ModelValue):
        return True
    ka, kb = _kind(a), _kind(b)
    return ka == kb


def _kind(v):
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, str):
        return "str"
    if isinstance(v, (frozenset, InfiniteSet, FcnSetV)):
        return "set"
    if isinstance(v, Fcn):
        return "fcn"
    return "other"


def tla_eq(a, b) -> bool:
    if isinstance(a, ModelValue) or isinstance(b, ModelValue):
        return a is b
    if not values_comparable(a, b):
        raise EvalError(f"attempted to compare {fmt(a)} with {fmt(b)}")
    if isinstance(a, FcnSetV):
        return a == b
    if isinstance(b, FcnSetV):
        return b == a
    r = a == b
    if r and isinstance(a, (frozenset, Fcn)) and (_has_bool(a)
                                                  or _has_bool(b)):
        # Python-equal containers may be equal only via a nested True==1
        # conflation ({{TRUE}} == {{1}}), which needs an actual bool on
        # one side: TLC raises there, never equates
        _assert_no_collapse(a, b)
    return r


def fmt(v) -> str:
    """TLC-style display, used for counterexample traces
    (format reference: tla-rust README.md:268-318)."""
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, ModelValue):
        return v.name
    if isinstance(v, frozenset):
        return "{" + ", ".join(fmt(x) for x in sorted(v, key=sort_key)) + "}"
    if isinstance(v, Fcn):
        if len(v) == 0:
            return "<<>>"
        if v.is_seq():
            return "<<" + ", ".join(fmt(x) for x in v.as_list()) + ">>"
        if v.is_record():
            return "[" + ", ".join(f"{k} |-> {fmt(x)}"
                                   for k, x in sorted(v.d.items())) + "]"
        items = sorted(v.d.items(), key=lambda kv: sort_key(kv[0]))
        return "(" + " @@ ".join(f"{fmt(k)} :> {fmt(x)}" for k, x in items) + ")"
    if isinstance(v, (InfiniteSet, FcnSetV)):
        return repr(v)
    return repr(v)
