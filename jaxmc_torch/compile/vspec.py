r"""Value-shape inference and fixed-width lane encodings for the TPU path.

The checker cannot know statically whether an empty TLA+ function value is a
sequence, a map, or a message bag — so the layout is inferred by sampling
reachable states with the exact interpreter and merging observed shapes
(SURVEY.md §7.3 "model grounder"). The merge lattice:

  int / bool / enum                     one i32 lane each
  fcn   (stable finite domain)          concatenated element blocks
  seq   (int keys 1..n, n varies)      len lane + cap x elem lanes, zero-pad
  set   (members all enums)            |universe| membership lanes
  growset (members anything else)      count lane + cap x elem lanes,
                                        elements sorted by lane tuple,
                                        SENTINEL padding  (raft's allLogs,
                                        elections — history sets that only
                                        grow, raft.tla:43-48)
  pfcn  (enum keys, domain varies)     per-key present lane + value lanes,
                                        zeroed when absent (voterLog[i])
  union (records with differing keys)  tag lane + max-width payload,
                                        zero-pad (raft's message records,
                                        raft.tla:28-32 in Paxos, mtype
                                        dispatch raft.tla:449-464)
  kvtable (keys anything else -> val)  count lane + cap x (key+val) lanes,
                                        sorted by key lanes, SENTINEL pad
                                        (the message bag Message -> Nat,
                                        raft.tla:33-36,117-132)

Exactness: encodings are canonical (sorted containers, deterministic
padding), so lane-tuple equality == TLA+ value equality, and capacity
overflow is a hard error — state counts stay exact (BASELINE.json).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..sem.values import Fcn, ModelValue, fmt, sort_key


class CompileError(Exception):
    """Raised when a construct cannot be compiled to the TPU path; callers
    fall back to the interpreter (SURVEY.md §7.2)."""


class ModeError(CompileError):
    """An unsupported option/mode combination (e.g. --resident with
    --host-seen, or resident mode on a model with temporal properties) —
    the fix is different flags, not a different backend, so the CLI must
    not advise 'this spec is outside the compilable subset'."""


SENTINEL_LANE = 2**31 - 1


@dataclass
class Bounds:
    """Capacity FLOORS for the lane encodings. A container's capacity is
    max(floor, observed_max * margin) — observed over constraint-satisfying
    sampled states; the floors exist to be raised when sampling
    under-observes a model (the runtime overflow guard aborts exactly if a
    search outgrows the inferred caps, naming the flag to raise)."""
    seq_cap: int = 4        # sequence length floor
    grow_cap: int = 4       # growing-set cardinality floor
    kv_cap: int = 4         # message-table domain floor
    observed_margin: int = 2  # caps at least observed_max * margin


class EnumUniverse:
    """Global index space for strings and model values (pc labels, roles,
    message types, Nil, ...)."""

    def __init__(self):
        self.to_idx: Dict[Any, int] = {}
        self.values: List[Any] = []

    def add(self, v):
        if v not in self.to_idx:
            self.to_idx[v] = len(self.values)
            self.values.append(v)

    def index(self, v) -> int:
        try:
            return self.to_idx[v]
        except KeyError:
            raise CompileError(f"value {fmt(v)} not in enum universe")

    def value(self, i: int):
        return self.values[i]

    def __len__(self):
        return len(self.values)


@dataclass(frozen=True)
class VS:
    """A value spec node."""
    kind: str
    # fcn: dom=ordered keys, elems=per-key spec
    # seq: cap=int, elem=spec
    # set: dom=universe members
    # growset: cap, elem
    # pfcn: dom=key universe, elem (uniform value spec)
    # union: variants=tuple of (fieldnames_tuple, fields_spec_tuple)
    # kvtable: cap, elem (key spec), val (value spec)
    dom: Tuple = ()
    elems: Tuple = ()
    elem: Optional["VS"] = None
    val: Optional["VS"] = None
    cap: int = 0
    variants: Tuple = ()

    @property
    def width(self) -> int:
        k = self.kind
        if k == "justempty":
            return 0
        if k in ("int", "bool", "enum"):
            return 1
        if k == "fcn":
            return sum(e.width for e in self.elems)
        if k == "seq":
            return 1 + self.cap * self.elem.width
        if k == "set":
            return len(self.dom)
        if k == "growset":
            return 1 + self.cap * self.elem.width
        if k == "pfcn":
            return sum(1 + e.width for e in self.elems)
        if k == "union":
            return 1 + max((sum(f.width for f in fs)
                            for _, fs in self.variants), default=0)
        if k == "kvtable":
            return 1 + self.cap * (self.elem.width + self.val.width)
        raise AssertionError(k)


_EMPTY_MARKER = VS("empty")


def infer(v, uni: EnumUniverse) -> VS:
    """Shape of a single observed value."""
    if isinstance(v, bool):
        return VS("bool")
    if isinstance(v, int):
        return VS("int")
    if isinstance(v, (str, ModelValue)):
        uni.add(v)
        return VS("enum")
    if isinstance(v, Fcn):
        if len(v.d) == 0:
            return _EMPTY_MARKER
        keys = sorted(v.d.keys(), key=sort_key)
        if all(isinstance(k, int) and not isinstance(k, bool) for k in keys) \
                and keys == list(range(1, len(keys) + 1)):
            try:
                elem = None
                for k in keys:
                    s = infer(v.d[k], uni)
                    elem = s if elem is None else merge(elem, s)
                return VS("seq", cap=len(keys), elem=elem)
            except CompileError:
                # heterogeneous tuple (<<data, bit>> pairs in
                # AlternatingBit): a fixed int-keyed record, not a sequence
                pass
        for k in keys:
            if isinstance(k, (str, ModelValue)):
                uni.add(k)
        elems = tuple(infer(v.d[k], uni) for k in keys)
        return VS("fcn", dom=tuple(keys), elems=elems)
    if isinstance(v, frozenset):
        if not v:
            return VS("emptyset")
        members = sorted(v, key=sort_key)
        mspecs = [infer(m, uni) for m in members]
        if all(s.kind == "enum" for s in mspecs):
            return VS("set", dom=tuple(members))
        elem = mspecs[0]
        for s in mspecs[1:]:
            elem = merge(elem, s)
        return VS("growset", cap=len(members), elem=elem)
    raise CompileError(f"cannot infer a lane encoding for {fmt(v)}")


def _is_record(spec: VS) -> bool:
    return spec.kind == "fcn" and all(isinstance(k, str) for k in spec.dom)


def merge(a: VS, b: VS) -> VS:
    """Least upper bound of two observed shapes."""
    if a.kind == b.kind and a.kind in ("int", "bool", "enum"):
        return a
    if a.kind in ("empty", "justempty"):
        a, b = b, a
    if b.kind in ("empty", "justempty"):
        # an empty function: compatible with seq / pfcn / kvtable
        if a.kind in ("seq", "pfcn", "kvtable", "empty", "justempty"):
            return a
        if a.kind == "fcn":
            # stable-domain fcn seen with an empty variant -> partial fcn
            return _fcn_to_pfcn(a)
        raise CompileError(f"empty function merged with {a.kind}")
    if a.kind == "emptyset":
        a, b = b, a
    if b.kind == "emptyset":
        if a.kind in ("set", "growset", "emptyset"):
            return a
        raise CompileError(f"empty set merged with {a.kind}")
    if a.kind == b.kind:
        k = a.kind
        if k == "seq":
            return VS("seq", cap=max(a.cap, b.cap),
                      elem=merge(a.elem, b.elem))
        if k == "set":
            return VS("set", dom=tuple(sorted(set(a.dom) | set(b.dom),
                                              key=sort_key)))
        if k == "growset":
            return VS("growset", cap=max(a.cap, b.cap),
                      elem=merge(a.elem, b.elem))
        if k == "fcn":
            if a.dom == b.dom:
                return VS("fcn", dom=a.dom,
                          elems=tuple(merge(x, y)
                                      for x, y in zip(a.elems, b.elems)))
            if _is_record(a) and _is_record(b):
                return _merge_unions(_record_to_union(a),
                                     _record_to_union(b))
            return merge(_fcn_to_pfcn(a), _fcn_to_pfcn(b))
        if k == "pfcn":
            keys = sorted(set(a.dom) | set(b.dom), key=sort_key)
            ae = dict(zip(a.dom, a.elems))
            be = dict(zip(b.dom, b.elems))
            elems = []
            for kk in keys:
                if kk in ae and kk in be:
                    elems.append(merge(ae[kk], be[kk]))
                else:
                    elems.append(ae.get(kk) or be[kk])
            return VS("pfcn", dom=tuple(keys), elems=tuple(elems))
        if k == "union":
            return _merge_unions(a, b)
        if k == "kvtable":
            return VS("kvtable", cap=max(a.cap, b.cap),
                      elem=merge(a.elem, b.elem), val=merge(a.val, b.val))
    # cross-kind promotions
    pair = {a.kind, b.kind}
    if pair == {"fcn", "seq"}:
        f = a if a.kind == "fcn" else b
        s = a if a.kind == "seq" else b
        if all(isinstance(kk, int) for kk in f.dom):
            elem = s.elem
            for e in f.elems:
                elem = merge(elem, e)
            return VS("seq", cap=max(s.cap, len(f.dom)), elem=elem)
        raise CompileError("sequence merged with non-int-keyed function")
    if pair == {"fcn", "pfcn"}:
        f = a if a.kind == "fcn" else b
        return merge(_fcn_to_pfcn(f), a if a.kind == "pfcn" else b)
    if pair == {"fcn", "union"} and _is_record(a if a.kind == "fcn" else b):
        f = a if a.kind == "fcn" else b
        u = a if a.kind == "union" else b
        return _merge_unions(_record_to_union(f), u)
    if pair == {"fcn", "kvtable"}:
        f = a if a.kind == "fcn" else b
        t = a if a.kind == "kvtable" else b
        kspec = None
        vspec = None
        for kk, e in zip(f.dom, f.elems):
            ks = infer_key(kk)
            kspec = ks if kspec is None else merge(kspec, ks)
            vspec = e if vspec is None else merge(vspec, e)
        return VS("kvtable", cap=max(t.cap, len(f.dom)),
                  elem=merge(t.elem, kspec) if kspec else t.elem,
                  val=merge(t.val, vspec) if vspec else t.val)
    if pair == {"set", "growset"}:
        g = a if a.kind == "growset" else b
        s = a if a.kind == "set" else b
        elem = g.elem
        return VS("growset", cap=max(g.cap, len(s.dom)), elem=elem)
    # scalar/RECORD mixes become tagged unions with scalar variants
    # (CachingMemory's buf[p]). Scalar/scalar mixes (int vs enum) still
    # RAISE: the heterogeneous-tuple inference (<<bit, data>> pairs,
    # AlternatingBit) depends on that failure to pick the int-keyed
    # record layout instead.
    orig_kinds = (a.kind, b.kind)

    def _unionable(x):
        return (x.kind == "union" or
                (x.kind == "fcn" and _is_record(x)))

    if (a.kind in _SCALARS and _unionable(b)) or \
            (b.kind in _SCALARS and _unionable(a)):
        if a.kind in _SCALARS:
            a = _scalar_to_union(a)
        if b.kind in _SCALARS:
            b = _scalar_to_union(b)
        if a.kind == "fcn":
            a = _record_to_union(a)
        if b.kind == "fcn":
            b = _record_to_union(b)
        return _merge_unions(a, b)
    raise CompileError(
        f"cannot merge shapes {orig_kinds[0]} and {orig_kinds[1]}")


def collect_enums_from_value(v, uni: EnumUniverse):
    """Register every string/model value reachable inside v (including ones
    nested in container keys) in the enum universe. Run over all sampled
    states before shape inference."""
    if isinstance(v, (str, ModelValue)):
        uni.add(v)
    elif isinstance(v, frozenset):
        for x in v:
            collect_enums_from_value(x, uni)
    elif isinstance(v, Fcn):
        for k, x in v.d.items():
            collect_enums_from_value(k, uni)
            collect_enums_from_value(x, uni)


def infer_key(k) -> VS:
    """Shape of a container key (enums were pre-registered by
    collect_enums_from_value, so a throwaway universe suffices here)."""
    if isinstance(k, bool):
        return VS("bool")
    if isinstance(k, int):
        return VS("int")
    if isinstance(k, (str, ModelValue)):
        return VS("enum")
    if isinstance(k, Fcn):
        return infer(k, EnumUniverse())
    raise CompileError(f"unsupported key value {fmt(k)}")


def _fcn_to_pfcn(f: VS) -> VS:
    if not all(isinstance(k, (str, ModelValue)) or isinstance(k, int)
               for k in f.dom):
        # composite keys -> kvtable
        kspec = None
        vspec = None
        for kk, e in zip(f.dom, f.elems):
            ks = infer_key(kk)
            kspec = ks if kspec is None else merge(kspec, ks)
            vspec = e if vspec is None else merge(vspec, e)
        return VS("kvtable", cap=len(f.dom), elem=kspec, val=vspec)
    return VS("pfcn", dom=f.dom, elems=f.elems)


def _record_to_union(f: VS) -> VS:
    return VS("union", variants=((tuple(f.dom), f.elems),))


def _scalar_to_union(s: VS) -> VS:
    """A scalar (enum/int/bool) as a one-variant union: variant name is
    the reserved marker ("$scalar:<kind>",) so scalars of different
    kinds coexist as distinct variants and never merge with record
    variants (CachingMemory's buf[p] in MReq u Val u {NoVal},
    tla-rust examples/SpecifyingSystems/CachingMemory)."""
    return VS("union", variants=(((f"$scalar:{s.kind}",), (s,)),))


_SCALARS = ("int", "bool", "enum")


def is_scalar_variant(names: Tuple) -> bool:
    return len(names) == 1 and isinstance(names[0], str) and \
        names[0].startswith("$scalar:")


def _merge_unions(a: VS, b: VS) -> VS:
    vs = {names: list(fields) for names, fields in a.variants}
    for names, fields in b.variants:
        if names in vs:
            vs[names] = [merge(x, y) for x, y in zip(vs[names], fields)]
        else:
            vs[names] = list(fields)
    return VS("union", variants=tuple(
        (names, tuple(fields)) for names, fields in sorted(vs.items())))


def apply_bounds(spec: VS, bounds: Bounds) -> VS:
    """Grow inferred caps to the configured bounds."""
    k = spec.kind
    if k == "seq":
        return VS("seq",
                  cap=max(bounds.seq_cap,
                          spec.cap * bounds.observed_margin),
                  elem=apply_bounds(spec.elem, bounds))
    if k == "growset":
        return VS("growset",
                  cap=max(bounds.grow_cap, spec.cap * bounds.observed_margin),
                  elem=apply_bounds(spec.elem, bounds))
    if k == "kvtable":
        return VS("kvtable",
                  cap=max(bounds.kv_cap, spec.cap * bounds.observed_margin),
                  elem=apply_bounds(spec.elem, bounds),
                  val=apply_bounds(spec.val, bounds))
    if k == "fcn":
        return VS("fcn", dom=spec.dom,
                  elems=tuple(apply_bounds(e, bounds) for e in spec.elems))
    if k == "pfcn":
        return VS("pfcn", dom=spec.dom,
                  elems=tuple(apply_bounds(e, bounds) for e in spec.elems))
    if k == "union":
        return VS("union", variants=tuple(
            (names, tuple(apply_bounds(f, bounds) for f in fields))
            for names, fields in spec.variants))
    if k == "empty":
        # only ever observed as the empty function: encode as zero lanes;
        # if a later state grows it, encoding raises a hard error and the
        # run aborts exactly (sample deeper or raise caps)
        return VS("justempty")
    if k == "emptyset":
        return VS("set", dom=())
    return spec


# ---------------- encode / decode ----------------

def encode(v, spec: VS, uni: EnumUniverse, out: List[int]):
    k = spec.kind
    if k == "justempty":
        if not (isinstance(v, Fcn) and len(v.d) == 0):
            raise CompileError(
                f"value {fmt(v)} appeared where only empty functions were "
                f"sampled - deepen layout sampling")
        return
    if k == "int":
        if isinstance(v, bool) or not isinstance(v, int):
            raise CompileError(f"expected int, got {fmt(v)}")
        out.append(v)
    elif k == "bool":
        if not isinstance(v, bool):
            raise CompileError(f"expected bool, got {fmt(v)}")
        out.append(1 if v else 0)
    elif k == "enum":
        out.append(uni.index(v))
    elif k == "fcn":
        if not isinstance(v, Fcn) or set(map(_hk, v.d)) != set(map(_hk,
                                                                   spec.dom)):
            raise CompileError(f"expected function over {spec.dom}, "
                               f"got {fmt(v)}")
        lookup = {_hk(kk): val for kk, val in v.d.items()}
        for kk, es in zip(spec.dom, spec.elems):
            encode(lookup[_hk(kk)], es, uni, out)
    elif k == "seq":
        if not isinstance(v, Fcn) or not (len(v) == 0 or v.is_seq()):
            raise CompileError(f"expected sequence, got {fmt(v)}")
        lst = v.as_list()
        if len(lst) > spec.cap:
            raise CompileError(
                f"sequence length {len(lst)} exceeds capacity {spec.cap} - "
                f"raise --seq-cap")
        out.append(len(lst))
        for x in lst:
            encode(x, spec.elem, uni, out)
        for _ in range(spec.cap - len(lst)):
            out.extend([0] * spec.elem.width)
    elif k == "set":
        if not isinstance(v, frozenset):
            raise CompileError(f"expected set, got {fmt(v)}")
        extra = v - frozenset(spec.dom)
        if extra:
            raise CompileError(f"set member outside universe: {fmt(extra)}")
        for m in spec.dom:
            out.append(1 if m in v else 0)
    elif k == "growset":
        if not isinstance(v, frozenset):
            raise CompileError(f"expected set, got {fmt(v)}")
        if len(v) > spec.cap:
            raise CompileError(f"set cardinality {len(v)} exceeds capacity "
                               f"{spec.cap} - raise --grow-cap")
        encs = []
        for m in v:
            buf: List[int] = []
            encode(m, spec.elem, uni, buf)
            encs.append(buf)
        encs.sort()
        out.append(len(v))
        for e in encs:
            out.extend(e)
        for _ in range(spec.cap - len(encs)):
            out.extend([SENTINEL_LANE] * spec.elem.width)
    elif k == "pfcn":
        if not isinstance(v, Fcn):
            raise CompileError(f"expected function, got {fmt(v)}")
        lookup = {_hk(kk): val for kk, val in v.d.items()}
        seen = set()
        for kk, es in zip(spec.dom, spec.elems):
            h = _hk(kk)
            if h in lookup:
                out.append(1)
                encode(lookup[h], es, uni, out)
                seen.add(h)
            else:
                out.append(0)
                out.extend([0] * es.width)
        extra = set(lookup) - seen
        if extra:
            raise CompileError(f"pfcn key outside universe: {extra}")
    elif k == "union":
        if not isinstance(v, Fcn):
            want = f"$scalar:{_scalar_kind(v)}"
            for tag, (vnames, vfields) in enumerate(spec.variants):
                if vnames == (want,):
                    out.append(tag)
                    n0 = len(out)
                    encode(v, vfields[0], uni, out)
                    out.extend([0] * (spec.width - 1 - (len(out) - n0)))
                    return
            raise CompileError(
                f"scalar {fmt(v)} not a variant of the union")
        if not v.is_record():
            raise CompileError(f"expected record, got {fmt(v)}")
        names = tuple(sorted(v.d.keys()))
        for tag, (vnames, vfields) in enumerate(spec.variants):
            if vnames == names:
                out.append(tag)
                n0 = len(out)
                for nm, fs in zip(vnames, vfields):
                    encode(v.d[nm], fs, uni, out)
                pay = spec.width - 1
                out.extend([0] * (pay - (len(out) - n0)))
                return
        raise CompileError(f"record shape {names} not in union variants")
    elif k == "kvtable":
        if not isinstance(v, Fcn):
            raise CompileError(f"expected function, got {fmt(v)}")
        if len(v.d) > spec.cap:
            raise CompileError(f"table domain {len(v.d)} exceeds capacity "
                               f"{spec.cap} - raise --kv-cap")
        rows = []
        for kk, val in v.d.items():
            kb: List[int] = []
            encode(kk, spec.elem, uni, kb)
            vb: List[int] = []
            encode(val, spec.val, uni, vb)
            rows.append((kb, vb))
        rows.sort(key=lambda r: r[0])
        out.append(len(rows))
        for kb, vb in rows:
            out.extend(kb)
            out.extend(vb)
        pad = spec.elem.width + spec.val.width
        for _ in range(spec.cap - len(rows)):
            out.extend([SENTINEL_LANE] * pad)
    else:
        raise AssertionError(k)


def _hk(k):
    return (type(k).__name__, k.name if isinstance(k, ModelValue) else k)


def _scalar_kind(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, (str, ModelValue)):
        return "enum"
    raise CompileError(f"not a scalar: {fmt(v)}")


def decode(row, i: int, spec: VS, uni: EnumUniverse):
    k = spec.kind
    if k == "justempty":
        from ..sem.values import EMPTY_FCN
        return EMPTY_FCN, i
    if k == "int":
        return int(row[i]), i + 1
    if k == "bool":
        return bool(row[i]), i + 1
    if k == "enum":
        return uni.value(int(row[i])), i + 1
    if k == "fcn":
        d = {}
        for kk, es in zip(spec.dom, spec.elems):
            d[kk], i = decode(row, i, es, uni)
        return Fcn(d), i
    if k == "seq":
        n = int(row[i])
        i += 1
        items = []
        for j in range(spec.cap):
            v, i = decode(row, i, spec.elem, uni)
            if j < n:
                items.append(v)
        from ..sem.values import mk_seq
        return mk_seq(items), i
    if k == "set":
        members = []
        for m in spec.dom:
            if int(row[i]):
                members.append(m)
            i += 1
        return frozenset(members), i
    if k == "growset":
        n = int(row[i])
        i += 1
        items = []
        for j in range(spec.cap):
            v_i = i
            if j < n:
                v, _ = decode(row, v_i, spec.elem, uni)
                items.append(v)
            i += spec.elem.width
        return frozenset(items), i
    if k == "pfcn":
        d = {}
        for kk, es in zip(spec.dom, spec.elems):
            present = int(row[i])
            i += 1
            v, _ = decode(row, i, es, uni)
            if present:
                d[kk] = v
            i += es.width
        return Fcn(d), i
    if k == "union":
        tag = int(row[i])
        i += 1
        names, fields = spec.variants[tag]
        if is_scalar_variant(names):
            v, _ = decode(row, i, fields[0], uni)
            return v, i + spec.width - 1
        d = {}
        j = i
        for nm, fs in zip(names, fields):
            d[nm], j = decode(row, j, fs, uni)
        return Fcn(d), i + spec.width - 1
    if k == "kvtable":
        n = int(row[i])
        i += 1
        d = {}
        for j in range(spec.cap):
            if j < n:
                kk, mid = decode(row, i, spec.elem, uni)
                vv, _ = decode(row, mid, spec.val, uni)
                d[kk] = vv
            i += spec.elem.width + spec.val.width
        return Fcn(d), i
    raise AssertionError(k)
