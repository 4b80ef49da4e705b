r"""SYMMETRY canonicalisation over encoded state rows, batch-first
(the port of jaxmc/compile/symmetry2.py).

Every cfg SYMMETRY permutation of model values induces an exact
transformation of the fixed-width lane encoding (compile/vspec.py):
enum lanes remap through a value table, function/set lanes permute
position-wise with the domain, and containers with a canonical internal
order (growset, kvtable) are re-sorted after the element remap.  The
canonical representative of a state row is the lexicographic minimum
of the row over the closed permutation group (sem/symmetry.py), which
gives the same orbit partition as the reference.

`build_canon2` returns a `Canon` holding the transform twice:

  twin(rows [N, W]) -> rows    the per-segment transforms of the
                               reference's `_seg_tf`, over [N, *]
                               tensors (the CPU path and the oracle);
  program                      the same transforms flattened into an
                               int32 table that the CUDA kernel K5
                               (kernels/csrc/canon.cu) interprets.

The program.  Every transform reads only the INPUT row: each output
lane of a permutation is the first of a list of alternatives whose
conditions all hold, an alternative being (conditions, source lane,
value table or not) and a condition (input lane, op, constant) with op
GT (`in[lane] > k`: the `j < n` count guard of seq, growset and
kvtable) or EQ (`in[lane] == k`: the pfcn present bit, the union tag).
A lane without alternatives is the input lane.  After the lanes, the
permutation's sort blocks re-sort growset and kvtable rows (stable, by
their first `kc` lanes, signed), inner blocks before outer ones, each
under its own conditions.  Blob layout (int32), offsets in words:

  header[16]   P, U, W, off_pl, off_lops, off_alts, off_conds, off_ps,
               off_sorts, off_tabs, total, 0...
  pl[P+1]      lane-op range of each permutation
  lops[L, 3]   (out lane, first alternative, number of alternatives)
  alts[A, 4]   (source lane, use value table, first condition, number)
  conds[C, 3]  (input lane, op, k)
  ps[P+1]      sort-block range of each permutation
  sorts[S, 6]  (offset, rows, row width, key lanes, first cond, number)
  tabs[P, U]   each permutation's enum value table (identity if none)

Encodings that cannot be permuted exactly raise CompileError with the
reference's text; the engine then runs unreduced with its SYMMETRY
warning, as the reference's does.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .vspec import VS, EnumUniverse, SENTINEL_LANE, CompileError

SENTINEL = SENTINEL_LANE
GT, EQ = 0, 1
HEADER = 16

Cond = Tuple[int, int, int]


def _hk(k):
    from .vspec import _hk as h
    return h(k)


def _value_table(pd: Dict, uni: EnumUniverse) -> Optional[np.ndarray]:
    """Index remap table over the enum universe for permutation pd, or
    None when pd fixes every universe member (identity on enum lanes)."""
    n = len(uni)
    tab = np.arange(n, dtype=np.int32)
    changed = False
    for i, v in enumerate(uni.values):
        w = pd.get(v, v)
        if w is not v:
            try:
                tab[i] = uni.index(w)
            except CompileError:
                raise CompileError(
                    f"symmetry image {w} not in the layout's enum "
                    f"universe - deepen layout sampling")
            changed = True
    return tab if changed else None


def _lex_sort_rows(m: torch.Tensor, key_cols: int) -> torch.Tensor:
    """Stable lexicographic sort of the rows of each m[n] ([N, c, w]) by
    the first key_cols columns (LSD: chained single-key stable sorts).
    SENTINEL padding rows sort last (SENTINEL is the int32 maximum)."""
    for c in reversed(range(key_cols)):
        idx = torch.sort(m[:, :, c], dim=1, stable=True).indices
        m = torch.gather(m, 1, idx[:, :, None].expand_as(m))
    return m


def _on(cache: Dict, arr: np.ndarray, dev) -> torch.Tensor:
    t = cache.get(dev)
    if t is None:
        t = cache[dev] = torch.as_tensor(arr, device=dev)
    return t


class _Prog:
    """One permutation's program while it is being emitted."""

    def __init__(self):
        self.alts: Dict[int, List[Tuple[Tuple[Cond, ...], int, int]]] = {}
        self.sorts: List[Tuple[int, int, int, int, Tuple[Cond, ...]]] = []

    def put(self, out: int, conds, src: int, tab: int = 0) -> None:
        self.alts.setdefault(out, []).append((tuple(conds), src, tab))

    def copy(self, in_off: int, out_off: int, width: int, conds) -> None:
        for lane in range(width):
            self.put(out_off + lane, conds, in_off + lane)


class _Tf:
    """A segment's transform: `fn` over [N, width] tensors (the twin)
    and `emit(prog, in_off, out_off, conds)` (the program)."""
    __slots__ = ("fn", "emit")

    def __init__(self, fn: Callable, emit: Callable):
        self.fn = fn
        self.emit = emit


def _seg_tf(spec: VS, pd: Dict, uni: EnumUniverse,
            tab: Optional[np.ndarray]) -> Optional[_Tf]:
    """Transform for one encoded segment (length spec.width) under pd.
    Returns None when the transform is the identity (common: int lanes,
    domains untouched by pd). Raises CompileError when the encoding
    cannot be permuted exactly."""
    k = spec.kind
    if k in ("justempty", "int", "bool"):
        return None
    if k == "enum":
        if tab is None:
            return None
        cache: Dict = {}
        n_tab = len(tab)

        def enum_fn(seg):
            v = seg[:, 0]
            jt = _on(cache, tab, seg.device)
            out = torch.where(v == SENTINEL, v,
                              jt[v.clamp(0, n_tab - 1).to(torch.int64)])
            return out[:, None]

        def enum_emit(P, i0, o0, conds):
            P.put(o0, conds, i0, 1)
        return _Tf(enum_fn, enum_emit)

    if k == "fcn":
        # new[key] = old[pd^-1(key)]: position i takes the segment of the
        # source key, itself element-transformed
        inv = {_hk(v): kk for kk, v in pd.items()}
        pos = {_hk(kk): i for i, kk in enumerate(spec.dom)}
        offs = np.cumsum([0] + [e.width for e in spec.elems])
        src_idx, sub_tfs, moved = [], [], False
        for i, kk in enumerate(spec.dom):
            src = inv.get(_hk(kk), kk)
            j = pos.get(_hk(src))
            if j is None:
                raise CompileError(
                    f"symmetry moves {src} outside the function domain "
                    f"{spec.dom}")
            if spec.elems[j] != spec.elems[i]:
                raise CompileError(
                    "heterogeneous function-value specs within one "
                    "symmetry orbit")
            src_idx.append(j)
            moved = moved or j != i
            sub_tfs.append(_seg_tf(spec.elems[j], pd, uni, tab))
        if not moved and all(t is None for t in sub_tfs):
            return None

        def fcn_fn(seg):
            parts = []
            for i, j in enumerate(src_idx):
                sub = seg[:, offs[j]:offs[j + 1]]
                parts.append(sub if sub_tfs[i] is None
                             else sub_tfs[i].fn(sub))
            return torch.cat(parts, dim=1) if parts else seg

        def fcn_emit(P, i0, o0, conds):
            for i, j in enumerate(src_idx):
                if sub_tfs[i] is None:
                    P.copy(i0 + offs[j], o0 + offs[i],
                           offs[j + 1] - offs[j], conds)
                else:
                    sub_tfs[i].emit(P, i0 + offs[j], o0 + offs[i], conds)
        return _Tf(fcn_fn, fcn_emit)

    if k == "set":
        inv = {_hk(v): kk for kk, v in pd.items()}
        pos = {_hk(m): i for i, m in enumerate(spec.dom)}
        src_idx = []
        for i, m in enumerate(spec.dom):
            src = inv.get(_hk(m), m)
            j = pos.get(_hk(src))
            if j is None:
                raise CompileError(
                    f"symmetry moves {src} outside the set universe "
                    f"{spec.dom}")
            src_idx.append(j)
        if src_idx == list(range(len(spec.dom))):
            return None
        gidx = np.asarray(src_idx, np.int64)
        cache = {}

        def set_fn(seg):
            return seg[:, _on(cache, gidx, seg.device)]

        def set_emit(P, i0, o0, conds):
            for i, j in enumerate(src_idx):
                P.put(o0 + i, conds, i0 + j)
        return _Tf(set_fn, set_emit)

    if k == "seq":
        sub = _seg_tf(spec.elem, pd, uni, tab)
        if sub is None:
            return None
        ew = spec.elem.width

        def seq_fn(seg):
            n = seg[:, :1]
            parts = [seg[:, :1]]
            for j in range(spec.cap):
                s = seg[:, 1 + j * ew:1 + (j + 1) * ew]
                # zero padding beyond the length lane must NOT remap
                parts.append(torch.where(j < n, sub.fn(s), s))
            return torch.cat(parts, dim=1)

        def seq_emit(P, i0, o0, conds):
            P.copy(i0, o0, 1, conds)
            for j in range(spec.cap):
                b = 1 + j * ew
                sub.emit(P, i0 + b, o0 + b, list(conds) + [(i0, GT, j)])
                P.copy(i0 + b, o0 + b, ew, conds)
        return _Tf(seq_fn, seq_emit)

    if k == "growset":
        sub = _seg_tf(spec.elem, pd, uni, tab)
        if sub is None:
            return None  # remap is identity => sorted order unchanged
        ew = spec.elem.width

        def growset_fn(seg):
            n = seg[:, :1]
            parts = []
            for j in range(spec.cap):
                s = seg[:, 1 + j * ew:1 + (j + 1) * ew]
                # SENTINEL padding beyond the count must NOT remap
                parts.append(torch.where(j < n, sub.fn(s), s))
            m = torch.cat(parts, dim=1).reshape(-1, spec.cap, ew)
            m = _lex_sort_rows(m, ew)
            return torch.cat([seg[:, :1], m.reshape(-1, spec.cap * ew)],
                             dim=1)

        def growset_emit(P, i0, o0, conds):
            P.copy(i0, o0, 1, conds)
            for j in range(spec.cap):
                b = 1 + j * ew
                sub.emit(P, i0 + b, o0 + b, list(conds) + [(i0, GT, j)])
                P.copy(i0 + b, o0 + b, ew, conds)
            P.sorts.append((o0 + 1, spec.cap, ew, ew, tuple(conds)))
        return _Tf(growset_fn, growset_emit)

    if k == "pfcn":
        inv = {_hk(v): kk for kk, v in pd.items()}
        pos = {_hk(kk): i for i, kk in enumerate(spec.dom)}
        offs = np.cumsum([0] + [1 + e.width for e in spec.elems])
        src_idx, sub_tfs, moved = [], [], False
        for i, kk in enumerate(spec.dom):
            src = inv.get(_hk(kk), kk)
            j = pos.get(_hk(src))
            if j is None:
                raise CompileError(
                    f"symmetry moves {src} outside the pfcn universe")
            if spec.elems[j] != spec.elems[i]:
                raise CompileError(
                    "heterogeneous pfcn value specs within one symmetry "
                    "orbit")
            src_idx.append(j)
            moved = moved or j != i
            sub_tfs.append(_seg_tf(spec.elems[j], pd, uni, tab))
        if not moved and all(t is None for t in sub_tfs):
            return None

        def pfcn_fn(seg):
            parts = []
            for i, j in enumerate(src_idx):
                blk = seg[:, offs[j]:offs[j + 1]]
                bit, val = blk[:, :1], blk[:, 1:]
                if sub_tfs[i] is not None:
                    # absent entries are zero-padded: remap only present
                    val = torch.where(bit == 1, sub_tfs[i].fn(val), val)
                parts.append(torch.cat([bit, val], dim=1))
            return torch.cat(parts, dim=1)

        def pfcn_emit(P, i0, o0, conds):
            for i, j in enumerate(src_idx):
                bi, bo = i0 + offs[j], o0 + offs[i]
                width = offs[j + 1] - offs[j]
                if sub_tfs[i] is not None:
                    P.copy(bi, bo, 1, conds)
                    sub_tfs[i].emit(P, bi + 1, bo + 1,
                                    list(conds) + [(bi, EQ, 1)])
                P.copy(bi, bo, width, conds)
        return _Tf(pfcn_fn, pfcn_emit)

    if k == "union":
        var_tfs = []
        any_tf = False
        pw = spec.width - 1
        for _vnames, vfields in spec.variants:
            offs = np.cumsum([0] + [f.width for f in vfields])
            subs = [_seg_tf(f, pd, uni, tab) for f in vfields]
            if any(s is not None for s in subs):
                any_tf = True
            var_tfs.append((offs, subs))
        if not any_tf:
            return None

        def vtf(seg, offs, subs):
            parts = []
            for i, s in enumerate(subs):
                fld = seg[:, offs[i]:offs[i + 1]]
                parts.append(fld if s is None else s.fn(fld))
            parts.append(seg[:, offs[-1]:])  # zero tail padding
            return torch.cat(parts, dim=1)

        def union_fn(seg):
            tag, payload = seg[:, :1], seg[:, 1:]
            out = payload
            for t, (offs, subs) in enumerate(var_tfs):
                out = torch.where(tag == t, vtf(payload, offs, subs), out)
            return torch.cat([seg[:, :1], out], dim=1)

        def union_emit(P, i0, o0, conds):
            P.copy(i0, o0, 1, conds)
            for t, (offs, subs) in enumerate(var_tfs):
                ct = list(conds) + [(i0, EQ, t)]
                for i, s in enumerate(subs):
                    if s is not None:
                        s.emit(P, i0 + 1 + offs[i], o0 + 1 + offs[i], ct)
            # fields without a transform, the tail padding and unknown
            # tags keep their lanes
            P.copy(i0 + 1, o0 + 1, pw, conds)
        return _Tf(union_fn, union_emit)

    if k == "kvtable":
        ksub = _seg_tf(spec.elem, pd, uni, tab)
        vsub = _seg_tf(spec.val, pd, uni, tab)
        if ksub is None and vsub is None:
            return None
        kw, vw = spec.elem.width, spec.val.width
        rw = kw + vw

        def kv_fn(seg):
            n = seg[:, :1]
            parts = []
            for j in range(spec.cap):
                blk = seg[:, 1 + j * rw:1 + (j + 1) * rw]
                kb, vb = blk[:, :kw], blk[:, kw:]
                nk = kb if ksub is None else ksub.fn(kb)
                nv = vb if vsub is None else vsub.fn(vb)
                nb = torch.cat([nk, nv], dim=1)
                # SENTINEL padding rows must NOT remap
                parts.append(torch.where(j < n, nb, blk))
            m = torch.cat(parts, dim=1).reshape(-1, spec.cap, rw)
            # encode sorts rows by the key lanes (keys unique, so the
            # stable key-only sort is deterministic)
            m = _lex_sort_rows(m, kw)
            return torch.cat([seg[:, :1], m.reshape(-1, spec.cap * rw)],
                             dim=1)

        def kv_emit(P, i0, o0, conds):
            P.copy(i0, o0, 1, conds)
            for j in range(spec.cap):
                b = 1 + j * rw
                cj = list(conds) + [(i0, GT, j)]
                if ksub is not None:
                    ksub.emit(P, i0 + b, o0 + b, cj)
                if vsub is not None:
                    vsub.emit(P, i0 + b + kw, o0 + b + kw, cj)
                P.copy(i0 + b, o0 + b, rw, conds)
            P.sorts.append((o0 + 1, spec.cap, rw, kw, tuple(conds)))
        return _Tf(kv_fn, kv_emit)

    raise AssertionError(k)


class Canon:
    """The orbit canonicaliser of one layout: `twin` (batch-first torch)
    and `program` (the int32 table kernel K5 interprets)."""

    def __init__(self, row_tfs: List[Callable], program: np.ndarray,
                 width: int):
        self.row_tfs = row_tfs
        self.program = program
        self.width = width
        self.n_perms = len(row_tfs)
        self._dev: Dict = {}

    def twin(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [N, W] int32 -> each row's lexicographic minimum over
        the group (signed int32 order, first differing lane decides)."""
        best = rows
        W = rows.shape[1]
        lanes = torch.arange(W, device=rows.device)
        for tf in self.row_tfs:
            cand = tf(rows)
            diff = cand != best
            first = torch.where(diff, lanes, W).min(dim=1).values
            at = first.clamp(max=W - 1)[:, None]
            lt = (first < W) & (cand.gather(1, at) <
                                best.gather(1, at))[:, 0]
            best = torch.where(lt[:, None], cand, best)
        return best

    def program_on(self, device) -> torch.Tensor:
        """The program as an int32 tensor on `device` (cached)."""
        return _on(self._dev, self.program, torch.device(device))


def _flatten(progs: List[_Prog], tabs: List[np.ndarray], U: int,
             W: int) -> np.ndarray:
    """The per-permutation programs as one int32 blob (layout in the
    module docstring)."""
    pl, lops, alts, conds = [0], [], [], []
    ps, sorts = [0], []

    def add_conds(cs):
        start = len(conds)
        conds.extend(cs)
        return start, len(cs)

    for P in progs:
        for out in sorted(P.alts):
            lst = P.alts[out]
            # alternatives after the first unconditional one never win,
            # and a trailing unconditional copy of the lane itself is
            # what an unlisted lane gets anyway
            for i, (cs, _s, _t) in enumerate(lst):
                if not cs:
                    lst = lst[:i + 1]
                    break
            if lst and not lst[-1][0] and lst[-1][1:] == (out, 0):
                lst = lst[:-1]
            if not lst:
                continue
            a0 = len(alts)
            for cs, src, tab in lst:
                c0, nc = add_conds(cs)
                alts.append((src, tab, c0, nc))
            lops.append((out, a0, len(lst)))
        pl.append(len(lops))
        for off, rows, rw, kc, cs in P.sorts:
            c0, nc = add_conds(cs)
            sorts.append((off, rows, rw, kc, c0, nc))
        ps.append(len(sorts))
    for src, _tab, _c0, _nc in alts:
        assert 0 <= src < W
    for lane, _op, _k in conds:
        assert 0 <= lane < W
    for off, rows, rw, _kc, _c0, _nc in sorts:
        assert 0 <= off and off + rows * rw <= W
    parts = [np.asarray(pl, np.int32),
             np.asarray(lops, np.int32).reshape(-1),
             np.asarray(alts, np.int32).reshape(-1),
             np.asarray(conds, np.int32).reshape(-1),
             np.asarray(ps, np.int32),
             np.asarray(sorts, np.int32).reshape(-1),
             np.concatenate(tabs).astype(np.int32) if U else
             np.zeros(0, np.int32)]
    offs = np.cumsum([HEADER] + [len(p) for p in parts])
    header = np.zeros(HEADER, np.int32)
    header[:11] = [len(progs), U, W] + list(offs[:7]) + [offs[7]]
    return np.concatenate([header] + parts).astype(np.int32)


def build_canon2(model, layout) -> Optional[Canon]:
    """The canonicaliser over encoded rows: each row replaced by the
    lexicographic minimum of its symmetry orbit.  None when the model
    declares no (non-identity) symmetry.  Raises CompileError when some
    lane encoding cannot be permuted."""
    from ..sem.symmetry import symmetry_group
    perms = symmetry_group(model)
    if not perms:
        return None
    # the reference's compile-time guard, kept with its text so both
    # packages reduce the same models: the reference unrolls one
    # transform per non-identity group element into every jitted kernel
    # (a 5-6 element set closes to 119-719 of them).  Above the limit
    # the search runs unreduced and the caller reports the SYMMETRY
    # warning.
    limit = int(os.environ.get("JAXMC_SYM_GROUP_LIMIT", "64"))
    if len(perms) > limit:
        raise CompileError(
            f"symmetry group has {len(perms)} non-identity elements "
            f"(> {limit}): device canonicalization would unroll that "
            f"many transforms into every kernel; falling back to the "
            f"unreduced search (set JAXMC_SYM_GROUP_LIMIT to raise)")

    row_tfs, progs, tabs = [], [], []
    widths = [layout.specs[v].width for v in layout.vars]
    offs = np.cumsum([0] + widths)
    U = len(layout.uni)
    for pd in perms:
        tab = _value_table(pd, layout.uni)
        seg_tfs = [_seg_tf(layout.specs[v], pd, layout.uni, tab)
                   for v in layout.vars]
        if all(t is None for t in seg_tfs):
            continue  # permutation fixes every lane

        def row_tf(rows, seg_tfs=seg_tfs):
            parts = []
            for i, t in enumerate(seg_tfs):
                seg = rows[:, offs[i]:offs[i + 1]]
                parts.append(seg if t is None else t.fn(seg))
            return torch.cat(parts, dim=1)
        row_tfs.append(row_tf)
        P = _Prog()
        for i, t in enumerate(seg_tfs):
            if t is not None:
                t.emit(P, int(offs[i]), int(offs[i]), [])
        progs.append(P)
        tabs.append(tab if tab is not None else np.arange(U, dtype=np.int32))
    if not row_tfs:
        return None
    return Canon(row_tfs, _flatten(progs, tabs, U, layout.width),
                 layout.width)
