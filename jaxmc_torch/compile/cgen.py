"""Graph -> CUDA C++: the generated transition kernels K15-K17.

Each compiled unit of an engine (every grounded action instance, slot
by slot; every invariant and constraint; the VIEW) is captured once by
compile/trace.py and written here as one `__device__` row function over
a state row `x[W]` and the lifted constants `c[L]`, writing its outputs
to `o[]`.  Every graph node is a per-row local array of its static
size; loops over static extents are unrolled up to UNROLL elements and
stay loops above that; constants are literals, or `__device__ const`
tables where a loop or a traced index reads them.  Arithmetic is done
in uint32_t and cast back, so int32 wrap is defined; floor `//` and `%`
are helpers with the lanes rules (a zero divisor gives 0, INT_MIN // -1
wraps to INT_MIN); traced gather indices clamp into range; `sum`
accumulates in uint32_t (the low 32 bits of the int64 sum).

One source per engine holds every unit and three kernels:

  jmc_gen_expand  K15  a block stages a tile of T frontier rows in
                       shared memory once and runs a group of instances
                       of units[] over it, one thread a row; each
                       instance's [T, W] successors are staged and
                       written as one run (16-byte stores), en and aok
                       4 bytes at a time, into the [A, N] / [A, N, W]
                       outputs in the engine's instance order
  jmc_gen_pred    K16  one predicate (`which`) over N rows -> ok [N]
  jmc_gen_value   K17  the VIEW over N rows -> [N, VW] int32

each with a C entry point taking pointers, sizes and the stream.  The
lifted constants are a table cv [M, L], one row per batch member: row
n of the block reads cv[n / per], per = N / M (M = 1 broadcasts).  The
same source compiles as plain C++17 (g++), where `__device__` is
defined away and `jmc_gen_*_host` loop over the rows instead: the CPU
tests run the very row functions that nvcc compiles, and K15's host
entry runs the kernel's tile schedule and staging code block by block.
That host build is a test harness, never a path of the port.  The
source is deterministic: the same model gives the same bytes.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import trace as tr

UNROLL = 32
# runs of a static data movement above which it reads index tables
MAX_RUNS = 64
# K15's tile: the shared memory a block's staging aims at, and the most
# a block can have on the card (227 KB)
TILE_SMEM = 24 * 1024
SMEM_MAX = 232448


def tile_bytes(W: int, T: int) -> int:
    """Shared memory of K15's tile of T rows of W lanes: the rows and
    one instance's successors at the odd stride W | 1, en and aok."""
    return T * (8 * (W | 1) + 2)


def tile_rows(W: int) -> int:
    """K15's rows a block: the largest power of two T <= 256 whose tile
    fits TILE_SMEM, else 1 when one row's fits SMEM_MAX, else 0 (rows
    too wide to stage: the kernel then writes each output where its
    thread stands)."""
    T = 256
    while T > 1 and tile_bytes(W, T) > TILE_SMEM:
        T //= 2
    if tile_bytes(W, T) <= TILE_SMEM:
        return T
    return 1 if tile_bytes(W, 1) <= SMEM_MAX else 0


class GenError(RuntimeError):
    """A unit the generator cannot translate, or a failed build: names
    the unit.  Never a CompileError, so nothing demotes it away."""


# ---------------------------------------------------------------------------
# one unit
# ---------------------------------------------------------------------------

def _lit(v: int) -> str:
    v = int(v)
    if v == -2**31:
        return "(-2147483647 - 1)"
    return f"({v})" if v < 0 else str(v)


def _arr(vals) -> str:
    return "{" + ", ".join(_lit(v) for v in np.asarray(vals).reshape(-1)) \
        + "}"


def _affine(a: np.ndarray) -> Optional[Tuple[int, ...]]:
    """(a0, s0, s1, ...) when a[i, j, ...] = a0 + i*s0 + j*s1 ...,
    else None."""
    a = np.asarray(a, np.int64)
    if a.size == 0:
        return None
    a0 = int(a.reshape(-1)[0])
    strides = []
    for ax in range(a.ndim):
        if a.shape[ax] > 1:
            sl = [0] * a.ndim
            sl[ax] = 1
            strides.append(int(a[tuple(sl)]) - a0)
        else:
            strides.append(0)
    grid = np.indices(a.shape).reshape(a.ndim, -1)
    want = a0 + (np.asarray(strides, np.int64)[:, None] * grid).sum(0)
    if np.array_equal(want, a.reshape(-1)):
        return (a0,) + tuple(strides)
    return None


class _UnitWriter:
    """C++ of one captured unit: its tables (file scope) and its row
    function."""

    def __init__(self, u: int, cap: tr.Captured, label: str):
        self.u, self.cap, self.label = u, cap, label
        self.tables: List[str] = []
        self.body: List[str] = []
        self._tabs: Dict[Any, str] = {}

    # ---- references ----
    def table(self, key, vals) -> str:
        name = self._tabs.get(key)
        if name is None:
            name = f"jmc_t{self.u}_{len(self._tabs)}"
            vals = np.asarray(vals, np.int64).reshape(-1)
            self.tables.append(f"JMC_CONST int32_t {name}[{max(len(vals), 1)}]"
                               f" = {_arr(vals) if len(vals) else '{0}'};")
            self._tabs[key] = name
        return name

    def ref(self, node: tr.Node, idx) -> str:
        """Element idx (an int, or a C expression) of node."""
        if node.op == "const":
            if isinstance(idx, (int, np.integer)):
                return _lit(node.par[int(idx)])
            return f"{self.table(('c', node.id), node.par)}[{idx}]"
        return f"n{node.id}[{idx}]"

    def oper(self, r, k) -> str:
        """An ew operand at element k (int or C expression)."""
        if isinstance(r, int):
            return _lit(r)
        node, off, step = r
        if step == 0:
            return self.ref(node, off)
        if isinstance(k, int):
            return self.ref(node, off + k)
        return self.ref(node, f"{off} + {k}" if off else k)

    # ---- nodes ----
    def emit(self, n: tr.Node):
        w = self.body.append
        if n.op == "const":
            return                       # read as literals or tables
        w(f"  int32_t n{n.id}[{max(n.size, 1)}];")
        if n.op == "in":
            self.loop(n.size, lambda k: f"n{n.id}[{k}] = x[{k}];")
        elif n.op == "cin":
            w(f"  n{n.id}[0] = c[{n.par}];")
        elif n.op == "ew":
            self.ew(n)
        elif n.op == "sel":
            self.sel(n)
        elif n.op == "red":
            self.red(n)
        elif n.op == "gat":
            self.gat(n)
        else:
            raise GenError(f"node op {n.op}")

    def loop(self, size: int, stmt: Callable[[Any], str]):
        if size <= UNROLL:
            for k in range(size):
                self.body.append("  " + stmt(k))
        else:
            self.body.append(f"  for (int k = 0; k < {size}; ++k) "
                             + stmt("k"))

    def ew(self, n: tr.Node):
        fn, dts = n.par
        args = n.args

        def expr(k):
            a = [self.oper(r, k) for r in args]
            if fn in ("add", "sub", "mul", "max", "min", "fdiv", "fmod",
                      "pow"):
                e = f"j{fn}({a[0]}, {a[1]})"
            elif fn in ("lt", "le", "gt", "ge", "eq", "ne"):
                op = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
                      "eq": "==", "ne": "!="}[fn]
                e = f"(int32_t)({a[0]} {op} {a[1]})"
            elif fn in ("and", "or", "xor"):
                op = {"and": "&", "or": "|", "xor": "^"}[fn]
                e = f"({a[0]} {op} {a[1]})"
            elif fn == "land":
                e = f"(int32_t)(({a[0]} != 0) & ({a[1]} != 0))"
            elif fn == "lor":
                e = f"(int32_t)(({a[0]} != 0) | ({a[1]} != 0))"
            elif fn == "where":
                e = f"({a[0]} != 0 ? {a[1]} : {a[2]})"
            elif fn == "neg":
                e = f"jneg({a[0]})"
            elif fn == "bnot":
                e = f"(int32_t)({a[0]} == 0)" if dts[0] == tr.BOOL \
                    else f"(~{a[0]})"
            elif fn in ("lnot",):
                e = f"(int32_t)({a[0]} == 0)"
            elif fn == "tob":
                e = f"(int32_t)({a[0]} != 0)"
            elif fn == "toi":
                e = a[0]
            elif fn == "clamp":
                e = f"jmin(jmax({a[0]}, {a[1]}), {a[2]})"
            else:
                raise GenError(f"elementwise {fn}")
            if n.dt == tr.BOOL and fn in ("add", "sub", "mul", "neg", "pow",
                                          "fdiv", "fmod", "clamp"):
                e = f"(int32_t)({e} != 0)"
            return e

        self.loop(n.size, lambda k: f"n{n.id}[{k}] = {expr(k)};")

    def sel(self, n: tr.Node):
        sid, idx = n.par
        srcs = n.args
        if n.size <= UNROLL:
            for k in range(n.size):
                self.body.append(f"  n{n.id}[{k}] = "
                                 f"{self.ref(srcs[sid[k]], int(idx[k]))};")
            return
        runs = []                        # (k0, length, src, i0, stride)
        k = 0
        while k < n.size:
            s, i0 = int(sid[k]), int(idx[k])
            ln, st = 1, 0
            if k + 1 < n.size and sid[k + 1] == s:
                st = int(idx[k + 1]) - i0
                while k + ln < n.size and sid[k + ln] == s and \
                        int(idx[k + ln]) == i0 + ln * st:
                    ln += 1
            runs.append((k, ln, s, i0, st))
            k += ln
        if len(runs) <= MAX_RUNS:
            for k0, ln, s, i0, st in runs:
                if ln <= 4:
                    for t in range(ln):
                        self.body.append(
                            f"  n{n.id}[{k0 + t}] = "
                            f"{self.ref(srcs[s], i0 + t * st)};")
                else:
                    ie = f"{i0} + t * {st}" if st else str(i0)
                    self.body.append(
                        f"  for (int t = 0; t < {ln}; ++t) n{n.id}"
                        f"[{k0} + t] = {self.ref(srcs[s], ie)};")
            return
        for s, src in enumerate(srcs):
            ks = np.nonzero(sid == s)[0]
            tk = self.table(("sk", n.id, s), ks)
            ti = self.table(("si", n.id, s), idx[ks])
            self.body.append(
                f"  for (int t = 0; t < {len(ks)}; ++t) n{n.id}[{tk}[t]] = "
                f"{self.ref(src, f'{ti}[t]')};")

    def red(self, n: tr.Node):
        fn, mat = n.par
        src = n.args[0]
        J, L = mat.shape
        w = self.body.append
        if L == 0:
            init = {"all": 1, "any": 0, "sum": 0, "argmax": 0}[fn]
            self.loop(J, lambda k: f"n{n.id}[{k}] = {init};")
            return
        if J * L <= 2 * UNROLL:
            for j in range(J):
                vs = [self.ref(src, int(i)) for i in mat[j]]
                if fn == "all":
                    e = " & ".join(f"({v} != 0)" for v in vs)
                    w(f"  n{n.id}[{j}] = (int32_t)({e});")
                elif fn == "any":
                    e = " | ".join(f"({v} != 0)" for v in vs)
                    w(f"  n{n.id}[{j}] = (int32_t)({e});")
                elif fn == "sum":
                    e = " + ".join(f"(uint32_t){v}" for v in vs)
                    w(f"  n{n.id}[{j}] = (int32_t)({e});")
                else:
                    w(f"  {{ int32_t b = {vs[0]}, bi = 0;")
                    for t in range(1, L):
                        w(f"    if ({vs[t]} > b) {{ b = {vs[t]}; bi = {t}; }}")
                    w(f"    n{n.id}[{j}] = bi; }}")
            return
        aff = _affine(mat)
        if aff is not None:
            a0, sj, st = aff
            iexp = f"{a0} + j * {sj} + t * {st}"
        else:
            iexp = f"{self.table(('r', n.id), mat)}[j * {L} + t]"
        v = self.ref(src, iexp)
        w(f"  for (int j = 0; j < {J}; ++j) {{")
        if fn in ("all", "any", "sum"):
            init = {"all": "1u", "any": "0u", "sum": "0u"}[fn]
            upd = {"all": f"a &= (uint32_t)({v} != 0);",
                   "any": f"a |= (uint32_t)({v} != 0);",
                   "sum": f"a += (uint32_t){v};"}[fn]
            w(f"    uint32_t a = {init};")
            w(f"    for (int t = 0; t < {L}; ++t) {upd}")
            w(f"    n{n.id}[j] = (int32_t)a;")
        else:
            v0 = self.ref(src, iexp.replace("t * ", "0 * ")
                          if aff is not None else
                          f"{self.table(('r', n.id), mat)}[j * {L}]")
            w(f"    int32_t b = {v0}, bi = 0;")
            w(f"    for (int t = 1; t < {L}; ++t) {{ int32_t y = {v}; "
              f"if (y > b) {{ b = y; bi = t; }} }}")
            w(f"    n{n.id}[j] = bi;")
        w("  }")

    def gat(self, n: tr.Node):
        ixpos, xoff, S, hi = n.par
        x, ix = n.args

        def el(ie, oe):
            c = f"jmin(jmax({self.ref(ix, ie)}, 0), {hi})"
            return self.ref(x, f"{c} * {S} + {oe}" if S != 1
                            else f"{c} + {oe}")

        if n.size <= UNROLL:
            for k in range(n.size):
                self.body.append(f"  n{n.id}[{k}] = "
                                 f"{el(int(ixpos[k]), int(xoff[k]))};")
            return
        ap, ao = _affine(ixpos), _affine(xoff)
        if ap is not None and ao is not None:
            ie = f"{ap[0]} + k * {ap[1]}" if ap[1] else str(ap[0])
            oe = f"{ao[0]} + k * {ao[1]}" if ao[1] else str(ao[0])
        else:
            ie = f"{self.table(('gp', n.id), ixpos)}[k]"
            oe = f"{self.table(('go', n.id), xoff)}[k]"
        self.body.append(f"  for (int k = 0; k < {n.size}; ++k) "
                         f"n{n.id}[k] = {el(ie, oe)};")

    # ---- the function ----
    def write(self) -> str:
        outs = self.cap.outs
        for nd in _live(self.cap):
            self.emit(nd)
        pos = 0
        for o in outs:
            size = o.size
            p0 = pos
            if o.node.op == "const":
                vals = o.node.par[o.off:o.off + size]
                for k in range(size):
                    self.body.append(f"  o[{p0 + k}] = {_lit(vals[k])};")
            else:
                self.loop(size, lambda k, p0=p0, o=o: (
                    f"o[{p0} + {k}] = "
                    f"{self.ref(o.node, f'{o.off} + {k}')};"
                    if isinstance(k, str) else
                    f"o[{p0 + k}] = {self.ref(o.node, o.off + k)};"))
            pos += size
        head = (f"// unit {self.u}: {' '.join(self.label.split())}\n"
                f"JMC_FN void jmc_u{self.u}(const int32_t* __restrict__ x, "
                f"const int32_t* __restrict__ c, int32_t* __restrict__ o) "
                f"{{\n  (void)x; (void)c;")
        return "\n".join(self.tables + [head] + self.body + ["}"]) + "\n"


# ---------------------------------------------------------------------------
# the source of an engine
# ---------------------------------------------------------------------------

PRELUDE = r"""// Generated by compile/cgen.py: the transition kernels of one
// engine (K15 gen_expand, K16 gen_pred, K17 gen_value).  Replaces the
// reference's jax.vmap of compile_action2 / compile_predicate2 /
// compile_value2 (jaxmc/compile/kernel2.py:2464, :2792, :2762).  Bound by
// bytes: the rows read once, every output written once.  K15 stages a
// tile of rows and each instance's successor tile in shared memory, so
// both move in whole 16-byte runs.
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define JMC_FN static __device__ __forceinline__
#define JMC_CONST static __device__ const
#else
#define JMC_FN static inline
#define JMC_CONST static const
#endif

JMC_FN int32_t jadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
JMC_FN int32_t jsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
JMC_FN int32_t jmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
JMC_FN int32_t jneg(int32_t a) { return (int32_t)(0u - (uint32_t)a); }
JMC_FN int32_t jmax(int32_t a, int32_t b) { return a > b ? a : b; }
JMC_FN int32_t jmin(int32_t a, int32_t b) { return a < b ? a : b; }
// floor division and modulo; a zero divisor gives 0, INT_MIN // -1 wraps
JMC_FN int32_t jfdiv(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return jneg(a);
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
JMC_FN int32_t jfmod(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// torch's integer pow: negative exponents give 0 but for bases 1 and -1
JMC_FN int32_t jpow(int32_t a, int32_t b) {
  if (b < 0) {
    if (a == 1) return 1;
    if (a == -1) return (b & 1) ? -1 : 1;
    return 0;
  }
  uint32_t r = 1u, x = (uint32_t)a, e = (uint32_t)b;
  while (e) {
    if (e & 1u) r *= x;
    e >>= 1;
    x *= x;
  }
  return (int32_t)r;
}
"""


def _live(cap: tr.Captured) -> List[tr.Node]:
    """The nodes the unit's outputs depend on, in graph order (dead
    nodes of the capture are not written)."""
    live, stack = set(), [o.node for o in cap.outs]
    while stack:
        nd = stack.pop()
        if nd.id in live:
            continue
        live.add(nd.id)
        for a in nd.args:
            if isinstance(a, tr.Node):
                stack.append(a)
            elif isinstance(a, tuple):
                stack.append(a[0])
    return [nd for nd in cap.graph.nodes if nd.id in live]


class Unit:
    """One compiled unit: kind 'action' (outputs en, aok, ov, succ),
    'pred' (ok) or 'value' (view lanes), its label, its emitter call
    (the twin) and its capture."""

    def __init__(self, kind: str, label: str, fn: Callable, slot=None):
        self.kind, self.label, self.fn, self.slot = kind, label, fn, slot
        self.cap: Optional[tr.Captured] = None


def _check_outputs(u: Unit, W: int) -> int:
    """Validate a unit's outputs; returns its output width."""
    outs = u.cap.outs
    if u.kind == "action":
        sizes = [o.size for o in outs]
        if len(outs) != 4 or sizes[:3] != [1, 1, 1] or sizes[3] != W:
            raise GenError(f"action {u.label}: outputs of sizes {sizes}")
        return 3 + W
    if len(outs) != 1:
        raise GenError(f"{u.kind} {u.label}: {len(outs)} outputs")
    if u.kind == "pred":
        if outs[0].size != 1 or outs[0].dtype != torch.bool:
            raise GenError(f"predicate {u.label}: {outs[0].size} lanes "
                           f"of {outs[0].dtype}")
        return 1
    return outs[0].size


def generate(units: Sequence[Unit], W: int, L: int) -> Tuple[str, Dict]:
    """The engine's source and its layout: {'actions': [unit index],
    'preds': [...], 'value': unit index or None, 'VW': view width,
    'lines': [(first line, last line, label)], 'tile': K15's T}."""
    parts = [PRELUDE]
    meta: Dict[str, Any] = {"actions": [], "preds": [], "value": None,
                            "VW": 0, "lines": [], "tile": tile_rows(W)}
    for i, u in enumerate(units):
        ow = _check_outputs(u, W)
        first = sum(p.count("\n") + 1 for p in parts) + 1
        try:
            parts.append(_UnitWriter(i, u.cap, f"{u.kind} {u.label}")
                         .write())
        except Exception as ex:
            raise GenError(f"cannot generate {u.kind} {u.label}: "
                           f"{type(ex).__name__}: {ex}") from ex
        meta["lines"].append((first, first + parts[-1].count("\n"),
                              f"{u.kind} {u.label}"))
        if u.kind == "action":
            meta["actions"].append(i)
        elif u.kind == "pred":
            meta["preds"].append(i)
        else:
            meta["value"] = i
            meta["VW"] = ow
    parts.append(_kernels(meta, W, L))
    return "\n".join(parts), meta


def _kernels(meta, W: int, L: int) -> str:
    acts, preds, val = meta["actions"], meta["preds"], meta["value"]
    VW = meta["VW"]
    s = [f"#define JMC_W {W}", f"#define JMC_L {L}", ""]
    # K15
    s.append("JMC_FN void jmc_expand_one(int32_t unit, const int32_t* x, "
             "const int32_t* c, uint8_t* en, uint8_t* aok, int32_t* ov, "
             "int32_t* succ) {")
    s.append(f"  int32_t o[3 + JMC_W] = {{0}};")
    s.append("  switch (unit) {")
    for a, ui in enumerate(acts):
        s.append(f"    case {a}: jmc_u{ui}(x, c, o); break;")
    s.append("    default: break;")
    s.append("  }")
    s.append("  *en = (uint8_t)(o[0] != 0);")
    s.append("  *aok = (uint8_t)(o[1] != 0);")
    s.append("  *ov = o[2];")
    s.append("  for (int k = 0; k < JMC_W; ++k) succ[k] = o[3 + k];")
    s.append("}")
    # K16
    s.append("JMC_FN void jmc_pred_one(int32_t which, const int32_t* x, "
             "const int32_t* c, uint8_t* out, int64_t n) {")
    s.append("  int32_t o[1] = {0};")
    s.append("  switch (which) {")
    for p, ui in enumerate(preds):
        s.append(f"    case {p}: jmc_u{ui}(x, c, o); break;")
    s.append("    default: break;")
    s.append("  }")
    s.append("  out[n] = (uint8_t)(o[0] != 0);")
    s.append("}")
    # K17
    s.append(f"#define JMC_VW {max(VW, 1)}")
    s.append("JMC_FN void jmc_value_one(const int32_t* x, const int32_t* c, "
             "int32_t* out) {")
    if val is not None:
        s.append("  int32_t o[JMC_VW];")
        s.append(f"  jmc_u{val}(x, c, o);")
        s.append(f"  for (int k = 0; k < {VW}; ++k) out[k] = o[k];")
    else:
        s.append("  (void)x; (void)c; (void)out;")
    s.append("}")
    s.append(f"#define JMC_TILE {int(meta['tile'])}")
    s.append(f"#define JMC_WS {W | 1}")
    s.append(r"""
#if JMC_TILE
// K15's staged tile, shared by the kernel and the host build.  A block
// stages frontier rows [n0, n0 + nt) in shared memory at the odd row
// stride JMC_WS (lane k of neighbouring rows in different banks), runs
// each instance of its group over them with one thread a row, stages
// the successors at the same stride and writes the instance's [nt, W]
// successor run, en and aok whole.  Thread tid of nthr moves words
// tid, tid + nthr, ...; the 16-byte-aligned middle of a run moves in
// 16-byte accesses, en and aok in 4-byte stores.
#define JMC_SMEM_BYTES (2 * JMC_TILE * JMC_WS * 4 + 2 * JMC_TILE)
#ifdef __CUDACC__
typedef int4 jmc_v4;
JMC_FN jmc_v4 jmc_ld4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}
JMC_FN void jmc_st4(int32_t* p, jmc_v4 v) {
  *reinterpret_cast<int4*>(p) = v;
}
JMC_FN void jmc_st_u32(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
#else
#include <stdlib.h>
#include <string.h>
typedef struct { int32_t x, y, z, w; } jmc_v4;
JMC_FN jmc_v4 jmc_ld4(const int32_t* p) {
  jmc_v4 v;
  memcpy(&v, p, 16);
  return v;
}
JMC_FN void jmc_st4(int32_t* p, jmc_v4 v) { memcpy(p, &v, 16); }
JMC_FN void jmc_st_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
#endif
// the words before p's first 16-byte boundary, at most nw
JMC_FN int jmc_head4(const int32_t* p, int nw) {
  const int h = (int)((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) >> 2;
  return h < nw ? h : nw;
}
// s[(i / JMC_W) * JMC_WS + i % JMC_W] = g[i] for i in [0, nw)
JMC_FN void jmc_tile_in(int tid, int nthr, const int32_t* __restrict__ g,
                        int nw, int32_t* __restrict__ s) {
  const int h = jmc_head4(g, nw), nv = (nw - h) >> 2;
  for (int i = tid; i < h; i += nthr)
    s[(i / JMC_W) * JMC_WS + i % JMC_W] = g[i];
  for (int v = tid; v < nv; v += nthr) {
    const jmc_v4 q = jmc_ld4(g + h + 4 * v);
    const int32_t e[4] = {q.x, q.y, q.z, q.w};
    const int i = h + 4 * v;
    int r = i / JMC_W, l = i % JMC_W;
    for (int k = 0; k < 4; ++k) {
      s[r * JMC_WS + l] = e[k];
      if (++l == JMC_W) {
        l = 0;
        ++r;
      }
    }
  }
  for (int i = h + 4 * nv + tid; i < nw; i += nthr)
    s[(i / JMC_W) * JMC_WS + i % JMC_W] = g[i];
}
// g[i] = s[(i / JMC_W) * JMC_WS + i % JMC_W] for i in [0, nw)
JMC_FN void jmc_tile_out(int tid, int nthr, const int32_t* __restrict__ s,
                         int nw, int32_t* __restrict__ g) {
  const int h = jmc_head4(g, nw), nv = (nw - h) >> 2;
  for (int i = tid; i < h; i += nthr)
    g[i] = s[(i / JMC_W) * JMC_WS + i % JMC_W];
  for (int v = tid; v < nv; v += nthr) {
    const int i = h + 4 * v;
    int r = i / JMC_W, l = i % JMC_W;
    int32_t e[4];
    for (int k = 0; k < 4; ++k) {
      e[k] = s[r * JMC_WS + l];
      if (++l == JMC_W) {
        l = 0;
        ++r;
      }
    }
    jmc_v4 q;
    q.x = e[0];
    q.y = e[1];
    q.z = e[2];
    q.w = e[3];
    jmc_st4(g + i, q);
  }
  for (int i = h + 4 * nv + tid; i < nw; i += nthr)
    g[i] = s[(i / JMC_W) * JMC_WS + i % JMC_W];
}
// g[i] = s[i] for i in [0, n), the 4-byte-aligned middle in 4-byte stores
JMC_FN void jmc_bytes_out(int tid, int nthr, const uint8_t* __restrict__ s,
                          int n, uint8_t* __restrict__ g) {
  int h = (int)((4u - ((uint32_t)(uintptr_t)g & 3u)) & 3u);
  if (h > n) h = n;
  const int nv = (n - h) >> 2;
  for (int i = tid; i < h; i += nthr) g[i] = s[i];
  for (int v = tid; v < nv; v += nthr) {
    const uint8_t* b = s + h + 4 * v;
    jmc_st_u32(g + h + 4 * v, (uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                                  ((uint32_t)b[2] << 16) |
                                  ((uint32_t)b[3] << 24));
  }
  for (int i = h + 4 * nv + tid; i < n; i += nthr) g[i] = s[i];
}
// block b: rows [n0, n0 + nt) of tile b / groups, instances [a0, a1) of
// group b % groups (G a group; the groups of a tile are neighbours)
JMC_FN void jmc_block(int64_t b, int64_t groups, int G, int A, int64_t N,
                      int64_t* n0, int* nt, int* a0, int* a1) {
  const int64_t tile = b / groups;
  const int g = (int)(b - tile * groups);
  *n0 = tile * JMC_TILE;
  *nt = N - *n0 < JMC_TILE ? (int)(N - *n0) : JMC_TILE;
  *a0 = g * G;
  *a1 = A - *a0 < G ? A : *a0 + G;
}
// thread t's row under instance `unit`: en and aok to the staged bytes,
// ov to its place, the successor to the staged tile
JMC_FN void jmc_tile_row(int t, int nt, int32_t unit, const int32_t* xs,
                         const int32_t* cv, int64_t per, int64_t n0,
                         uint8_t* ens, uint8_t* aoks, int32_t* ov,
                         int32_t* ss) {
  if (t >= nt) return;
  jmc_expand_one(unit, xs + t * JMC_WS, cv + ((n0 + t) / per) * JMC_L,
                 ens + t, aoks + t, ov + t, ss + t * JMC_WS);
}
#endif

#ifdef __CUDACC__
#if JMC_TILE
__global__ void __launch_bounds__(JMC_TILE)
    jmc_gen_expand_k(const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cv, int64_t per,
                     const int32_t* __restrict__ units, int A, int64_t N,
                     int G, int64_t groups, uint8_t* en, uint8_t* aok,
                     int32_t* ov, int32_t* succ) {
  extern __shared__ int4 jmc_smem[];
  int32_t* xs = reinterpret_cast<int32_t*>(jmc_smem);
  int32_t* ss = xs + JMC_TILE * JMC_WS;
  uint8_t* ens = reinterpret_cast<uint8_t*>(ss + JMC_TILE * JMC_WS);
  uint8_t* aoks = ens + JMC_TILE;
  int64_t n0;
  int nt, a0, a1;
  jmc_block(blockIdx.x, groups, G, A, N, &n0, &nt, &a0, &a1);
  const int t = threadIdx.x;
  jmc_tile_in(t, JMC_TILE, rows + n0 * JMC_W, nt * JMC_W, xs);
  __syncthreads();
  for (int a = a0; a < a1; ++a) {
    const int64_t i0 = (int64_t)a * N + n0;
    jmc_tile_row(t, nt, units[a], xs, cv, per, n0, ens, aoks, ov + i0, ss);
    __syncthreads();
    jmc_tile_out(t, JMC_TILE, ss, nt * JMC_W, succ + i0 * JMC_W);
    jmc_bytes_out(t, JMC_TILE, ens, nt, en + i0);
    jmc_bytes_out(t, JMC_TILE, aoks, nt, aok + i0);
    __syncthreads();
  }
}
#else
// rows too wide to stage: one thread per (instance, row), blockIdx.y
// names the instance, each output written where the thread stands
__global__ void jmc_gen_expand_k(const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ cv,
                                 int64_t per,
                                 const int32_t* __restrict__ units,
                                 int64_t N, uint8_t* en, uint8_t* aok,
                                 int32_t* ov, int32_t* succ) {
  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int64_t i = (int64_t)blockIdx.y * N + n;
  jmc_expand_one(units[blockIdx.y], rows + n * JMC_W, cv + (n / per) * JMC_L,
                 en + i, aok + i, ov + i, succ + i * JMC_W);
}
#endif
__global__ void jmc_gen_pred_k(int32_t which,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ cv,
                               int64_t per, int64_t N, uint8_t* out) {
  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  jmc_pred_one(which, rows + n * JMC_W, cv + (n / per) * JMC_L, out, n);
}
__global__ void jmc_gen_value_k(const int32_t* __restrict__ rows,
                                const int32_t* __restrict__ cv,
                                int64_t per, int64_t N, int32_t* out) {
  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  jmc_value_one(rows + n * JMC_W, cv + (n / per) * JMC_L, out + n * JMC_VW);
}
#define JMC_BLOCK 128
// K15 over N rows and the A instances units[], G instances a block
extern "C" int jmc_gen_expand(const void* rows, const void* cv,
                              int64_t per, const void* units, int A,
                              int64_t N, int G, void* en, void* aok,
                              void* ov, void* succ, void* stream) {
  if (N == 0 || A == 0) return 0;
#if JMC_TILE
  if (G < 1) return (int)cudaErrorInvalidValue;
  const int64_t groups = (A + G - 1) / G;
  const int64_t blocks = (N + JMC_TILE - 1) / JMC_TILE * groups;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  if (JMC_SMEM_BYTES > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        jmc_gen_expand_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        JMC_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  jmc_gen_expand_k<<<(unsigned)blocks, JMC_TILE, JMC_SMEM_BYTES,
                     (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)cv, per,
      (const int32_t*)units, A, N, G, groups, (uint8_t*)en, (uint8_t*)aok,
      (int32_t*)ov, (int32_t*)succ);
#else
  (void)G;
  if (A > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + JMC_BLOCK - 1) / JMC_BLOCK), (unsigned)A);
  jmc_gen_expand_k<<<grid, JMC_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)cv, per,
      (const int32_t*)units, N, (uint8_t*)en, (uint8_t*)aok, (int32_t*)ov,
      (int32_t*)succ);
#endif
  return (int)cudaGetLastError();
}
extern "C" int jmc_gen_pred(int which, const void* rows, const void* cv,
                            int64_t per, int64_t N, void* out,
                            void* stream) {
  if (N == 0) return 0;
  unsigned grid = (unsigned)((N + JMC_BLOCK - 1) / JMC_BLOCK);
  jmc_gen_pred_k<<<grid, JMC_BLOCK, 0, (cudaStream_t)stream>>>(
      which, (const int32_t*)rows, (const int32_t*)cv, per, N,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
extern "C" int jmc_gen_value(const void* rows, const void* cv,
                             int64_t per, int64_t N, void* out,
                             void* stream) {
  if (N == 0) return 0;
  unsigned grid = (unsigned)((N + JMC_BLOCK - 1) / JMC_BLOCK);
  jmc_gen_value_k<<<grid, JMC_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)cv, per, N,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
#else
// the host build (tests only): the same row functions over every row;
// K15 runs the kernel's blocks in order, each thread's part of a phase
// before the next phase, shared memory poisoned at every block
extern "C" int jmc_gen_expand_host(const void* rows, const void* cv,
                                   int64_t per, const void* units,
                                   int A, int64_t N, int G, void* en,
                                   void* aok, void* ov, void* succ) {
  if (N == 0 || A == 0) return 0;
#if JMC_TILE
  if (G < 1) return 1;
  const int64_t groups = (A + G - 1) / G;
  const int64_t blocks = (N + JMC_TILE - 1) / JMC_TILE * groups;
  int32_t* xs = (int32_t*)malloc(JMC_SMEM_BYTES);
  if (xs == NULL) return 1;
  int32_t* ss = xs + JMC_TILE * JMC_WS;
  uint8_t* ens = (uint8_t*)(ss + JMC_TILE * JMC_WS);
  uint8_t* aoks = ens + JMC_TILE;
  for (int64_t b = 0; b < blocks; ++b) {
    memset(xs, 0xA5, JMC_SMEM_BYTES);
    int64_t n0;
    int nt, a0, a1;
    jmc_block(b, groups, G, A, N, &n0, &nt, &a0, &a1);
    for (int t = 0; t < JMC_TILE; ++t)
      jmc_tile_in(t, JMC_TILE, (const int32_t*)rows + n0 * JMC_W,
                  nt * JMC_W, xs);
    for (int a = a0; a < a1; ++a) {
      const int64_t i0 = (int64_t)a * N + n0;
      for (int t = 0; t < JMC_TILE; ++t)
        jmc_tile_row(t, nt, ((const int32_t*)units)[a], xs,
                     (const int32_t*)cv, per, n0, ens, aoks,
                     (int32_t*)ov + i0, ss);
      for (int t = 0; t < JMC_TILE; ++t) {
        jmc_tile_out(t, JMC_TILE, ss, nt * JMC_W,
                     (int32_t*)succ + i0 * JMC_W);
        jmc_bytes_out(t, JMC_TILE, ens, nt, (uint8_t*)en + i0);
        jmc_bytes_out(t, JMC_TILE, aoks, nt, (uint8_t*)aok + i0);
      }
    }
  }
  free(xs);
#else
  (void)G;
  for (int a = 0; a < A; ++a)
    for (int64_t n = 0; n < N; ++n) {
      int64_t i = (int64_t)a * N + n;
      jmc_expand_one(((const int32_t*)units)[a],
                     (const int32_t*)rows + n * JMC_W,
                     (const int32_t*)cv + (n / per) * JMC_L, (uint8_t*)en + i,
                     (uint8_t*)aok + i, (int32_t*)ov + i,
                     (int32_t*)succ + i * JMC_W);
    }
#endif
  return 0;
}
extern "C" int jmc_gen_pred_host(int which, const void* rows,
                                 const void* cv, int64_t per, int64_t N,
                                 void* out) {
  for (int64_t n = 0; n < N; ++n)
    jmc_pred_one(which, (const int32_t*)rows + n * JMC_W,
                 (const int32_t*)cv + (n / per) * JMC_L, (uint8_t*)out, n);
  return 0;
}
extern "C" int jmc_gen_value_host(const void* rows, const void* cv,
                                  int64_t per, int64_t N, void* out) {
  for (int64_t n = 0; n < N; ++n)
    jmc_value_one((const int32_t*)rows + n * JMC_W,
                  (const int32_t*)cv + (n / per) * JMC_L,
                  (int32_t*)out + n * JMC_VW);
  return 0;
}
#endif
""")
    return "\n".join(s)


# ---------------------------------------------------------------------------
# an engine's generated module
# ---------------------------------------------------------------------------

class GenModule:
    """The generated kernels of one engine: its units (with their
    emitter calls, the twins), the source, and the loaded library.
    `kc` and `lift_names` bind the lifted constants of a twin call."""

    def __init__(self, units: List[Unit], W: int, lift_names: Sequence[str],
                 kc):
        self.units = units
        self.W = W
        self.lift_names = tuple(lift_names)
        self.L = len(self.lift_names)
        self.kc = kc
        self.source, self.meta = generate(units, W, self.L)
        self.VW = self.meta["VW"]
        self.actions = [units[i] for i in self.meta["actions"]]
        self.preds = [units[i] for i in self.meta["preds"]]
        v = self.meta["value"]
        self.value = None if v is None else units[v]
        self.lib = None
        self.info: Dict[str, Any] = {}
        # the lifted-constant table the engine binds for the next calls
        # ([M, L] on the device, one row per member; None: unbound)
        self.cv: Optional[torch.Tensor] = None

    def labels_at(self, lines: Sequence[int]) -> List[str]:
        """The units whose source spans any of `lines`."""
        out = []
        for a, b, lab in self.meta["lines"]:
            if any(a <= ln <= b for ln in lines) and lab not in out:
                out.append(lab)
        return out

    def load(self):
        """Build (nvcc, sm_90a) and load the library; `info` then holds
        the nvcc wall (None when the build directory had it) and the
        ptxas lines.  A failed build raises naming the units nvcc's
        errors point at."""
        if self.lib is None:
            from ..kernels import build
            self.lib = build.build_generated(self.source, self.labels_at)
            self.info = build.GEN_INFO[build.gen_digest(self.source)]
        return self.lib

    @contextlib.contextmanager
    def consts(self, cvals: Optional[torch.Tensor], N: int):
        """The lifted constants `cvals` [M, L] (M divides N) bound per
        row where the emitter reads them (kc.const_lanes), for a twin
        call over N rows."""
        if cvals is None or not self.L:
            yield
            return
        from .lanes import BL
        if cvals.shape[0] not in (1, N):
            cvals = cvals.repeat_interleave(N // cvals.shape[0], dim=0)
        prev = self.kc.const_lanes
        self.kc.const_lanes = {nm: BL(cvals[:, j].contiguous())
                               for j, nm in enumerate(self.lift_names)}
        try:
            yield
        finally:
            self.kc.const_lanes = prev


def build_module(kc, W: int, compiled, preds, view_fn,
                 lift_names: Sequence[str] = ()) -> GenModule:
    """Capture every unit of an engine and generate its source:
    `compiled` the CompiledAction2s (slot by slot), `preds` the
    (label, fn) of its invariants then constraints, `view_fn` the VIEW
    or None.  A unit the generator cannot translate raises GenError
    with its label."""
    L = len(lift_names)

    def install(cins):
        kc.const_lanes = {} if cins is None else dict(zip(lift_names, cins))

    units: List[Unit] = []
    for ca in compiled:
        for s in (range(ca.n_slots) if ca.n_slots else [None]):
            lab = ca.label if s is None else f"{ca.label}[slot {s}]"
            units.append(Unit("action", lab, ca.fn, s))
    units += [Unit("pred", nm, f) for nm, f in preds]
    if view_fn is not None:
        units.append(Unit("value", "VIEW", view_fn))
    prev = kc.const_lanes
    try:
        for u in units:
            try:
                u.cap = tr.capture(u.fn, W, L, slot=u.slot, install=install)
            except Exception as ex:
                raise GenError(f"cannot generate {u.kind} {u.label}: "
                               f"{type(ex).__name__}: {ex}") from ex
    finally:
        kc.const_lanes = prev
    return GenModule(units, W, lift_names, kc)
