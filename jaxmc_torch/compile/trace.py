"""The graph of one compiled unit: the port's trace of the emitter.

The emitter (compile/kernel2.py) reaches torch only through the
`lanes` functions and `BL` methods, whose shapes are static per row.
`capture` runs a compiled unit ONCE over a symbolic row block: every
lanes operation whose operands include a symbolic value records a node
here instead of computing a tensor, and keeps the lanes semantics
exactly (int32 wrap, floor `//` and `%` with a zero divisor giving 0,
clamped traced gathers, an int64 `sum` wrapped to int32, the first
maximum of `argmax`).  Operations over constants alone still run
eagerly (on the CPU), so row-independent work is folded at capture.
compile/cgen.py writes the graph as CUDA C++.  This is what XLA's trace
of `jnp` is to the reference; it is the port's own code (no torch.fx,
no __torch_function__, no dispatcher hooks).

A node is one per-row value of a static flat size, int32 or bool:

  in     the state row, size W
  cin    lifted CONSTANT j (a per-row input), size 1
  const  a numpy array (row-independent)
  ew     elementwise `fn` over operands (node, off, step) with step 1
         (element off + k) or 0 (element off, broadcast), or Python
         int immediates
  sel    static data movement: element k is source sid[k] at idx[k]
  red    all / any / sum / argmax over static index rows idx[j, :]
  gat    element k is x[clamp(ix[ixpos[k]], 0, hi) * S + xoff[k]]

A value (`Sym`) is a node, an offset into it and a per-row shape: a
reshape or a contiguous slice is a new view of the same node.
Identical nodes are shared (hash-consing), so repeated subexpressions
are computed once.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ctx = threading.local()

BOOL, INT = "b", "i"


class TraceError(RuntimeError):
    """An operation the graph cannot record: the unit cannot be
    generated (the engine names the unit and raises).  Not a
    CompileError, so no recovery path of the emitter catches it."""


class Node:
    __slots__ = ("id", "op", "args", "par", "dt", "size")

    def __init__(self, nid, op, args, par, dt, size):
        self.id, self.op, self.args, self.par = nid, op, args, par
        self.dt, self.size = dt, size

    def __repr__(self):
        return f"Node({self.id}, {self.op}, {self.dt}, size={self.size})"


class Sym:
    """A symbolic per-row value: `size` elements of `node` from `off`,
    viewed with per-row shape `rshape`.  Mimics the parts of a [1, ...]
    tensor that BL reads (shape, dtype, dim)."""

    __slots__ = ("node", "off", "rshape", "dtype")

    def __init__(self, node: Node, off: int, rshape, dtype):
        self.node, self.off = node, int(off)
        self.rshape = tuple(int(d) for d in rshape)
        self.dtype = dtype

    @property
    def shape(self):
        return (1,) + self.rshape

    def dim(self) -> int:
        return len(self.rshape) + 1

    @property
    def size(self) -> int:
        return int(np.prod(self.rshape, dtype=np.int64))


def _dt(dtype) -> str:
    if dtype == torch.bool:
        return BOOL
    if dtype == torch.int32:
        return INT
    raise TraceError(f"lanes value of dtype {dtype}")


class Graph:
    """The nodes of one unit, in creation (topological) order."""

    def __init__(self):
        self.nodes: List[Node] = []
        self._cons: Dict[Any, Node] = {}

    def add(self, op, args, par, dt, size, key_par=None) -> Node:
        key = (op, tuple(_arg_key(a) for a in args),
               key_par if key_par is not None else par, dt, size)
        n = self._cons.get(key)
        if n is None:
            n = Node(len(self.nodes), op, tuple(args), par, dt, int(size))
            self.nodes.append(n)
            self._cons[key] = n
        return n


def _arg_key(a):
    if isinstance(a, Node):
        return ("n", a.id)
    if isinstance(a, tuple):
        return tuple(_arg_key(x) for x in a)
    return a


def _arr_key(a: np.ndarray):
    return (a.dtype.str, a.shape, a.tobytes())


def graph() -> Graph:
    g = getattr(_ctx, "graph", None)
    if g is None:
        raise TraceError("a symbolic lane value outside capture()")
    return g


def active() -> bool:
    return getattr(_ctx, "graph", None) is not None


# ---------------------------------------------------------------------------
# values: constants, views, operands
# ---------------------------------------------------------------------------

def const_sym(value, dtype=None) -> Sym:
    """A row-independent value (numpy array, scalar, or a B=1 tensor's
    row) as a const node."""
    if isinstance(value, torch.Tensor):
        dtype = value.dtype if dtype is None else dtype
        a = value.detach().cpu().numpy()
    else:
        a = np.asarray(value)
        if dtype is None:
            dtype = torch.bool if a.dtype == np.bool_ else torch.int32
    rshape = a.shape
    flat = a.reshape(-1).astype(np.int64)
    flat = ((flat + 2**31) % 2**32 - 2**31).astype(np.int32)
    dt = _dt(dtype)
    n = graph().add("const", (), flat, dt, flat.size, key_par=_arr_key(flat))
    return Sym(n, 0, rshape, dtype)


def sym_of(x) -> Sym:
    """A lanes operand as a Sym: a traced BL's, or a constant's."""
    from . import lanes
    if isinstance(x, lanes.BL):
        t = x.t
        if isinstance(t, Sym):
            return t
        if t.shape[0] != 1:
            raise TraceError("a per-row tensor in a captured unit")
        return const_sym(t[0])
    if isinstance(x, Sym):
        return x
    if isinstance(x, torch.Tensor):
        raise TypeError("raw tensor in a lane expression")
    a = np.asarray(x)
    if a.dtype != np.bool_:
        a = a.astype(np.int32)
    return const_sym(a)


def _ids(s: Sym) -> np.ndarray:
    """The absolute element indices of a view, in its per-row shape."""
    return (np.arange(s.size, dtype=np.int64) + s.off).reshape(s.rshape)


def view(s: Sym, ids: np.ndarray, dtype=None) -> Sym:
    """The elements `ids` (absolute indices into s.node) in ids' shape:
    a contiguous run is a view, anything else a sel node."""
    dtype = s.dtype if dtype is None else dtype
    flat = ids.reshape(-1)
    if flat.size == 0:
        return const_sym(np.zeros(ids.shape, np.int32), dtype)
    if np.array_equal(flat, np.arange(flat[0], flat[0] + flat.size)):
        return Sym(s.node, int(flat[0]), ids.shape, dtype)
    if s.node.op == "const":
        vals = s.node.par[flat]
        return const_sym(vals.reshape(ids.shape).astype(
            np.bool_ if dtype == torch.bool else np.int32), dtype)
    return select([s.node], np.zeros(flat.size, np.int32),
                  flat.astype(np.int32), ids.shape, dtype)


def select(nodes: Sequence[Node], sid: np.ndarray, idx: np.ndarray,
           rshape, dtype) -> Sym:
    sid = np.ascontiguousarray(sid, np.int32)
    idx = np.ascontiguousarray(idx, np.int32)
    n = graph().add("sel", tuple(nodes), (sid, idx), _dt(dtype), sid.size,
                    key_par=(_arr_key(sid), _arr_key(idx)))
    return Sym(n, 0, rshape, dtype)


def broadcast(s: Sym, out_shape) -> Tuple[Node, int, int]:
    """An operand ref (node, off, step) of s broadcast, right-aligned,
    to out_shape (the eager operation has checked that it broadcasts)."""
    out_shape = tuple(out_shape)
    if s.size == int(np.prod(out_shape, dtype=np.int64)):
        return (s.node, s.off, 1)
    if s.size == 1:
        return (s.node, s.off, 0)
    ids = np.broadcast_to(_ids(s), out_shape)
    v = view(s, np.ascontiguousarray(ids))
    return (v.node, v.off, 1)


def _imm(x) -> Optional[int]:
    if isinstance(x, (bool, np.bool_)):
        return int(bool(x))
    if isinstance(x, (int, np.integer)):
        v = int(x)
        return (v + 2**31) % 2**32 - 2**31
    return None


# ---------------------------------------------------------------------------
# the operations (called from lanes.py when an operand is symbolic)
# ---------------------------------------------------------------------------

def _dummy(x):
    """A zero B=1 stand-in for a symbolic operand (shapes and dtypes
    come from running the eager lanes operation on the stand-ins)."""
    from . import lanes
    if isinstance(x, lanes.BL) and isinstance(x.t, Sym):
        return lanes.BL(torch.zeros((1,) + x.t.rshape, dtype=x.t.dtype))
    if isinstance(x, (list, tuple)):
        return type(x)(_dummy(y) for y in x)
    return x


def _out(eager: Callable, *args):
    """Per-row shape and dtype of the eager operation on stand-ins."""
    r = eager(*[_dummy(a) for a in args])
    return tuple(r.t.shape[1:]), r.t.dtype


def _wrap(s: Sym):
    from . import lanes
    return lanes.BL(s)


def elementwise(fn: str, eager: Callable, *operands):
    """An elementwise node: operands are lanes values or Python
    scalars; its shape and dtype are the eager operation's."""
    rshape, dtype = _out(eager, *operands)
    size = int(np.prod(rshape, dtype=np.int64))
    refs = []
    dts = []
    for x in operands:
        iv = _imm(x)
        if iv is not None and not isinstance(x, np.ndarray):
            refs.append(iv)
            dts.append(BOOL if isinstance(x, (bool, np.bool_)) else INT)
            continue
        s = sym_of(x)
        refs.append(broadcast(s, rshape))
        dts.append(_dt(s.dtype))
    n = graph().add("ew", tuple(refs), (fn, tuple(dts)), _dt(dtype), size)
    return _wrap(Sym(n, 0, rshape, dtype))


def astype(x, dtype):
    s = x.t
    if dtype == s.dtype:
        from . import lanes
        return lanes.BL(s)
    if dtype == torch.bool:
        return elementwise("tob", lambda a: a.astype(torch.bool), x)
    if dtype == torch.int32:
        return elementwise("toi", lambda a: a.astype(torch.int32), x)
    raise TraceError(f"astype to {dtype}")


def reshape(x, shape):
    s = x.t
    rshape, _ = _out(lambda a: a.reshape(shape), x)
    return _wrap(Sym(s.node, s.off, rshape, s.dtype))


def basic_index(x, idx):
    """x[idx] for basic indices (ints, slices, None, Ellipsis)."""
    s = x.t
    ids = _ids(s)[idx]
    if not isinstance(ids, np.ndarray):
        ids = np.asarray(ids)
    return _wrap(view(s, np.ascontiguousarray(ids)))


def concatenate(parts, axis, eager):
    rshape, dtype = _out(eager, list(parts))
    syms = [sym_of(p) for p in parts]
    ax = axis if axis >= 0 else len(rshape) + axis
    nodes: List[Node] = []
    nidx: Dict[int, int] = {}
    sid_parts, idx_parts = [], []
    for s in syms:
        j = nidx.setdefault(s.node.id, len(nodes))
        if j == len(nodes):
            nodes.append(s.node)
        ids = _ids(s)
        if ids.ndim == 0:
            ids = ids.reshape(1)
        sid_parts.append(np.full(ids.shape, j, np.int64))
        idx_parts.append(ids)
    sid = np.concatenate(sid_parts, axis=ax).reshape(-1)
    idx = np.concatenate(idx_parts, axis=ax).reshape(-1)
    if len(nodes) == 1:
        whole = Sym(nodes[0], 0, (nodes[0].size,), dtype)
        return _wrap(view(whole, idx.reshape(rshape), dtype))
    return _wrap(select(nodes, sid, idx, rshape, dtype))


def reduce(fn: str, x, axis, eager):
    """all / any / sum / argmax of x over `axis` (None: every element)."""
    rshape, dtype = _out(eager, x, axis)
    s = x.t
    ids = _ids(s)
    if axis is None:
        mat = ids.reshape(1, -1)
    else:
        ax = axis if axis >= 0 else len(s.rshape) + axis
        moved = np.moveaxis(ids, ax, -1)
        mat = moved.reshape(-1, moved.shape[-1]) if moved.size else \
            np.zeros((int(np.prod(moved.shape[:-1])), 0), np.int64)
    mat = np.ascontiguousarray(mat, np.int32)
    n = graph().add("red", (s.node,), (fn, mat), _dt(dtype),
                    mat.shape[0], key_par=(fn, _arr_key(mat)))
    return _wrap(Sym(n, 0, rshape, dtype))


def gather(x, ix, rest, eager):
    """x[ix, *rest] per row: ix (traced or static) on the first row
    axis, clamped into range; `rest` basic indices after it."""
    rshape, dtype = _out(eager, x, ix)
    xs = sym_of(x)
    ixs = sym_of(ix)
    d0 = xs.rshape[0]
    S = int(np.prod(xs.rshape[1:], dtype=np.int64))
    hi = max(d0 - 1, 0)
    inner = np.arange(S, dtype=np.int64).reshape(xs.rshape[1:])
    if rest:
        inner = np.asarray(inner[tuple(rest)])
    restmap = inner.reshape(-1)
    R = restmap.size
    ni = ixs.size
    ixpos = np.repeat(np.arange(ni, dtype=np.int64), R) + ixs.off
    xoff = np.tile(restmap, ni) + xs.off
    return _gather_node(xs, ixs, ixpos, xoff, S, hi, rshape, dtype)


def take_along_axis(arr, indices, axis, eager):
    rshape, dtype = _out(eager, arr, indices, axis)
    xs = sym_of(arr)
    ixs = sym_of(indices)
    ax = axis if axis >= 0 else len(xs.rshape) + axis
    strides = [int(np.prod(xs.rshape[i + 1:], dtype=np.int64))
               for i in range(len(xs.rshape))]
    pos = np.indices(ixs.rshape).reshape(len(ixs.rshape), -1) \
        if ixs.rshape else np.zeros((0, 1), np.int64)
    base = np.zeros(pos.shape[1], np.int64)
    for i in range(len(xs.rshape)):
        if i != ax:
            base += pos[i] * strides[i]
    ixpos = np.arange(ixs.size, dtype=np.int64) + ixs.off
    return _gather_node(xs, ixs, ixpos, base + xs.off, strides[ax],
                        xs.rshape[ax] - 1, rshape, dtype)


def _gather_node(xs, ixs, ixpos, xoff, S, hi, rshape, dtype):
    if ixs.node.op == "const":
        # a static index: a static data movement
        iv = np.clip(ixs.node.par[ixpos].astype(np.int64), 0, hi)
        return _wrap(view(xs, (iv * S + xoff).reshape(rshape), dtype))
    ixpos = np.ascontiguousarray(ixpos, np.int32)
    xoff = np.ascontiguousarray(xoff, np.int32)
    n = graph().add("gat", (xs.node, ixs.node), (ixpos, xoff, int(S),
                                                 int(hi)),
                    _dt(dtype), ixpos.size,
                    key_par=(_arr_key(ixpos), _arr_key(xoff), S, hi))
    return _wrap(Sym(n, 0, rshape, dtype))


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

class Rows:
    """The symbolic [N, W] row block a compiled unit is called with
    (lanes.BL(rows) takes its `sym`, the `in` node)."""

    def __init__(self, sym: Sym):
        self.sym = sym
        self.shape = (1, sym.size)
        self.device = torch.device("cpu")


class Captured:
    """A unit's graph and its outputs (Syms, in the unit's order)."""

    def __init__(self, g: Graph, outs: List[Sym]):
        self.graph, self.outs = g, outs


def capture(fn: Callable, W: int, L: int = 0, slot=None,
            install: Optional[Callable] = None) -> Captured:
    """Run fn over a symbolic [N, W] block once; `install` receives the
    L lifted-constant inputs (BLs over cin nodes) before the call and
    None after it.  Returns the graph of fn's outputs (one value or a
    tuple).  A CompileError of the eager run is raised unchanged."""
    from . import lanes
    if active():
        raise TraceError("nested capture")
    g = Graph()
    _ctx.graph = g
    try:
        rows = Rows(Sym(g.add("in", (), None, INT, W), 0, (W,),
                        torch.int32))
        if install is not None:
            install([lanes.BL(Sym(g.add("cin", (), j, INT, 1), 0, (),
                                  torch.int32)) for j in range(L)])
        try:
            out = fn(rows) if slot is None else fn(rows, slot)
        finally:
            if install is not None:
                install(None)
        outs = [output(o) for o in
                (list(out) if isinstance(out, tuple) else [out])]
    finally:
        _ctx.graph = None
    return Captured(g, outs)


def output(x) -> Sym:
    """lanes.rows_of under capture: the unit's output value."""
    if isinstance(x, Sym):
        return x
    return sym_of(x)
