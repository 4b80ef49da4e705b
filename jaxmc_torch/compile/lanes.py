"""Batch-first lane arrays for the transition-kernel compiler.

The reference compiler (jaxmc/compile/kernel2.py) evaluates a TLA+
expression symbolically over ONE state row and lets `jax.vmap` batch it.
The port evaluates it once over a whole frontier block: a traced value
is a `BL` holding an int32 or bool tensor of shape [B, *row_shape],
where B is the block's row count N, or 1 for a row-independent value
that broadcasts.  Static values stay numpy arrays and Python scalars.

`BL` and the `jnp`-style functions below take and give PER-ROW shapes
(`x.shape`, `x[i]`, `x[a:b]`, `all(x, axis=1)` all speak of the row),
so the compiler reads like its reference while every operation runs
batched: `lanes[off:off + w]` is one slice of an [N, W] tensor.

Integer results are int32 and wrap, as JAX's do with x64 off; `//` and
`%` floor (torch.div rounding_mode="floor", torch.remainder); a zero
divisor gives 0 instead of raising, since a guarded-out row may divide
by zero (the reference's value there is never used either).  Gathers
with a traced index clamp it into range (JAX's retrieval rule).
"""

from __future__ import annotations

import builtins
import threading
from typing import Any, Sequence

import numpy as np
import torch

int32 = torch.int32
bool_ = torch.bool

_ctx = threading.local()


class on_device:
    """Context: numpy constants met during evaluation become tensors on
    `device`."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.prev = getattr(_ctx, "device", None)
        _ctx.device = self.device
        return self

    def __exit__(self, *exc):
        _ctx.device = self.prev
        return False


def _device():
    d = getattr(_ctx, "device", None)
    return d if d is not None else torch.device("cpu")


def _norm_dtype(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool or t.dtype == torch.int32:
        return t
    return t.to(torch.int32)


def _np_tensor(x) -> torch.Tensor:
    """A static numpy array/scalar as a [1, *shape] tensor."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        a = a.astype(np.bool_)
    else:
        a = a.astype(np.int32)
    # np.ascontiguousarray would turn a 0-d array into a 1-d one
    return torch.as_tensor(a.copy(order="C"), device=_device())[None]


class BL:
    """A traced per-row value: tensor `t` of shape [B, *row_shape]."""

    __slots__ = ("t",)
    __array_ufunc__ = None  # numpy defers binary ops to our reflections
    __hash__ = None

    def __init__(self, t: torch.Tensor):
        self.t = t

    # ---- per-row shape ----
    @property
    def ndim(self) -> int:
        return self.t.dim() - 1

    @property
    def shape(self):
        return tuple(self.t.shape[1:])

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def B(self) -> int:
        return self.t.shape[0]

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a per-row scalar")
        return self.t.shape[1]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        raise TypeError("a traced lane value has no Python truth value")

    def __repr__(self):
        return f"BL(row_shape={self.shape}, B={self.B}, {self.dtype})"

    def astype(self, dtype):
        return BL(self.t.to(dtype))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return BL(self.t.reshape((self.B,) + tuple(shape)))

    # ---- indexing ----
    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if builtins.any(isinstance(i, (BL, np.ndarray, torch.Tensor, list))
               for i in idx):
            return _gather(self, idx)
        out = []
        for i in idx:
            if isinstance(i, (np.integer,)):
                i = int(i)
            out.append(i)
        return BL(self.t[(slice(None),) + tuple(out)])

    # ---- arithmetic / comparison ----
    def _bin(self, other, fn, reflect=False):
        a, b = (other, self) if reflect else (self, other)
        ta, tb = _align(a, b)
        return BL(_norm_dtype(fn(ta, tb)))

    def __add__(self, o): return self._bin(o, torch.add)
    def __radd__(self, o): return self._bin(o, torch.add, True)
    def __sub__(self, o): return self._bin(o, torch.sub)
    def __rsub__(self, o): return self._bin(o, torch.sub, True)
    def __mul__(self, o): return self._bin(o, torch.mul)
    def __rmul__(self, o): return self._bin(o, torch.mul, True)
    def __floordiv__(self, o): return floor_divide(self, o)
    def __rfloordiv__(self, o): return floor_divide(o, self)
    def __mod__(self, o): return mod(self, o)
    def __rmod__(self, o): return mod(o, self)
    def __lt__(self, o): return self._bin(o, torch.lt)
    def __le__(self, o): return self._bin(o, torch.le)
    def __gt__(self, o): return self._bin(o, torch.gt)
    def __ge__(self, o): return self._bin(o, torch.ge)
    def __eq__(self, o): return self._bin(o, torch.eq)  # noqa: E704
    def __ne__(self, o): return self._bin(o, torch.ne)  # noqa: E704
    def __and__(self, o): return self._bin(o, torch.bitwise_and)
    def __rand__(self, o): return self._bin(o, torch.bitwise_and, True)
    def __or__(self, o): return self._bin(o, torch.bitwise_or)
    def __ror__(self, o): return self._bin(o, torch.bitwise_or, True)
    def __xor__(self, o): return self._bin(o, torch.bitwise_xor)
    def __invert__(self): return BL(torch.bitwise_not(self.t))
    def __neg__(self): return BL(_norm_dtype(torch.neg(self.t)))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, BL):
        return x.t
    if isinstance(x, torch.Tensor):
        raise TypeError("raw tensor in a lane expression")
    return _np_tensor(x)


def _rank(x) -> int:
    if isinstance(x, BL):
        return x.ndim
    if isinstance(x, np.ndarray):
        return x.ndim
    return 0


def _lift_row(t: torch.Tensor, r: int, R: int) -> torch.Tensor:
    """[B, *rs] (row rank r) -> [B, 1.., *rs] with row rank R, so that
    torch broadcasts per-row shapes right-aligned."""
    if r == R:
        return t
    return t.reshape((t.shape[0],) + (1,) * (R - r) + tuple(t.shape[1:]))


def _scalar(x):
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return None


def _align(*xs):
    """Operands as tensors (Python scalars kept as scalars) with their
    row shapes right-aligned."""
    R = max(_rank(x) for x in xs)
    out = []
    for x in xs:
        s = _scalar(x) if not isinstance(x, (BL, np.ndarray)) else None
        if s is not None:
            out.append(s)
            continue
        t = _as_tensor(x)
        out.append(_lift_row(t, _rank(x), R))
    return out


def _expand_batch(ts: Sequence[torch.Tensor]):
    B = max(t.shape[0] for t in ts)
    return [t.expand((B,) + tuple(t.shape[1:])) if t.shape[0] != B else t
            for t in ts]


def _to_tensor_op(x, like: torch.Tensor):
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.bool if isinstance(x, bool)
                        else torch.int32, device=like.device)


def _gather(x: BL, idx):
    """x[idx] per row with one advanced (traced or array) index on the
    first row axis, optionally followed by basic indices."""
    first, rest = idx[0], idx[1:]
    if isinstance(first, (BL, np.ndarray, list)):
        ix = first if isinstance(first, BL) else BL(_np_tensor(first))
    else:
        raise TypeError("advanced index only on the first row axis")
    if builtins.any(isinstance(i, (BL, np.ndarray, list)) for i in rest):
        raise TypeError("one advanced index per gather")
    d0 = x.t.shape[1]
    it = ix.t.to(torch.int64).clamp(0, max(d0 - 1, 0))
    xt, it = _expand_batch([x.t, it])
    B = xt.shape[0]
    bidx = torch.arange(B, device=xt.device).reshape(
        (B,) + (1,) * (it.dim() - 1))
    g = xt[bidx, it]                      # [B, *ri, *rest_shape]
    if rest:
        g = g[(slice(None),) * it.dim() + tuple(rest)]
    return BL(g)


# ---------------------------------------------------------------------------
# jnp-style functions over per-row shapes
# ---------------------------------------------------------------------------

def asarray(x, dtype=None):
    if isinstance(x, BL):
        return x if dtype is None else x.astype(dtype)
    if isinstance(x, (list, tuple)):
        x = np.asarray(x)
    t = _np_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    return BL(t)


def zeros(shape, dtype=int32):
    if isinstance(shape, int):
        shape = (shape,)
    return BL(torch.zeros((1,) + tuple(shape), dtype=dtype,
                          device=_device()))


def arange(*args, dtype=None):
    return BL(torch.arange(*args, dtype=torch.int32,
                           device=_device())[None])


def reshape(x, shape):
    if isinstance(x, BL):
        return x.reshape(shape)
    return asarray(np.reshape(np.asarray(x), shape))


def where(c, a, b):
    if isinstance(c, (bool, np.bool_)):
        return a if c else b
    tc, ta, tb = _align(c, a, b)
    if isinstance(tc, bool):
        return a if tc else b
    if tc.dtype != torch.bool:
        tc = tc != 0
    if isinstance(ta, (bool, int)) and isinstance(tb, (bool, int)):
        ta = _to_tensor_op(ta, tc)
    return BL(_norm_dtype(torch.where(tc, ta, tb)))


def concatenate(parts, axis=0):
    ts = [_as_tensor(p) for p in parts]
    ts = _expand_batch(ts)
    return BL(torch.cat(ts, dim=axis + 1 if axis >= 0 else axis))


def _reduce(x, axis):
    if not isinstance(x, BL):
        x = asarray(x)
    t = x.t
    if axis is None:
        t = t.reshape(t.shape[0], -1)
        return t, 1
    return t, (axis + 1 if axis >= 0 else axis)


def all(x, axis=None):  # noqa: A001 — jnp name
    t, d = _reduce(x, axis)
    if t.dtype != torch.bool:
        t = t != 0
    return BL(t.all(dim=d))


def any(x, axis=None):  # noqa: A001 — jnp name
    t, d = _reduce(x, axis)
    if t.dtype != torch.bool:
        t = t != 0
    return BL(t.any(dim=d))


def sum(x, axis=None, dtype=None):  # noqa: A001 — jnp name
    t, d = _reduce(x, axis)
    return BL(t.to(torch.int64).sum(dim=d).to(torch.int32))


def argmax(x, axis=None):
    t, d = _reduce(x, axis)
    if t.dtype == torch.bool:
        t = t.to(torch.int32)
    return BL(torch.argmax(t, dim=d).to(torch.int32))


def take(x, idx, axis=0):
    if axis != 0:
        raise TypeError("take: only axis=0")
    if not isinstance(x, BL):
        x = asarray(x)
    if not isinstance(idx, (BL, np.ndarray)):
        idx = np.asarray(idx)
    return _gather(x, (idx,))


def take_along_axis(arr, indices, axis):
    if not isinstance(arr, BL):
        arr = asarray(arr)
    it = indices.t if isinstance(indices, BL) else _np_tensor(indices)
    at, it = _expand_batch([arr.t, it.to(torch.int64)])
    d = axis + 1 if axis >= 0 else axis
    it = it.clamp(0, at.shape[d] - 1)
    return BL(torch.gather(at, d, it))


def clip(x, lo, hi):
    if not isinstance(x, BL):
        return int(np.clip(x, lo, hi))
    return BL(x.t.clamp(int(lo), int(hi)))


def _binop(fn):
    def op(a, b):
        if not isinstance(a, BL) and not isinstance(b, BL):
            a, b = asarray(a), b
        ta, tb = _align(a, b)
        if not isinstance(ta, torch.Tensor):
            ta = _to_tensor_op(ta, tb)
        return BL(_norm_dtype(fn(ta, tb)))
    return op


add = _binop(torch.add)
subtract = _binop(torch.sub)
multiply = _binop(torch.mul)
equal = _binop(torch.eq)
less = _binop(torch.lt)
less_equal = _binop(torch.le)
greater = _binop(torch.gt)
greater_equal = _binop(torch.ge)
logical_and = _binop(lambda a, b: a.bool() & (b.bool() if isinstance(
    b, torch.Tensor) else bool(b)))
logical_or = _binop(lambda a, b: a.bool() | (b.bool() if isinstance(
    b, torch.Tensor) else bool(b)))


def _tensor_pair(a, b):
    ta, tb = _align(a, b)
    like = ta if isinstance(ta, torch.Tensor) else tb
    return _to_tensor_op(ta, like), _to_tensor_op(tb, like)


def maximum(a, b):
    ta, tb = _tensor_pair(a, b)
    return BL(_norm_dtype(torch.maximum(ta, tb)))


def minimum(a, b):
    ta, tb = _tensor_pair(a, b)
    return BL(_norm_dtype(torch.minimum(ta, tb)))


def floor_divide(a, b):
    ta, tb = _tensor_pair(a, b)
    z = tb == 0
    q = torch.div(ta, torch.where(z, torch.ones_like(tb), tb),
                  rounding_mode="floor")
    return BL(_norm_dtype(torch.where(z, torch.zeros_like(q), q)))


def mod(a, b):
    ta, tb = _tensor_pair(a, b)
    z = tb == 0
    r = torch.remainder(ta, torch.where(z, torch.ones_like(tb), tb))
    return BL(_norm_dtype(torch.where(z, torch.zeros_like(r), r)))


def power(a, b):
    ta, tb = _tensor_pair(a, b)
    return BL(_norm_dtype(torch.pow(ta, tb)))


def negative(a):
    return -a if isinstance(a, BL) else -asarray(a)


def logical_not(a):
    if isinstance(a, BL):
        t = a.t if a.t.dtype == torch.bool else a.t != 0
        return BL(~t)
    return BL(~_np_tensor(np.asarray(a, bool)))


def rows_of(x: Any, n: int) -> torch.Tensor:
    """A per-row value as a plain [n, *row_shape] tensor (a static value
    or a B=1 broadcast expanded to the block's n rows)."""
    if not isinstance(x, BL):
        x = asarray(x)
    t = x.t
    if t.shape[0] != n:
        t = t.expand((n,) + tuple(t.shape[1:]))
    return t.contiguous()
