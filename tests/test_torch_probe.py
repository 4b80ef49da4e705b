"""K3 seen_probe's tile-windowed search (kernels/csrc/probe.cu),
modelled in numpy where the kernel cannot run: tiles of T = 256 * R
queries, the 33-ary warp search of the tile's first and last query, the
order check over the tile's adjacent pairs, then per tile one of three
routes: an ordered tile whose window seen[L .. min(R, count-1)] fits the
8,192-word budget searches a copy of the window alone (any read outside
it fails the test), a wider one searches the table, both by a binary
search for a thread's first query and an exponential search from the
previous lower bound for each next; an unordered tile runs a thread's R
binary searches of [0, count) with the kernel's step count.  The POR
sites' keys (candidate order) and keys wider than 9 words take the
kernel's one-query-a-thread search, modelled the same way.

The model is held bit for bit against ops.seen_probe_twin and the JAX
reference's _seen_probe (jaxmc/backend/bfs.py:199, the fixed-trip
_lower_bound of :142), run on the CPU, and each case asserts the routes
its tiles took."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import _seen_probe
from jaxmc_torch.kernels import ops

SENT = 2**31 - 1
THREADS = 256
BUF_WORDS = 8192        # probe.cu kBufWords


def geometry(K):
    """(R, T, window rows) of probe.cu's Geometry<K - 1>."""
    nw = K - 1
    R = min(8, max(1, BUF_WORDS // (THREADS * nw)))
    return R, THREADS * R, BUF_WORDS // nw


def cmp(row, q):
    return (row > q) - (row < q)


def warp_lower_bound(rows, count, q):
    """32 lanes probe 32 evenly spaced rows a round."""
    lo, hi = 0, count
    while hi - lo > 32:
        n = hi - lo
        ps = [lo + (lane + 1) * n // 33 for lane in range(32)]
        lt = [rows[p] < q for p in ps]
        c = sum(lt)
        assert lt == [True] * c + [False] * (32 - c)
        if c:
            lo = ps[c - 1] + 1
        if c < 32:
            hi = ps[c]
    return lo + sum(rows[lo + lane] < q for lane in range(hi - lo))


def sorted_search(row_at, lo0, hi0, count, qs):
    """A thread's sorted queries, every lb in [lo0, hi0]."""
    lbs, founds, prev = [], [], lo0
    for i, q in enumerate(qs):
        a, b, at_b = prev, hi0, None
        if i:
            step = 1
            while step <= hi0 - a:
                p = a + step - 1
                c = cmp(row_at(p), q)
                if c >= 0:
                    b, at_b = p, c
                    break
                a, step = p + 1, step * 2
        while a < b:
            mid = (a + b) // 2
            c = cmp(row_at(mid), q)
            if c < 0:
                a = mid + 1
            else:
                b, at_b = mid, c
        if a < count and at_b is None:
            at_b = cmp(row_at(a), q)
        lbs.append(a)
        founds.append(a < count and at_b == 0)
        prev = a
    return lbs, founds


def full_search(rows, count, qs):
    """Binary searches of [0, count), the kernel's 32 - clz(count)
    steps each."""
    lbs, founds = [], []
    for q in qs:
        lo, hi = 0, count
        for _ in range(count.bit_length()):
            if lo < hi:
                mid = (lo + hi) // 2
                if rows[min(mid, count - 1)] < q:
                    lo = mid + 1
                else:
                    hi = mid
        assert lo == hi
        lbs.append(lo)
        founds.append(lo < count and rows[lo] == q)
    return lbs, founds


def probe_model(seen, count, queries, sorted_keys=True):
    """(found, lb, the route of each tile); `sorted_keys` is the
    wrapper's word for the rank sites."""
    N, K = queries.shape
    rows = [tuple(r) for r in seen[:count, 1:].tolist()]
    qs = [tuple(r) for r in queries[:, 1:].tolist()]
    if not sorted_keys or K - 1 > 8:
        lb, found = full_search(rows, count, qs)
        return np.array(found, bool), np.array(lb, np.int32), ["any"]
    R, T, wrows = geometry(K)
    lb, found, routes = [], [], []
    for q0 in range(0, N, T):
        tq = qs[q0:q0 + T]
        lo = warp_lower_bound(rows, count, tq[0])
        hi = warp_lower_bound(rows, count, tq[-1])
        if all(a <= b for a, b in zip(tq, tq[1:])):
            last = min(hi, count - 1)
            if last - lo + 1 <= wrows:
                window = rows[lo:last + 1]

                def row_at(p, lo=lo, last=last, window=window):
                    assert lo <= p <= last, "read outside the window"
                    return window[p - lo]
                routes.append("window")
            else:
                def row_at(p):
                    return rows[p]
                routes.append("global")
            for t in range(0, len(tq), R):
                b, f = sorted_search(row_at, lo, hi, count, tq[t:t + R])
                lb += b
                found += f
        else:
            routes.append("unordered")
            b, f = full_search(rows, count, tq)
            lb += b
            found += f
    return np.array(found, bool), np.array(lb, np.int32), routes


def make_case(case, K, seed):
    """(seen [SC, K], count, keys [N, K]) and the routes the case must
    take."""
    rng = np.random.default_rng(seed)
    R, T, wrows = geometry(K)
    lo, hi = (-2**31, 2**31) if case in ("wide", "above", "unsorted") \
        else (-40, 40)
    count, N, inval = {"sorted": (3000, 2 * T + 77, 0.3),
                       "straddle": (3000, 2 * T + 77, 0.3),
                       "repeated": (50, T + 300, 0.3),
                       "unsorted": (4000, T + 5, 0.2),
                       "count0": (0, T + 9, 0.2),
                       "count_sc": (2000, T + 100, 0.2),
                       "above": (1500, T // 2 + 3, 0.0),
                       "wide": (12 * wrows, T + 11, 0.0),
                       "small": (700, 100, 0.2)}[case]
    pool = np.unique(rng.integers(lo, hi, (count * 2 + 10, K - 1)), axis=0)
    pool = pool[np.sort(rng.permutation(len(pool))[:count])]
    count = len(pool)
    SC = count if case == "count_sc" else count + 64
    seen = np.full((SC, K), SENT, np.int64)
    seen[:count, 0] = 0
    seen[:count, 1:] = pool
    if case == "above":
        seen[:count, 1:] = np.sort(rng.integers(-2**31, -2**30,
                                                (count, K - 1)), axis=0)
        seen[:count] = seen[np.lexsort(seen[:count, 1:].T[::-1])]
    keys = np.zeros((N, K), np.int64)
    keys[:, 1:] = rng.integers(lo, hi, (N, K - 1))
    if case == "above":
        keys[:, 1:] = rng.integers(0, 2**31, (N, K - 1))
    elif count:
        pick = rng.random(N) < 0.4
        keys[pick, 1:] = pool[rng.integers(0, count, pick.sum())]
    dup = rng.random(N) < (0.6 if case == "repeated" else 0.1)
    keys[dup] = keys[rng.integers(0, N, dup.sum())]
    bad = rng.random(N) < inval
    keys[bad, 0] = 1
    # a POR block's invalid rows keep data words, so the data words of a
    # sorted block restart below the valid ones at the boundary
    keys[bad, 1:] = rng.integers(-40, 40, (bad.sum(), K - 1)) \
        if case == "straddle" else SENT
    keys = keys.astype(np.int32)
    if case != "unsorted":
        keys = keys[ops.lsd_sort(torch.as_tensor(keys)).numpy()]
    need = {"sorted": {"window"}, "straddle": {"window", "unordered"},
            "repeated": {"window"}, "unsorted": {"unordered"},
            "count0": {"window"}, "count_sc": {"window"},
            "above": {"window"}, "wide": {"global"},
            "small": {"window"}}[case]
    return seen.astype(np.int32), count, np.ascontiguousarray(keys), need


CASES = ["sorted", "straddle", "repeated", "unsorted", "count0", "count_sc",
         "above", "wide", "small"]


@pytest.mark.parametrize("K", [3, 5, 6])
@pytest.mark.parametrize("case", CASES)
def test_k3_model_matches_twin_and_reference(case, K):
    """Sorted rank-merge blocks with an invalid SENTINEL tail (a tile
    across the boundary), invalid rows whose data words restart,
    repeated keys, unsorted (POR-site) keys, count 0 and count == SC,
    queries above every seen row, a window wider than the budget, N not
    a multiple of T and below it."""
    seen, count, keys, need = make_case(case, K, 1000 * K + len(case))
    ft, lt = ops.seen_probe_twin(torch.as_tensor(seen), count,
                                 torch.as_tensor(keys))
    fj, lj = _seen_probe(jnp.asarray(seen), count, jnp.asarray(keys),
                         seen.shape[0])
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    # the rank sites' tiles, then the POR sites' one thread a query, on
    # the same keys
    for sorted_keys in (True, False):
        found, lb, routes = probe_model(seen, count, keys, sorted_keys)
        assert (need if sorted_keys else {"any"}) <= set(routes), routes
        np.testing.assert_array_equal(found, ft.numpy())
        np.testing.assert_array_equal(lb, lt.numpy())
    if case == "above":
        assert (lb == count).all() and not found.any()
    if case == "count0":
        assert (lb == 0).all() and not found.any()


def test_k3_model_wide_keys():
    """Keys of more than 9 words take the one-query-a-thread search."""
    seen, count, keys, _ = make_case("sorted", 11, 5)
    found, lb, routes = probe_model(seen, count, keys)
    assert routes == ["any"]
    ft, lt = ops.seen_probe_twin(torch.as_tensor(seen), count,
                                 torch.as_tensor(keys))
    np.testing.assert_array_equal(found, ft.numpy())
    np.testing.assert_array_equal(lb, lt.numpy())


def test_k3_geometry():
    """The tile sizes the kernel's head comment states."""
    assert [geometry(K)[1] for K in (2, 3, 5, 6, 7, 8, 9)] == \
        [2048, 2048, 2048, 1536, 1280, 1024, 1024]
    assert geometry(3)[2] == 4096
