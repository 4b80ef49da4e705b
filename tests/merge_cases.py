"""Inputs of K4 merge_sorted (and of the whole rank merge) made with
numpy from a seed, for the CPU model (test_torch_merge_tiles.py) and
the card tests (test_torch_cuda.py): a sorted seen prefix with its
SENTINEL tail, and a candidate key block with in-block duplicates,
duplicates of seen keys and invalid rows.  Each kind stresses one part
of the two launches:

  empty    no candidate key (N = 0)
  count0   an empty seen table
  nonew    every candidate a seen key, a duplicate or invalid
  allnew   every candidate valid, distinct and new
  runs     a few keys, each repeated in long runs across the tiles of
           the first launch
  atcount  new keys above every seen key (lower bound = count)
  past     SC below count + new: the rows past SC are dropped
  small    words in [-6, 6): many equal words, early-out compares
  full     words across the whole int32 range (signed order)

No jax here: the card tests import this module."""

import numpy as np

SENT = 2**31 - 1
KINDS = ("empty", "count0", "nonew", "allnew", "runs", "atcount", "past",
         "small", "full")


def merge_case(kind, K, N, seed, count=None):
    """(seen [SC, K], count, keys [N, K]) as int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    small = kind in ("small", "runs")
    lo, hi = (-6, 6) if small else (-2**31, 2**31)
    if kind == "empty":
        N = 0
    count = (N // 3 + 17 if count is None else count) if kind != "count0" \
        else 0
    pool = np.unique(rng.integers(lo, hi, (count * 2 + 40, K - 1)), axis=0)
    rng.shuffle(pool)
    pool = pool[:count]
    pool = pool[np.lexsort(pool.T[::-1])] if len(pool) else pool
    count = len(pool)
    keys = np.zeros((N, K), np.int64)
    keys[:, 1:] = rng.integers(lo, hi, (N, K - 1))
    if kind == "runs":
        few = rng.integers(lo, hi, (7, K - 1))
        keys[:, 1:] = few[np.sort(rng.integers(0, 7, N))]
    if kind == "allnew":
        keys[:, 1:] = rng.integers(lo, hi, (N, K - 1))
        keys = np.unique(keys, axis=0)
        keep = np.ones(len(keys), bool)
        if count:
            seen_set = {tuple(r) for r in pool.tolist()}
            keep = np.array([tuple(r) not in seen_set
                             for r in keys[:, 1:].tolist()], bool)
        keys = keys[keep]
        keys = keys[rng.permutation(len(keys))]
        N = len(keys)
    elif kind == "atcount":
        top = pool[-1] if count else np.full(K - 1, lo)
        keys[:, 1:] = top
        keys[:, 1] = np.minimum(top[0] + 1 + rng.integers(0, 1000, N),
                                2**31 - 2) if K > 1 else 0
    elif kind == "nonew":
        if count:
            keys[:, 1:] = pool[rng.integers(0, count, N)]
        inval = rng.random(N) < 0.3
        keys[inval, 0] = 1
        keys[inval, 1:] = SENT
    elif kind not in ("empty",):
        if count and kind != "runs":
            pick = rng.random(N) < 0.3
            keys[pick, 1:] = pool[rng.integers(0, count, pick.sum())]
        if N:
            dup = rng.random(N) < 0.2
            keys[dup] = keys[rng.integers(0, N, dup.sum())]
        inval = rng.random(N) < 0.15
        keys[inval, 0] = 1
        keys[inval, 1:] = SENT
    SC = count + N + 5
    if kind == "past":
        SC = count + N // 3
    seen = np.full((SC, K), SENT, np.int32)
    seen[:, 0] = 1
    seen[:count, 0] = 0
    seen[:count, 1:] = pool
    return seen, count, keys.astype(np.int32)
