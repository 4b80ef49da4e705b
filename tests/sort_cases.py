"""K18 sort_keys's and front_order's inputs for the CPU model
(test_torch_sort.py) and the card (test_torch_cuda.py): numpy only, so
the card's test file imports no JAX."""

import numpy as np

SENT = 2**31 - 1
IMIN = -2**31
PATTERNS = ("random", "equal", "extremes", "valid_tail", "stale", "oracle",
            "ties")


def keys_case(pattern, N, K, seed):
    """[N, K] int32 keys of one pattern: uniform words, all rows equal,
    INT_MIN / -1 / 0 / INT_MAX in every word, a validity word with a
    SENTINEL tail (the rank sites), word 0 SENTINEL on stale rows (the
    full-sort step), the oracle's uniform keys (RandomState), few
    distinct words (long runs of ties)."""
    rng = np.random.default_rng(seed)
    if pattern == "random":
        k = rng.integers(IMIN, SENT, (N, K), endpoint=True)
    elif pattern == "equal":
        k = np.broadcast_to(rng.integers(IMIN, SENT, (1, K)), (N, K))
    elif pattern == "extremes":
        k = rng.choice(np.array([IMIN, -1, 0, SENT]), (N, K))
    elif pattern in ("valid_tail", "stale"):
        v = rng.random(N) < 0.2
        k = rng.integers(0, 1 << 20, (N, K))
        k[:, 0] = np.where(v, 0, 1)
        k[~v, 1:] = SENT
        if pattern == "stale":
            stale = rng.random(N) < 0.3
            k[stale, 0] = SENT
    elif pattern == "oracle":
        k = np.random.RandomState(seed).randint(-2**31, 2**31 - 1, (N, K),
                                                dtype=np.int64)
    else:
        k = rng.integers(-2, 2, (N, K))
    return np.ascontiguousarray(k, dtype=np.int32)


def front_case(A, FC, seed, explored=0.5, new_frac=0.3):
    """(explore [C] bool, prov [C] int64) as the level step makes them:
    the first new_count rows carry candidate indices, the rest index 0
    and are not explored."""
    rng = np.random.default_rng(seed)
    C = A * FC
    new = int(C * new_frac)
    prov = np.zeros(C, np.int64)
    prov[:new] = rng.permutation(C)[:new]
    explore = np.zeros(C, bool)
    explore[:new] = rng.random(new) < explored
    return explore, prov
