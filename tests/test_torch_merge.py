"""The seen probe and the rank merge of the torch port against
jaxmc.backend.bfs._seen_probe and _rank_merge(multikey=True): bit for
bit on a random sorted seen prefix and candidate blocks with in-block
duplicates, duplicates of seen keys and invalid rows, for K = 2, 3, 5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import _rank_merge, _seen_probe
from jaxmc_torch.kernels import ops

SENT = 2**31 - 1


def _case(K, seen_count, N, SC, seed, small_words=True):
    rng = np.random.default_rng(seed)
    hi = 6 if small_words else 2**31 - 1
    lo = -6 if small_words else -2**31
    # unique sorted seen prefix (validity lane 0)
    pool = rng.integers(lo, hi, (seen_count * 3 + 10, K - 1))
    pool = np.unique(pool, axis=0)[:seen_count]
    seen_count = len(pool)
    seen = np.full((SC, K), SENT, np.int32)
    seen[:seen_count, 0] = 0
    seen[:seen_count, 1:] = pool          # np.unique sorts rows lexically
    # candidates: new words, seen duplicates, in-block duplicates,
    # invalid rows
    keys = np.zeros((N, K), np.int64)
    keys[:, 1:] = rng.integers(lo, hi, (N, K - 1))
    if seen_count:
        pick = rng.random(N) < 0.3
        keys[pick, 1:] = pool[rng.integers(0, seen_count, pick.sum())]
    dup = rng.random(N) < 0.2
    keys[dup] = keys[rng.integers(0, N, dup.sum())]
    inval = rng.random(N) < 0.15
    keys[inval, 0] = 1
    keys[inval, 1:] = SENT
    return seen, seen_count, keys.astype(np.int32)


CASES = [(K, sc, N, SC, seed)
         for K in (2, 3, 5)
         for (sc, N, SC, seed) in ((0, 40, 64, 1), (30, 200, 256, 2),
                                   (150, 300, 512, 3))]


@pytest.mark.parametrize("K,sc,N,SC,seed", CASES)
def test_seen_probe_twin_matches_reference(K, sc, N, SC, seed):
    seen, sc, keys = _case(K, sc, N, SC, seed)
    fj, lj = _seen_probe(jnp.asarray(seen), sc, jnp.asarray(keys), SC)
    ft, lt = ops.seen_probe(torch.as_tensor(seen), sc,
                            torch.as_tensor(keys))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("K,sc,N,SC,seed", CASES)
def test_rank_merge_twin_matches_reference(K, sc, N, SC, seed):
    seen, sc, keys = _case(K, sc, N, SC, seed)
    assert sc + N <= SC
    rj = _rank_merge(jnp.asarray(seen), sc, jnp.asarray(keys), N, SC, K,
                     multikey=True)
    rt = ops.rank_merge(torch.as_tensor(seen), sc, torch.as_tensor(keys))
    n = int(rj["new_count"])
    assert int(rt["new_count"]) == n
    assert int(rt["seen_count2"]) == int(rj["seen_count2"]) == sc + n
    np.testing.assert_array_equal(rt["nk_sidx"].numpy()[:n],
                                  np.asarray(rj["nk_sidx"])[:n])
    np.testing.assert_array_equal(rt["nk_sidx"].numpy(),
                                  np.asarray(rj["nk_sidx"]))
    np.testing.assert_array_equal(rt["seen2"].numpy(),
                                  np.asarray(rj["seen2"]))


@pytest.mark.parametrize("K", [2, 3, 5])
def test_rank_merge_full_range_words(K):
    """Words across the whole int32 range (signed order matters)."""
    seen, sc, keys = _case(K, 100, 250, 512, 9, small_words=False)
    rj = _rank_merge(jnp.asarray(seen), sc, jnp.asarray(keys), 250, 512,
                     K, multikey=True)
    rt = ops.rank_merge(torch.as_tensor(seen), sc, torch.as_tensor(keys))
    assert int(rt["new_count"]) == int(rj["new_count"])
    np.testing.assert_array_equal(rt["seen2"].numpy(),
                                  np.asarray(rj["seen2"]))
    np.testing.assert_array_equal(rt["nk_sidx"].numpy(),
                                  np.asarray(rj["nk_sidx"]))


def test_lsd_sort_is_stable_lexicographic():
    rng = np.random.default_rng(4)
    keys = rng.integers(-3, 3, (500, 3)).astype(np.int32)
    perm = ops.lsd_sort(torch.as_tensor(keys)).numpy()
    want = np.lexsort(tuple(keys[:, j] for j in reversed(range(3))),
                      axis=0)
    np.testing.assert_array_equal(perm, want)   # np.lexsort is stable
