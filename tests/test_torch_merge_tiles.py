"""K4 merge_sorted's two launches (jaxmc_torch/kernels/csrc/merge.cu)
modelled in numpy, where the kernel cannot run, and held bit for bit
against ops.merge_sorted_twin and, through the LSD sort and K3's twin,
against the JAX reference's _rank_merge (jaxmc/backend/bfs.py:285) on
the CPU.

Launch 1: tiles of 256 * items sorted keys, started in ticket order at
random moments and advanced in a random interleaving; each stages its
words and the key before it by merge.cu's stage_run split (a scalar
head up to the 16-byte boundary of the source, 16-byte words, a scalar
tail, landing at the source's phase in the staged array); thread t
holds rows t, t + 256, ... and a warp's ballot of `new` per item; the
counts are scanned in (item, warp) order; the tile's count goes through
the decoupled look-back of lookback_model.py on status words that start
at zero (epoch 0), and the last tile writes the scalars.  Launch 2:
blocks of R output rows in a random order, each with the two 32-ary
warp searches of count_below, its seen run staged by stage_run, the new
keys gathered behind it, the bitmap of their rows, the prefix popcounts
and the rows written as a head, 16-byte words and a tail; every block's
share of nk_sidx's zero tail and of the status words.  Reads of staged
words no thread wrote fail (POISON), every output word is written
exactly once, and after each call the status words and the ticket are
zero again: a second call on the same words is right."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import _rank_merge
from jaxmc_torch.kernels import ops
from lookback_model import look_back, run_tiles
from merge_cases import KINDS, merge_case

THREADS, WARPS = 256, 8
POISON = -0x5A5A5A5B


def stage_run(g, g0, nw, phase0):
    """merge.cu stage_run: g[g0 : g0 + nw] into a staged array at offset
    o = the source's word phase; returns (staged, o)."""
    o = (phase0 + g0) & 3
    h = min((4 - o) & 3, nw)
    nv = (nw - h) >> 2
    s = np.full(nw + 3, POISON, np.int64)
    src = g[g0:g0 + nw].astype(np.int64)
    s[o:o + h] = src[:h]
    assert (o + h) % 4 == 0 or nv == 0        # 16-byte words on both sides
    assert (phase0 + g0 + h) % 4 == 0 or nv == 0
    s[o + h:o + h + 4 * nv] = src[h:h + 4 * nv]
    s[o + h + 4 * nv:o + nw] = src[h + 4 * nv:]
    return s, o


def launch1(skeys, found, sidx, lb, count, SC, items, ws, out, rng):
    """The new flags, look-back and compaction of every tile."""
    N, K = skeys.shape
    T1 = THREADS * items
    ntiles = -(-N // T1) if N else 1
    flat = skeys.reshape(-1)
    status = ws["status"]
    status.extend([0] * (ntiles - len(status)))

    def tile_body(tile):
        ws["ticket"] += 1
        if ws["ticket"] == ntiles:           # the last ticket resets it
            ws["ticket"] = 0
        r0 = tile * T1
        nt = min(T1, N - r0)
        pre = 1 if r0 > 0 else 0
        s, o = stage_run(flat, (r0 - pre) * K, (nt + pre) * K,
                         out["phase"]["skeys"])
        rows = s[o:o + (nt + pre) * K].reshape(nt + pre, K)
        assert (rows != POISON).all()
        cur = rows[pre:]
        fresh = np.zeros(T1, bool)
        if nt:
            neq = np.ones(nt, bool)
            if pre:
                neq = (cur != rows[:-1]).any(axis=1)
            else:
                neq[1:] = (cur[1:] != cur[:-1]).any(axis=1)
            fresh[:nt] = (cur[:, 0] == 0) & ~found[r0:r0 + nt] & neq
        # thread t holds rows t + 256 q: group (q, warp) of 32 lanes
        grp = fresh.reshape(items, WARPS, 32)
        counts = grp.sum(axis=2).reshape(-1)
        off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        agg = int(counts.sum())
        excl = yield from look_back(status, tile, 0, agg)
        if tile == ntiles - 1:
            out["scalars"][:] = (excl + agg, count + excl + agg)
        for i in np.nonzero(fresh)[0]:
            q, t = divmod(int(i), THREADS)
            warp, lane = divmod(t, 32)
            j = excl + off[q * WARPS + warp] + int(grp[q, warp, :lane].sum())
            r = r0 + int(i)
            assert out["nk_sidx"][j] == POISON      # each j written once
            out["nk_sidx"][j] = sidx[r]
            out["pairs"][j] = (r, min(max(int(lb[r]), 0), SC))

    run_tiles(ntiles, tile_body, rng)
    return ntiles


def count_below(pairs, nc, tgt):
    """merge.cu count_below: #{j < nc: pairs[j].y + j < tgt}, by the
    warp's 32-ary rounds (the probes' verdicts must be monotone)."""
    lo, hi = 0, nc
    while hi - lo > 32:
        span = hi - lo
        m = [lo + span * (lane + 1) // 33 for lane in range(32)]
        below = [int(pairs[x][1]) + x < tgt for x in m]
        c = sum(below)
        assert below == [True] * c + [False] * (32 - c)
        nlo = lo + span * c // 33 + 1 if c else lo
        nhi = lo + span * (c + 1) // 33 if c < 32 else hi
        lo, hi = nlo, nhi
    return lo + sum(1 for lane in range(32) if lo + lane < hi and
                    int(pairs[lo + lane][1]) + lo + lane < tgt)


def launch2(seen, skeys, count, R, ntiles1, ws, out, rng):
    """The merge: blocks of R output rows in a random order."""
    SC, K = seen.shape
    nc = int(out["scalars"][0])
    count2 = count + nc
    pairs = out["pairs"]
    ws["status"][:ntiles1] = [0] * ntiles1
    out["nk_sidx"][nc:] = 0
    flat = seen.reshape(-1)
    seen2 = out["seen2"]
    writes = np.zeros(SC * K, np.int64)
    ph = out["phase"]["seen2"]
    for b in rng.permutation(-(-SC // R)):
        p0 = int(b) * R
        p1 = min(p0 + R, SC)
        rows = p1 - p0
        jlo = nc if p0 >= count2 else count_below(pairs, nc, p0)
        jhi = nc if p1 >= count2 else count_below(pairs, nc, p1)
        nnew = jhi - jlo
        live = max(0, min(p1, count2) - p0)
        nseen = live - nnew
        assert 0 <= nnew <= live
        s, o = stage_run(flat, (p0 - jlo) * K, nseen * K,
                         out["phase"]["seen"])
        nk = np.full(nnew * K, POISON, np.int64)
        bm = np.zeros(R // 32, np.uint64)
        for u in range(nnew):
            x, _ = pairs[jlo + u]
            nk[u * K:(u + 1) * K] = skeys[x]
            lp = int(pairs[jlo + u][1]) + jlo + u - p0
            assert 0 <= lp < rows
            bm[lp >> 5] |= np.uint64(1 << (lp & 31))
        pop = np.array([bin(int(w)).count("1") for w in bm])
        before = np.concatenate([[0], np.cumsum(pop)[:-1]])
        lp = np.arange(rows)
        bits = np.array([(int(bm[x >> 5]) >> (x & 31)) & 1 for x in lp],
                        bool)
        u = before[lp >> 5] + np.array(
            [bin(int(bm[x >> 5]) & ((1 << (x & 31)) - 1)).count("1")
             for x in lp], np.int64)
        vals = np.empty((rows, K), np.int64)
        tail = p0 + lp >= count2
        vals[tail, 0], vals[tail, 1:] = 1, ops.SENTINEL
        new = bits & ~tail
        old = ~bits & ~tail
        if new.any():
            vals[new] = nk.reshape(-1, K)[u[new]]
        if old.any():
            vals[old] = s[o:o + nseen * K].reshape(-1, K)[(lp - u)[old]]
        assert (vals != POISON).all()
        # the block's run: a head to the 16-byte boundary, words, a tail
        g0, nw = p0 * K, rows * K
        h = min((4 - ((ph + g0) & 3)) & 3, nw)
        nv = (nw - h) >> 2
        for a, z in ((0, h), (h, h + 4 * nv), (h + 4 * nv, nw)):
            seen2[g0 + a:g0 + z] = vals.reshape(-1)[a:z]
            writes[g0 + a:g0 + z] += 1
    assert (writes == 1).all()


def model_merge(seen, count, skeys, sidx, found, lb, items, R, ws, rng):
    SC, K = seen.shape
    N = skeys.shape[0]
    out = dict(nk_sidx=np.full(N, POISON, np.int64),
               pairs=[(POISON, POISON)] * N,
               scalars=np.full(2, POISON, np.int64),
               seen2=np.full(SC * K, POISON, np.int64),
               phase=dict(skeys=int(rng.integers(4)),
                          seen=int(rng.integers(4)), seen2=0))
    ntiles1 = launch1(skeys, found, sidx, lb, count, SC, items, ws, out, rng)
    launch2(seen, skeys, count, R, ntiles1, ws, out, rng)
    assert ws["ticket"] == 0 and not any(ws["status"])
    return dict(new_count=out["scalars"][0], nk_sidx=out["nk_sidx"],
                seen2=out["seen2"].reshape(SC, K),
                seen_count2=out["scalars"][1])


def _inputs(kind, K, N, seed):
    seen, count, keys = merge_case(kind, K, N, seed)
    ts, tk = torch.as_tensor(seen), torch.as_tensor(keys)
    skeys, sidx = ops.sort_keys_twin(tk)
    found, lb = ops.seen_probe_twin(ts, count, skeys)
    return seen, count, keys, (ts, count, skeys, sidx, found, lb)


def _same(model, twin):
    for name in ("new_count", "nk_sidx", "seen2", "seen_count2"):
        np.testing.assert_array_equal(np.asarray(model[name]),
                                      twin[name].numpy(), err_msg=name)


@pytest.mark.parametrize("geom", ["card", "small"])
@pytest.mark.parametrize("K", [2, 3, 5, 9])
@pytest.mark.parametrize("kind", KINDS)
def test_merge_sorted_model_matches_twin(kind, K, geom):
    """Every kind of merge_cases at the card's geometry
    (ops.merge_geometry) and at the smallest one (tiles of 256 keys,
    blocks of 32 rows: many tiles, look-back past 32 tiles, many
    blocks); two calls on the same zero words."""
    items, _tile, R = ops.merge_geometry(K)
    if geom == "small":
        items, R = 1, 32
    rng = np.random.default_rng(K * 100 + len(kind))
    ws = dict(status=[], ticket=0)
    for seed in (1, 2):
        seen, count, keys, args = _inputs(kind, K, 9000 + 37 * seed, seed)
        twin = ops.merge_sorted_twin(*args)
        model = model_merge(seen, count, *(a.numpy() for a in args[2:]),
                            items, R, ws, rng)
        _same(model, twin)


@pytest.mark.parametrize("K", [2, 3, 5])
@pytest.mark.parametrize("kind", ["count0", "nonew", "allnew", "runs",
                                  "atcount", "small", "full"])
def test_merge_sorted_model_matches_reference(kind, K):
    """The model after the twins' LSD sort and probe equals the JAX
    reference's _rank_merge(multikey=True) of the unsorted keys."""
    seen, count, keys, args = _inputs(kind, K, 3000, 7)
    SC, N = seen.shape[0], keys.shape[0]
    model = model_merge(seen, count, *(a.numpy() for a in args[2:]), 1, 64,
                        dict(status=[], ticket=0), np.random.default_rng(3))
    rj = _rank_merge(jnp.asarray(seen), count, jnp.asarray(keys), N, SC, K,
                     multikey=True)
    for name in ("new_count", "nk_sidx", "seen2", "seen_count2"):
        np.testing.assert_array_equal(np.asarray(model[name]),
                                      np.asarray(rj[name]), err_msg=name)


@pytest.mark.parametrize("K", [2, 3, 5, 9])
def test_merge_geometry_fits_the_kernel(K):
    """merge.cu's limits: items 8, 4, 2 or 1 with launch 1's staged keys
    within 48 KB, launch 2's rows a multiple of 32."""
    items, tile, R = ops.merge_geometry(K)
    assert items in (8, 4, 2, 1) and tile == 256 * items
    assert 4 * ops._pad4((tile + 1) * K + 3) <= 48 * 1024
    assert R % 32 == 0 and R * K <= ops.MERGE_OUT_WORDS
