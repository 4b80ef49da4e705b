"""The single-pass stable compactions of K8 resident_compact and K11
fullsort_dedup (kernels/csrc/resident.cu, fullsort.cu, lookback.cuh),
modelled in numpy where the kernels cannot run: tiles of T entries,
64-bit status words tagged with the call's epoch, the look-back a warp
of 32 lanes reading a tile each a round, tiles taking tickets in the
order they start and then advancing in a random interleaving (a tile whose look-back meets
an unpublished word yields and reads again), the unset tail of K8 by
its second launch's route (a tile's unset entries before it, tile * T
- toff[tile]).  One workspace serves every call of a test, so words of
earlier calls (older epochs, more tiles) are present.

The model is held against both twins (kernels/ops.py) and against the
JAX reference's own partitions, run on the CPU through lax.sort as
jaxmc/backend/bfs.py:2348-2351 (the chunk), :2483-2486 (the explore
mask) and :1820-1851 (the full-sort branch) write them.  Every
comparison is bit-exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from jaxmc_torch.kernels import ops
from lookback_model import (AGGREGATE, INCLUSIVE, INVALID, Workspace,
                            look_back, run_tiles, state_of, word)

SENT = 2**31 - 1
NONE = 0x7FFFFFFF


def k8_model(mask, cap, flim, aok, ov, T, ws, rng):
    """(idx [cap], scalars [6]) by the model of res_compact_pass and
    res_compact_tail."""
    A, CH = mask.shape
    C = A * CH
    flat = mask.reshape(-1)
    f_of = np.tile(np.arange(CH), A)
    setm = flat & (f_of < flim)
    ntiles = max(1, -(-C // T))
    status = ws.words("k8", ntiles)
    epoch = ws.next_epoch()
    toff = [0] * ntiles
    red = [0, 0, 0]
    idx = np.full(cap, -1, np.int64)
    scalars = [None] * 6
    spt = -(-CH // ntiles) if CH else 0

    def pass_tile(t):
        lo, hi = t * T, min(C, (t + 1) * T)
        if aok is not None:
            fv = f_of[lo:hi] < flim
            if fv.any():
                red[0] = max(red[0], int(np.where(fv, ov.reshape(-1)[lo:hi],
                                                   0).max()))
            bad = np.nonzero(fv & ~aok.reshape(-1)[lo:hi])[0]
            if len(bad):
                red[1] = max(red[1], NONE - (lo + int(bad[0])))
            for f in range(t * spt, min(flim, (t + 1) * spt)):
                if not mask[:, f].any():
                    red[2] = max(red[2], NONE - f)
                    break
        mine = lo + np.nonzero(setm[lo:hi])[0]
        yield
        excl = yield from look_back(status, t, epoch, len(mine))
        toff[t] = excl
        if t == ntiles - 1:
            scalars[0] = excl + len(mine)
        for j, i in enumerate(mine):
            if excl + j < cap:
                idx[excl + j] = i

    def tail_tile(t):
        if t == 0:
            m, b, d = red
            scalars[1:] = [m, int(b != 0), NONE - b if b else 0,
                           int(d != 0), NONE - d if d else 0]
            red[:] = [0, 0, 0]
        total = scalars[0]
        need = cap - total
        ub = t * T - toff[t]
        if ub >= need:
            return
        yield
        lo, hi = t * T, min(C, (t + 1) * T)
        unset = lo + np.nonzero(~setm[lo:hi])[0]
        for j, i in enumerate(unset):
            if ub + j < need:
                idx[total + ub + j] = i

    run_tiles(ntiles, pass_tile, rng)
    # the tail's blocks: the tiles below cap / T (block 0 at least), in
    # any order
    tail = max(1, min(ntiles, -(-cap // T)))
    order = rng.permutation(tail)
    run_tiles(tail, lambda k: tail_tile(int(order[k])), rng)
    assert red == [0, 0, 0]
    return idx, scalars


def k11_model(skeys, sflag, perm, SC, C, T, ws, rng):
    """(new_cidx [C], seen2 [SC, K], counts) by the model of
    fullsort_pass: two look-backs side by side, one a count."""
    N, K = skeys.shape
    ntiles = max(1, -(-N // T))
    st_new = ws.words("k11_new", ntiles)
    st_keep = ws.words("k11_keep", ntiles)
    epoch = ws.next_epoch()
    new_cidx = np.zeros(C, np.int64)
    seen2 = np.full((SC, K), -9, np.int64)
    counts = [None, None]
    neq = np.ones(N, bool)
    neq[1:] = (skeys[1:] != skeys[:-1]).any(axis=1)
    rvalid = skeys[:, 0] == 0
    new = (sflag != 0) & rvalid & neq
    keep = ((sflag == 0) & rvalid) | new

    def tile(t):
        lo, hi = t * T, min(N, (t + 1) * T)
        rn = lo + np.nonzero(new[lo:hi])[0]
        rk = lo + np.nonzero(keep[lo:hi])[0]
        yield
        gn = look_back(st_new, t, epoch, len(rn))
        gk = look_back(st_keep, t, epoch, len(rk))
        en = ek = None
        while en is None or ek is None:     # the two warps interleave
            for which in rng.permutation(2):
                g = (gn, gk)[which]
                if (en, ek)[which] is not None:
                    continue
                try:
                    next(g)
                except StopIteration as stop:
                    if which == 0:
                        en = stop.value
                    else:
                        ek = stop.value
            yield
        if t == ntiles - 1:
            counts[:] = [en + len(rn), ek + len(rk)]
        for j, i in enumerate(rn):
            if en + j < C:
                new_cidx[en + j] = perm[i] - SC
        for j, i in enumerate(rk):
            if ek + j < SC:
                seen2[ek + j] = skeys[i]

    run_tiles(ntiles, tile, rng)
    return new_cidx, seen2, counts


# ---------------------------------------------------------------------------
# the reference's partitions, as bfs.py writes them
# ---------------------------------------------------------------------------

def ref_chunk(en, flim, cap):
    """bfs.py:2320-2351: the valid grid and its stable partition."""
    A, CH = en.shape
    fvalid = jnp.arange(CH) < flim
    cvalid = (jnp.asarray(en) & fvalid[None, :]).reshape(A * CH)
    ops_ = ((1 - cvalid.astype(jnp.int32)),
            jnp.arange(A * CH, dtype=jnp.int32))
    comp = lax.sort(ops_, num_keys=1, is_stable=True)
    return np.asarray(comp[1][:cap]), int(jnp.sum(cvalid, dtype=jnp.int32))


def ref_explore(explore, cap):
    """bfs.py:2483-2486: the explore mask's stable partition."""
    idx4 = jnp.arange(explore.shape[0], dtype=jnp.int32)
    ops4 = ((1 - jnp.asarray(explore).astype(jnp.int32)), idx4)
    comp4 = lax.sort(ops4, num_keys=1, is_stable=True)
    return np.asarray(comp4[1][:cap])


def ref_fullsort(skeys, sflag, perm, SC, C):
    """bfs.py:1834-1851 on the sorted keys: new, keep and the two
    stable partitions."""
    skeys, sflag, perm = (jnp.asarray(x) for x in (skeys, sflag, perm))
    K = skeys.shape[1]
    cidx = perm - SC
    rvalid = skeys[:, 0] == 0
    neq_prev = jnp.concatenate([
        jnp.array([True]), jnp.any(skeys[1:] != skeys[:-1], axis=1)])
    new = (sflag == 1) & rvalid & neq_prev
    comp = lax.sort(((1 - new.astype(jnp.int32)), cidx), num_keys=1,
                    is_stable=True)
    keep = ((sflag == 0) & rvalid) | new
    comp3 = lax.sort(((1 - keep.astype(jnp.int32)),) +
                     tuple(skeys[:, i] for i in range(K)), num_keys=1,
                     is_stable=True)
    return (np.asarray(comp[1][:C]), np.asarray(jnp.stack(comp3[1:],
                                                          axis=1)[:SC]),
            (int(jnp.sum(new)), int(jnp.sum(keep))))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [16, 64, 4096])
@pytest.mark.parametrize("A,CH", [(1, 1), (1, 63), (3, 700), (13, 257),
                                  (2, 2500)])
@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_k8_model_matches_twin_and_reference(T, A, CH, p):
    """The chunk and explore sites, every cap from 0 to C and flim from
    0 to CH, several calls on one workspace."""
    rng = np.random.default_rng(T + A * 1000 + CH + int(p * 10))
    ws = Workspace()
    C = A * CH
    for flim in sorted({0, CH // 2 + 1, CH}):
        en = rng.random((A, CH)) < p
        aok = rng.random((A, CH)) > 0.02
        ov = np.where(rng.random((A, CH)) < 0.02,
                      rng.integers(1, 4, (A, CH)), 0).astype(np.int32)
        n = int((en & (np.arange(CH) < flim)[None, :]).sum())
        for cap in sorted({0, 1, max(n - 3, 0), n, min(n + 7, C), C}):
            idx, sc = k8_model(en, cap, flim, aok, ov, T, ws, rng)
            ti, ts = ops.resident_compact_twin(
                torch.as_tensor(en), cap, flim, torch.as_tensor(aok),
                torch.as_tensor(ov))
            np.testing.assert_array_equal(idx, ti.numpy())
            assert sc == ts.tolist()
            ridx, rcount = ref_chunk(en, flim, cap)
            np.testing.assert_array_equal(idx, ridx)
            assert sc[0] == rcount
    m = rng.random(C) < p
    for cap in sorted({0, int(m.sum()), C}):
        idx, sc = k8_model(m[None, :], cap, C, None, None, T, ws, rng)
        np.testing.assert_array_equal(idx, ref_explore(m, cap))
        np.testing.assert_array_equal(
            idx, ops.resident_compact_twin(torch.as_tensor(m), cap)[0])
        assert sc == [int(m.sum()), 0, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def _sorted_tables(rng, SC, C, K, vals):
    """Sorted seen + candidate keys (a live seen prefix, invalid rows,
    duplicates) as the full-sort step sorts them, with flags and perm."""
    seen = np.full((SC, K), SENT, np.int32)
    sv = np.unique(rng.integers(-vals, vals, (SC // 2, K - 1))
                   .astype(np.int32), axis=0)
    seen[:len(sv), 0] = 0
    seen[:len(sv), 1:] = sv
    cand = np.zeros((C, K), np.int32)
    cand[:, 1:] = rng.integers(-vals, vals, (C, K - 1))
    bad = rng.random(C) < 0.2
    cand[bad, 0] = 1
    cand[bad, 1:] = SENT
    allk = torch.as_tensor(np.concatenate([seen, cand]))
    perm = ops.lsd_sort(allk)
    skeys = allk[perm].numpy()
    perm = perm.to(torch.int32).numpy()
    return skeys, (perm >= SC).astype(np.int32), perm


@pytest.mark.parametrize("T", [16, 64, 2048])
@pytest.mark.parametrize("K", [2, 3, 5])
@pytest.mark.parametrize("SC,C", [(1, 0), (0, 1), (40, 25), (700, 900),
                                  (1500, 0)])
def test_k11_model_matches_twin_and_reference(T, K, SC, C):
    """Runs of equal keys across tile boundaries (few distinct keys),
    N = 1, the look-backs of both counts interleaved; several calls on
    one workspace."""
    rng = np.random.default_rng(T + K * 10000 + SC * 7 + C)
    ws = Workspace()
    for vals in (2, 50):
        skeys, sflag, perm = _sorted_tables(rng, SC, C, K, vals)
        nc, s2, counts = k11_model(skeys, sflag, perm, SC, C, T, ws, rng)
        tn, ts, tc = ops.fullsort_dedup_twin(
            torch.as_tensor(skeys), torch.as_tensor(sflag),
            torch.as_tensor(perm), SC, C)
        rn, rs, rc = ref_fullsort(skeys, sflag, perm, SC, C)
        assert tuple(counts) == rc == tuple(tc.tolist())
        n_new, n_keep = rc
        np.testing.assert_array_equal(nc[:n_new], rn[:n_new])
        np.testing.assert_array_equal(nc[:n_new], tn.numpy()[:n_new])
        np.testing.assert_array_equal(s2[:n_keep], rs[:n_keep])
        np.testing.assert_array_equal(s2[:n_keep], ts.numpy()[:n_keep])
        # nothing past the prefixes: new_cidx stays zeros, seen2 unwritten
        assert not nc[n_new:].any() and (s2[n_keep:] == -9).all()


def test_epochs_reject_words_of_earlier_calls():
    """A word of an earlier call reads as unpublished, whatever its state."""
    for st in (AGGREGATE, INCLUSIVE):
        w = word(6, st, 123)
        assert state_of(w, 6) == st
        assert state_of(w, 7) == INVALID
    assert state_of(0, 1) == INVALID
    assert word(2**30 - 1, INCLUSIVE, 2**31 - 1) < 2**64


class _Lib:
    """A kernel library's workspace size: 16 bytes a tile and a ticket."""

    @staticmethod
    def nbytes(tiles):
        return 16 * tiles + 8


def test_workspace_epochs_streams_and_growth():
    """ops._Workspace: one buffer a (device, stream) with consecutive
    epochs, another stream's own buffer, growth to at least double, and
    a cleared buffer when the epochs wrap or after a drop."""
    ws, lib, dev = ops._Workspace("nbytes"), _Lib(), torch.device("cpu")
    with ws.lock:
        p1, c1, e1 = ws.take(lib, dev, 7, 3)
        p2, c2, e2 = ws.take(lib, dev, 7, 2)
        q1, _, f1 = ws.take(lib, dev, 8, 3)
    assert (p2, c2, e1, e2) == (p1, 3, 1, 2)
    assert q1 != p1 and f1 == 1
    buf = ws._by_key[(str(dev), 7)][0]
    assert buf.numel() * 8 >= lib.nbytes(3)
    buf.fill_(5)
    with ws.lock:
        p3, c3, e3 = ws.take(lib, dev, 7, 4)
    assert (c3, e3) == (6, 1)
    assert not ws._by_key[(str(dev), 7)][0].any()
    ws._by_key[(str(dev), 7)][0].fill_(5)
    ws._by_key[(str(dev), 7)][2] = ws.EPOCHS - 1
    with ws.lock:
        _, _, e4 = ws.take(lib, dev, 7, 4)
    assert e4 == 1 and not ws._by_key[(str(dev), 7)][0].any()
    ws.drop(dev, 7)
    with ws.lock:
        _, c5, e5 = ws.take(lib, dev, 7, 1)
    assert (c5, e5) == (1, 1)


def test_workspace_epochs_unique_across_threads():
    """Calls from several threads, each taking its epoch under the lock:
    every epoch on a stream is taken once."""
    import threading
    ws, lib, dev = ops._Workspace("nbytes"), _Lib(), torch.device("cpu")
    seen = []

    def run():
        for _ in range(500):
            with ws.lock:
                seen.append(ws.take(lib, dev, 0, 8)[2])

    threads = [threading.Thread(target=run) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sorted(seen) == list(range(1, 2001))

