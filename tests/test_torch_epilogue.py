"""K7 hstep_epilogue's single launch (kernels/csrc/hstep.cu), modelled
in numpy where the kernel cannot run: tiles of T candidates over
max(C, CH) indices taking tickets, each tile's valid count published
and its exclusive prefix found by the look-back of lookback.cuh
(tests/lookback_model.py: epoch-tagged status words, tiles advancing in
a random interleaving), the valid candidates written at their ranks,
each tile's share of the dead slots, the three order-free atomicMax
reductions, and the block that finishes last (by a done-count) writing
the scalars and setting the reductions and the count back to 0.  One
workspace serves every call of a test, so words of earlier calls are
present.

The model is held against ops.hstep_epilogue_twin, and the twin against
the reference: the masks and reductions of jaxmc/backend/bfs.py:1938
_hstep_core (:1959-1978), run through jax.numpy on the CPU, and the
host's reads of them in _run_host_seen (np.argmax of the assert and
dead masks, np.nonzero(cvalid), keys[valid_idx][:, 1:], the candidate
rows).  Every comparison is bit-exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc_torch.compile.kernel2 import OV_PACK
from jaxmc_torch.kernels import ops
from lookback_model import Workspace, look_back, run_tiles

NONE = 0x7FFFFFFF
# the kernel's tile: 256 threads x 16 candidates (lookback.cuh kTile)
TILE = 4096
OUTS = ("idx", "fps", "rows", "inv_ok", "explore")


def k7_model(en, aok, ov, fcount, keys, cand, pack_ovf, ov_pack, inv, exp,
             T, ws, rng):
    """hstep_kernel's outputs: scalars [6], dead [CH] and the compacted
    valid candidates (entries past nv keep their fill, -9)."""
    A, CH = en.shape
    C = A * CH
    PW = cand.shape[1]
    ntiles = max(1, -(-max(C, CH) // T))
    status = ws.words("k7", ntiles)
    red = ws.words("k7_red", 3)
    done = ws.words("k7_done", 1)
    assert red == [0, 0, 0] and done == [0]
    epoch = ws.next_epoch()
    spt = -(-CH // ntiles) if CH else 0
    f_of = np.tile(np.arange(CH), A)
    fv_all = f_of < fcount
    valid = en.reshape(-1) & fv_all
    flat_ov, flat_aok = ov.reshape(-1), aok.reshape(-1)
    scalars = [None] * 6
    dead = np.full(CH, 2, np.int64)
    out = dict(idx=np.full(C, -9, np.int64), fps=np.full((C, 4), -9, np.int64),
               rows=np.full((C, PW), -9, np.int64),
               inv_ok=np.full(C, -9, np.int64),
               explore=np.full(C, -9, np.int64))

    def tile(t):
        lo, hi = t * T, min(C, (t + 1) * T)
        fv = fv_all[lo:hi]
        if fv.any():
            red[0] = max(red[0], int(np.where(fv, flat_ov[lo:hi], 0).max()))
            bad = np.nonzero(fv & ~flat_aok[lo:hi])[0]
            if len(bad):
                red[1] = max(red[1], NONE - (lo + int(bad[0])))
        mine = lo + np.nonzero(valid[lo:hi])[0]
        yield
        excl = yield from look_back(status, t, epoch, len(mine))
        if t == ntiles - 1:
            scalars[0] = excl + len(mine)
        for j, i in enumerate(mine):
            out["idx"][excl + j] = i
            out["fps"][excl + j] = keys[i, 1:5]
            out["rows"][excl + j] = cand[i]
            out["inv_ok"][excl + j] = inv[i]
            out["explore"][excl + j] = exp[i]
        yield
        for f in range(t * spt, min(CH, (t + 1) * spt)):
            d = f < fcount and not en[:, f].any()
            dead[f] = d
            if d:
                red[2] = max(red[2], NONE - f)
        done[0] += 1
        if done[0] == ntiles:
            m, b, d = red
            red[:] = [0, 0, 0]
            done[0] = 0
            scalars[1:] = [m if m else (ov_pack if pack_ovf else 0),
                           int(b != 0), NONE - b if b else 0,
                           int(d != 0), NONE - d if d else 0]

    run_tiles(ntiles, tile, rng)
    assert (dead != 2).all(), "a dead slot no tile wrote"
    return dict(scalars=scalars, dead=dead.astype(bool), **out)


def ref_hstep(en, aok, ov, fcount, keys, cand, pack_ovf, inv, exp):
    """bfs.py:1959-1978 as _hstep_core writes them (jax.numpy, CPU) and
    the host's reads in _run_host_seen."""
    A, CH = en.shape
    en_j, aok_j = jnp.asarray(en), jnp.asarray(aok)
    fvalid = jnp.arange(CH) < fcount
    valid = en_j & fvalid[None, :]
    assert_bad = (~aok_j) & fvalid[None, :]
    overflow = jnp.where(fvalid[None, :], jnp.asarray(ov), 0)
    dead = fvalid & ~jnp.any(en_j, axis=0)
    gen = jnp.sum(valid)
    base_ov = jnp.max(overflow, initial=0)
    ov_out = jnp.where(base_ov != 0, base_ov,
                       jnp.where(pack_ovf, OV_PACK, 0))
    ab = np.asarray(assert_bad)
    dd = np.asarray(dead)
    vidx = np.nonzero(np.asarray(valid.reshape(A * CH)))[0]
    return dict(scalars=[int(gen), int(ov_out), int(ab.any()),
                         int(np.argmax(ab)) if ab.any() else 0,
                         int(dd.any()),
                         int(np.argmax(dd)) if dd.any() else 0],
                dead=dd, idx=vidx, fps=keys[vidx][:, 1:], rows=cand[vidx],
                inv_ok=inv[vidx], explore=exp[vidx])


def _inputs(rng, A, CH, p, fcount, case):
    C = A * CH
    en = rng.random((A, CH)) < p
    aok = np.ones((A, CH), bool)
    ov = np.zeros((A, CH), np.int32)
    if case == "assert_first":
        aok[0, 0] = False
    elif case == "assert_last" and fcount:
        aok[A - 1, fcount - 1] = False
    elif case == "dead_first":
        en[:, 0] = False
    elif case == "dead_last" and fcount:
        en[:, fcount - 1] = False
        en[:, :fcount - 1] |= True
    elif case == "overflow":
        ov = np.where(rng.random((A, CH)) < 0.01, rng.integers(1, 4, (A, CH)),
                      0).astype(np.int32)
        aok = rng.random((A, CH)) > 0.01
    keys = rng.integers(-2**31, 2**31, (C, 5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (C, 3)).astype(np.int32)
    return (en, aok, ov, fcount, keys, cand, rng.random(C) < 0.9,
            rng.random(C) < 0.7)


def _check(model, want, twin):
    assert model["scalars"] == want["scalars"] == twin["scalars"].tolist()
    nv = want["scalars"][0]
    np.testing.assert_array_equal(model["dead"], want["dead"])
    np.testing.assert_array_equal(twin["dead"].numpy(), want["dead"])
    for k in OUTS:
        np.testing.assert_array_equal(model[k][:nv], want[k], err_msg=k)
        np.testing.assert_array_equal(twin[k].numpy()[:nv], want[k],
                                      err_msg=k)
        # the kernel writes nothing past nv
        assert (model[k][nv:] == -9).all(), k


CASES = [
    # (A, CH, p, fcounts, case)
    (13, 700, 0.4, "0,CH", "plain"),
    (1, 1, 1.0, "0,CH", "plain"),
    (3, 5000, 0.0, "CH,half", "plain"),          # no valid candidate
    (3, 5000, 1.0, "CH,half", "plain"),          # every one valid
    (7, 333, 0.5, "CH,half", "assert_first"),
    (7, 333, 0.5, "CH,half", "assert_last"),
    (5, 2049, 0.5, "CH,half", "dead_first"),
    (5, 2049, 0.5, "CH,half", "dead_last"),
    (4, 1500, 0.6, "CH,half", "overflow"),
    (0, 900, 0.5, "CH,half", "plain"),           # every arm demoted
    (2, 9000, 0.3, "CH,half", "plain"),          # C not a multiple of T
]


@pytest.mark.parametrize("T", [16, 256, TILE])
@pytest.mark.parametrize("A,CH,p,fcounts,case", CASES)
def test_k7_model_matches_twin_and_reference(T, A, CH, p, fcounts, case):
    """Each case at two fcounts, with and without K2's pack flag, all on
    one workspace after a larger call has left its words."""
    rng = np.random.default_rng(T + A * 1000 + CH + int(p * 10))
    ws = Workspace()
    warm = _inputs(rng, 3, 3 * T + 5, 0.5, 3 * T + 5, "plain")
    k7_model(*warm[:6], False, OV_PACK, *warm[6:], T, ws, rng)
    for fc in fcounts.split(","):
        fcount = {"0": 0, "CH": CH, "half": CH // 2 + 1}[fc]
        en, aok, ov, fcount, keys, cand, inv, exp = _inputs(
            rng, A, CH, p, fcount, case)
        for pack_ovf in (False, True):
            model = k7_model(en, aok, ov, fcount, keys, cand, pack_ovf,
                             OV_PACK, inv, exp, T, ws, rng)
            want = ref_hstep(en, aok, ov, fcount, keys, cand, pack_ovf,
                             inv, exp)
            twin = ops.hstep_epilogue_twin(
                *(torch.as_tensor(x) for x in (en, aok, ov)), fcount,
                torch.as_tensor(keys), torch.as_tensor(cand),
                torch.tensor(pack_ovf), OV_PACK, torch.as_tensor(inv),
                torch.as_tensor(exp))
            _check(model, want, twin)
            if case in ("assert_first", "assert_last") and fcount:
                assert want["scalars"][2] == 1
                assert want["scalars"][3] == (
                    0 if case == "assert_first" else (A - 1) * CH + fcount - 1)
            if case in ("dead_first", "dead_last") and fcount:
                assert want["scalars"][4] == 1
                assert want["scalars"][5] == (
                    0 if case == "dead_first" else fcount - 1)
            if case == "overflow" and fcount:
                # a kernel code outranks the pack flag
                assert want["scalars"][1] == int(ov[:, :fcount].max()) > 0
            elif case == "plain":
                assert want["scalars"][1] == (OV_PACK if pack_ovf else 0)


def test_k7_tiles_cover_the_grid_and_the_slots():
    """The grid is max(C, CH) wide, so every candidate and every dead
    slot belongs to a tile, also when CH exceeds C (A = 0, 1) or the
    tiles outnumber the slots."""
    for A, CH in ((0, 10000), (1, 4097), (40, 5), (2, 1)):
        C = A * CH
        ntiles = max(1, -(-max(C, CH) // TILE))
        spt = -(-CH // ntiles) if CH else 0
        assert ntiles * TILE >= max(C, CH, 1)
        assert ntiles * spt >= CH
