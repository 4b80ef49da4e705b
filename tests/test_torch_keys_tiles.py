"""K2 keys_of's one launch over tiles (jaxmc_torch/kernels/csrc/keys.cu)
modelled in numpy, where the kernel cannot run, and held bit for bit
against ops.keys_of_twin on synthetic lane plans (keys_cases.py: odd W
and PW, full lanes, sentinel codes, guarded lanes out of range) and
against the JAX reference's TpuExplorer._keys_of (jaxmc/backend/bfs.py:
1584, with LanePlan.pack_rows and fingerprint128) on the fixture
models' plans and candidate blocks, on the CPU.

The model: each warp of the grid works tiles of RW rows (ops.
keys_geometry) grid-stride, the blocks in a random order; per tile
each lane's RW / 32 validity bytes and a warp scan of their counts
list the valid rows in row order; the listed rows are taken P at a
time, only their lanes (and basis lanes) are read, each exactly once,
and no invalid row ever; lane u packs the u-th row of a pass by the
kernel's walk (lanes in order, a word handed on when the lane's word
index moves on) and keys it (the emitted words, a packed basis, raw
basis lanes, or their fingerprint); the staged key and packed rows sit
at their destination's 16-byte phase and go out as a head, 16-byte
words and a tail, an invalid row's words filled on the way (a valid
row's word no lane staged fails: POISON; every output word is written
once).  The overflow flag:
each block that saw a guarded lane out of range ORs the accumulator,
the block finishing last (random order) writes the flag and leaves the
accumulator and the done count at zero, so a second call on the same
words is right."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import TpuExplorer
from jaxmc.session import load_model as jload
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload
from keys_cases import PATTERNS, keys_case, plan, plan_tensors

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")
SENT = 2**31 - 1
M32 = 0xFFFFFFFF
POISON = -0x5A5A5A5B
KIND = {"stored": 0, "canon": 1, "view": 2}


def wrap(x):
    """int64 -> the int32 value of its low 32 bits."""
    x = x & M32
    return np.where(x >= 2**31, x - 2**32, x)


def pack_walk(lanes, p):
    """keys.cu pack_row over the listed rows' staged lanes [m, W]: the
    emitted words in order [m, PW] (uint32 values) and the guard."""
    m, W = lanes.shape
    PW = p["PW"]
    out = np.zeros((m, PW), np.int64)
    bad = np.zeros(m, bool)
    acc = np.zeros(m, np.int64)
    cur = 0
    for i in range(W):
        v = lanes[:, i].astype(np.int64)
        if p["full"][i]:
            code_u = v & M32
        else:
            sc = int(p["sent_code"][i])
            code = np.where((sc >= 0) & (v == SENT), sc,
                            wrap(v - int(p["bias"][i])))
            bad |= (code < 0) | (code > int(p["allowed"][i]))
            code_u = code & M32
        while cur < int(p["word"][i]):
            out[:, cur] = acc
            acc = np.zeros(m, np.int64)
            cur += 1
        acc |= ((code_u & int(p["mask"][i])) << int(p["shift"][i])) & M32
    while cur < PW:
        out[:, cur] = acc
        acc = np.zeros(m, np.int64)
        cur += 1
    return out, bad


def fingerprint(words):
    """KeyAcc<true>: four multiply-xor streams over the key words."""
    mix = [(0x9E3779B1, 0x85EBCA6B), (0xC2B2AE35, 0x27D4EB2F),
           (0x165667B1, 0x9E3779B1), (0x85EBCA6B, 0xC2B2AE35)]
    out = []
    for j, (m1, m2) in enumerate(mix):
        h = np.full(len(words), (2166136261 + j * 0x9E3779B1) & M32,
                    np.uint64)
        for c in range(words.shape[1]):
            x = words[:, c].astype(np.uint64) & np.uint64(M32)
            h = ((h ^ ((x * np.uint64(m1)) & np.uint64(M32)))
                 * np.uint64(m2)) & np.uint64(M32)
        h ^= h >> np.uint64(15)
        h = (h * np.uint64(0x2C1B3C6D)) & np.uint64(M32)
        h ^= h >> np.uint64(12)
        out.append(h.astype(np.int64))
    return np.stack(out, axis=1)


def rows_out(src, nw, k, rb, key, g, g0, phase, writes):
    """keys.cu rows_out: a head to g's 16-byte boundary, words, a tail;
    the words of an invalid row (flag bit 0 clear) are the fill."""
    h = min((4 - ((phase + g0) & 3)) & 3, nw)
    nv = (nw - h) >> 2
    assert (phase + g0 + h) % 4 == 0 or nv == 0
    i = np.arange(nw)
    live = (rb[i // max(k, 1)] & 1) == 1
    fill = np.where(key & (i % max(k, 1) == 0), 1, SENT)
    vals = np.where(live, src[:nw], fill)
    assert (vals != POISON).all()            # a valid row's word unstaged
    for a, z in ((0, h), (h, h + 4 * nv), (h + 4 * nv, nw)):
        g[g0 + a:g0 + z] = vals[a:z]
        writes[g0 + a:g0 + z] += 1


def model_keys(rows, valid, p, fp, kind, basis, bw, geom, blocks, ws, rng):
    """The keys, packed rows, flag and per-row flags of one launch at
    geometry (warps, RW, P): warp g of the grid works tiles g, g + nw, ...
    of RW rows (nw the grid's warps), the blocks finishing in a random
    order; lane l lists rows l * RW / 32 .., a warp scan of their counts
    in row order; the listed rows in passes of P."""
    warps, RW, P = geom[:3]
    N, W = rows.shape
    PW = p["PW"]
    K = (4 if fp else (bw if kind == 2 else PW)) + 1
    per = RW // 32
    keys = np.full(N * K, POISON, np.int64)
    packed = np.full(N * PW, POISON, np.int64)
    row_ovf = np.zeros(N, bool)
    wk, wp = np.zeros(N * K, np.int64), np.zeros(N * PW, np.int64)
    reads = np.zeros(N, np.int64)
    ph_k, ph_p = int(rng.integers(4)), int(rng.integers(4))
    ntiles = -(-N // RW)
    blocks = max(1, min(blocks, -(-ntiles // warps)))
    nw = blocks * warps
    for b in rng.permutation(blocks):
        any_bad = False
        for g in range(int(b) * warps, (int(b) + 1) * warps):
            for tile in range(g, ntiles, nw):
                r0 = tile * RW
                nt = min(RW, N - r0)
                vt = np.zeros(RW, bool)
                vt[:nt] = valid[r0:r0 + nt]
                counts = vt.reshape(32, per).sum(axis=1)
                before = np.concatenate([[0], np.cumsum(counts)[:-1]])
                lst = np.nonzero(vt)[0]
                # lane r // per writes row r at its scan offset plus the
                # valid rows before r among its own
                own = np.cumsum(vt) - vt
                pos = before[lst // per] + own[lst] - own[lst // per * per]
                assert (pos == np.arange(len(lst))).all()
                rb = np.zeros(RW, np.int64)
                rb[lst] = 1
                kt = np.full(RW * K + 3, POISON, np.int64)
                pt = np.full(RW * PW + 3, POISON, np.int64)
                ok, op = (ph_k + r0 * K) & 3, (ph_p + r0 * PW) & 3
                for c0 in range(0, len(lst), P):
                    part = lst[c0:c0 + P]
                    reads[r0 + part] += 1
                    words, bad_row = pack_walk(rows[r0 + part], p)
                    bad_key = np.zeros(len(part), bool)
                    if kind == 0:
                        kw = words
                    elif kind == 1:
                        kw, bad_key = pack_walk(basis[r0 + part], p)
                    else:
                        kw = basis[r0 + part].astype(np.int64) & M32
                    kw = fingerprint(kw) if fp else kw
                    kt[ok + part * K] = 0
                    kt[ok + part[:, None] * K + 1 + np.arange(K - 1)] = \
                        wrap(kw)
                    pt[op + part[:, None] * PW + np.arange(PW)] = wrap(words)
                    rb[part[bad_row]] = 3
                    any_bad |= bool((bad_row | bad_key).any())
                rows_out(kt[ok:], nt * K, K, rb, True, keys, r0 * K, ph_k,
                         wk)
                rows_out(pt[op:], nt * PW, PW, rb, False, packed, r0 * PW,
                         ph_p, wp)
                row_ovf[r0:r0 + nt] = rb[:nt] == 3
        ws["acc"] |= int(any_bad)
        ws["done"] += 1
        if ws["done"] == blocks:             # the last block to finish
            ws["flag"] = ws["acc"] != 0
            ws["acc"], ws["done"] = 0, 0
    if N == 0:                               # one block, no tile
        ws["flag"] = ws["acc"] != 0
        ws["acc"], ws["done"] = 0, 0
    assert (wk == 1).all() and (wp == 1).all()
    assert (reads == valid).all()            # valid rows once, no other
    return (keys.reshape(N, K), packed.reshape(N, PW), ws.pop("flag"),
            row_ovf)


def _twin(rows, valid, p, fp, kind, basis):
    pt = plan_tensors(p, "cpu")
    kw = {}
    if kind:
        kw = dict(basis=torch.as_tensor(basis), basis_packed=kind == 1)
    r, v = torch.as_tensor(rows), torch.as_tensor(valid)
    k, pk, f = ops.keys_of_twin(r, v, pt, fp, False, **kw)
    return k.numpy(), pk.numpy(), bool(f), \
        (ops.pack_rows_twin(r, pt)[1] & v).numpy()


def _check(model, twin):
    for a, b in zip(model[:2], twin[:2]):
        np.testing.assert_array_equal(a, b)
    assert model[2] == twin[2]
    np.testing.assert_array_equal(model[3], twin[3])


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("basis", ["stored", "canon", "view"])
@pytest.mark.parametrize("W", [1, 3, 7, 26, 138])
def test_keys_of_model_matches_twin(W, basis, fp):
    """Synthetic plans in every basis, every validity pattern, a guarded
    lane out of range (rows and canonical basis) or none, at the card's
    geometry (ops.keys_geometry), at a small budget (small tiles and
    passes) and at tiles of 160 rows (5 validity bytes a lane) in passes
    of 48; two calls on the same words."""
    kind = KIND[basis]
    rng = np.random.default_rng(W * 10 + kind + 3 * fp)
    # a wide row (W 138) walks its lanes in Python: fewer patterns
    wide = ("all", "edges", "sparse") if W > 100 else PATTERNS
    for budget in (None, 4096, (2, 160, 48)):
        for pattern in wide if budget is None else ("edges", "sparse"):
            for bad in (False, True):
                seed = W + len(pattern) + 7 * bad
                p = plan(W, seed)
                bw = min(W, 3 + seed % 3) if kind == 2 else p["PW"]
                K = (4 if fp else bw) + 1
                geom = budget if isinstance(budget, tuple) else \
                    ops.keys_geometry(W, p["PW"], K, bw, kind, budget, fp)
                T = geom[1]
                n = 12 * T + 77 if budget is None else 9 * T + 5
                p, rows, valid, other = keys_case(W, n, pattern, T, seed,
                                                  bad=bad)
                b = None if kind == 0 else (
                    other if kind == 1 else
                    np.ascontiguousarray(other[:, :bw]))
                ws = dict(acc=0, done=0)
                for _ in range(2 if pattern == "sparse" else 1):
                    model = model_keys(rows, valid, p, fp, kind, b, bw, geom,
                                       int(rng.integers(1, 5)), ws, rng)
                    _check(model, _twin(rows, valid, p, fp, kind, b))
                    assert ws == dict(acc=0, done=0)


def test_keys_of_model_empty_and_single_rows():
    """N = 0 (one block writes the flag) and one row, valid or not."""
    p = plan(5, 1)
    for n, pattern in ((0, "all"), (1, "all"), (1, "none")):
        _p, rows, valid, _o = keys_case(5, n, pattern, 256, 1)
        ws = dict(acc=0, done=0)
        model = model_keys(rows, valid, p, False, 0, None, p["PW"],
                           (8, 128, 32), 1, ws, np.random.default_rng(0))
        _check(model, _twin(rows, valid, p, False, 0, None))


@pytest.mark.parametrize("W,PW,K,bw,kind", [(10, 2, 3, 2, 0), (9, 2, 3, 2, 1),
                                            (3, 1, 5, 4, 2), (26, 5, 6, 5, 0),
                                            (138, 20, 21, 20, 1)])
def test_keys_geometry_matches_the_kernel_layout(W, PW, K, bw, kind):
    """keys.cu's shared memory for the staged plan and a block of warps,
    each with its list and flag bytes, its pass of P rows' lanes and its
    tile's staged key and packed rows, word for word, within the budget;
    a geometry the kernel takes (1-8 warps, tiles of a multiple of 32
    rows up to 256, 1 <= P <= RW)."""
    warps, RW, P, smem = ops.keys_geometry(W, PW, K, bw, kind)

    def pad(x):
        return (x + 3) // 4 * 4
    bl = 0 if kind == 0 else (bw if kind == 2 else W) | 1
    warp = (2 * pad(-(-RW // 4)) + pad(P * (W | 1) + 3)
            + (pad(P * bl + 3) if bl else 0)
            + pad(RW * K + 3) + pad(RW * PW + 3))
    assert smem == 4 * (4 * W + pad(W) + warps * warp) <= ops.KEYS_SMEM
    assert 1 <= warps <= 8 and RW % 32 == 0 and 32 <= RW <= 256
    assert 1 <= P <= RW


def _engines(spec, cfg, seen_mode):
    kw = dict(seen_mode=seen_mode)
    ej = TpuExplorer(jload(os.path.join(SPECS, spec),
                           os.path.join(SPECS, cfg), False), **kw)
    et = TorchExplorer(tload(os.path.join(SPECS, spec),
                             os.path.join(SPECS, cfg), False),
                       device="cpu", **kw)
    return ej, et


@pytest.mark.parametrize("seen_mode", ["exact", "fingerprint"])
@pytest.mark.parametrize("spec,cfg", [
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("symtoy_scaled.tla", "symtoy_scaled.cfg"),
    ("viewtoy_scaled.tla", "viewtoy_scaled.cfg"),
    ("msgstoy.tla", "msgstoy.cfg"),
])
def test_keys_of_model_matches_reference(spec, cfg, seen_mode):
    """The fixture models' plans and key bases (the packed row, the
    SYMMETRY orbit minimum, the VIEW lanes) on a candidate block of real
    successor rows: the model equals the reference's _keys_of."""
    from jaxmc.engine.simulate import sample_states
    ej, et = _engines(spec, cfg, seen_mode)
    n = 900
    rows = np.stack([ej.layout.encode(s) for s in sample_states(
        ej.model, bfs_states=n, n_walks=5, walk_depth=20)])
    rng = np.random.default_rng(11)
    rows = rows[rng.integers(0, len(rows), n)].astype(np.int32)
    valid = rng.random(n) < 0.3
    rows[~valid] = SENT
    kj, pj, oj = ej._keys_of(jnp.asarray(rows), jnp.asarray(valid))
    r, v = torch.as_tensor(rows), torch.as_tensor(valid)
    basis, kind = None, 0
    if et.canon is not None or et.view_fn is not None:
        crows = r if et.canon is None else et._canon(r, v)
        if et.view_fn is not None:
            basis, kind = et.view_fn(crows).reshape(n, -1).to(
                torch.int32).numpy(), 2
        else:
            basis, kind = crows.numpy(), 1
    pl = et.plan
    p = dict(word=pl.word.astype(np.int64), shift=pl.shift.astype(np.int64),
             mask=pl.mask.astype(np.int64), bias=pl.bias.astype(np.int64),
             allowed=pl.allowed.astype(np.int64),
             full=pl.full.astype(np.int64),
             sent_code=pl.sent_code.astype(np.int64), W=pl.width,
             PW=pl.packed_width)
    bw = basis.shape[1] if kind == 2 else p["PW"]
    K = (4 if et.fp_mode else bw) + 1
    geom = ops.keys_geometry(p["W"], p["PW"], K, bw, kind, 6000, et.fp_mode)
    assert geom[0] < 8                       # several tiles a block
    model = model_keys(rows, valid, p, et.fp_mode, kind, basis, bw, geom, 3,
                       dict(acc=0, done=0), rng)
    np.testing.assert_array_equal(model[0], np.asarray(kj))
    np.testing.assert_array_equal(model[1], np.asarray(pj))
    assert model[2] == bool(oj)
