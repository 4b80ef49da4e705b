"""K15 gen_expand's staged tiles (compile/cgen.py, jmc_gen_expand_k),
modelled in numpy where the kernel cannot run: the block schedule (block
b takes tile b // groups and instance group b % groups of
kernels/ops.py gen_groups' G), the staging of a tile's rows at the odd
stride W | 1 by the kernel's head / 16-byte middle / tail split of the
rows' addresses, one thread a staged row under each instance of the
group (the emitter on exactly the staged rows, each with the constants
of its own batch member), each instance's successors staged and written
as one run (the same split of the run's address), en and aok 4 bytes at
a time from their first 4-byte boundary, ov where the thread stands.
Every output word is written once and no staged word is read before a
thread wrote it; blocks run in a random order.

The model is held bit for bit against ops.gen_expand_twin and jax.vmap
of the reference's compiled units (jaxmc/compile/kernel2.py:2464), on
rows of W odd and even, N not a multiple of T, A = 1, several groupings,
and a batch member table whose members straddle tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc_torch.compile import cgen
from jaxmc_torch.kernels import ops
from test_torch_gen import _build

POISON = -0x5A5A5A5B


def schedule(N, A, T, G):
    """(block, n0, nt, a0, a1) of every block of a launch."""
    groups = -(-A // G)
    for b in range(-(-N // T) * groups):
        tile, g = divmod(b, groups)
        n0 = tile * T
        yield b, n0, min(T, N - n0), g * G, min(A, g * G + G)


def split(addr, n, unit):
    """The kernel's head and whole units (4 words, or 4 bytes) of a run of
    n elements whose first element sits at address `addr` (in elements)
    modulo `unit`."""
    head = min(n, (unit - addr % unit) % unit)
    return head, (n - head) // unit


def copy_run(src_at, n, dst, d0, addr, unit, written):
    """dst[d0 + i] = src_at(i) for i in [0, n): each element once, the
    whole units' first elements on a unit boundary of the address."""
    head, nv = split(addr + d0, n, unit)
    for i in range(n):
        if head <= i < head + unit * nv:
            assert (addr + d0 + i - (i - head) % unit) % unit == 0
        assert not written[d0 + i]
        written[d0 + i] = True
        dst[d0 + i] = src_at(i)


def model(gm, rows, units, cvals, T, G, addr=0, seed=0):
    """The kernel's (en, aok, ov, succ) on numpy inputs; `addr` is the
    rows' first word address modulo 4 (the outputs start on 16 bytes,
    as torch allocates them)."""
    N, W = rows.shape
    A = len(units)
    ws = W | 1
    flat = rows.reshape(-1)
    en = np.zeros(A * N, np.int64)
    aok = np.zeros(A * N, np.int64)
    ov = np.full(A * N, POISON, np.int64)
    succ = np.full(A * N * W, POISON, np.int64)
    w_en = np.zeros(A * N, bool)
    w_aok = np.zeros(A * N, bool)
    w_ov = np.zeros(A * N, bool)
    w_succ = np.zeros(A * N * W, bool)
    per = N // (1 if cvals is None else len(cvals))
    blocks = list(schedule(N, A, T, G))
    np.random.default_rng(seed).shuffle(blocks)
    for _b, n0, nt, a0, a1 in blocks:
        xs = np.full(T * ws, POISON, np.int64)
        filled = np.zeros(T * ws, bool)

        def stage_at(i, n0=n0):
            return flat[n0 * W + i]
        head, nv = split(addr + n0 * W, nt * W, 4)
        for i in range(nt * W):
            if head <= i < head + 4 * nv:
                assert (addr + n0 * W + i - (i - head) % 4) % 4 == 0
            j = (i // W) * ws + i % W
            assert not filled[j]
            filled[j] = True
            xs[j] = stage_at(i)
        staged = np.stack([xs[t * ws:t * ws + W] for t in range(nt)])
        assert (staged != POISON).all()
        cv = None if cvals is None else torch.as_tensor(
            np.asarray(cvals)[(n0 + np.arange(nt)) // per])
        for a in range(a0, a1):
            e, k, o, s = ops.gen_expand_twin(
                gm, torch.as_tensor(staged.astype(np.int32)),
                torch.as_tensor(np.asarray(units[a:a + 1], np.int32)), cv)
            ss = np.full(T * ws, POISON, np.int64)
            for t in range(nt):
                ss[t * ws:t * ws + W] = s[0, t].numpy()
            i0 = a * N + n0
            copy_run(lambda i: ss[(i // W) * ws + i % W], nt * W, succ,
                     i0 * W, 0, 4, w_succ)
            copy_run(lambda i: int(e[0, i]), nt, en, i0, 0, 4, w_en)
            copy_run(lambda i: int(k[0, i]), nt, aok, i0, 0, 4, w_aok)
            for t in range(nt):
                assert not w_ov[i0 + t]
                w_ov[i0 + t] = True
                ov[i0 + t] = int(o[0, t])
    assert w_en.all() and w_aok.all() and w_ov.all() and w_succ.all()
    return (en.reshape(A, N).astype(bool), aok.reshape(A, N).astype(bool),
            ov.reshape(A, N).astype(np.int32),
            succ.reshape(A, N, W).astype(np.int32))


def _module(spec, cfg):
    """Both packages' compiled units on one layout, the port's generated
    module, and rows of the layout (sampled states, some mutated)."""
    lj, casj, _pj, _vj, sampled, _ = _build("jaxmc", spec, cfg)
    lt, cast, predst, viewt, _, kc = _build("jaxmc_torch", spec, cfg)
    gm = cgen.build_module(kc, lt.width, cast, predst, viewt)
    enc = np.stack([lj.encode(s) for s in sampled]).astype(np.int32)
    return gm, casj, enc


def _reference(casj, rows):
    """jax.vmap of every reference instance (slot by slot), stacked."""
    outs = []
    for a in casj:
        for slot in (range(a.n_slots) if a.n_slots else [None]):
            if slot is None:
                outs.append(jax.vmap(a.fn)(jnp.asarray(rows)))
            else:
                outs.append(jax.vmap(a.fn, in_axes=(0, None))(
                    jnp.asarray(rows), jnp.int32(slot)))
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(4)]


def _rows(enc, n, seed):
    rng = np.random.default_rng(seed)
    rows = enc[rng.integers(0, len(enc), n)].copy()
    mut = rng.random(rows.shape) < 0.1
    rows[mut] += rng.integers(-2, 3, int(mut.sum())).astype(np.int32)
    return rows


@pytest.mark.parametrize("spec,cfg,W", [
    ("transfer_scaled.tla", "transfer_scaled.cfg", 8),
    ("pcal_intro_buggy.tla", None, 13),
    ("msgstoy.tla", "msgstoy.cfg", None),
])
def test_model_matches_twin_and_reference(spec, cfg, W):
    """Tiles of 8 and 16 rows over 3T + 5 rows, each grouping from one
    instance a block to all of them, the rows at each word alignment."""
    gm, casj, enc = _module(spec, cfg)
    if W is not None:
        assert gm.W == W
    A = len(gm.actions)
    units = np.arange(A, dtype=np.int32)
    want_ref = None
    for T in (8, 16):
        rows = _rows(enc, 3 * T + 5, seed=T)
        twin = ops.gen_expand_twin(gm, torch.as_tensor(rows),
                                   torch.as_tensor(units))
        ref = _reference(casj, rows)
        for G, addr in ((1, 0), (2, 1), (A, 2), (max(1, A - 1), 3)):
            got = model(gm, rows, units, None, T, G, addr=addr, seed=G)
            for g, t, r in zip(got, twin, ref):
                np.testing.assert_array_equal(g, t.numpy())
                np.testing.assert_array_equal(g, r)
        want_ref = ref
    assert want_ref[0].any()


def test_one_instance_and_a_short_tile():
    """A = 1 (one instance of the middle of the list) and N < T."""
    gm, casj, enc = _module("pcal_intro_buggy.tla", None)
    A = len(gm.actions)
    ref_all = None
    for N in (1, 5, 37):
        rows = _rows(enc, N, seed=N)
        ref_all = _reference(casj, rows)
        units = np.asarray([A // 2], np.int32)
        got = model(gm, rows, units, None, 64, 1, addr=N % 4)
        for g, r in zip(got, ref_all):
            np.testing.assert_array_equal(g, r[A // 2:A // 2 + 1])
    assert ref_all is not None


def test_member_constants_straddle_tiles():
    """A batchtoy cohort's lifted constants as a member table: 4 members
    of 10 rows each over tiles of 8, so tiles 1, 2 and 3 each hold two
    members' rows; per-row constants too."""
    from jaxmc_torch.analyze.bounds import liftable_constants
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    from test_torch_gen import _path
    models = [load_model(_path("batchtoy.tla"), _path(f"batchtoy_{c}.cfg"))
              for c in "abcd"]
    lift = liftable_constants(models[0])
    eng = TorchExplorer(models[0], device="cpu", host_seen=True,
                        lift_consts=lift)
    gm = cgen.build_module(eng.kc, eng.W, eng.compiled,
                           list(eng.inv_fns) + list(eng.constraint_fns),
                           eng.view_fn, eng._lift_names)
    table = np.asarray([[int(m.defs[n]) for n in lift] for m in models],
                       np.int32)
    rng = np.random.default_rng(2)
    base = np.stack([eng.layout.encode(s) for s in eng.init_states])
    rows = base[rng.integers(0, len(base), 40)].astype(np.int32)
    rows += rng.integers(-2, 3, rows.shape).astype(np.int32)
    units = np.arange(len(gm.actions), dtype=np.int32)
    # rows 8-15 (tile 1) belong to members 0 and 1
    assert {r // 10 for r in range(8, 16)} == {0, 1}
    for cv in (table, table[rng.integers(0, 4, 40)]):
        twin = ops.gen_expand_twin(gm, torch.as_tensor(rows),
                                   torch.as_tensor(units),
                                   torch.as_tensor(cv))
        for G in (1, len(units)):
            got = model(gm, rows, units, cv, 8, G, addr=1)
            for g, t in zip(got, twin):
                np.testing.assert_array_equal(g, t.numpy())


@pytest.mark.parametrize("N,A,T,G", [
    (1, 1, 256, 1), (255, 3, 256, 3), (257, 13, 256, 13), (1000, 33, 64, 17),
    (65, 5, 16, 2), (7, 40, 1, 1), (2, 2, 128, 5)])
def test_schedule_covers_every_pair_once(N, A, T, G):
    """Every (instance, row) in exactly one block; a tile's groups are
    neighbouring blocks, in instance order."""
    seen = np.zeros((A, N), int)
    last = {}
    for b, n0, nt, a0, a1 in schedule(N, A, T, G):
        assert 0 < nt <= T and 0 <= a0 < a1 <= A and a1 - a0 <= G
        seen[a0:a1, n0:n0 + nt] += 1
        if n0 in last:
            assert last[n0] == (b - 1, a0)
        last[n0] = (b, a1)
    assert (seen == 1).all()


def test_groups_rule():
    """gen_groups: every instance in the tile's block once the tiles fill
    GEN_BLOCKS; below, enough groups that tiles * groups reaches it (or
    one instance a block)."""
    B = ops.GEN_BLOCKS
    for A in (1, 2, 13, 15, 33, 100):
        for tiles in (1, 7, 64, 256, 1024, B - 1, B, 8192):
            G = ops.gen_groups(A, tiles)
            groups = -(-A // G)
            assert 1 <= G <= A and (groups - 1) * G < A
            if tiles >= B:
                assert G == A
            else:
                assert tiles * groups >= min(B, tiles * A)


def test_tile_rows(monkeypatch):
    """tile_rows: the largest power of two up to 256 within TILE_SMEM,
    then one row within SMEM_MAX, then 0 (nothing staged)."""
    got = {W: cgen.tile_rows(W) for W in (2, 8, 9, 10, 13, 26, 138, 1000)}
    assert got == {2: 256, 8: 256, 9: 256, 10: 256, 13: 128, 26: 64,
                   138: 16, 1000: 2}
    for W, T in got.items():
        assert cgen.tile_bytes(W, T) <= cgen.TILE_SMEM
        assert T == 256 or cgen.tile_bytes(W, 2 * T) > cgen.TILE_SMEM
    assert cgen.tile_rows(20000) == 1
    assert cgen.tile_rows(30000) == 0
    monkeypatch.setattr(cgen, "TILE_SMEM", 0)
    assert cgen.tile_rows(9) == 1
    monkeypatch.setattr(cgen, "SMEM_MAX", 0)
    assert cgen.tile_rows(9) == 0
