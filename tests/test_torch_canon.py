"""K5 canon_rows' orbit minimum kept on chip (kernels/csrc/canon.cu),
modelled in numpy where the kernel cannot run: tiles of T rows from
ops.canon_geometry (the tile, the minimum and, for a program with sort
blocks, the candidate in shared memory, the packed lane ops, the
program staged when it fits), each tile staged at the odd row stride
W | 1 by the kernel's head / 16-byte middle / tail split of the rows'
addresses (every word read and written once, any read of a word no
thread wrote fails the test), the tile's valid rows listed in the
order of the kernel's shared counter (random here) and thread t on the
t-th of them: a permutation
none of whose sort blocks applies builds its candidate lane by lane and
compares as it goes (out at the first lane above the minimum, from the
first lane below straight into the minimum; a lane op with one
unconditional alternative read from its packed word, any other through
the program's tables), one whose sort blocks
apply builds, sorts (stable insertion sorts of the blocks whose
conditions hold) and compares.  The tiles run in a random order (the
blocks walk them grid-stride in no set order).

The model is held bit for bit against ops.canon_rows_twin and the JAX
reference's build_canon2 (jaxmc/compile/symmetry2.py:272), run on the
CPU, on the fixture layouts, symtoy_scaled_4p's 23 permutations, the
symkinds layout (every container kind), a group at the size limit,
all-invalid rows and rows wider than one block's budget; each case
asserts which of the kernel's paths its rows took."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.compile.kernel2 import build_layout2 as jbuild_layout
from jaxmc.compile.symmetry2 import build_canon2 as jbuild_canon
from jaxmc.compile.vspec import Bounds as JBounds
from jaxmc.engine.simulate import sample_states as jsample
from jaxmc.session import load_model as jload
from jaxmc_torch.compile.kernel2 import build_layout2 as tbuild_layout
from jaxmc_torch.compile.symmetry2 import build_canon2 as tbuild_canon
from jaxmc_torch.compile.vspec import Bounds as TBounds
from jaxmc_torch.compile.vspec import CompileError
from jaxmc_torch.engine.simulate import sample_states as tsample
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
FIXTURES = os.path.join(ROOT, "jaxmc_torch", "fixtures")
SENT = 2**31 - 1
POISON = -0x5A5A5A5B


class Prog:
    """The program blob's tables (compile/symmetry2.py docstring)."""

    def __init__(self, blob):
        self.P, self.U, self.W = (int(x) for x in blob[:3])
        o = [int(x) for x in blob[3:11]]
        self.pl = blob[o[0]:o[1]]
        self.lops = blob[o[1]:o[2]].reshape(-1, 3)
        self.alts = blob[o[2]:o[3]].reshape(-1, 4)
        self.conds = blob[o[3]:o[4]].reshape(-1, 3)
        self.ps = blob[o[4]:o[5]]
        self.sorts = blob[o[5]:o[6]].reshape(-1, 6)
        self.tabs = blob[o[6]:o[7]].reshape(self.P, self.U)

    def holds(self, inp, c0, nc):
        for lane, op, k in self.conds[c0:c0 + nc]:
            v = inp[lane]
            if not (v > k if op == 0 else v == k):
                return False
        return True

    def packed(self, l):
        """canon.cu pack_lane_op: (out, src, table) of a lane op with one
        unconditional alternative, else (out, None, None)."""
        out, a0, na = (int(x) for x in self.lops[l])
        if na != 1 or self.alts[a0][3] != 0:
            return out, None, None
        return out, int(self.alts[a0][0]), bool(self.alts[a0][1])

    def lane_value(self, inp, p, l, o):
        _out, a0, na = self.lops[l]
        for src, use_tab, c0, nc in self.alts[a0:a0 + na]:
            if self.holds(inp, c0, nc):
                v = int(inp[src])
                if use_tab and v != SENT:
                    v = int(self.tabs[p][min(max(v, 0), self.U - 1)])
                return v
        return int(inp[o])


def canon_row(pg, inp, cand, best, stats):
    """One thread: the orbit minimum of `inp` (its staged row, a view of
    the tile) written back over it; cand and best are its [W] columns
    of the block's [W][T] arrays."""
    W = pg.W
    best[:] = inp
    for p in range(pg.P):
        l0, l1 = int(pg.pl[p]), int(pg.pl[p + 1])
        blocks = pg.sorts[pg.ps[p]:pg.ps[p + 1]]
        if not any(pg.holds(inp, c0, nc) for *_x, c0, nc in blocks):
            l, less = l0, False
            nxt = pg.packed(l)[0] if l < l1 else W
            for o in range(W):
                if o == nxt:
                    _out, src, tab = pg.packed(l)
                    v = pg.lane_value(inp, p, l, o)
                    if src is None:
                        stats["general"] += 1
                    else:
                        stats["fast"] += 1
                        w = int(inp[src])
                        if tab and w != SENT:
                            w = int(pg.tabs[p][min(max(w, 0), pg.U - 1)])
                        assert w == v
                    l += 1
                    nxt = pg.packed(l)[0] if l < l1 else W
                else:
                    v = int(inp[o])
                assert v != POISON
                if not less:
                    if v > best[o]:
                        stats["out"] += 1
                        break
                    less = v < best[o]
                if less:
                    best[o] = v
            else:
                stats["kept" if less else "equal"] += 1
            continue
        stats["sorted"] += 1
        cand[:] = inp
        for l in range(l0, l1):
            o = int(pg.lops[l][0])
            cand[o] = pg.lane_value(inp, p, l, o)
        for off, nrow, rw, kc, c0, nc in blocks:
            if not pg.holds(inp, c0, nc):
                continue
            for i in range(1, nrow):
                for j in range(i, 0, -1):
                    a, b = off + j * rw, off + (j - 1) * rw
                    if tuple(cand[a:a + kc]) >= tuple(cand[b:b + kc]):
                        break
                    tmp = cand[a:a + rw].copy()
                    cand[a:a + rw] = cand[b:b + rw]
                    cand[b:b + rw] = tmp
        if tuple(cand) < tuple(best):
            best[:] = cand
    inp[:] = best


def split(addr_words, nw):
    """The kernel's head / 16-byte middle / tail of a run of nw words
    whose first word sits at word address addr_words: (head, vectors)."""
    head = min(nw, (4 - addr_words % 4) % 4)
    return head, (nw - head) // 4


def stage(words, addr_words, nw, W, ws, s, filled):
    """tile_in: words[i] to s[(i // W) * ws + i % W], each written once,
    the vectors' first words 16-byte aligned."""
    head, nv = split(addr_words, nw)
    for i in range(nw):
        if head <= i < head + 4 * nv:
            assert (addr_words + i - (i - head) % 4) % 4 == 0
        j = (i // W) * ws + i % W
        assert not filled[j]
        filled[j] = True
        s[j] = words[i]


def model(blob, rows, valid, budget=ops.CANON_SMEM, addr=0, seed=0):
    """The kernel's output and the count of each path its rows took;
    `addr` is the rows' first word address modulo 4."""
    pg = Prog(blob)
    N, W = rows.shape
    assert W == pg.W
    T, staged, smem = ops.canon_geometry(blob, budget)
    ws = W | 1
    prog_bytes = 4 * (-(-len(blob) // 4) * 4)
    sorts = len(pg.sorts) > 0
    fixed = 16 + 4 * (-(-len(pg.lops) // 4) * 4)
    assert smem == fixed + (prog_bytes if staged else 0) + \
        4 * T * (ws + 1 + (2 if sorts else 1) * W)
    assert smem <= max(budget, ops.SMEM_MAX) and 1 <= T <= 256
    assert T < 32 or T % 32 == 0
    flat = rows.reshape(-1)
    out = np.full(N * W, POISON, np.int64)
    written = np.zeros(N * W, bool)
    stats = dict(out=0, kept=0, equal=0, sorted=0, tiles=0, T=T,
                 staged=staged, rows=0, fast=0, general=0)
    tiles = list(range(0, N, T))
    rng = np.random.default_rng(seed)
    rng.shuffle(tiles)
    for r0 in tiles:
        nt = min(T, N - r0)
        tile = np.full(T * ws, POISON, np.int64)
        filled = np.zeros(T * ws, bool)
        stage(flat[r0 * W:(r0 + nt) * W], addr + r0 * W, nt * W, W, ws,
              tile, filled)
        # no candidate array without sort blocks: the path never runs
        cand = np.full((W, T), POISON, np.int64) if sorts else None
        best = np.full((W, T), POISON, np.int64)
        listed = [r for r in range(nt) if valid[r0 + r]]
        rng.shuffle(listed)
        for t, r in enumerate(listed):
            stats["rows"] += 1
            canon_row(pg, tile[r * ws:r * ws + W],
                      None if cand is None else cand[:, t], best[:, t],
                      stats)
        # tile_out: every word a thread's row holds, read once
        head, nv = split(addr + r0 * W, nt * W)
        for i in range(nt * W):
            j = (i // W) * ws + i % W
            assert filled[j] and not written[r0 * W + i]
            written[r0 * W + i] = True
            out[r0 * W + i] = tile[j]
        stats["tiles"] += 1
    assert written.all()
    return out.reshape(N, W).astype(np.int32), stats


def _layouts(spec, cfg):
    mj, mt = jload(spec, cfg, False), tload(spec, cfg)
    sj = list(jsample(mj))
    lj = jbuild_layout(mj, sj, JBounds())
    lt = tbuild_layout(mt, list(tsample(mt)), TBounds())
    assert lj.width == lt.width
    return mj, mt, lj, lt, sj


def _rows(layout, n, seed, extra=()):
    """Encoded sample states and rows of small random lane values (count
    lanes, tags, present bits and enum indices inside and past their
    ranges), some SENTINEL lanes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2, 14, (n, layout.width)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = SENT
    enc = [np.asarray(layout.encode(s), np.int32) for s in extra]
    return np.concatenate([np.stack(enc), rows]) if enc else rows


def _check(mj, mt, lj, lt, rows, valid, **kw):
    """The model against the twin and the reference; its path counts."""
    canon = tbuild_canon(mt, lt)
    want = np.asarray(jbuild_canon(mj, lj)(jnp.asarray(rows)))
    twin = ops.canon_rows_twin(torch.as_tensor(rows), torch.as_tensor(valid),
                               canon).numpy()
    got, stats = model(canon.program, rows, valid, **kw)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[~valid], rows[~valid])
    return canon, stats


def _spec(name):
    return os.path.join(SPECS, name)


KINDS = os.path.join(FIXTURES, "symkinds")


@pytest.mark.parametrize("spec,cfg", [
    (_spec("symtoy.tla"), _spec("symtoy.cfg")),
    (_spec("symtoy_multiinit.tla"), _spec("symtoy_multiinit.cfg")),
    (_spec("symtoy_scaled.tla"), _spec("symtoy_scaled.cfg")),
])
def test_model_matches_reference_on_fixture_layouts(spec, cfg):
    """Tiles of 256 rows, the last one short, rows at each word
    alignment; then tiles of 64 rows (a smaller budget)."""
    mj, mt, lj, lt, sampled = _layouts(spec, cfg)
    rows = _rows(lj, 500, seed=5, extra=sampled[:80])
    valid = np.random.default_rng(6).random(len(rows)) < 0.8
    for addr in range(4):
        canon, st = _check(mj, mt, lj, lt, rows, valid, addr=addr,
                           seed=addr)
        assert st["T"] == 256 and st["staged"]
        assert st["tiles"] == -(-len(rows) // 256) >= 2 and len(rows) % 256
        # the early-out compare ran every way, every lane op packed
        assert st["out"] and st["kept"] and st["equal"]
        assert st["fast"] and not st["general"]
    W, blob = lt.width, canon.program
    row = 4 * ((W | 1) + 1 + W)
    budget = 16 + 4 * (-(-((blob[5] - blob[4]) // 3) // 4) * 4) + \
        4 * (-(-len(blob) // 4) * 4) + 64 * row
    canon, st = _check(mj, mt, lj, lt, rows, valid, budget=budget, addr=1)
    assert (st["T"], st["tiles"]) == (64, -(-len(rows) // 64))


def test_model_matches_reference_at_the_widest_level_layout():
    """symtoy_scaled_4p: 4 processes, 23 permutations, W 9 (odd: the
    staged stride is W)."""
    mj, mt, lj, lt, sampled = _layouts(_spec("symtoy_scaled.tla"),
                                       os.path.join(FIXTURES,
                                                    "symtoy_scaled_4p.cfg"))
    rows = _rows(lj, 200, seed=8, extra=sampled[:200])
    valid = np.random.default_rng(9).random(len(rows)) < 0.85
    canon, st = _check(mj, mt, lj, lt, rows, valid, addr=1)
    assert canon.n_perms == 23 and lt.width == 9
    # every permutation of every valid row took one path; most stopped
    # at their first lane above the minimum
    total = st["out"] + st["kept"] + st["equal"] + st["sorted"]
    assert total == canon.n_perms * st["rows"]
    assert st["out"] > total / 2 and st["kept"] > 0


def test_model_matches_reference_on_every_container_kind():
    """symkinds (seq, growset, union, pfcn, kvtable): the sort blocks run
    under their conditions; W 138 takes blocks of 32 rows, and its
    program (9,550 words) stays in device memory."""
    mj, mt, lj, lt, sampled = _layouts(KINDS + ".tla", KINDS + ".cfg")
    rows = _rows(lj, 120, seed=7, extra=sampled[:80])
    valid = np.random.default_rng(3).random(len(rows)) < 0.9
    canon, st = _check(mj, mt, lj, lt, rows, valid, addr=3)
    assert lt.width == 138 and st["T"] == 32 and not st["staged"]
    # its top-level growset and kvtable sort under no condition: every
    # permutation builds, sorts, then compares
    assert st["sorted"] == canon.n_perms * st["rows"] > 0


@pytest.mark.parametrize("budget,T,staged", [
    (40 * 1024, 23, False),      # 32 rows do not fit beside the program
    (8 * 1024, 3, False),        # blocks of 3 rows
    (4 * 1024, 1, False),        # one row a block
])
def test_rows_wider_than_a_block_budget(budget, T, staged):
    """A smaller budget takes fewer rows a block and leaves the program
    in device memory; the result does not change."""
    mj, mt, lj, lt, sampled = _layouts(KINDS + ".tla", KINDS + ".cfg")
    rows = _rows(lj, 37, seed=11, extra=sampled[:20])
    valid = np.random.default_rng(12).random(len(rows)) < 0.9
    canon, st = _check(mj, mt, lj, lt, rows, valid, budget=budget, addr=2)
    assert (st["T"], st["staged"]) == (T, staged)
    assert st["tiles"] == -(-len(rows) // T)


def _header(prog_len, W, sorts, lops=50):
    """A program of prog_len words whose header gives W, its lane ops'
    count and whether it has sort blocks: all canon_geometry reads."""
    blob = np.zeros(prog_len, np.int32)
    blob[2], blob[4], blob[5] = W, 16, 16 + 3 * lops
    blob[8], blob[9] = 20, 26 if sorts else 20
    return blob


def test_geometry_rules():
    """canon_geometry: at most 256 rows, multiples of 32 from 32 up, a
    candidate array only with sort blocks, the program staged only
    beside 32 rows, SMEM_MAX for a row too wide for the budget, a raise
    for one wider still."""
    assert ops.canon_geometry(_header(1371, 9, False, 167)) == \
        (256, True, 16 + 672 + 5488 + 256 * 4 * 19)
    for W in (1, 2, 9, 26, 138, 400):
        for prog in (60, 1371, 9000):
            for sorts in (False, True):
                for budget in (2048, 48 * 1024, ops.CANON_SMEM):
                    T, staged, smem = ops.canon_geometry(
                        _header(prog, W, sorts), budget)
                    row = 4 * ((W | 1) + 1 + (2 if sorts else 1) * W)
                    fixed = 16 + 4 * 52
                    b = budget if budget >= fixed + row else ops.SMEM_MAX
                    pb = 4 * (-(-prog // 4) * 4)
                    assert smem == fixed + (pb if staged else 0) + T * row
                    assert smem <= b and staged == (fixed + pb + 32 * row
                                                    <= b)
                    assert T < 32 or T % 32 == 0
    assert ops.canon_geometry(_header(60, 10000, True), 1024)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        ops.canon_geometry(_header(60, 40000, True))


def test_all_invalid_rows_pass_through():
    mj, mt, lj, lt, sampled = _layouts(_spec("symtoy_scaled.tla"),
                                       _spec("symtoy_scaled.cfg"))
    rows = _rows(lj, 300, seed=13, extra=sampled[:20])
    valid = np.zeros(len(rows), bool)
    canon, st = _check(mj, mt, lj, lt, rows, valid)
    assert st["rows"] == 0 and st["tiles"] == 2


def test_group_at_the_size_limit(monkeypatch):
    """JAXMC_SYM_GROUP_LIMIT at the group's size builds the program (23
    permutations of 4 processes); one below refuses, as the reference."""
    spec = _spec("symtoy_scaled.tla")
    cfg = os.path.join(FIXTURES, "symtoy_scaled_4p.cfg")
    monkeypatch.setenv("JAXMC_SYM_GROUP_LIMIT", "23")
    mj, mt, lj, lt, sampled = _layouts(spec, cfg)
    rows = _rows(lj, 40, seed=14, extra=sampled[:60])
    valid = np.ones(len(rows), bool)
    canon, st = _check(mj, mt, lj, lt, rows, valid)
    assert canon.n_perms == 23
    monkeypatch.setenv("JAXMC_SYM_GROUP_LIMIT", "22")
    with pytest.raises(CompileError, match="non-identity elements"):
        tbuild_canon(mt, lt)


def test_wrapper_on_cpu_takes_the_twin(monkeypatch):
    """On the CPU canon_rows is its twin whatever the budget; the budget
    is read only to size a launch."""
    mj, mt, lj, lt, sampled = _layouts(_spec("symtoy.tla"),
                                       _spec("symtoy.cfg"))
    canon = tbuild_canon(mt, lt)
    rows = torch.as_tensor(_rows(lj, 50, seed=15, extra=sampled[:10]))
    valid = torch.ones(rows.shape[0], dtype=torch.bool)
    want = ops.canon_rows_twin(rows, valid, canon)
    for budget in (ops.CANON_SMEM, 64):
        monkeypatch.setattr(ops, "CANON_SMEM", budget)
        assert torch.equal(ops.canon_rows(rows, valid, canon), want)
