"""K18 sort_keys and its front_order site (jaxmc_torch/kernels/csrc/
sort.cu) on the CPU, where the kernel cannot run.

(a) sort_keys_twin and front_order_twin against the JAX reference on
seeded numpy keys: jaxmc.backend.bfs._lsd_sort, lax.sort(cols +
(arange,), num_keys=K, is_stable=True), and the level step's comp4 sort
written as the reference writes it (jaxmc/backend/bfs.py:1879-1883).
(b) sort.cu's schedule modelled in numpy at small tiles (2 warps of 2
items: 128 rows a tile), bit for bit against the twins: the upsweep's
tail bytes, its histograms of the other rows and its tail counts in a
random block order, the plan of kept digit positions built by the last
block, each pass's tile ranking (a warp's items walk its rows, lanes
ranked as __match_any_sync groups), the per-digit decoupled look-back
in a random ticket interleaving (lookback_model.run_tiles), pass 0's
tail block (its words written flat), the word columns in turn and the
last pass's output; every output word written once, no staged slot
read unwritten, and the workspace words back at zero after every call
(two calls on one workspace).  The tile sizes, block counts and the
upsweep's queue change no result and are not modelled.
(c) The level engine with twins=True on the full-sort step
(JAXMC_LEVEL_RANKMERGE=0), whose sorts are the twins of K18 and of its
front_order site, against the corpus pins and the reference's trace."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from jaxmc.backend.bfs import _lsd_sort
from jaxmc_torch.kernels import ops
from lookback_model import run_tiles
from sort_cases import PATTERNS, front_case, keys_case

SENT = 2**31 - 1
M32 = 0xFFFFFFFF
FLIP = 0x80000000
RADIX, BINS, TAIL = 256, 257, 256
DEAD = BINS
POISON = -0x5A5A5A5B


def ref_sort(keys):
    """lax.sort of the columns with an index payload (the reference's
    multikey _rank_merge sort)."""
    N, K = keys.shape
    cols = tuple(jnp.asarray(keys[:, j]) for j in range(K))
    res = lax.sort(cols + (jnp.arange(N, dtype=jnp.int32),), num_keys=K,
                   is_stable=True)
    return (np.stack([np.asarray(c) for c in res[:K]], 1).reshape(N, K),
            np.asarray(res[K]))


def ref_front(explore, prov, A, FC):
    """comp4's perm4 as jaxmc/backend/bfs.py:1879-1883 writes it."""
    new_prov = jnp.asarray(prov.astype(np.int32))
    C = prov.shape[0]
    fmaj = (new_prov % FC) * jnp.int32(max(A, 1)) + new_prov // FC
    idx4 = jnp.arange(C, dtype=jnp.int32)
    ops4 = ((1 - jnp.asarray(explore).astype(jnp.int32)), fmaj, idx4)
    comp4 = lax.sort(ops4, num_keys=2, is_stable=True)
    return np.asarray(comp4[2])


# ---------------------------------------------------------------------------
# (a) the twins against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 5, 8])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_sort_keys_twin_matches_lax_sort(pattern, K):
    keys = keys_case(pattern, 4097, K, K)
    sk, si = ops.sort_keys_twin(torch.as_tensor(keys))
    rk, ri = ref_sort(keys)
    np.testing.assert_array_equal(sk.numpy(), rk)
    np.testing.assert_array_equal(si.numpy(), ri)
    assert si.dtype == torch.int32


@pytest.mark.parametrize("K", [1, 3, 5, 8])
@pytest.mark.parametrize("N", [0, 1, 2])
def test_sort_keys_twin_small(N, K):
    keys = keys_case("extremes", N, K, 7)
    sk, si = ops.sort_keys_twin(torch.as_tensor(keys))
    rk, ri = ref_sort(keys)
    np.testing.assert_array_equal(sk.numpy().reshape(N, K), rk)
    np.testing.assert_array_equal(si.numpy(), ri)


@pytest.mark.parametrize("pattern", ["valid_tail", "ties"])
def test_sort_keys_twin_matches_lsd_chain(pattern):
    """The reference's own LSD chain (_lsd_sort, the resident engine's
    sort) gives the same rows and indices."""
    keys = keys_case(pattern, 4097, 3, 1)
    kc, ec = _lsd_sort([jnp.asarray(keys[:, j]) for j in range(3)],
                       [jnp.arange(4097, dtype=jnp.int32)])
    sk, si = ops.sort_keys_twin(torch.as_tensor(keys))
    np.testing.assert_array_equal(sk.numpy(),
                                  np.stack([np.asarray(c) for c in kc], 1))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ec[0]))


@pytest.mark.parametrize("A,FC,explored,new_frac",
                         [(3, 8, 0.5, 0.3), (13, 512, 0.8, 0.18),
                          (1, 1, 1.0, 1.0), (7, 64, 0.0, 0.5),
                          (5, 256, 1.0, 1.0)])
def test_front_order_twin_matches_comp4(A, FC, explored, new_frac):
    explore, prov = front_case(A, FC, A + FC, explored, new_frac)
    got = ops.front_order_twin(torch.as_tensor(explore),
                               torch.as_tensor(prov), A, FC)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_front(explore, prov, A, FC))
    assert got.dtype == torch.int32


def test_wrappers_take_the_twins_on_the_cpu():
    keys = torch.as_tensor(keys_case("valid_tail", 500, 3, 2))
    for a, b in zip(ops.sort_keys(keys), ops.sort_keys_twin(keys)):
        assert torch.equal(a, b)
    explore, prov = front_case(4, 32, 3)
    e, p = torch.as_tensor(explore), torch.as_tensor(prov)
    assert torch.equal(ops.front_order(e, p, 4, 32),
                       ops.front_order_twin(e, p, 4, 32))
    with pytest.raises(TypeError):
        ops.sort_keys(keys.to(torch.int64))
    with pytest.raises(TypeError):
        ops.front_order(e, p.to(torch.int32), 4, 32)


# ---------------------------------------------------------------------------
# (b) sort.cu's schedule in numpy
# ---------------------------------------------------------------------------

WARPS, ITEMS = 2, 2                 # the model's tile: 2 warps x 2 items
TILE = WARPS * 32 * ITEMS


def pad4(x):
    return (x + 3) & ~3


def layout(n, np_, tile=TILE):
    """sort.cu layout(): offsets in 32-bit words."""
    tiles = -(-n // tile)
    st = pad4(tiles * BINS)
    L = dict(hist=0, cnt=np_ * RADIX)
    L["plan"] = L["cnt"] + 4
    L["digit"] = L["plan"] + 4
    L["base"] = L["digit"] + pad4(np_)
    L["status0"] = L["base"] + np_ * RADIX
    L["status1"] = L["status0"] + st
    L["total"] = L["status1"] + st
    return L


class Src:
    """The rows' words: keys [n, k], or front_order's one word."""

    def __init__(self, keys=None, explore=None, prov=None, a=1, fc=1,
                 bits=0):
        self.keys, self.explore, self.prov = keys, explore, prov
        self.a, self.fc, self.bits = a, fc, bits

    def words(self, rows, c):
        """Column c of the rows (int64 values of int32 words)."""
        if self.keys is not None:
            return self.keys[rows, c].astype(np.int64)
        p = self.prov[rows]
        fmaj = (p % self.fc) * self.a + p // self.fc
        w = np.where(self.explore[rows], 0, 1 << self.bits) | fmaj
        return np.where(w >= 2**31, w - 2**32, w)


def tail_word(src, n, c):
    """Word c of the tail key: the last row's."""
    return int(src.words(np.array([n - 1]), c)[0])


def digit_of(w, shift):
    return ((np.asarray(w, np.int64) & M32) ^ FLIP) >> shift & 0xFF


def tail_cmp(src, rows, k, n):
    """-1 / 0 / 1 per row: below, equal to, above the tail key."""
    cmp = np.zeros(len(rows), np.int64)
    for c in range(k):
        w = src.words(rows, c)
        t = tail_word(src, n, c)
        open_ = cmp == 0
        cmp[open_ & (w < t)] = -1
        cmp[open_ & (w > t)] = 1
    return cmp


def upsweep(src, n, k, np_, ws, L, rng, blocks, tails):
    """Each block's tail bytes, its histograms of the other rows and its
    tail counts, added in a random block order; the last block builds
    the plan and clears the counts."""
    per = -(-n // blocks)
    for b in rng.permutation(blocks):
        rows = np.arange(b * per, min(n, (b + 1) * per))
        if len(rows) == 0:
            ws[L["cnt"] + 2] += 1
            continue
        cmp = tail_cmp(src, rows, k, n)
        tails[rows] = cmp == 0
        rest = rows[cmp != 0]
        for c in range(k):
            w = src.words(rest, c)
            p0 = 4 * (k - 1 - c)
            for bb in range(4):
                if p0 + bb < np_:
                    h = np.bincount(digit_of(w, 8 * bb), minlength=RADIX)
                    ws[L["hist"] + (p0 + bb) * RADIX:][:RADIX] += h
        ws[L["cnt"]] += int((cmp == 0).sum())
        ws[L["cnt"] + 1] += int((cmp < 0).sum())
        ws[L["cnt"] + 2] += 1
    assert ws[L["cnt"] + 2] == blocks          # the last block: the plan
    ntail, nless = int(ws[L["cnt"]]), int(ws[L["cnt"] + 1])
    m = n - ntail
    kept = 0
    for p in range(np_):
        h = ws[L["hist"] + p * RADIX:][:RADIX].astype(np.int64)
        ws[L["hist"] + p * RADIX:][:RADIX] = 0
        assert h.sum() == m
        if (h == m).any():
            continue
        ws[L["base"] + kept * RADIX:][:RADIX] = np.cumsum(h) - h
        ws[L["digit"] + kept] = p
        kept += 1
    ws[L["plan"]:L["plan"] + 4] = (kept, m, nless, ntail)
    ws[L["cnt"]:L["cnt"] + 3] = 0


def look_back(ws, st, tile, agg, base):
    """look_back_bin for every bin of a tile at once (bins walk back
    independently; here in lock step): yields while a word it needs is
    unpublished; returns each bin's first output position."""
    nb = len(agg)
    mine = st + tile * BINS
    if tile == 0:
        ws[mine:mine + nb] = (2 << 30) | (base + agg)
        return base.copy()
    ws[mine:mine + nb] = (1 << 30) | agg
    excl = np.zeros(nb, np.int64)
    open_ = np.ones(nb, bool)
    p = tile - 1
    while open_.any():
        v = ws[st + p * BINS:][:nb].astype(np.int64)
        while (open_ & (v >> 30 == 0)).any():
            yield
            v = ws[st + p * BINS:][:nb].astype(np.int64)
        excl[open_] += v[open_] & ((1 << 30) - 1)
        open_ &= (v >> 30) != 2
        p -= 1
    ws[mine:mine + nb] = (2 << 30) | (excl + agg)
    return excl


def run_pass(j, src, frm, to, out, n, k, np_, ws, L, rng, tails):
    """Launch j of sort_pass_kernel over every block, tiles advancing in
    a random interleaving."""
    kept, m, nless, ntail = (int(x) for x in ws[L["plan"]:L["plan"] + 4])
    npass = kept or 1
    if j >= npass:
        return
    st = L["status1"] if j & 1 else L["status0"]
    grid = -(-n // TILE)
    if j >= 1:
        prev = L["status0"] if j & 1 else L["status1"]
        rows_prev = n if j == 1 else m
        for b in range(grid):
            if b * TILE < rows_prev:
                ws[prev + b * BINS:][:BINS] = 0
    rows = n if j == 0 else m
    last = j == npass - 1
    dp = int(ws[L["digit"] + j]) if kept else -1
    bases = ws[L["base"] + j * RADIX:][:RADIX].astype(np.int64)
    dcol = 0 if dp < 0 else k - 1 - dp // 4
    dsh = 0 if dp < 0 else 8 * (dp % 4)
    tk = L["cnt"] + 3

    def body(_block):
        t = int(ws[tk])                     # take_ticket
        ws[tk] = 0 if t == grid - 1 else t + 1
        r0 = t * TILE
        if r0 >= rows:
            return
        nt = min(TILE, rows - r0)
        ii = np.arange(TILE)
        live = ii < nt
        r = r0 + ii[live]
        if j == 0:
            is_tail = tails[r].astype(bool)
            w = np.zeros(nt, np.int64)           # read for other rows only
            w[~is_tail] = src.words(r[~is_tail], dcol)
        else:
            w = frm[dcol, r].astype(np.int64)
            is_tail = np.zeros(nt, bool)
        b = np.full(TILE, DEAD, np.int64)
        b[live] = np.where(is_tail, TAIL, digit_of(w, dsh) if dp >= 0 else 0)
        # each warp's items walk its rows: ranks within the warp's rows
        wc = np.zeros((WARPS, BINS), np.int64)
        rank = np.zeros(TILE, np.int64)
        for warp in range(WARPS):
            for q in range(ITEMS):
                lanes = warp * 32 * ITEMS + q * 32 + np.arange(32)
                bl = b[lanes]
                same = bl[:, None] == bl[None, :]
                lower = np.tril(same, -1).sum(axis=1)   # peers below
                ok = bl != DEAD
                rank[lanes[ok]] = wc[warp, bl[ok]] + lower[ok]
                np.add.at(wc[warp], bl[ok], 1)
        tot = wc.sum(axis=0)
        wpre = np.cumsum(wc, axis=0) - wc
        lex = np.zeros(BINS, np.int64)
        lex[:RADIX] = np.cumsum(tot[:RADIX]) - tot[:RADIX]
        lex[TAIL] = tot[:RADIX].sum()
        nb = BINS if j == 0 else RADIX
        base = np.zeros(nb, np.int64)
        base[:RADIX] = bases if dp >= 0 else 0
        if j == 0:
            base[TAIL] = nless
        gb = yield from look_back(ws, st, t, tot[:nb], base)
        warp_of = ii // (32 * ITEMS)
        s_pos = np.full(TILE, -1, np.int64)
        slot = np.full(TILE, -1, np.int64)
        for i in np.nonzero(live)[0]:
            bi = b[i]
            rk = rank[i] + wpre[warp_of[i], bi]
            p = gb[bi] + rk
            if last and bi != TAIL and p >= nless:
                p += ntail
            slot[i] = lex[bi] + rk
            s_pos[slot[i]] = p
        ntl = lex[TAIL]
        if j == 0 and out["skeys"] is not None and ntl < nt:
            # the tail rows' output run, its words the tail key's, flat
            for u in range(nt - ntl):
                for c in range(k):
                    out["skeys"][gb[TAIL] + u, c] = tail_word(src, n, c)
                    out["wkeys"][gb[TAIL] + u, c] += 1
        for c in range(k + 1):
            if last and c < k and out["skeys"] is None:
                continue
            if c == k:
                v = r if j == 0 else frm[k, r].astype(np.int64)
            elif j == 0:                         # the tail rows' words:
                v = np.full(nt, tail_word(src, n, c), np.int64)  # its
                v[~is_tail] = src.words(r[~is_tail], c)
            else:
                v = frm[c, r].astype(np.int64)
            s_col = np.full(TILE, POISON, np.int64)
            keep = live.copy()
            if c < k:                            # the key words: below ntl
                keep[live] = slot[live] < ntl
            s_col[slot[keep]] = v[keep[live]]
            for i in range(nt if c == k else ntl):
                p, val = s_pos[i], s_col[i]
                assert p >= 0 and val != POISON
                if last or i >= ntl:
                    if c == k:
                        out["sidx"][p] = val
                        out["wsidx"][p] += 1
                    elif out["skeys"] is not None:
                        out["skeys"][p, c] = val
                        out["wkeys"][p, c] += 1
                else:
                    to[c, p] = val
                    out["wto"][j][c, p] += 1

    run_tiles(grid, body, rng)
    assert ws[tk] == 0                       # the last ticket reset it


def model_sort(src, n, k, np_, ws, rng, want_keys=True):
    """The whole call: upsweep, np_ pass launches, the clearing launch.
    Returns (skeys, sidx); asserts every output word written once."""
    L = layout(n, np_)
    assert len(ws) >= L["total"] and not ws.any()
    cols = [np.full((k + 1, n), POISON, np.int64) for _ in range(2)]
    out = dict(skeys=np.full((n, k), POISON, np.int64) if want_keys else
               None, sidx=np.full(n, POISON, np.int64),
               wkeys=np.zeros((n, k), np.int64),
               wsidx=np.zeros(n, np.int64),
               wto=[np.zeros((k + 1, n), np.int64) for _ in range(np_)])
    blocks = min(-(-n // 64), 7)            # kUpRows, kUpBlocks at scale
    tails = np.full(n, 2, np.int64)          # every row's byte is written
    upsweep(src, n, k, np_, ws, L, rng, blocks, tails)
    assert (tails != 2).all()
    kept, m = int(ws[L["plan"]]), int(ws[L["plan"] + 1])
    for j in range(np_):
        run_pass(j, src, cols[(j + 1) & 1], cols[j & 1], out, n, k, np_,
                 ws, L, rng, tails)
    for j in range(max(kept, 1) - 1):       # the column passes' rows
        wto = out["wto"][j]
        assert (wto[:, :m] == 1).all() and not wto[:, m:].any()
    ws[L["plan"]:L["total"]] = 0             # sort_clear_kernel
    assert not ws.any()
    assert (out["wsidx"] == 1).all()
    if want_keys:
        assert (out["wkeys"] == 1).all()
    return out["skeys"], out["sidx"]


MODEL_CASES = [("valid_tail", 4097, 3), ("stale", 1000, 3),
               ("sentinel_fill", 700, 5), ("last_real", 500, 3),
               ("oracle", 700, 4), ("random", 300, 1), ("ties", 513, 5),
               ("extremes", 129, 2), ("equal", 200, 3), ("all_tail", 300, 3),
               ("valid_tail", 1, 3), ("valid_tail", 128, 1),
               ("const_bytes", 600, 3), ("one_valid", 257, 3)]


def model_keys(pattern, N, K, seed):
    if pattern == "sentinel_fill":               # a resident accumulator
        k = keys_case("random", N, K, seed)
        k[:, 0] = 0
        k[N // 3:] = SENT
        return k
    if pattern == "last_real":                   # the last row valid
        k = keys_case("valid_tail", N, K, seed)
        k[-1] = (0,) + (5,) * (K - 1)
        return k
    if pattern == "all_tail":
        k = np.full((N, K), SENT, np.int32)
        k[:, 0] = 1
        return k
    if pattern == "const_bytes":                 # most digits constant
        k = keys_case("valid_tail", N, K, seed)
        v = k[:, 0] == 0
        k[v, 1:] &= 0x0F0F
        return k
    if pattern == "one_valid":                   # one row sorts
        k = model_keys("all_tail", N, K, seed)
        k[N // 2] = 0
        return k
    return keys_case(pattern, N, K, seed)


@pytest.mark.parametrize("pattern,N,K", MODEL_CASES)
def test_model_matches_twin(pattern, N, K):
    keys = model_keys(pattern, N, K, N + K)
    want_k, want_i = ops.sort_keys_twin(torch.as_tensor(keys))
    rng = np.random.default_rng(N * K)
    ws = np.zeros(layout(N, 4 * K)["total"] + 100, np.int64)
    for _ in range(2):                          # one workspace, two calls
        sk, si = model_sort(Src(keys=keys), N, K, 4 * K, ws, rng)
        np.testing.assert_array_equal(sk, want_k.numpy())
        np.testing.assert_array_equal(si, want_i.numpy())


def test_model_skips_constant_digits_and_splits_the_tail():
    """The plan: the validity word's four digits and the data words'
    constant bytes are skipped, the tail rows counted apart."""
    keys = model_keys("const_bytes", 600, 3, 5)
    keys[-1] = (1, SENT, SENT)                   # the last row invalid
    L = layout(600, 12)
    ws = np.zeros(L["total"], np.int64)
    upsweep(Src(keys=keys), 600, 3, 12, ws, L,
            np.random.default_rng(0), 5, np.zeros(600, np.int64))
    kept, m, nless, ntail = ws[L["plan"]:L["plan"] + 4]
    valid = int((keys[:, 0] == 0).sum())
    assert (m, nless, ntail) == (valid, valid, 600 - valid)
    # the valid rows' data words: bytes 0 and 1 of each vary, 2 and 3 not
    assert list(ws[L["digit"]:L["digit"] + kept]) == [0, 1, 4, 5]


@pytest.mark.parametrize("A,FC,explored,new_frac",
                         [(3, 40, 0.5, 0.3), (13, 64, 0.8, 0.18),
                          (1, 1, 1.0, 1.0), (7, 32, 0.0, 0.5),
                          (2, 300, 1.0, 1.0)])
def test_model_front_order_matches_twin(A, FC, explored, new_frac):
    explore, prov = front_case(A, FC, A * FC, explored, new_frac)
    C = A * FC
    b = (C - 1).bit_length()
    np_ = b // 8 + 1
    want = ops.front_order_twin(torch.as_tensor(explore),
                                torch.as_tensor(prov), A, FC)
    ws = np.zeros(layout(C, np_)["total"], np.int64)
    rng = np.random.default_rng(C)
    for _ in range(2):
        _sk, si = model_sort(Src(explore=explore, prov=prov, a=A, fc=FC,
                                 bits=b), C, 1, np_, ws, rng,
                             want_keys=False)
        np.testing.assert_array_equal(si, want.numpy())


# ---------------------------------------------------------------------------
# (c) the level engine's sorts on the twins
# ---------------------------------------------------------------------------

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")


@pytest.fixture
def one_thread():
    """Whole searches on one intra-op thread: the test workers share the
    machine, and oversubscribed thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(spec, cfg, no_deadlock=False):
    from jaxmc_torch.session import load_model
    return load_model(os.path.join(SPECS, spec), os.path.join(SPECS, cfg),
                      no_deadlock)


@pytest.mark.parametrize("spec,cfg,nd,pins", [
    ("transfer_scaled.tla", "transfer_scaled.cfg", False,
     (153701, 311153, 9)),
    ("symtoy.tla", "symtoy.cfg", True, (22, 33, 12))])
def test_full_sort_step_on_the_twins(monkeypatch, one_thread, spec, cfg, nd,
                                     pins):
    """The corpus pins (jaxmc/corpus.py) with twins=True on the
    full-sort step: each level's sort is sort_keys_twin and its next
    frontier's order front_order_twin, both launched once a level."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    monkeypatch.setenv("JAXMC_LEVEL_RANKMERGE", "0")
    calls = {"sort": 0, "order": 0}
    sort_twin, order_twin = ops.sort_keys_twin, ops.front_order_twin

    def sort2(keys):
        calls["sort"] += 1
        return sort_twin(keys)

    def order2(*a):
        calls["order"] += 1
        return order_twin(*a)
    monkeypatch.setattr(ops, "sort_keys_twin", sort2)
    monkeypatch.setattr(ops, "front_order_twin", order2)
    r = TorchExplorer(_port_model(spec, cfg, nd), device="cpu", twins=True,
                      store_trace=False).run()
    assert (r.ok, r.distinct, r.generated, r.diameter) == (True,) + pins
    assert calls["sort"] == calls["order"] == pins[2] + 1


def test_full_sort_twins_match_reference_trace(monkeypatch, one_thread):
    """batchtoy_bad (an invariant's trace) on the full-sort step with
    twins=True against the JAX reference's run."""
    from jaxmc.backend.bfs import TpuExplorer
    from jaxmc.engine.explore import format_trace as jformat
    from jaxmc.session import load_model as jload
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace as tformat
    monkeypatch.setenv("JAXMC_LEVEL_RANKMERGE", "0")
    spec, cfg = "batchtoy.tla", "batchtoy_bad.cfg"
    rj = TpuExplorer(jload(os.path.join(SPECS, spec),
                           os.path.join(SPECS, cfg), False)).run()
    rt = TorchExplorer(_port_model(spec, cfg), device="cpu",
                       twins=True).run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert rt.violation.kind == rj.violation.kind == "invariant"
    assert tformat(rt.violation) == jformat(rj.violation)
