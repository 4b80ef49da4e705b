"""The CUDA kernels of the torch port (K1-K18) against their plain
PyTorch twins, on the card, at the shapes the engines give them, the
level engine on the card against the corpus pins, with SYMMETRY, VIEW
and --por among them, the host-seen engine on the card against the
same run on the CPU, PROPERTYs on both engines, a batch cohort, the
full-sort step, checkpoint/resume on the card against the CPU, the
preflight probe (K12) and the oracle's gpu verdict, the mesh
engine's exchange (K13), scalar vector (K14) and runs on the card
against the CPU, and the generated transition kernels (K15 gen_expand,
K16 gen_pred, K17 gen_value) against the emitter, and K18 sort_keys
with its front_order site, which every engine's sorts take.

Needs a CUDA card and nvcc; elsewhere every test skips with the reason.
Run on the card with:  python -m pytest -m gpu tests/test_torch_cuda.py
All comparisons are bit-exact: every kernel computes in int32/uint32."""

import os
import shutil

import numpy as np
import pytest
import torch
from keys_cases import PATTERNS as KEYS_PATTERNS
from keys_cases import keys_case
from keys_cases import plan as keys_plan
from keys_cases import plan_tensors as keys_plan_tensors
from merge_cases import KINDS as MERGE_KINDS
from merge_cases import merge_case
from sort_cases import PATTERNS as SORT_PATTERNS
from sort_cases import front_case
from sort_cases import keys_case as sort_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SENT = 2**31 - 1

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    """Decided when a test runs, never at import: the card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only "
                    "on the card")
    if not (shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc")):
        pytest.skip("no nvcc: the CUDA kernels cannot be built here")
    from jaxmc_torch.kernels import build
    build.load_all()
    return torch.device("cuda")


def _plan_and_rows(n, seed):
    """transfer_scaled's lane plan and n rows in its ranges (plus
    SENTINEL-filled invalid rows)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    eng = TorchExplorer(load_model(os.path.join(SPECS, "transfer_scaled.tla")),
                        device="cuda")
    plan = eng.plan
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, plan.width), np.int64)
    for i in range(plan.width):
        rows[:, i] = plan.bias[i] + rng.integers(
            0, max(int(plan.allowed[i]), 0) + 1, n)
    valid = rng.random(n) < 0.6
    rows[~valid] = SENT
    return eng, rows.astype(np.int32), valid


def _eq(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n", [1, 1000, 655360])
def test_unpack_rows_matches_twin(card, n):
    from jaxmc_torch.kernels import ops
    eng, rows, valid = _plan_and_rows(n, 1)
    rows[~valid] = rows[valid][0] if valid.any() else 0
    pt = eng.pt
    packed = ops.pack_rows_twin(torch.as_tensor(rows, device=card), pt)[0]
    packed[torch.as_tensor(~valid, device=card)] = SENT   # padded frontier
    got = ops.unpack_rows(packed, pt)
    torch.cuda.synchronize()
    _eq(got, ops.unpack_rows_twin(packed, pt))


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("n", [1, 4096, 655360])
def test_keys_of_matches_twin(card, n, fp):
    from jaxmc_torch.kernels import ops
    eng, rows, valid = _plan_and_rows(n, 2)
    r = torch.as_tensor(rows, device=card)
    v = torch.as_tensor(valid, device=card)
    k = ops.keys_of(r, v, eng.pt, fp, False)
    t = ops.keys_of_twin(r, v, eng.pt, fp, False)
    torch.cuda.synchronize()
    for a, b in zip(k, t):
        _eq(a, b)
    # one valid row out of range raises the flag; invalid ones do not
    lane = int(np.nonzero(~eng.plan.full)[0][0])
    bad = rows.copy()
    bad[~valid, lane] = int(eng.plan.bias[lane] + eng.plan.allowed[lane]) + 3
    k = ops.keys_of(torch.as_tensor(bad, device=card), v, eng.pt, fp, False)
    assert not bool(k[2])
    if valid.any():
        bad[int(np.nonzero(valid)[0][0]), lane] = \
            int(eng.plan.bias[lane] + eng.plan.allowed[lane]) + 3
        rb = torch.as_tensor(bad, device=card)
        k = ops.keys_of(rb, v, eng.pt, fp, False)
        t = ops.keys_of_twin(rb, v, eng.pt, fp, False)
        assert bool(k[2]) and bool(t[2])
        _eq(k[1], t[1])
    # LanePlan.pack_rows on the card: K2 with per-row flags
    p, o = eng.plan.pack_rows(rb if valid.any() else r)
    pt_, ot_ = ops.pack_rows_twin(rb if valid.any() else r, eng.pt)
    _eq(p, pt_)
    _eq(o, ot_)


def _merge_case(K, seen_count, N, SC, seed, device):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(-2**31, 2**31, (seen_count, K - 1)),
                     axis=0)
    seen_count = len(pool)
    seen = np.full((SC, K), SENT, np.int32)
    seen[:seen_count, 0] = 0
    seen[:seen_count, 1:] = pool
    keys = np.zeros((N, K), np.int64)
    keys[:, 1:] = rng.integers(-2**31, 2**31, (N, K - 1))
    pick = (rng.random(N) < 0.4) & (seen_count > 0)
    if pick.any():
        keys[pick, 1:] = pool[rng.integers(0, seen_count, pick.sum())]
    dup = rng.random(N) < 0.2
    keys[dup] = keys[rng.integers(0, N, dup.sum())]
    inval = rng.random(N) < 0.3
    keys[inval, 0] = 1
    keys[inval, 1:] = SENT
    return (torch.as_tensor(seen, device=device), seen_count,
            torch.as_tensor(keys.astype(np.int32), device=device))


@pytest.mark.parametrize("K,sc,N,SC", [(3, 1000, 5000, 8192),
                                       (3, 150000, 655360, 1 << 20),
                                       (5, 150000, 655360, 1 << 20),
                                       (2, 0, 300, 512)])
def test_seen_probe_and_rank_merge_match_twins(card, K, sc, N, SC):
    from jaxmc_torch.kernels import ops
    seen, sc, keys = _merge_case(K, sc, N, SC, 3, card)
    f, lb = ops.seen_probe(seen, sc, keys)
    ft, lbt = ops.seen_probe_twin(seen, sc, keys)
    torch.cuda.synchronize()
    _eq(f, ft)
    _eq(lb, lbt)
    rk = ops.rank_merge(seen, sc, keys)
    rt = ops.rank_merge_twin(seen, sc, keys)
    torch.cuda.synchronize()
    for name in ("new_count", "nk_sidx", "seen2", "seen_count2"):
        _eq(rk[name], rt[name])
    # K4 alone, on the sorted keys and their probe
    skeys = keys[ops.lsd_sort(keys)].contiguous()
    sidx = ops.lsd_sort(keys).to(torch.int32)
    f, lb = ops.seen_probe_twin(seen, sc, skeys)
    mk = ops.merge_sorted(seen, sc, skeys, sidx, f, lb)
    mt = ops.merge_sorted_twin(seen, sc, skeys, sidx, f, lb)
    torch.cuda.synchronize()
    for name in ("new_count", "nk_sidx", "seen2", "seen_count2"):
        _eq(mk[name], mt[name])


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    from jaxmc_torch.kernels import ops
    seen, sc, keys = _merge_case(3, 10, 20, 64, 4, card)
    with pytest.raises(TypeError):
        ops.seen_probe(seen, sc, keys.to(torch.int64))
    with pytest.raises(ValueError):
        ops.seen_probe(seen, sc, keys[:, :2].contiguous())
    with pytest.raises(ValueError):
        ops.rank_merge(seen, 65, keys)

def _probe_case(K, kind, device, seed=7):
    """K3's inputs at its two sites: sorted rank-merge blocks (an
    invalid SENTINEL tail; `straddle` gives the invalid rows data words
    that restart below the valid ones, as a POR block's do), unsorted
    candidate-order keys, and sorted keys spread over a seen table far
    wider than a tile's window budget."""
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(seed + K)
    wide = kind == "wide"
    sc, N = (300000, 20000) if wide else (150000, 655360 + 77)
    pool = np.unique(rng.integers(-2**31, 2**31, (sc, K - 1)), axis=0)
    sc = len(pool)
    seen = np.full((sc + 1000, K), SENT, np.int32)
    seen[:sc, 0] = 0
    seen[:sc, 1:] = pool
    keys = np.zeros((N, K), np.int64)
    keys[:, 1:] = rng.integers(-2**31, 2**31, (N, K - 1))
    pick = rng.random(N) < 0.4
    keys[pick, 1:] = pool[rng.integers(0, sc, pick.sum())]
    dup = rng.random(N) < 0.2
    keys[dup] = keys[rng.integers(0, N, dup.sum())]
    inval = rng.random(N) < 0.3
    keys[inval, 0] = 1
    keys[inval, 1:] = rng.integers(-50, 50, (inval.sum(), K - 1)) \
        if kind == "straddle" else SENT
    keys = torch.as_tensor(keys.astype(np.int32), device=device)
    if kind != "unsorted":
        keys = keys[ops.lsd_sort(keys)].contiguous()
    return torch.as_tensor(seen, device=device), sc, keys


@pytest.mark.parametrize("K", [3, 5, 6, 11])
@pytest.mark.parametrize("kind", ["sorted", "straddle", "unsorted", "wide"])
@pytest.mark.parametrize("site", ["", "por"])
def test_seen_probe_tiles_match_twin(card, K, kind, site):
    """K3 at both sites on sorted blocks, a tile straddling the
    valid/invalid boundary, unsorted keys and windows wider than the
    budget; count 0 and count == SC; one launch a call."""
    from jaxmc_torch.kernels import ops
    seen, sc, keys = _probe_case(K, kind, card)
    name = "seen_probe_" + site if site else "seen_probe"
    for count in (sc, 0, seen.shape[0]):
        ops.reset_launches()
        f, lb = ops.seen_probe(seen, count, keys, site=site)
        assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
        ft, lbt = ops.seen_probe_twin(seen, count, keys)
        torch.cuda.synchronize()
        _eq(f, ft)
        _eq(lb, lbt)


def test_seen_probe_replays_in_a_cuda_graph(card):
    """K3 keeps no state between calls, so a captured call replays to
    the twin's result on new inputs copied into its buffers."""
    from jaxmc_torch.kernels import ops
    seen, sc, keys = _probe_case(3, "sorted", card)
    seen2, sc2, keys2 = _probe_case(3, "sorted", card, seed=8)
    assert seen.shape == seen2.shape and keys.shape == keys2.shape
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        ops.seen_probe(seen, sc, keys)      # built and warm outside
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        f, lb = ops.seen_probe(seen, sc, keys)
    seen.copy_(seen2)
    keys.copy_(keys2)
    g.replay()
    torch.cuda.synchronize()
    ft, lbt = ops.seen_probe_twin(seen, sc, keys)
    _eq(f, ft)
    _eq(lb, lbt)


MERGE_OUT = ("new_count", "nk_sidx", "seen2", "seen_count2")


def _k4_inputs(kind, K, N, seed, device):
    """K4's inputs from merge_cases: the sorted keys, their original
    indices and their probe (K3's twin), and the unsorted keys."""
    from jaxmc_torch.kernels import ops
    seen, count, keys = merge_case(kind, K, N, seed)
    seen = torch.as_tensor(seen, device=device)
    keys = torch.as_tensor(keys, device=device)
    perm = ops.lsd_sort(keys)
    skeys = keys[perm].contiguous()
    found, lb = ops.seen_probe_twin(seen, count, skeys)
    return (seen, count, skeys, perm.to(torch.int32), found.contiguous(),
            lb.contiguous()), keys


@pytest.mark.parametrize("K", [2, 3, 5, 9])
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_sorted_two_launches_match_twin(card, kind, K):
    """K4 on every kind of merge_cases (N 0, an empty table, no new key,
    every key new, runs across tiles, new keys at lb = count, rows past
    SC dropped, small and full-range words), twice in a row on one
    workspace, two launches a call; the whole rank merge beside it."""
    from jaxmc_torch.kernels import ops
    N = 655360 + 77 if kind in ("runs", "past", "full") else 5003
    args, keys = _k4_inputs(kind, K, N, 11, card)
    want = ops.merge_sorted_twin(*args)
    for _ in range(2):
        ops.reset_launches()
        got = ops.merge_sorted(*args)
        assert ops.LAUNCHES["rank_merge"] == 2 and \
            sum(ops.LAUNCHES.values()) == 2, ops.LAUNCHES
        torch.cuda.synchronize()
        for name in MERGE_OUT:
            _eq(got[name], want[name])
    rk = ops.rank_merge(args[0], args[1], keys)
    rt = ops.rank_merge_twin(args[0], args[1], keys)
    torch.cuda.synchronize()
    for name in MERGE_OUT:
        _eq(rk[name], rt[name])


def _k2_call(f, case, basis, fp, row_ovf=False):
    p, rows, valid, other, pt, bw = case
    dev = pt["word"].device
    r = torch.as_tensor(rows, device=dev)
    v = torch.as_tensor(valid, device=dev)
    kw = {}
    if basis == "canon":
        kw = dict(basis=torch.as_tensor(other, device=dev), basis_packed=True)
    elif basis == "view":
        kw = dict(basis=torch.as_tensor(
            np.ascontiguousarray(other[:, :bw]), device=dev))
    if row_ovf:
        return f(r, v, pt, fp, False, row_ovf=True, **kw)
    return f(r, v, pt, fp, False, **kw)


def _k2_case(W, pattern, n, seed, device, basis="stored", fp=False,
             bad=False):
    from jaxmc_torch.kernels import ops
    p = keys_plan(W, seed)
    bw = min(W, 3 + seed % 3)
    kind = {"stored": 0, "canon": 1, "view": 2}[basis]
    K = (4 if fp else (bw if kind == 2 else p["PW"])) + 1
    T = ops.keys_geometry(W, p["PW"], K, bw if kind == 2 else p["PW"],
                          kind, fp=fp)[1]
    p, rows, valid, other = keys_case(W, n, pattern, T, seed, bad=bad)
    return p, rows, valid, other, keys_plan_tensors(p, device), bw


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("basis", ["stored", "canon", "view"])
@pytest.mark.parametrize("W", [1, 7, 26, 138])
def test_keys_of_tiles_match_twin(card, W, basis, fp):
    """K2 on synthetic plans of W lanes (odd PW among them) in every
    basis: no valid row, all valid, valid rows only at tile edges, 18%
    and half valid, a guarded lane out of range in the rows and in the
    canonical basis; twice in a row, one launch a call; the per-row
    flags of LanePlan.pack_rows."""
    from jaxmc_torch.kernels import ops
    name = {"stored": "keys_of", "canon": "keys_of_canon",
            "view": "keys_of_view"}[basis]
    for pattern in KEYS_PATTERNS:
        for bad in (False, True):
            case = _k2_case(W, pattern, 20000 + W, W + len(pattern), card,
                            basis, fp, bad)
            want = _k2_call(ops.keys_of_twin, case, basis, fp)
            for _ in range(2):
                ops.reset_launches()
                got = _k2_call(ops.keys_of, case, basis, fp)
                assert ops.LAUNCHES[name] == 1 and \
                    sum(ops.LAUNCHES.values()) == 1, ops.LAUNCHES
                torch.cuda.synchronize()
                assert got[2].dim() == 0 and got[2].dtype == torch.bool
                for a, b in zip(got, want):
                    _eq(a, b)
            if bad and case[2].any():
                assert bool(got[2])
            if basis == "stored" and not fp:
                got = _k2_call(ops.keys_of, case, basis, fp, row_ovf=True)
                r = torch.as_tensor(case[1], device=card)
                v = torch.as_tensor(case[2], device=card)
                _eq(got[3], ops.pack_rows_twin(r, case[4])[1] & v)


def test_keys_of_and_merge_sorted_replay_in_a_cuda_graph(card):
    """K2 and K4 keep no state between calls: captured once (after a
    warm call on the capture stream), each replays to the twins' results
    on two input sets copied into the captured inputs."""
    from jaxmc_torch.kernels import ops
    sets = [_k4_inputs("full", 3, 300000, seed, card)[0] for seed in (1, 2)]
    assert all(a.shape == b.shape for a, b in zip(sets[0], sets[1])
               if isinstance(a, torch.Tensor)) and sets[0][1] == sets[1][1]
    # two row sets (rows of another seed's plan may leave this plan's
    # ranges: the flag is compared too)
    k2 = [_k2_case(26, "sparse", 50000, seed, card, "canon", True)
          for seed in (3, 4)]
    c = k2[0]
    r = torch.as_tensor(c[1], device=card)
    v = torch.as_tensor(c[2], device=card)
    b = torch.as_tensor(c[3], device=card)
    args = [x.clone() if isinstance(x, torch.Tensor) else x
            for x in sets[0]]
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        ops.keys_of(r, v, c[4], True, False, basis=b, basis_packed=True)
        ops.merge_sorted(*args)
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        got2 = ops.keys_of(r, v, c[4], True, False, basis=b,
                           basis_packed=True)
        got4 = ops.merge_sorted(*args)
    for i in (1, 0, 1):
        ci = k2[i]
        r.copy_(torch.as_tensor(ci[1], device=card))
        v.copy_(torch.as_tensor(ci[2], device=card))
        b.copy_(torch.as_tensor(ci[3], device=card))
        for dst, src in zip(args, sets[i]):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        g.replay()
        torch.cuda.synchronize()
        for x, y in zip(got2, ops.keys_of_twin(r, v, c[4], True, False,
                                               basis=b, basis_packed=True)):
            _eq(x, y)
        want = ops.merge_sorted_twin(*sets[i])
        for name in MERGE_OUT:
            _eq(got4[name], want[name])


@pytest.mark.parametrize("streams", ["one", "two"])
def test_keys_of_and_merge_sorted_from_two_threads(card, streams):
    """K2 and K4 from two host threads at once, on one stream or on a
    stream each: every call equals its twin (K4's two launches stay
    together on a stream; another stream has zero words of its own)."""
    import threading
    from jaxmc_torch.kernels import ops
    k4 = [_k4_inputs(kind, 3, 200000, 5, card)[0]
          for kind in ("full", "small")]
    k2 = [_k2_case(7, "sparse", 100000, seed, card, "stored", seed == 1,
                   bad=seed == 1) for seed in (1, 2)]
    want4 = [ops.merge_sorted_twin(*a) for a in k4]
    want2 = [_k2_call(ops.keys_of_twin, c, "stored", t == 0)
             for t, c in enumerate(k2)]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def run(t):
        try:
            s = torch.cuda.Stream() if streams == "two" \
                else torch.cuda.default_stream()
            with torch.cuda.stream(s):
                for _ in range(30):
                    got[t].append((ops.merge_sorted(*k4[t]),
                                   _k2_call(ops.keys_of, k2[t], "stored",
                                            t == 0)))
            s.synchronize()
        except Exception as e:     # raised again in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    for t in (0, 1):
        assert len(got[t]) == 30
        for g4, g2 in got[t]:
            for name in MERGE_OUT:
                _eq(g4[name], want4[t][name])
            for a, b in zip(g2, want2[t]):
                _eq(a, b)


def test_keys_of_and_merge_sorted_raise_on_a_refused_launch(card,
                                                            monkeypatch):
    """A launch the card refuses (too much shared memory for K2, a tile
    K4 does not take) raises and counts nothing; the next call, with
    the geometry restored, equals the twin."""
    from jaxmc_torch.kernels import ops
    case = _k2_case(7, "half", 5000, 1, card)
    args, _keys = _k4_inputs("full", 3, 5000, 1, card)
    ops.reset_launches()
    monkeypatch.setattr(ops, "_KEYS_GEOM", {})
    monkeypatch.setattr(ops, "keys_geometry",
                        lambda *a, **k: (8, 128, 32, 300000))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _k2_call(ops.keys_of, case, "stored", False)
    monkeypatch.setattr(ops, "_MERGE_GEOM", {})
    monkeypatch.setattr(ops, "merge_geometry", lambda K: (3, 768, 64))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ops.merge_sorted(*args)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    monkeypatch.undo()
    for a, b in zip(_k2_call(ops.keys_of, case, "stored", False),
                    _k2_call(ops.keys_of_twin, case, "stored", False)):
        _eq(a, b)
    got, want = ops.merge_sorted(*args), ops.merge_sorted_twin(*args)
    torch.cuda.synchronize()
    for name in MERGE_OUT:
        _eq(got[name], want[name])


@pytest.mark.parametrize("seen_mode", ["auto", "fingerprint"])
def test_transfer_scaled_on_the_card(card, seen_mode):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    eng = TorchExplorer(load_model(os.path.join(SPECS, "transfer_scaled.tla")),
                        seen_mode=seen_mode)
    assert eng.device.type == "cuda"
    ops.reset_launches()
    r = eng.run()
    assert (r.ok, r.distinct, r.generated, r.diameter) == \
        (True, 153701, 311153, 9)
    base = ("unpack_rows", "keys_of", "seen_probe", "rank_merge")
    assert all(ops.LAUNCHES[k] > 0 for k in base), ops.LAUNCHES


def _sym_layout(spec, cfg):
    from jaxmc_torch.compile.kernel2 import build_layout2
    from jaxmc_torch.compile.symmetry2 import build_canon2
    from jaxmc_torch.compile.vspec import Bounds
    from jaxmc_torch.engine.simulate import sample_states
    from jaxmc_torch.session import load_model
    m = load_model(spec, cfg)
    lay = build_layout2(m, list(sample_states(m)), Bounds())
    return lay, build_canon2(m, lay)


@pytest.mark.parametrize("which", ["symtoy_scaled", "symkinds"])
@pytest.mark.parametrize("n", [1, 3000, 400000])
def test_canon_rows_matches_twin(card, which, n):
    from jaxmc_torch.kernels import ops
    if which == "symkinds":
        base = os.path.join(ROOT, "jaxmc_torch", "fixtures", "symkinds")
        lay, canon = _sym_layout(base + ".tla", base + ".cfg")
    else:
        lay, canon = _sym_layout(os.path.join(SPECS, which + ".tla"),
                                 os.path.join(SPECS, which + ".cfg"))
    rng = np.random.default_rng(n)
    rows = rng.integers(-2, 14, (n, lay.width)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = SENT
    valid = rng.random(n) < 0.8
    r = torch.as_tensor(rows, device=card)
    v = torch.as_tensor(valid, device=card)
    got = ops.canon_rows(r, v, canon)
    torch.cuda.synchronize()
    _eq(got, ops.canon_rows_twin(r, v, canon))


@pytest.mark.parametrize("budget,T", [(8192, 3), (4096, 1)])
def test_canon_rows_small_blocks(card, budget, T, monkeypatch):
    """K5 on the symkinds layout (W 138) with a budget (ops.CANON_SMEM)
    that forces blocks of T rows and leaves the program in device
    memory; rows at every
    word alignment, all-invalid rows, one row."""
    from jaxmc_torch.kernels import ops
    base = os.path.join(ROOT, "jaxmc_torch", "fixtures", "symkinds")
    lay, canon = _sym_layout(base + ".tla", base + ".cfg")
    W = lay.width
    monkeypatch.setattr(ops, "CANON_SMEM", budget)
    assert ops.canon_geometry(canon.program)[:2] == (T, False)
    rng = np.random.default_rng(budget)
    rows = rng.integers(-2, 14, (3001, W)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = SENT
    flat = torch.as_tensor(rows.reshape(-1), device=card)
    for off in range(4):
        r = flat[off:off + 3000 * W].view(3000, W)
        for v in (rng.random(3000) < 0.8, np.zeros(3000, bool)):
            v = torch.as_tensor(v, device=card)
            want = ops.canon_rows_twin(r, v, canon)
            for _ in range(2):
                _eq(ops.canon_rows(r, v, canon), want)
    one = flat[:W].view(1, W)
    v1 = torch.ones(1, dtype=torch.bool, device=card)
    _eq(ops.canon_rows(one, v1, canon), ops.canon_rows_twin(one, v1, canon))


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("n", [1, 4096, 655360])
def test_keys_of_basis_branches_match_twin(card, n, fp):
    """K2 with the canonical rows (packed with the plan, range-guarded)
    and with raw view lanes as the key basis."""
    from jaxmc_torch.kernels import ops
    eng, rows, valid = _plan_and_rows(n, 5)
    rng = np.random.default_rng(n + 1)
    other = rows[valid][rng.integers(0, max(int(valid.sum()), 1), n)] \
        if valid.any() else rows.copy()
    r = torch.as_tensor(rows, device=card)
    v = torch.as_tensor(valid, device=card)
    view = torch.as_tensor(np.ascontiguousarray(rows[:, :3]), device=card)
    for basis, packed in ((torch.as_tensor(other, device=card), True),
                          (view, False)):
        k = ops.keys_of(r, v, eng.pt, fp, False, basis=basis,
                        basis_packed=packed)
        t = ops.keys_of_twin(r, v, eng.pt, fp, False, basis=basis,
                             basis_packed=packed)
        torch.cuda.synchronize()
        for a, b in zip(k, t):
            _eq(a, b)
    # a canonical row out of range raises the flag, the raw rows do not
    if valid.any():
        lane = int(np.nonzero(~eng.plan.full)[0][0])
        bad = other.copy()
        bad[int(np.nonzero(valid)[0][0]), lane] = \
            int(eng.plan.bias[lane] + eng.plan.allowed[lane]) + 3
        b = torch.as_tensor(bad, device=card)
        k = ops.keys_of(r, v, eng.pt, fp, False, basis=b, basis_packed=True)
        t = ops.keys_of_twin(r, v, eng.pt, fp, False, basis=b,
                             basis_packed=True)
        assert bool(k[2]) and bool(t[2])


@pytest.mark.parametrize("A,FC,n_arms", [(4, 1, 4), (13, 4096, 9),
                                         (40, 300000, 70)])
def test_por_mask_matches_twin(card, A, FC, n_arms):
    from jaxmc_torch.kernels import build, ops
    assert build.library("por").jmc_por_max_arms() == ops.POR_MAX_ARMS
    rng = np.random.default_rng(A)
    inst = np.sort(rng.integers(0, n_arms, A)).astype(np.int32)
    for trial in range(3):
        cvalid = rng.random(A * FC) < (0.3, 0.8, 1.0)[trial]
        found = rng.random(A * FC) < (0.05, 0.2, 0.5)[trial]
        safe = rng.random(n_arms) < 0.5
        args = [torch.as_tensor(x, device=card)
                for x in (found, cvalid, inst, safe)] + [A, FC]
        k = ops.por_mask(*args)
        t = ops.por_mask_twin(*args)
        torch.cuda.synchronize()
        for a, b in zip(k, t):
            _eq(a, b)


@pytest.mark.parametrize("spec,cfg,kw,want,need", [
    ("symtoy_scaled.tla", "symtoy_scaled.cfg", {}, (10725, 65365),
     ("canon_rows", "keys_of_canon")),
    ("viewtoy_scaled.tla", "viewtoy_scaled.cfg", {}, (18432, 239617),
     ("keys_of_view",)),
    ("msgstoy.tla", "msgstoy.cfg", {"por": True}, None,
     ("seen_probe_por", "por_mask")),
])
def test_reduction_modes_on_the_card(card, spec, cfg, kw, want, need):
    """Each mode on the kernels equals the same model on the twins (on
    the card) and, where given, the corpus pins."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    res = {}
    for twins in (False, True):
        m = load_model(os.path.join(SPECS, spec), os.path.join(SPECS, cfg),
                       no_deadlock=True)
        ops.reset_launches()
        res[twins] = TorchExplorer(m, twins=twins, **kw).run()
        if not twins:
            assert all(ops.LAUNCHES[k] > 0 for k in need), ops.LAUNCHES
    a, b = res[False], res[True]
    assert (a.ok, a.distinct, a.generated, a.diameter) == \
        (b.ok, b.distinct, b.generated, b.diameter)
    if want is not None:
        assert (a.distinct, a.generated) == want


@pytest.mark.parametrize("A,CH", [(1, 64), (13, 4096), (33, 65536),
                                  (7, 1 << 18), (0, 1024)])
@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_hstep_epilogue_matches_twin(card, A, CH, p):
    """K7 on random masks: A not a multiple of 32, chunks from 64 to
    2^18, all-invalid and all-valid chunks, a partial last chunk with
    K2's pack-overflow flag set."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(A * 7 + CH)
    C = A * CH
    for fcount, pack_ovf in ((CH, False), (CH - CH // 3, True)):
        en = rng.random((A, CH)) < p
        aok = rng.random((A, CH)) > (0.0 if pack_ovf else 1e-4)
        ov = np.where(rng.random((A, CH)) < (1e-5 if pack_ovf else 0.0),
                      rng.integers(1, 3, (A, CH)), 0).astype(np.int32)
        keys = rng.integers(-2**31, 2**31, (C, 5)).astype(np.int32)
        cand = rng.integers(-2**31, 2**31, (C, 2)).astype(np.int32)
        inv = torch.as_tensor(rng.random(C) < 0.9, device=card)
        exp = torch.as_tensor(rng.random(C) < 0.7, device=card)
        args = [torch.as_tensor(x, device=card) for x in (en, aok, ov)] + \
            [fcount, torch.as_tensor(keys, device=card),
             torch.as_tensor(cand, device=card),
             torch.tensor(pack_ovf, device=card), OV_PACK, inv, exp]
        k = ops.hstep_epilogue(*args)
        t = ops.hstep_epilogue_twin(*args)
        torch.cuda.synchronize()
        _eq(k["scalars"], t["scalars"])
        _eq(k["dead"], t["dead"])
        nv = int(t["scalars"][0])
        for name in ("idx", "fps", "rows", "inv_ok", "explore"):
            _eq(k[name][:nv], t[name][:nv])

def _k7_args(card, A=13, CH=65536, p=0.4, seed=3, pack_ovf=True):
    from jaxmc_torch.compile.kernel2 import OV_PACK
    rng = np.random.default_rng(seed)
    C = A * CH
    ov = np.where(rng.random((A, CH)) < 1e-5, rng.integers(1, 3, (A, CH)),
                  0).astype(np.int32)
    return [torch.as_tensor(rng.random((A, CH)) < p, device=card),
            torch.as_tensor(rng.random((A, CH)) > 1e-4, device=card),
            torch.as_tensor(ov, device=card), CH - CH // 5,
            torch.as_tensor(rng.integers(-2**31, 2**31, (C, 5))
                            .astype(np.int32), device=card),
            torch.as_tensor(rng.integers(-2**31, 2**31, (C, 2))
                            .astype(np.int32), device=card),
            torch.tensor(pack_ovf, device=card), OV_PACK,
            torch.as_tensor(rng.random(C) < 0.9, device=card),
            torch.as_tensor(rng.random(C) < 0.7, device=card)]


def _k7_eq(k, t):
    _eq(k["scalars"], t["scalars"])
    _eq(k["dead"], t["dead"])
    nv = int(t["scalars"][0])
    for name in ("idx", "fps", "rows", "inv_ok", "explore"):
        _eq(k[name][:nv], t[name][:nv])


def test_hstep_epilogue_one_launch_a_call(card):
    """K7 counts one launch a call, and calls in a row on one workspace
    (older epochs' words present, fewer tiles than before) each equal
    the twin."""
    from jaxmc_torch.kernels import ops
    for A, CH, p in ((13, 65536, 0.4), (3, 1000, 1.0), (13, 65536, 0.0),
                     (1, 64, 0.5), (0, 4096, 0.5)):
        args = _k7_args(card, A, CH, p)
        before = ops.LAUNCHES["hstep_epilogue"]
        k = ops.hstep_epilogue(*args)
        assert ops.LAUNCHES["hstep_epilogue"] == before + 1
        torch.cuda.synchronize()
        _k7_eq(k, ops.hstep_epilogue_twin(*args))


def test_hstep_epilogue_from_two_threads(card):
    """K7 from two host threads on the default stream: the workspace's
    lock keeps each call's launch whole; every call equals its twin."""
    import threading
    from jaxmc_torch.kernels import ops
    cases = [_k7_args(card, 13, 16384, p, seed=9 + t)
             for t, p in enumerate((0.3, 0.7))]
    want = [ops.hstep_epilogue_twin(*a) for a in cases]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def run(t):
        try:
            for _ in range(40):
                got[t].append(ops.hstep_epilogue(*cases[t]))
        except Exception as e:     # raised again in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    for t in (0, 1):
        assert len(got[t]) == 40
        for k in got[t]:
            _k7_eq(k, want[t])


def test_hstep_epilogue_refuses_capture_and_host_flags(card):
    """K7 takes a new epoch a call, so it refuses CUDA graph capture;
    K2's pack flag must be its 0-d device tensor (a host bool would be
    a host-to-device copy a call).  Neither launches anything."""
    from jaxmc_torch.kernels import ops
    args = _k7_args(card, 2, 4096)
    torch.cuda.synchronize()
    ops.reset_launches()
    for flag in (True, False, np.bool_(True)):
        bad = list(args)
        bad[6] = flag
        with pytest.raises(TypeError, match="pack_ovf"):
            ops.hstep_epilogue(*bad)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with pytest.raises(RuntimeError, match="CUDA graph"):
            ops.hstep_epilogue(*args)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES



@pytest.mark.parametrize("spec,cfg,kw", [
    ("transfer_scaled.tla", None, {}),
    ("pcal_intro_buggy.tla", None, {"chunk": 64}),
    ("interparm_toy.tla", "interparm_toy.cfg", {"chunk": 64}),
    ("msgstoy.tla", "msgstoy.cfg", {"por": True}),
    # every arm interpreted: the chunk step has no instances
    (os.path.join(ROOT, "jaxmc_torch", "fixtures", "allinterp.tla"),
     os.path.join(ROOT, "jaxmc_torch", "fixtures", "allinterp.cfg"), {}),
])
def test_host_seen_on_the_card_equals_the_cpu(card, spec, cfg, kw):
    """The host-seen engine on the card (K1, K2, K7) and on the CPU:
    verdict, counts, trace, warnings and log lines equal."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    res = {}
    for dev in ("cuda", "cpu"):
        m = load_model(os.path.join(SPECS, spec),
                       os.path.join(SPECS, cfg) if cfg else None,
                       no_deadlock=bool(kw.get("por")))
        lines = []
        ops.reset_launches()
        r = TorchExplorer(m, device=dev, host_seen=True, log=lines.append,
                          progress_every=1e9, **kw).run()
        if dev == "cuda":
            assert ops.LAUNCHES["hstep_epilogue"] > 0, ops.LAUNCHES
            assert ops.LAUNCHES["rank_merge"] == 0
        res[dev] = (r.ok, r.generated, r.distinct, r.diameter, r.warnings,
                    r.violation and format_trace(r.violation), lines)
    assert res["cuda"] == res["cpu"]


def _k8_call(mask, cap, flim=None, aok=None, ov=None, site=""):
    """K8 twice on the same inputs against its twin: the whole idx[:cap]
    and the six scalars bit for bit, both calls bit-identical, and 2
    launches a call."""
    from jaxmc_torch.kernels import ops
    name = "resident_compact" + ("_" + site if site else "")
    ops.reset_launches()
    kw = {"site": site} if site else {}
    k1 = ops.resident_compact(mask, cap, flim, aok, ov, **kw)
    k2 = ops.resident_compact(mask, cap, flim, aok, ov, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 4, ops.LAUNCHES
    t = ops.resident_compact_twin(mask, cap, flim, aok, ov)
    for k in (k1, k2):
        _eq(k[0], t[0])
        _eq(k[1], t[1])


@pytest.mark.parametrize("A,CH,cap", [(1, 64, 64), (13, 4096, 1 << 14),
                                      (33, 65536, 1 << 18),
                                      (7, 1 << 18, 1 << 14)])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_resident_compact_matches_twin(card, A, CH, cap, p):
    """K8 at the chunk site (a partial last chunk, assert and overflow
    codes, dead slots) and at the explore site ([C] mask capped at
    FCap): every index of the stable partition and every scalar, twice
    in a row, 2 launches a call (the single pass and the unset tail)."""
    rng = np.random.default_rng(A * 11 + CH)
    cap = min(cap, A * CH)
    for flim in (CH, CH - CH // 3, 0):
        en = torch.as_tensor(rng.random((A, CH)) < p, device=card)
        aok = torch.as_tensor(rng.random((A, CH)) > 1e-4, device=card)
        ov = torch.as_tensor(np.where(rng.random((A, CH)) < 1e-5,
                                      rng.integers(1, 3, (A, CH)), 0)
                             .astype(np.int32), device=card)
        _k8_call(en, cap, flim, aok, ov)
    _k8_call(en.reshape(-1).contiguous(), cap, site="explore")


def _k8_tile():
    from jaxmc_torch.kernels import build
    return int(build.library("resident").jmc_res_tile())


@pytest.mark.parametrize("size", ["T-1", "T", "T+1", "3T", "2^23+1"])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_resident_compact_tile_edges(card, size, p):
    """K8 at sizes around its tile T: every cap from 0 through cap below
    the count to cap = C, at both sites, with flim = 0 and a flim that
    cuts a row; none set, half set, all set."""
    T = _k8_tile()
    C = {"T-1": T - 1, "T": T, "T+1": T + 1, "3T": 3 * T,
         "2^23+1": 2**23 + 1}[size]
    rng = np.random.default_rng(C + int(p * 10))
    m = torch.as_tensor(rng.random(C) < p, device=card)
    n = int(m.sum())
    for cap in sorted({0, 1, max(n - 7, 0), n // 2, min(n + 5, C), C}):
        _k8_call(m, cap, site="explore")
    # the chunk site over the same entries as a grid of A rows
    A = 3 if C % 3 == 0 else 1
    CH = C // A
    en = m.reshape(A, CH)
    aok = torch.as_tensor(rng.random((A, CH)) > 1e-3, device=card)
    ov = torch.as_tensor(np.where(rng.random((A, CH)) < 1e-3,
                                  rng.integers(1, 4, (A, CH)), 0)
                         .astype(np.int32), device=card)
    for flim in sorted({0, CH // 2 + 1, CH}):
        for cap in sorted({0, max(n // 3, 1), C}):
            _k8_call(en, cap, flim, aok, ov)


@pytest.mark.parametrize("case", range(8))
def test_resident_fold_matches_twin(card, case):
    """K9: every status (continue, the three overflows, assert,
    deadlock, a carry that is not ST_CONTINUE and must stay as it is),
    with and without POR deltas: carry, bad row and accumulators."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(case)
    VC, AccCap, PW, FC, CH = 4096, 1 << 15, 3, 1 << 14, 1 << 12
    stat0 = ops.ST_DEADLOCK if case == 7 else ops.ST_CONTINUE
    acc_n0 = [0, 9000, 27000, 0, 100, 0, 0, 7][case]
    vcnt = [4000, 4096, 1000, 5000, 10, 10, 10, 9][case]
    part = torch.tensor([vcnt, 2 if case == 3 else 0, int(case == 4),
                         int(rng.integers(0, 13 * CH)), int(case in (5, 6)),
                         int(rng.integers(0, CH))], dtype=torch.int64,
                        device=card)
    por = torch.tensor([3, 5, min(2, vcnt)], dtype=torch.int64,
                       device=card) if case % 2 else None
    args = [part, torch.tensor(case == 6, device=card), por] + [
        torch.as_tensor(x, device=card) for x in (
            rng.integers(-2**31, 2**31, (VC, 5)).astype(np.int32),
            rng.integers(-2**31, 2**31, (VC, PW)).astype(np.int32))]
    acc = [rng.integers(-9, 9, (AccCap, w)).astype(np.int32)
           for w in (5, PW)]
    frontier = torch.as_tensor(rng.integers(0, 99, (FC, PW))
                               .astype(np.int32), device=card)
    out = {}
    for name, f in (("kernel", ops.resident_fold),
                    ("twin", ops.resident_fold_twin)):
        carry = torch.tensor([stat0, acc_n0, 50, 0, 1, 2, 3],
                             dtype=torch.int64, device=card)
        bad = torch.full((PW,), SENT, dtype=torch.int32, device=card)
        ak, ar = (torch.as_tensor(a.copy(), device=card) for a in acc)
        f(carry, bad, *args, ak, ar, frontier, 1 << 13, CH, True, OV_PACK)
        torch.cuda.synchronize()
        out[name] = (carry, bad, ak, ar)
    for a, b in zip(out["kernel"], out["twin"]):
        _eq(a, b)


# the CPU formula's starting caps, given to both devices so that their
# growth lines are the same
RES_CAPS = {"SC": 1 << 15, "FCap": 2048, "AccCap": 1 << 15, "VC": 1 << 13}


@pytest.mark.parametrize("spec,cfg,kw", [
    ("transfer_scaled.tla", None, {}),
    ("pcal_intro_buggy.tla", None, {}),
    ("batchtoy.tla", "batchtoy_bad.cfg", {}),
    ("portoy.tla", "portoy_bad.cfg", {"por": True}),
    ("symtoy_scaled.tla", "symtoy_scaled.cfg", {"chunk": 256}),
    ("ooc_scaled.tla", "ooc_scaled.cfg",
     {"seen_cap": 512, "host_tier_keys": 1024, "chunk": 256}),
])
def test_resident_on_the_card_equals_the_cpu(card, spec, cfg, kw, tmp_path):
    """The resident engine on the card (K1-K4, K8, K9, and K5/K6 where
    the model asks) and on the CPU: verdict, counts, the decoded
    violation state, warnings, tier statistics and every log line."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    res = {}
    for dev in ("cuda", "cpu"):
        m = load_model(os.path.join(SPECS, spec),
                       os.path.join(SPECS, cfg) if cfg else None,
                       no_deadlock="symtoy" in spec)
        lines = []
        ops.reset_launches()
        r = TorchExplorer(m, device=dev, resident=True, log=lines.append,
                          progress_every=1e9, res_caps=RES_CAPS,
                          spill_dir=str(tmp_path / dev), **kw).run()
        if dev == "cuda":
            for k in ("unpack_rows", "resident_compact",
                      "resident_compact_explore", "resident_fold",
                      "seen_probe", "rank_merge"):
                assert ops.LAUNCHES[k] > 0, (k, ops.LAUNCHES)
            assert ops.LAUNCHES["hstep_epilogue"] == 0
        tiers = {k: v for k, v in (r.tiers or {}).items()
                 if k != "probe_wall_s"}
        res[dev] = (r.ok, r.generated, r.distinct, r.diameter, r.warnings,
                    r.violation and format_trace(r.violation), tiers, lines)
    assert res["cuda"] == res["cpu"]
    if "seen_cap" in kw:
        assert res["cuda"][6]["spills"] > 0


def test_tiered_level_engine_on_the_card_equals_the_cpu(card, tmp_path):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.session import load_model
    res = {}
    for dev in ("cuda", "cpu"):
        m = load_model(os.path.join(SPECS, "ooc_scaled.tla"),
                       os.path.join(SPECS, "ooc_scaled_bad.cfg"))
        lines = []
        r = TorchExplorer(m, device=dev, log=lines.append, seen_cap=512,
                          host_tier_keys=1024, progress_every=1e9,
                          spill_dir=str(tmp_path / dev)).run()
        res[dev] = (r.ok, r.generated, r.distinct, r.diameter,
                    r.violation and format_trace(r.violation),
                    r.tiers["spills"], lines)
    assert res["cuda"] == res["cpu"]


def test_resident_level_does_not_synchronise(card):
    """One level's chunk loop and level end run with no host
    synchronisation between the emitter's output and the summary read:
    torch.cuda.set_sync_debug_mode("error") is on around the code the
    resident engine adds (off inside the emitter and the predicates).
    A first run on the same engine fills the per-device caches (the
    lane plan's tensors, the kernel libraries)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    def quiet(f):
        def g(*a):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return f(*a)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return g

    class NoSync(TorchExplorer):
        levels = 0
        armed = False

        def _res_level(self, *a):
            if not self.armed:
                return super()._res_level(*a)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = super()._res_level(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            NoSync.levels += 1
            return out

        def _expand(self, frontier):
            return quiet(super()._expand)(frontier)

    for spec, cfg, kw in (("transfer_scaled.tla", None, {}),
                          ("msgstoy.tla", "msgstoy.cfg", {"por": True})):
        eng = NoSync(load_model(os.path.join(SPECS, spec),
                                os.path.join(SPECS, cfg) if cfg else None,
                                no_deadlock=True),
                     resident=True, **kw)
        eng.inv_fns = [(n, quiet(f)) for n, f in eng.inv_fns]
        eng.constraint_fns = [(n, quiet(f)) for n, f in eng.constraint_fns]
        eng.run()
        eng.armed = True
        try:
            r = eng.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert r.ok and NoSync.levels > 5


@pytest.mark.parametrize("B,A,CH", [(1, 13, 4096), (3, 13, 65536),
                                    (4, 33, 1024), (5, 1, 64), (2, 0, 256)])
@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_batch_epilogue_matches_twin(card, B, A, CH, p):
    """K10 on random masks: ragged fcounts, one idle lane, members'
    pack-overflow flags, A not a multiple of 32, and no instances."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(B * 1000 + A * 7 + CH)
    C = A * CH
    fc = rng.integers(1, CH + 1, B).astype(np.int32)
    fc[rng.integers(0, B)] = 0
    fc[0] = CH
    t = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    args = (t(rng.random((B, A, CH)) < p),
            t(rng.random((B, A, CH)) > 1e-4),
            t(np.where(rng.random((B, A, CH)) < 1e-5,
                       rng.integers(1, 3, (B, A, CH)), 0).astype(np.int32)),
            t(fc), t(rng.integers(-2**31, 2**31, (B * C, 5)).astype(np.int32)),
            t(rng.integers(-2**31, 2**31, (B * C, 3)).astype(np.int32)),
            t(rng.random(B) < 0.5), OV_PACK, t(rng.random(B * C) < 0.9),
            t(rng.random(B * C) < 0.7))
    k = ops.batch_epilogue(*args)
    w = ops.batch_epilogue_twin(*args)
    torch.cuda.synchronize()
    for name in ("scalars", "dead", "offsets"):
        _eq(k[name], w[name])
    n = int(w["offsets"][-1])
    for name in ("idx", "fps", "rows", "inv_ok", "explore"):
        _eq(k[name][:n], w[name][:n])


@pytest.mark.parametrize("prop", ["monotone", "frozen", "live", "nolive"])
@pytest.mark.parametrize("host_seen", [False, True])
def test_properties_on_the_card_equal_the_cpu(card, prop, host_seen,
                                              tmp_path):
    """transfer_props at MaxMoney 3 on the card (K8's edge site on the
    level engine, K7 under host-seen) and on the CPU: verdict, counts,
    property name, trace and warnings equal."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    fix = os.path.join(ROOT, "jaxmc_torch", "fixtures")
    cfg = str(tmp_path / f"tp3_{prop}.cfg")
    with open(os.path.join(fix, f"transfer_props_{prop}.cfg")) as fh:
        text = fh.read().replace("MaxMoney = 12", "MaxMoney = 3")
    with open(cfg, "w") as fh:
        fh.write(text)
    res = {}
    for dev in ("cuda", "cpu"):
        m = load_model(os.path.join(fix, "transfer_props.tla"), cfg, False,
                       [SPECS])
        ops.reset_launches()
        r = TorchExplorer(m, device=dev, host_seen=host_seen,
                          chunk=64).run()
        if dev == "cuda":
            site = "hstep_epilogue" if host_seen else \
                "resident_compact_edges"
            assert ops.LAUNCHES[site] > 0, ops.LAUNCHES
        res[dev] = (r.ok, r.generated, r.distinct, r.diameter, r.warnings,
                    r.violation and (r.violation.name,
                                     format_trace(r.violation)))
    assert res["cuda"] == res["cpu"]


@pytest.mark.parametrize("cohort", ["batchtoy", "msgstoy"])
def test_batch_cohort_on_the_card_equals_the_cpu(card, cohort, tmp_path):
    """The batchtoy cohort, and msgstoy at Cap 1-3 and T 2 (its Tick arm
    has a dynamic \\E slot axis, sized at build time), through K10 on
    the card and on the CPU: each member's result equal; K10 launched,
    K7 not."""
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import SessionConfig
    if cohort == "batchtoy":
        spec = os.path.join(SPECS, "batchtoy.tla")
        cfgs = [os.path.join(SPECS, f"batchtoy_{v}.cfg")
                for v in ("a", "b", "c", "d", "bad")]
    else:
        spec = os.path.join(SPECS, "msgstoy.tla")
        cfgs = []
        for cap in (1, 2, 3):
            with open(os.path.join(ROOT, "jaxmc_torch", "fixtures",
                                   f"msgstoy_batch_cap{cap}.cfg")) as fh:
                text = fh.read().replace("T = 6", "T = 2")
            (tmp_path / f"c{cap}.cfg").write_text(text)
            cfgs.append(str(tmp_path / f"c{cap}.cfg"))
    res = {}
    for dev in ("cuda", "cpu"):
        be = BatchCheckEngine([SessionConfig(
            spec=spec, cfg=c, host_seen=True, device=dev)
            for c in cfgs]).build()
        ops.reset_launches()
        members = be.run()
        if dev == "cuda":
            assert ops.LAUNCHES["batch_epilogue"] > 0, ops.LAUNCHES
            assert ops.LAUNCHES["hstep_epilogue"] == 0
        assert be.dispatcher.max_width == len(cfgs)
        res[dev] = [(m.error, m.result.ok, m.result.distinct,
                     m.result.generated, m.result.violation
                     and format_trace(m.result.violation))
                    for m in members]
    assert res["cuda"] == res["cpu"]


# ---------------------------------------------------------------------------
# K11 fullsort_dedup, the full-sort step, checkpoints and resume
# ---------------------------------------------------------------------------

def _k11_inputs(card, SC, C, K, dup, seed, n_seen=None, vals=50):
    """The sorted [SC + C, K] keys of a seen table (a live prefix, then
    invalid rows) and candidates with duplicates and invalid rows, and
    their flags and pre-sort indices."""
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(seed)
    n_seen = SC // 3 if n_seen is None else n_seen
    seen = np.full((SC, K), SENT, np.int32)
    sv = np.unique(rng.integers(-vals, vals, (n_seen, K - 1))
                   .astype(np.int32), axis=0)
    seen[:len(sv), 0] = 0
    seen[:len(sv), 1:] = sv
    cand = np.zeros((C, K), np.int32)
    cand[:, 1:] = rng.integers(-vals, vals, (C, K - 1))
    take = rng.random(C) < dup
    if len(sv) and take.any():
        cand[take, 1:] = sv[rng.integers(0, len(sv), int(take.sum()))]
    bad = rng.random(C) < 0.2
    cand[bad, 0] = 1
    cand[bad, 1:] = SENT
    allk = torch.as_tensor(np.concatenate([seen, cand]), device=card)
    perm = ops.lsd_sort(allk)
    skeys = allk[perm].contiguous()
    perm = perm.to(torch.int32)
    sflag = (perm >= SC).to(torch.int32)
    return skeys, sflag, perm


def _k11_call(skeys, sflag, perm, SC, C):
    """K11 twice on the same inputs against its twin: new_cidx over
    new_count, seen2 over seen_count2 and the counts bit for bit, both
    calls bit-identical, 1 launch a call."""
    from jaxmc_torch.kernels import ops
    ops.reset_launches()
    k1 = ops.fullsort_dedup(skeys, sflag, perm, SC, C)
    k2 = ops.fullsort_dedup(skeys, sflag, perm, SC, C)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fullsort_dedup"] == 2, ops.LAUNCHES
    nt, st, ct = ops.fullsort_dedup_twin(skeys, sflag, perm, SC, C)
    n_new, n_keep = int(ct[0]), int(ct[1])
    for nk, sk, ck in (k1, k2):
        _eq(ck, ct)
        _eq(nk[:n_new], nt[:n_new])
        _eq(sk[:n_keep], st[:n_keep])
    _eq(k1[0], k2[0])
    _eq(k1[1][:n_keep], k2[1][:n_keep])


@pytest.mark.parametrize("SC,C,K", [(64, 32, 3), (1 << 16, 40000, 3),
                                    (1 << 18, 1 << 18, 5), (256, 0, 2)])
@pytest.mark.parametrize("dup", [0.0, 0.5, 0.95])
def test_fullsort_dedup_matches_twin(card, SC, C, K, dup):
    """K11 against its twin over the sorted [SC + C, K] keys of a seen
    table (a live prefix, then invalid rows) and candidates with
    duplicates and invalid rows: new_cidx over new_count and seen2 over
    seen_count2 bit for bit, the counts equal, twice in a row, 1 launch
    a call."""
    _k11_call(*_k11_inputs(card, SC, C, K, dup, SC + C + K), SC, C)


@pytest.mark.parametrize("K", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("rows", ["1", "T-1", "T", "T+1", "3T",
                                  "2^23+1"])
def test_fullsort_dedup_tile_edges(card, K, rows):
    """K11 at row counts around its tile T (which depends on K) and N =
    1, with few distinct keys, so runs of equal keys cross tile
    boundaries: twice in a row against its twin, 1 launch a call."""
    from jaxmc_torch.kernels import build
    T = int(build.library("fullsort").jmc_fullsort_tile_rows(K))
    N = {"1": 1, "T-1": T - 1, "T": T, "T+1": T + 1, "3T": 3 * T,
         "2^23+1": 2**23 + 1}[rows]
    if N == 1:
        for SC, C in ((1, 0), (0, 1)):
            _k11_call(*_k11_inputs(card, SC, C, K, 0.5, K, 0), SC, C)
        return
    SC = N // 2
    C = N - SC
    _k11_call(*_k11_inputs(card, SC, C, K, 0.7, N + K, vals=3), SC, C)


@pytest.mark.parametrize("streams", ["one", "two"])
def test_compactions_from_two_threads(card, streams):
    """K8 and K11 called from two host threads at once, both on the
    default stream (as the batch engine's threads launch) or each on a
    stream of its own: every call equals its twin.  The workspace's lock
    keeps a call's launches together on one stream; another stream has
    a workspace of its own."""
    import threading
    from jaxmc_torch.kernels import ops
    SC, C, cap = 1 << 16, 40000, 1 << 19
    rng = np.random.default_rng(5)
    masks = [torch.as_tensor(rng.random(1 << 20) < p, device=card)
             for p in (0.3, 0.7)]
    k11 = [_k11_inputs(card, SC, C, 3, d, 9 + t)
           for t, d in enumerate((0.2, 0.8))]
    want8 = [ops.resident_compact_twin(m, cap) for m in masks]
    want11 = [ops.fullsort_dedup_twin(*x, SC, C) for x in k11]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def run(t):
        try:
            s = torch.cuda.Stream() if streams == "two" \
                else torch.cuda.default_stream()
            with torch.cuda.stream(s):
                for _ in range(40):
                    got[t].append((
                        ops.resident_compact(masks[t], cap, site="explore"),
                        ops.fullsort_dedup(*k11[t], SC, C)))
            s.synchronize()
        except Exception as e:     # raised again in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    for t in (0, 1):
        n_new, n_keep = (int(x) for x in want11[t][2])
        assert len(got[t]) == 40
        for (idx, sc), (nc, s2, cn) in got[t]:
            _eq(idx, want8[t][0])
            _eq(sc, want8[t][1])
            _eq(cn, want11[t][2])
            _eq(nc[:n_new], want11[t][0][:n_new])
            _eq(s2[:n_keep], want11[t][1][:n_keep])


def test_compactions_refuse_graph_capture(card):
    """A call's epoch is an argument of its launch, so a captured call
    would replay one epoch: K8 and K11 refuse capture, and launch
    nothing."""
    from jaxmc_torch.kernels import ops
    m = torch.ones(4096, dtype=torch.bool, device=card)
    skeys, sflag, perm = _k11_inputs(card, 64, 32, 3, 0.5, 1)
    torch.cuda.synchronize()
    ops.reset_launches()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with pytest.raises(RuntimeError, match="CUDA graph"):
            ops.resident_compact(m, 16, site="explore")
        with pytest.raises(RuntimeError, match="CUDA graph"):
            ops.fullsort_dedup(skeys, sflag, perm, 64, 32)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("spec,cfg,kw", [
    ("transfer_scaled.tla", None, {}),
    ("pcal_intro_buggy.tla", None, {}),
    ("msgstoy.tla", "msgstoy.cfg", dict(por=True)),
])
def test_fullsort_on_the_card_equals_the_cpu(card, spec, cfg, kw,
                                             monkeypatch):
    """JAXMC_LEVEL_RANKMERGE=0 on the card, through K11, equals the same
    run on the CPU and the rank path on the card."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    cfgp = os.path.join(SPECS, cfg) if cfg else None

    def run(dev, flag):
        monkeypatch.setenv("JAXMC_LEVEL_RANKMERGE", flag)
        r = TorchExplorer(load_model(os.path.join(SPECS, spec), cfgp,
                                     no_deadlock=bool(kw)),
                          device=dev, **kw).run()
        v = r.violation
        return (r.ok, r.distinct, r.generated, r.diameter,
                v and format_trace(v))
    ops.reset_launches()
    full = run("cuda", "0")
    assert ops.LAUNCHES["fullsort_dedup"] > 0
    assert ops.LAUNCHES["rank_merge"] == 0
    assert full == run("cpu", "0") == run("cuda", "1")


@pytest.mark.parametrize("engine", ["level", "host_seen", "resident"])
def test_resume_on_the_card_equals_the_cpu(card, engine, tmp_path):
    """A truncation checkpoint written on the card equals the CPU's
    field by field (the resident caps aside: the card starts from larger
    caps), and the card's resume reaches the pins."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.ckpt import load_checkpoint
    from jaxmc_torch.session import load_model
    spec = os.path.join(SPECS, "transfer_scaled.tla")
    kw = {"level": {}, "host_seen": dict(host_seen=True, chunk=4096),
          "resident": dict(resident=True, chunk=4096)}[engine]
    cks = {}
    for dev in ("cuda", "cpu"):
        cks[dev] = str(tmp_path / f"{dev}.ck")
        TorchExplorer(load_model(spec), device=dev, max_states=20000,
                      checkpoint_path=cks[dev], checkpoint_every=0.0,
                      **kw).run()
    a = load_checkpoint(cks["cuda"], kind="device")[1]
    b = load_checkpoint(cks["cpu"], kind="device")[1]
    a.pop("caps", None)
    b.pop("caps", None)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        elif k not in ("trace_levels", "frontier_maps", "graph"):
            assert a[k] == b[k], k
    r = TorchExplorer(load_model(spec), device="cuda",
                      resume_from=cks["cuda"], **kw).run()
    assert (r.ok, r.distinct, r.generated, r.diameter) == \
        (True, 153701, 311153, 9)


def test_completed_resident_checkpoint_launches_nothing(card, tmp_path):
    """Resuming a completed resident checkpoint replays the verdict with
    zero kernel launches: no level runs and the initial states are not
    keyed."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    spec = os.path.join(SPECS, "transfer_scaled.tla")
    ck = str(tmp_path / "f.ck")
    TorchExplorer(load_model(spec), device="cuda", resident=True,
                  chunk=4096, checkpoint_path=ck,
                  final_checkpoint=True).run()
    eng = TorchExplorer(load_model(spec), device="cuda", resident=True,
                        chunk=4096, resume_from=ck)
    ops.reset_launches()
    r = eng.run()
    torch.cuda.synchronize()
    assert (r.ok, r.distinct, r.generated, r.diameter) == \
        (True, 153701, 311153, 9)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("n,seed", [(1, 0), (8192, 0), (8192, 1),
                                    (100000, 2)])
def test_oracle_probe_matches_twin(card, n, seed):
    """K12 against its twin on sorted seeded keys, bit for bit on out,
    lo and the wrapped int32 checksum; the probe's own keys (seed 0 of
    the reference, n 8192) are the second case."""
    from jaxmc_torch.backend.oracle import probe_keys
    from jaxmc_torch.kernels import ops
    if (n, seed) == (8192, 0):
        keys = probe_keys("cuda")
    else:
        rng = np.random.RandomState(seed)
        keys = torch.as_tensor(rng.randint(-2**31, 2**31 - 1, (n, 4),
                                           dtype=np.int64).astype(np.int32),
                               device="cuda")
    perm = ops.lsd_sort(keys)
    sk = keys[perm].contiguous()
    perm = perm.to(torch.int32)
    before = ops.LAUNCHES["oracle_probe"]
    got = ops.oracle_probe(sk, perm, keys)
    want = ops.oracle_probe_twin(sk, perm, keys)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["oracle_probe"] == before + 1
    for a, b in zip(got, want):
        _eq(a, b)


def test_oracle_chooses_the_card(card):
    """The preflight oracle on the card: the gpu probe (K12) is live and
    wins, and its process launched K12 once for each of its two calls."""
    from jaxmc_torch import obs
    from jaxmc_torch.backend import oracle
    tel = obs.Telemetry()
    v = oracle.preflight(tel=tel, use_cache=False)
    assert v["platform"] == "gpu", v
    assert v["probes"]["gpu"]["live"] and v["probes"]["cpu"]["live"], v
    assert tel.gauges["backend.oracle_choice"] == "gpu"
    assert v["probes"]["gpu"]["launches"] == 2, v


def _mesh_candidates(D, C, p, seed, K=5, PW=3):
    rng = np.random.default_rng(seed)
    valid = rng.random((D, C)) < p
    keys = rng.integers(-2**31, 2**31 - 1, (D, C, K)).astype(np.int32)
    keys[..., 0] = 0
    keys[~valid] = SENT
    keys[~valid, 0] = 1
    cand = rng.integers(-2**31, 2**31 - 1, (D, C, PW)).astype(np.int32)
    cand[~valid] = SENT
    return [torch.as_tensor(x, device="cuda") for x in (keys, cand, valid)]


@pytest.mark.parametrize("D,C,p,B,SB,skew", [
    (2, 192, 0.5, 192, 48, False), (4, 4096, 0.9, 300, 75, False),
    (4, 100000, 0.3, 50000, 12500, True),
    (8, 65536, 0.6, 9000, 2250, False), (1, 1000, 1.0, 1000, 250, False)])
def test_mesh_route_matches_twin(card, D, C, p, B, SB, skew):
    """K13 (a2a) against its twin in both layouts, spills and overflows
    included; the send layout of one source at a time is that source's
    slice of the all-source send layout."""
    from jaxmc_torch.kernels import ops
    keys, cand, valid = _mesh_candidates(D, C, p, D * 7 + C)
    for send in (False, True):
        before = ops.LAUNCHES["mesh_route"]
        got = ops.mesh_route(keys, cand, valid, D, B, SB, skew, send=send)
        want = ops.mesh_route_twin(keys, cand, valid, D, B, SB, skew,
                                   send=send)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["mesh_route"] == before + 4
        for a, b in zip(got, want):
            _eq(a, b)
    one = ops.mesh_route(keys[-1:], cand[-1:], valid[-1:], D, B, SB, skew,
                         src_lo=D - 1, send=True)
    for a, b in zip(one, got):
        _eq(a[0], b[-1])


@pytest.mark.parametrize("D,N,skew", [(2, 384, False), (4, 400000, False),
                                      (4, 5000, True)])
def test_mesh_route_gather_matches_twin(card, D, N, skew):
    from jaxmc_torch.kernels import ops
    keys, _c, _v = _mesh_candidates(1, N, 0.4, N)
    keys = keys[0]
    for lo, n in ((0, D), (D - 1, 1)):
        got = ops.mesh_route_gather(keys, D, lo, n, skew)
        want = ops.mesh_route_gather_twin(keys, D, lo, n, skew)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            _eq(a, b)


@pytest.mark.parametrize("D,seed", [(1, 0), (4, 1), (8, 2), (64, 3)])
def test_mesh_scalars_matches_twin(card, D, seed):
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 3000, (D, len(ops.MESH_PARTIALS))).astype(np.int32)
    part[:, ops.MESH_PARTIALS.index("inv_which")] = np.where(
        rng.random(D) < 0.5, SENT, rng.integers(0, 4, D))
    part[0, 0] = 2**31 - 1  # the int32 wrap of a sum
    t = torch.as_tensor(part, device="cuda")
    for t_ovf in (0, 1):
        _eq(ops.mesh_scalars(t, 1024, 2048, t_ovf),
            ops.mesh_scalars_twin(t, 1024, 2048, t_ovf))


@pytest.mark.parametrize("spec,cfg,D,kw", [
    ("pcal_intro_buggy.tla", None, 2, {}),
    ("transfer_scaled.tla", None, 4, {"exchange": "gather"}),
    ("portoy.tla", "portoy_bad.cfg", 4, {"por": True})])
def test_mesh_on_the_card_equals_the_cpu(card, spec, cfg, D, kw):
    """The mesh engine on the card against the same run on the CPU:
    verdict, counts, trace; K13 and K14 launched."""
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    res = {}
    for dev in ("cuda", "cpu"):
        m = load_model(os.path.join(SPECS, spec),
                       cfg and os.path.join(SPECS, cfg))
        ops.reset_launches()
        r = MeshExplorer(m, shards=D, device=dev, **kw).run()
        v = r.violation
        res[dev] = (r.ok, r.generated, r.distinct, r.diameter,
                    v and format_trace(v))
        if dev == "cuda":
            route = "mesh_route_gather" if kw.get("exchange") == "gather" \
                else "mesh_route"
            assert ops.LAUNCHES[route] > 0 and ops.LAUNCHES["mesh_scalars"] > 0
    assert res["cuda"] == res["cpu"]


# ---------------------------------------------------------------------------
# K15-K17: the generated transition kernels
# ---------------------------------------------------------------------------

def _gen_engine(spec, cfg, **kw):
    """A card engine (which builds its generated units) and rows of its
    layout: the init states and a few levels of their successors."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    m = load_model(os.path.join(SPECS, spec),
                   os.path.join(SPECS, cfg) if cfg else None)
    eng = TorchExplorer(m, device="cuda", **kw)
    assert eng._gen is not None and eng._gen.lib is not None
    rows = torch.as_tensor(np.stack([eng.layout.encode(s)
                                     for s in eng.init_states]),
                           device="cuda")
    units = eng._gen_units(rows.device)
    for _ in range(4):
        en, _aok, _ov, succ = ops.gen_expand_twin(eng._gen, rows, units)
        if not bool(en.any()):
            break
        rows = torch.cat([rows, torch.unique(succ[en], dim=0)])[:20000]
    return eng, rows.contiguous(), units


@pytest.mark.parametrize("spec,cfg", [
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("msgstoy.tla", "msgstoy.cfg"),                  # slotted instances
    ("pcal_intro_buggy.tla", None),
    # W 26: tiles of 64 rows
    ("msgstoy.tla", os.path.join(ROOT, "jaxmc_torch", "fixtures",
                                 "msgstoy_scaled.cfg")),
])
def test_gen_expand_matches_twin(card, spec, cfg):
    """K15 against the emitter's loop, bit-exact, and its counter
    moves once per launch."""
    from jaxmc_torch.kernels import ops
    eng, rows, units = _gen_engine(spec, cfg)
    ops.reset_launches()
    k = ops.gen_expand(eng._gen, rows, units)
    assert ops.LAUNCHES["gen_expand"] == 1
    t = ops.gen_expand_twin(eng._gen, rows, units)
    torch.cuda.synchronize()
    for a, b in zip(k, t):
        _eq(a, b)
    assert ops.LAUNCHES["gen_expand"] == 1
    # an instance subset (a demotion's) and an empty block
    sub = units[::2].contiguous()
    for a, b in zip(ops.gen_expand(eng._gen, rows, sub),
                    ops.gen_expand_twin(eng._gen, rows, sub)):
        _eq(a, b)
    assert all(x.shape[1] == 0 for x in
               ops.gen_expand(eng._gen, rows[:0].contiguous(), units))


@pytest.mark.parametrize("spec,cfg", [
    ("pcal_intro_buggy.tla", None),                  # W 13, odd
    ("msgstoy.tla", "msgstoy.cfg"),
])
def test_gen_expand_tile_edges(card, spec, cfg, monkeypatch):
    """K15 with tiles of 8 rows (cgen.TILE_SMEM cut to fit 8) over rows
    at every word alignment, N not a multiple of the tile, one instance,
    each grouping of instances from one a block to all of them; and rows
    too wide to stage (the direct kernel).  Twice a call, bit for bit."""
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.kernels import ops
    eng0, rows0, units = _gen_engine(spec, cfg)
    for smem, smax, T in ((cgen.tile_bytes(eng0.W, 8), cgen.SMEM_MAX, 8),
                          (0, 0, 0)):
        monkeypatch.setattr(cgen, "TILE_SMEM", smem)
        monkeypatch.setattr(cgen, "SMEM_MAX", smax)
        eng, _rows, _units = _gen_engine(spec, cfg)
        gm = eng._gen
        assert gm.meta["tile"] == T
        n = 3 * 8 + 5
        assert rows0.shape[0] > n
        for off in range(4):
            # n rows from word `off` of the block: off words from 16 bytes
            rows = rows0.reshape(-1)[off:off + n * eng.W].view(n, eng.W)
            for blocks in (1, ops.GEN_BLOCKS, 1 << 30):
                monkeypatch.setattr(ops, "GEN_BLOCKS", blocks)
                want = ops.gen_expand_twin(gm, rows, units)
                for _ in range(2):
                    for a, b in zip(ops.gen_expand(gm, rows, units), want):
                        _eq(a, b)
                one = units[1:2].contiguous()
                for a, b in zip(ops.gen_expand(gm, rows, one),
                                ops.gen_expand_twin(gm, rows, one)):
                    _eq(a, b)


def test_gen_expand_in_a_batch_cohort(card):
    """Every K15 call of a msgstoy cohort (member tables whose members
    share tiles) against the emitter, bit for bit; the members' counts
    equal their solo runs'."""
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import SessionConfig, load_model
    fx = os.path.join(ROOT, "jaxmc_torch", "fixtures")
    cfgs = [os.path.join(fx, f"msgstoy_batch_cap{c}.cfg") for c in (1, 2)]
    spec = os.path.join(SPECS, "msgstoy.tla")
    gen = ops.gen_expand
    calls = []

    def checked(gm, rows, units, cvals=None):
        out = gen(gm, rows, units, cvals)
        for a, b in zip(out, ops.gen_expand_twin(gm, rows, units, cvals)):
            _eq(a, b)
        calls.append(None if cvals is None else cvals.shape[0])
        return out
    ops.gen_expand = checked
    try:
        members = BatchCheckEngine(
            [SessionConfig(spec=spec, cfg=c, host_seen=True, chunk=4096,
                           device="cuda") for c in cfgs]).build().run()
    finally:
        ops.gen_expand = gen
    assert calls and any(m and m > 1 for m in calls), calls
    for c, m in zip(cfgs, members):
        r = TorchExplorer(load_model(spec, c), device="cuda",
                          host_seen=True, chunk=4096).run()
        assert (m.result.distinct, m.result.generated) == \
            (r.distinct, r.generated)


def test_gen_pred_and_value_match_twins(card):
    """K16 (every invariant) and K17 (the VIEW) of viewtoy_scaled against
    the emitter, bit-exact, with their counters."""
    from jaxmc_torch.kernels import ops
    eng, rows, _units = _gen_engine("viewtoy_scaled.tla",
                                    "viewtoy_scaled.cfg")
    gm = eng._gen
    ops.reset_launches()
    for w in range(len(gm.preds)):
        _eq(ops.gen_pred(gm, w, rows), ops.gen_pred_twin(gm, w, rows))
    _eq(ops.gen_value(gm, rows), ops.gen_value_twin(gm, rows))
    assert ops.LAUNCHES["gen_pred"] == len(gm.preds) > 0
    assert ops.LAUNCHES["gen_value"] == 1


def test_gen_lifted_constants_match_twin(card):
    """K15 and K16 of a lifted-constant (batch) engine read each row's
    constants: equal to the emitter with the same lanes bound."""
    from jaxmc_torch.analyze.bounds import liftable_constants
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    ms = [load_model(os.path.join(SPECS, "batchtoy.tla"),
                     os.path.join(SPECS, f"batchtoy_{c}.cfg"))
          for c in "abcd"]
    lift = liftable_constants(ms[0])
    eng, rows, units = _gen_engine("batchtoy.tla", "batchtoy_a.cfg",
                                   host_seen=True, lift_consts=lift)
    cv = np.asarray([[int(m.defs[n]) for n in lift] for m in ms], np.int32)
    rng = np.random.default_rng(0)
    per_row = torch.as_tensor(cv[rng.integers(0, 4, rows.shape[0])],
                              device="cuda").contiguous()
    gm = eng._gen
    for a, b in zip(ops.gen_expand(gm, rows, units, per_row),
                    ops.gen_expand_twin(gm, rows, units, per_row)):
        _eq(a, b)
    for w in range(len(gm.preds)):
        _eq(ops.gen_pred(gm, w, rows, per_row),
            ops.gen_pred_twin(gm, w, rows, per_row))
    # a member table: one member per N/4 rows, as the batched step binds
    table = torch.as_tensor(cv, device="cuda").contiguous()
    r4 = rows[:rows.shape[0] // 4 * 4].contiguous()
    for a, b in zip(ops.gen_expand(gm, r4, units, table),
                    ops.gen_expand_twin(gm, r4, units, table)):
        _eq(a, b)


def test_generated_kernels_drive_every_engine(card):
    """The level, host-seen and resident engines on the card launch K15
    and equal their twin runs."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    for kw in ({}, dict(host_seen=True, chunk=4096),
               dict(resident=True, chunk=4096)):
        res = {}
        for twins in (False, True):
            m = load_model(os.path.join(SPECS, "msgstoy.tla"),
                           os.path.join(SPECS, "msgstoy.cfg"))
            ops.reset_launches()
            r = TorchExplorer(m, twins=twins, **kw).run()
            res[twins] = (r.ok, r.distinct, r.generated, r.diameter)
            assert (ops.LAUNCHES["gen_expand"] > 0) != twins, kw
        assert res[False] == res[True], kw


# ---------------------------------------------------------------------------
# K18: sort_keys and its front_order site
# ---------------------------------------------------------------------------

def _sort_twice(keys):
    """K18 twice in a row on the same zero words, each call bit for bit
    against the twin; 4K + 2 launches a call."""
    from jaxmc_torch.kernels import ops
    want = ops.sort_keys_twin(keys)
    before = ops.LAUNCHES["sort_keys"]
    for _ in range(2):
        got = ops.sort_keys(keys)
        torch.cuda.synchronize()
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    N, K = keys.shape
    assert ops.LAUNCHES["sort_keys"] == before + (2 * (4 * K + 2) if N
                                                  else 0)


@pytest.mark.parametrize("K", [1, 3, 5, 8])
@pytest.mark.parametrize("pattern", SORT_PATTERNS)
@pytest.mark.parametrize("N", [0, 1, 2, 4097, 300000])
def test_sort_keys_matches_twin(card, N, pattern, K):
    """K18 on every pattern of sort_cases: uniform words, equal rows,
    INT_MIN / -1 / 0 / INT_MAX, a validity word with a SENTINEL tail,
    stale rows, the oracle's keys, long runs of ties."""
    _sort_twice(torch.as_tensor(sort_case(pattern, N, K, N + K),
                                device=card))


@pytest.mark.parametrize("pattern,N,K", [
    ("valid_tail", 27262976, 3),     # the 4-process widest level
    ("stale", 60817408, 3),          # the full-sort step there
    ("valid_tail", 655360, 5),       # transfer_scaled, fp128
    ("oracle", 8192, 4),             # the preflight probe
    ("random", 100000, 49)])         # an exact key at FP_THRESHOLD
def test_sort_keys_at_the_engines_shapes(card, pattern, N, K):
    _sort_twice(torch.as_tensor(sort_case(pattern, N, K, 3), device=card))


@pytest.mark.parametrize("A,FC,explored,new_frac", [
    (13, 2097152, 0.9, 0.063),       # the 4-process widest level
    (13, 65536, 0.8, 0.18), (1, 1, 1.0, 1.0), (3, 8, 0.5, 0.3),
    (7, 4096, 0.0, 0.5), (5, 65536, 1.0, 1.0), (33, 262144, 0.5, 0.1)])
def test_front_order_matches_twin(card, A, FC, explored, new_frac):
    """front_order over the level step's explore flags and provenance,
    twice in a row, against torch.sort of the int64 key; ceil((b + 1) /
    8) + 2 launches a call."""
    from jaxmc_torch.kernels import ops
    explore, prov = front_case(A, FC, A + FC, explored, new_frac)
    e = torch.as_tensor(explore, device=card)
    p = torch.as_tensor(prov, device=card)
    want = ops.front_order_twin(e, p, A, FC)
    before = ops.LAUNCHES["front_order"]
    for _ in range(2):
        got = ops.front_order(e, p, A, FC)
        torch.cuda.synchronize()
        _eq(got, want)
    b = (A * FC - 1).bit_length()
    assert ops.LAUNCHES["front_order"] == before + 2 * (b // 8 + 3)


def test_sort_and_rank_merge_replay_in_a_cuda_graph(card):
    """K18 keeps no state between calls: rank_merge (K18 + K3 + K4) and
    front_order captured once, after a warm call on the capture stream,
    replay to the twins' results on two input sets copied into the
    captured inputs."""
    from jaxmc_torch.kernels import ops
    sets = []
    for seed in (1, 2):
        seen, count, keys = merge_case("full", 3, 300000, seed, count=1000)
        explore, prov = front_case(13, 16384, seed)
        sets.append([torch.as_tensor(x, device=card)
                     for x in (seen, keys, explore, prov)])
    seen, keys, e, p = [x.clone() for x in sets[0]]
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        ops.rank_merge(seen, 1000, keys)
        ops.front_order(e, p, 13, 16384)
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        got = ops.rank_merge(seen, 1000, keys)
        order = ops.front_order(e, p, 13, 16384)
    for i in (1, 0, 1):
        for dst, src in zip((seen, keys, e, p), sets[i]):
            dst.copy_(src)
        g.replay()
        torch.cuda.synchronize()
        want = ops.rank_merge_twin(seen, 1000, keys)
        for name in MERGE_OUT:
            _eq(got[name], want[name])
        _eq(order, ops.front_order_twin(e, p, 13, 16384))


@pytest.mark.parametrize("streams", ["one", "two"])
def test_sort_keys_from_two_threads(card, streams):
    """K18 and front_order from two host threads at once, on one stream
    or a stream each: every call equals its twin (a call's launches stay
    together on its stream; another stream has zero words of its own)."""
    import threading
    from jaxmc_torch.kernels import ops
    keys = [torch.as_tensor(sort_case(pat, 200000, 3, t), device=card)
            for t, pat in enumerate(("valid_tail", "random"))]
    fronts = [[torch.as_tensor(x, device=card) for x in front_case(
        13, 8192 << t, t)] for t in (0, 1)]
    want = [ops.sort_keys_twin(k) for k in keys]
    wantf = [ops.front_order_twin(e, p, 13, 8192 << t)
             for t, (e, p) in enumerate(fronts)]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def run(t):
        try:
            s = torch.cuda.Stream() if streams == "two" \
                else torch.cuda.default_stream()
            with torch.cuda.stream(s):
                for _ in range(20):
                    got[t].append((ops.sort_keys(keys[t]),
                                   ops.front_order(*fronts[t], 13,
                                                   8192 << t)))
            s.synchronize()
        except Exception as e:     # raised again in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    for t in (0, 1):
        assert len(got[t]) == 20
        for (sk, si), order in got[t]:
            _eq(sk, want[t][0])
            _eq(si, want[t][1])
            _eq(order, wantf[t])


def test_sort_keys_raises_on_a_refused_launch(card, monkeypatch):
    """A call the kernel does not take raises and counts nothing: with
    the wrapper's width check lifted, keys of 57 words ask the upsweep
    for more shared memory than a block has, and its entry refuses; the
    next call equals the twin.  Shapes past the limits raise ValueError."""
    from jaxmc_torch.kernels import ops
    keys = torch.as_tensor(sort_case("random", 5000, 3, 1), device=card)
    wide = torch.zeros((100, 57), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="sort_keys"):
        ops.sort_keys(wide)
    ops.reset_launches()
    monkeypatch.setattr(ops, "SORT_MAX_K", 64)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ops.sort_keys(wide)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    monkeypatch.undo()
    _sort_twice(keys)


@pytest.mark.parametrize("engine", ["level", "fullsort", "resident", "mesh",
                                    "oracle"])
def test_no_library_sort_on_the_card(card, monkeypatch, engine):
    """Each engine on the card with torch.sort and torch.argsort made to
    raise on a CUDA tensor: its sorts are K18's (sort_keys, and the level
    step's front_order) and its counts equal the CPU run's."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model

    def guard(f):
        def g(x, *a, **kw):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                raise AssertionError(f"{f.__name__} on a CUDA tensor")
            return f(x, *a, **kw)
        return g
    if engine == "oracle":
        from jaxmc_torch.backend import oracle
        for dev in ("cuda", "cpu"):
            res = oracle.probe(oracle.probe_keys(dev))
        monkeypatch.setattr(torch, "sort", guard(torch.sort))
        monkeypatch.setattr(torch, "argsort", guard(torch.argsort))
        ops.reset_launches()
        got = int(oracle.probe(oracle.probe_keys("cuda")))
        assert got == int(res)
        assert ops.LAUNCHES["sort_keys"] == 4 * 4 + 2
        assert ops.LAUNCHES["oracle_probe"] == 1
        return
    if engine == "fullsort":
        monkeypatch.setenv("JAXMC_LEVEL_RANKMERGE", "0")
    kw = {"resident": dict(resident=True, chunk=4096),
          "mesh": dict(shards=4)}.get(engine, {})
    cls = MeshExplorer if engine == "mesh" else TorchExplorer
    res = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            monkeypatch.setattr(torch, "sort", guard(torch.sort))
            monkeypatch.setattr(torch, "argsort", guard(torch.argsort))
        ops.reset_launches()
        r = cls(load_model(os.path.join(SPECS, "transfer_scaled.tla")),
                device=dev, store_trace=False, **kw).run()
        res[dev] = (r.ok, r.distinct, r.generated, r.diameter)
    assert res["cuda"] == res["cpu"] == (True, 153701, 311153, 9)
    assert ops.LAUNCHES["sort_keys"] > 0, ops.LAUNCHES
    assert (ops.LAUNCHES["front_order"] > 0) == \
        (engine in ("level", "fullsort")), ops.LAUNCHES


def test_level_step_does_not_synchronise(card):
    """The level step's sorts read nothing back to the host: the step
    runs under torch.cuda.set_sync_debug_mode("error") but for the
    emitter's predicates (the engine reads its scalars after the step,
    one synchronisation a level)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    def quiet(f):
        def g(*a):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return f(*a)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return g

    class NoSync(TorchExplorer):
        steps = 0
        armed = False

        def level_step(self, *a):
            if not self.armed:
                return super().level_step(*a)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = super().level_step(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            NoSync.steps += 1
            return out

        def _expand(self, frontier):
            return quiet(super()._expand)(frontier)

    eng = NoSync(load_model(os.path.join(SPECS, "transfer_scaled.tla")),
                 store_trace=False)
    eng.inv_fns = [(n, quiet(f)) for n, f in eng.inv_fns]
    eng.constraint_fns = [(n, quiet(f)) for n, f in eng.constraint_fns]
    eng.run()
    eng.armed = True
    try:
        r = eng.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert r.ok and NoSync.steps == 10
