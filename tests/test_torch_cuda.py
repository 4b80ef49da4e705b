"""The six CUDA kernels of the torch port against their plain PyTorch
twins, on the card, at the shapes the level engine gives them, and the
level engine on the card against the corpus pins, with SYMMETRY, VIEW
and --por among them.

Needs a CUDA card and nvcc; elsewhere every test skips with the reason.
Run on the card with:  python -m pytest -m gpu tests/test_torch_cuda.py
All comparisons are bit-exact: every kernel computes in int32/uint32."""

import os
import shutil

import numpy as np
import pytest
import torch

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
