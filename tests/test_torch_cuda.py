"""The CUDA kernels of the torch port (K1-K11) against their plain
PyTorch twins, on the card, at the shapes the engines give them, the
level engine on the card against the corpus pins, with SYMMETRY, VIEW
and --por among them, the host-seen engine on the card against the
same run on the CPU, PROPERTYs on both engines, a batch cohort, the
full-sort step and checkpoint/resume on the card against the CPU.

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


@pytest.mark.parametrize("A,CH,cap", [(1, 64, 64), (13, 4096, 1 << 14),
                                      (33, 65536, 1 << 18),
                                      (7, 1 << 18, 1 << 14)])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_resident_compact_matches_twin(card, A, CH, cap, p):
    """K8 at the chunk site (a partial last chunk, assert and overflow
    codes, dead slots) and at the explore site ([C] mask capped at
    FCap): every index of the stable partition and every scalar."""
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(A * 11 + CH)
    cap = min(cap, A * CH)
    for flim in (CH, CH - CH // 3, 0):
        en = torch.as_tensor(rng.random((A, CH)) < p, device=card)
        aok = torch.as_tensor(rng.random((A, CH)) > 1e-4, device=card)
        ov = torch.as_tensor(np.where(rng.random((A, CH)) < 1e-5,
                                      rng.integers(1, 3, (A, CH)), 0)
                             .astype(np.int32), device=card)
        k = ops.resident_compact(en, cap, flim, aok, ov)
        t = ops.resident_compact_twin(en, cap, flim, aok, ov)
        torch.cuda.synchronize()
        _eq(k[0], t[0])
        _eq(k[1], t[1])
    m = en.reshape(-1).contiguous()
    k = ops.resident_compact(m, cap, site="explore")
    t = ops.resident_compact_twin(m, cap)
    torch.cuda.synchronize()
    _eq(k[0], t[0])
    _eq(k[1], t[1])


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

@pytest.mark.parametrize("SC,C,K", [(64, 32, 3), (1 << 16, 40000, 3),
                                    (1 << 18, 1 << 18, 5), (256, 0, 2)])
@pytest.mark.parametrize("dup", [0.0, 0.5, 0.95])
def test_fullsort_dedup_matches_twin(card, SC, C, K, dup):
    """K11 against its twin over the sorted [SC + C, K] keys of a seen
    table (a live prefix, then invalid rows) and candidates with
    duplicates and invalid rows: new_cidx over new_count and seen2 over
    seen_count2 bit for bit, the counts equal."""
    from jaxmc_torch.kernels import ops
    rng = np.random.default_rng(SC + C + K)
    n_seen = SC // 3
    seen = np.full((SC, K), SENT, np.int32)
    sv = np.unique(rng.integers(-50, 50, (n_seen, K - 1)).astype(np.int32),
                   axis=0)
    seen[:len(sv), 0] = 0
    seen[:len(sv), 1:] = sv
    cand = np.zeros((C, K), np.int32)
    cand[:, 1:] = rng.integers(-50, 50, (C, K - 1))
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
    ops.reset_launches()
    nk, sk, ck = ops.fullsort_dedup(skeys, sflag, perm, SC, C)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fullsort_dedup"] == 3
    nt, st, ct = ops.fullsort_dedup_twin(skeys, sflag, perm, SC, C)
    _eq(ck, ct)
    n_new, n_keep = int(ct[0]), int(ct[1])
    _eq(nk[:n_new], nt[:n_new])
    _eq(sk[:n_keep], st[:n_keep])


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
