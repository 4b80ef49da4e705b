"""The resident engine of the torch port (TorchExplorer with
resident=True) against the JAX reference's (TpuExplorer with
resident=True and cap_profile=False on JAX's CPU): the twins of the
chunk compaction (K8) and the chunk fold (K9) against the reference's
lax.sort compaction and carry update, one real transfer_scaled chunk,
and whole runs with their verdicts, counts, diameters, truncation,
decoded violation states, warnings, `-- resident:` log lines and por.*
counters.  Every comparison is bit-exact (tolerance 0)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from jaxmc import obs as jobs
from jaxmc.backend.bfs import TpuExplorer
from jaxmc.compile.vspec import ModeError as JModeError
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import load_model as jload
from jaxmc_torch import obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.compile.kernel2 import OV_PACK
from jaxmc_torch.compile.vspec import ModeError as TModeError
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SENT = 2**31 - 1

POR_COUNTERS = ("por.ample_states", "por.full_states")
POR_GAUGES = ("por.enabled", "por.engine", "por.ample_ratio",
              "por.device_masked_arms", "por.reduced_states",
              "por.disabled_reason")

# transfer_scaled cut to two processes (1,164 distinct states)
TRANSFER_SMALL = """SPECIFICATION Spec
INVARIANT AliceBounded
CONSTANTS
  Procs = {p1, p2}
  MaxMoney = 8
"""

CNT_TLA = """---- MODULE cnt ----
EXTENDS Naturals
VARIABLE x
Init == x = 0
Next == x < 2 /\\ x' = x + 1
Spec == Init /\\ [][Next]_x
====
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs on one intra-op thread: several test workers
    share the machine, and oversubscribed OpenMP pools stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name):
    return os.path.join(SPECS, name)


# ---------------------------------------------------------------------------
# K8 and K9 twins against the reference's formulas
# ---------------------------------------------------------------------------

def _ref_compact(mask, cap):
    """bfs.py:2348-2351: the stable sort of (1 - valid, arange)."""
    m = jnp.asarray(mask)
    comp = lax.sort(((1 - m.astype(jnp.int32)),
                     jnp.arange(m.shape[0], dtype=jnp.int32)),
                    num_keys=1, is_stable=True)
    return np.asarray(comp[1][:cap])


def _ref_partials(en, aok, ov, flim):
    """bfs.py:2320-2344: gen, the overflow code, assert and dead, as the
    reference's chunk body computes them."""
    A, CH = en.shape
    fvalid = jnp.arange(CH) < flim
    valid = jnp.asarray(en) & fvalid[None, :]
    ov_codes = jnp.where(fvalid[None, :], jnp.asarray(ov), 0)
    abad = (~jnp.asarray(aok)) & fvalid[None, :]
    dead = fvalid & ~jnp.any(jnp.asarray(en), axis=0)
    return [int(jnp.sum(valid, dtype=jnp.int32)),
            int(jnp.max(ov_codes)), int(jnp.any(abad)),
            int(jnp.argmax(abad.reshape(-1))) if bool(jnp.any(abad))
            else 0,
            int(jnp.any(dead)),
            int(jnp.argmax(dead)) if bool(jnp.any(dead)) else 0]


def _grid(rng, A, CH, p, seed):
    en = rng.random((A, CH)) < p
    aok = rng.random((A, CH)) > (0.01 if seed % 2 else 0.0)
    ov = np.where(rng.random((A, CH)) < 0.005 * (seed % 3),
                  rng.integers(1, 4, (A, CH)), 0).astype(np.int32)
    return en, aok, ov


@pytest.mark.parametrize("A,CH,flim,p,cap", [
    (13, 64, 64, 0.3, 64), (33, 256, 200, 0.5, 1024), (7, 1024, 0, 0.5, 64),
    (5, 128, 128, 0.0, 640), (5, 128, 128, 1.0, 64), (1, 64, 1, 1.0, 64),
    (13, 2048, 1500, 0.2, 8192)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_compact_twin_matches_reference(A, CH, flim, p, cap, seed):
    """K8's twin, and its wrapper on the CPU, at the chunk site: the first
    cap indices of the reference's stable sort and its partials."""
    rng = np.random.default_rng(seed * 100 + A)
    en, aok, ov = _grid(rng, A, CH, p, seed)
    valid = (en & (np.arange(CH) < flim)[None, :]).reshape(-1)
    want_idx = _ref_compact(valid, cap)
    want = _ref_partials(en, aok, ov, flim)
    t = [torch.as_tensor(x) for x in (en, aok, ov)]
    for f in (ops.resident_compact_twin, ops.resident_compact):
        idx, sc = f(t[0], cap, flim, t[1], t[2])
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert sc.tolist() == want


@pytest.mark.parametrize("C,cap,p", [(128, 64, 0.3), (4096, 1024, 0.9),
                                     (1 << 15, 2048, 0.05), (64, 64, 0.0)])
def test_resident_compact_explore_site_matches_reference(C, cap, p):
    """K8's twin at the explore site: a [C] mask capped at FCap."""
    rng = np.random.default_rng(C)
    m = rng.random(C) < p
    for f in (ops.resident_compact_twin, ops.resident_compact):
        idx, sc = f(torch.as_tensor(m), cap)
        np.testing.assert_array_equal(idx.numpy(), _ref_compact(m, cap))
        assert sc.tolist() == [int(m.sum()), 0, 0, 0, 0, 0]


def _ref_fold(carry, bad_row, part, pack_ovf, por, keys_c, rows_c, acc_keys,
              acc_rows, frontier, base, CH, check_deadlock):
    """bfs.py:2323-2427 on the chunk's partials, in jnp: the carry after
    one chunk, as the reference's chunk body leaves it (the body runs
    only while stat is ST_CONTINUE)."""
    (stat, acc_n, gen, ovcode, pora, porx, porm) = [jnp.int32(x)
                                                   for x in carry]
    if int(stat) != ops.ST_CONTINUE:
        return (list(carry), bad_row, acc_keys, acc_rows)
    vcnt, ovmax, ab_any, ab_flat, dead_any, dead_f = part
    VC, AccCap = keys_c.shape[0], acc_keys.shape[0]
    gen = gen + vcnt
    ovf_lanes = jnp.asarray(ovmax != 0)
    ovcode = jnp.maximum(ovcode, jnp.int32(ovmax))
    ovf_lanes = ovf_lanes | pack_ovf
    ovcode = jnp.where(ovcode == 0,
                       jnp.where(pack_ovf, OV_PACK, 0).astype(jnp.int32),
                       ovcode)
    n_amp, n_exp, n_masked = por if por is not None else (0, 0, 0)
    gen = gen - n_masked
    off = jnp.clip(acc_n, 0, AccCap - VC)
    acc_keys = lax.dynamic_update_slice(jnp.asarray(acc_keys),
                                        jnp.asarray(keys_c), (off, 0))
    acc_rows = lax.dynamic_update_slice(jnp.asarray(acc_rows),
                                        jnp.asarray(rows_c), (off, 0))
    acc_n = acc_n + vcnt
    stat = jnp.where(ovf_lanes, ops.ST_OVF_LANES,
                     jnp.where(vcnt > VC, ops.ST_OVF_VC,
                               jnp.where(acc_n + VC > AccCap, ops.ST_OVF_ACC,
                                         ops.ST_CONTINUE)))
    assert_any = bool(ab_any)
    dead_any = bool(check_deadlock) and bool(dead_any)
    first_bad = (stat == ops.ST_CONTINUE) & (assert_any | dead_any)
    bad_f = (ab_flat % CH) if assert_any else dead_f
    brow = lax.dynamic_slice(jnp.asarray(frontier), (base + bad_f, 0),
                             (1, frontier.shape[1]))[0]
    bad_row = jnp.where(first_bad, brow, jnp.asarray(bad_row))
    stat = jnp.where((stat == ops.ST_CONTINUE) & assert_any, ops.ST_ASSERT,
                     jnp.where((stat == ops.ST_CONTINUE) & dead_any,
                               ops.ST_DEADLOCK, stat))
    out = [int(stat), int(acc_n), int(gen), int(ovcode), int(pora + n_amp),
           int(porx + n_exp), int(porm + n_masked)]
    return (out, np.asarray(bad_row), np.asarray(acc_keys),
            np.asarray(acc_rows))


@pytest.mark.parametrize("case", range(12))
def test_resident_fold_twin_matches_reference(case):
    """K9's twin, and its wrapper on the CPU, against the reference's
    carry update: every status (continue, the three overflows, assert,
    deadlock, a non-continue carry that must stay untouched), with and
    without POR deltas and the pack flag."""
    rng = np.random.default_rng(case)
    VC, AccCap, PW, FC, CH = 64, 256, 3, 512, 128
    stat0 = ops.ST_DEADLOCK if case == 11 else ops.ST_CONTINUE
    acc_n0 = [0, 10, 130, 190, 64, 0, 0, 0, 5, 0, 0, 7][case]
    carry0 = [stat0, acc_n0, 1000, 0, 3, 4, 5]
    vcnt = [40, 64, 60, 10, 70, 5, 5, 5, 0, 64, 12, 9][case]
    ovmax = 2 if case == 5 else 0
    pack_ovf = case in (6, 7)
    ab_any = case in (7, 8)
    dead_any = case in (8, 9, 10)
    part = [vcnt, ovmax, int(ab_any), int(rng.integers(0, 13 * CH)),
            int(dead_any), int(rng.integers(0, CH))]
    por = [int(x) for x in rng.integers(0, 9, 3)] if case % 2 else None
    if por is not None:
        por[2] = min(por[2], vcnt)
    keys_c = rng.integers(-2**31, 2**31, (VC, 5)).astype(np.int32)
    rows_c = rng.integers(-2**31, 2**31, (VC, PW)).astype(np.int32)
    acc_keys = np.full((AccCap, 5), SENT, np.int32)
    acc_rows = np.full((AccCap, PW), SENT, np.int32)
    frontier = rng.integers(0, 99, (FC, PW)).astype(np.int32)
    bad_row = np.full(PW, SENT, np.int32)
    base = 256
    check_deadlock = case != 10
    want = _ref_fold(carry0, bad_row, part, pack_ovf, por, keys_c, rows_c,
                     acc_keys, acc_rows, frontier, base, CH, check_deadlock)
    for f in (ops.resident_fold_twin, ops.resident_fold):
        carry = torch.tensor(carry0, dtype=torch.int64)
        br = torch.as_tensor(bad_row.copy())
        ak, ar = torch.as_tensor(acc_keys.copy()), torch.as_tensor(
            acc_rows.copy())
        f(carry, br, torch.tensor(part, dtype=torch.int64),
          torch.tensor(pack_ovf),
          torch.tensor(por, dtype=torch.int64) if por is not None else None,
          torch.as_tensor(keys_c), torch.as_tensor(rows_c), ak, ar,
          torch.as_tensor(frontier), base, CH, check_deadlock, OV_PACK)
        assert carry.tolist() == want[0]
        np.testing.assert_array_equal(br.numpy(), want[1])
        np.testing.assert_array_equal(ak.numpy(), want[2])
        np.testing.assert_array_equal(ar.numpy(), want[3])


def test_chunk_of_transfer_scaled_matches_reference():
    """One real chunk of transfer_scaled (its widest level, from the
    port's level engine): the port's emitter output through K8's twin
    gives the reference's compaction and partials over the reference's
    own expansion of the same rows, and the gathered rows and keys of
    the VC block equal the reference's _keys_of."""
    CH, VC = 2048, 1 << 13
    mj = jload(_spec("transfer_scaled.tla"), None, False)
    ej = TpuExplorer(mj, resident=True, cap_profile=False)
    et = TorchExplorer(tload(_spec("transfer_scaled.tla")), device="cpu",
                       resident=True)
    widest = {}

    class Keep(TorchExplorer):
        def _unpack(self, packed):
            if packed.shape[0] > widest.get("n", -1):
                widest.update(n=packed.shape[0], p=packed.clone())
            return super()._unpack(packed)
    Keep(tload(_spec("transfer_scaled.tla")), device="cpu",
         store_trace=False).run()
    block = widest["p"][:CH].contiguous()
    flim = CH
    en_j, aok_j, ov_j, succ_j = ej._expand_fn()(
        ej.plan.unpack_rows(jnp.asarray(block.numpy())))
    en, aok, ov, succ = et._expand(et._unpack(block))
    np.testing.assert_array_equal(en.numpy(), np.asarray(en_j))
    valid = np.asarray(en_j).reshape(-1)
    cidx, part = ops.resident_compact_twin(en, VC, flim, aok, ov)
    np.testing.assert_array_equal(cidx.numpy(), _ref_compact(valid, VC))
    assert part.tolist() == _ref_partials(np.asarray(en_j),
                                          np.asarray(aok_j),
                                          np.asarray(ov_j), flim)
    assert 1000 < int(part[0]) <= VC
    A, W = et.A, et.W
    vcnt = int(part[0])
    vmask = torch.arange(VC) < vcnt
    rows = succ.reshape(A * CH, W).index_select(0, cidx.to(torch.int64))
    rows = torch.where(vmask[:, None], rows, torch.full((), SENT,
                                                        dtype=torch.int32))
    keys, packed, povf = et._keys_of(rows, vmask)
    rows_j = jnp.take(jnp.asarray(succ_j).reshape(A * CH, W),
                      jnp.asarray(cidx.numpy()), axis=0)
    rows_j = jnp.where(jnp.asarray(vmask.numpy())[:, None], rows_j, SENT)
    kj, pj, oj = ej._keys_of(rows_j, jnp.asarray(vmask.numpy()))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(pj))
    assert bool(povf) == bool(oj)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def run_both(spec, cfg=None, no_deadlock=False, cfg_text=None, tmp=None,
             **kw):
    """The reference and the port, both resident=True, on the same spec:
    verdict, counts, diameter, truncation, warnings, the violation and
    its decoded state (rendered by both packages' format_trace), every
    log line (the `-- resident:` growth lines among them) and the por.*
    counters must be equal."""
    if cfg_text is not None:
        cfg = os.path.join(tmp, "case.cfg")
        with open(cfg, "w") as fh:
            fh.write(cfg_text)
    tel = jobs.Telemetry()
    jlog, tlog = [], []
    with jobs.use(tel):
        ej = TpuExplorer(jload(spec, cfg, no_deadlock), log=jlog.append,
                         resident=True, cap_profile=False,
                         progress_every=1e9, **kw)
        rj = ej.run()
    ttel = tobs.reset()
    et = TorchExplorer(tload(spec, cfg, no_deadlock=no_deadlock),
                       device="cpu", log=tlog.append, resident=True,
                       progress_every=1e9, **kw)
    rt = et.run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert (rt.truncated, rt.trunc_reason) == (rj.truncated, rj.trunc_reason)
    assert rt.warnings == rj.warnings
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name, vt.message) == (vj.kind, vj.name,
                                                  vj.message)
        assert tformat(vt) == jformat(vj)
    assert tlog == jlog
    for name in POR_COUNTERS:
        assert ttel.counters.get(name) == tel.counters.get(name), name
    for name in POR_GAUGES:
        assert ttel.gauges.get(name) == tel.gauges.get(name), name
    return rj, rt, tlog, ttel


@pytest.mark.parametrize("cfg,want", [
    ("batchtoy_a.cfg", None), ("batchtoy_b.cfg", None),
    ("batchtoy_c.cfg", None), ("batchtoy_d.cfg", None),
    ("batchtoy_bad.cfg", (False, "invariant")),
])
def test_batchtoy_matches_reference(cfg, want):
    _, rt, _, _ = run_both(_spec("batchtoy.tla"), _spec(cfg))
    if want is not None:
        assert (rt.ok, rt.violation.kind) == want
        assert len(rt.violation.trace) == 1


@pytest.mark.parametrize("chunk", [2048, 256])
def test_pcal_intro_buggy_assert(chunk):
    """The assert verdict stops mid-level, so its counts depend on the
    chunk: they are compared with the reference at the same chunk."""
    _, rt, _, _ = run_both(_spec("pcal_intro_buggy.tla"), chunk=chunk)
    assert rt.violation.kind == "assert"
    if chunk == 2048:
        assert (rt.generated, rt.distinct) == (10250, 6740)


@pytest.mark.parametrize("spec,cfg,nd", [
    ("symtoy.tla", "symtoy.cfg", True),
    ("symtoy_multiinit.tla", "symtoy_multiinit.cfg", True),
    ("symid.tla", "symid.cfg", False),
    ("viewtoy.tla", "viewtoy.cfg", False),
])
def test_reductions_match_reference(spec, cfg, nd):
    run_both(_spec(spec), _spec(cfg), nd)


@pytest.mark.parametrize("spec,cfg,nd", [
    ("portoy.tla", "portoy.cfg", False),
    ("portoy.tla", "portoy_ok.cfg", True),
    ("portoy.tla", "portoy_bad.cfg", False),
    ("msgstoy.tla", "msgstoy.cfg", True),
])
def test_por_runs_match_reference(spec, cfg, nd):
    _, rt, _, ttel = run_both(_spec(spec), _spec(cfg), nd, por=True)
    assert ttel.gauges["por.enabled"] is True


def test_reduced_transfer_scaled_grows_and_matches():
    """transfer_scaled cut at 20,000 states: from the CPU starting caps
    it grows FCap and AccCap (each growth redoes its level)."""
    _, rt, log, _ = run_both(_spec("transfer_scaled.tla"), max_states=20000)
    assert rt.truncated and rt.distinct >= 20000
    grown = {ln.split()[3] for ln in log if ln.startswith("-- resident:")}
    assert {"FCap", "AccCap"} <= grown


def test_max_states_truncation(tmp_path):
    _, rt, _, _ = run_both(_spec("transfer_scaled.tla"),
                           cfg_text=TRANSFER_SMALL, tmp=str(tmp_path),
                           max_states=100, chunk=64)
    assert rt.truncated and rt.distinct >= 100


def test_deadlock_keeps_the_depth(tmp_path):
    """The reference's deadlock-depth case (tests/test_jax_backend.py):
    a deadlocked state belongs to the current frontier."""
    (tmp_path / "cnt.tla").write_text(CNT_TLA)
    (tmp_path / "cnt.cfg").write_text("SPECIFICATION Spec\n")
    _, rt, _, _ = run_both(str(tmp_path / "cnt.tla"),
                           str(tmp_path / "cnt.cfg"))
    assert rt.violation.kind == "deadlock" and rt.diameter == 2


def test_small_caps_hit_every_grow_status(tmp_path):
    """Starting caps far below the model's need: the level is redone
    after each of the four growths, as the reference's log lines say."""
    _, rt, log, _ = run_both(
        _spec("transfer_scaled.tla"), cfg_text=TRANSFER_SMALL,
        tmp=str(tmp_path), chunk=64,
        res_caps={"SC": 256, "FCap": 64, "AccCap": 128, "VC": 64})
    assert (rt.distinct, rt.generated, rt.diameter) == (1164, 1804, 6)
    grown = {ln.split()[3] for ln in log if ln.startswith("-- resident:")}
    assert grown == {"SC", "FCap", "AccCap", "VC"}


LIVE_TLA = """---- MODULE livetoy ----
EXTENDS Naturals
VARIABLE x
Init == x = 0
Next == x' = (x + 1) % 3
Spec == Init /\\ [][Next]_x /\\ WF_x(Next)
Live == [](x < 3)
====
"""


@pytest.mark.parametrize("prop,text", [
    ("Live", "resident mode cannot check temporal properties"),
    ("Spec", "resident mode cannot check refinement PROPERTYs"),
])
def test_property_refusals_are_the_reference_texts(prop, text, tmp_path):
    (tmp_path / "livetoy.tla").write_text(LIVE_TLA)
    (tmp_path / "livetoy.cfg").write_text(
        f"SPECIFICATION Spec\nPROPERTY {prop}\n")
    spec, cfg = str(tmp_path / "livetoy.tla"), str(tmp_path / "livetoy.cfg")
    with pytest.raises(JModeError) as ej:
        TpuExplorer(jload(spec, cfg, False), resident=True,
                    cap_profile=False)
    with pytest.raises(TModeError) as et:
        TorchExplorer(tload(spec, cfg), device="cpu", resident=True)
    assert text in str(et.value)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw,text", [
    (dict(host_seen=True), "mutually exclusive"),
    (dict(seen_mode="exact"), "incompatible with the resident/host_seen"),
])
def test_mode_refusals_are_the_reference_texts(kw, text):
    spec = _spec("constoy.tla")
    with pytest.raises(JModeError) as ej:
        TpuExplorer(jload(spec, None, False), resident=True,
                    cap_profile=False, **kw)
    with pytest.raises(TModeError) as et:
        TorchExplorer(tload(spec), device="cpu", resident=True, **kw)
    assert text in str(et.value)
    assert str(et.value) == str(ej.value)


def test_resident_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TorchExplorer(tload(_spec("constoy.tla")), resident=True)


def _cli_lines(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    # the throughput line carries the wall and the backend's name; the
    # reference's CLI also saves a learned capacity profile, which the
    # port does not keep
    lines = [ln for ln in out.out.splitlines() if "states/sec" not in ln
             and not ln.startswith("-- capacity profile")]
    return rc, lines, out.err


def test_cli_resident_prints_the_reference_lines(capsys, tmp_path,
                                                 monkeypatch):
    from jaxmc.cli import main as jmain
    from jaxmc_torch.cli import main as tmain
    monkeypatch.setenv("JAXMC_PROFILE_STORE", str(tmp_path / "prof"))
    spec, cfg = _spec("batchtoy.tla"), _spec("batchtoy_bad.cfg")
    rj, lj, _ = _cli_lines(jmain, ["check", spec, "--cfg", cfg, "--backend",
                                   "jax", "--platform", "cpu", "--resident",
                                   "--chunk", "64"], capsys)
    rt, lt, _ = _cli_lines(tmain, ["check", spec, "--cfg", cfg, "--device",
                                   "cpu", "--resident", "--chunk", "64"],
                           capsys)
    assert rt == rj == 1
    assert lt == lj
    assert "Error: Invariant InBound is violated." in lt
