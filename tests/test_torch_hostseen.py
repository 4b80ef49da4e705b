"""The chunked host-seen engine of the torch port (TorchExplorer with
host_seen=True) against the JAX reference's (TpuExplorer with
host_seen=True on JAX's CPU): the port's copy of the native fingerprint
store against jaxmc.native_store, the chunk epilogue's twin (K7's plain
version) against the reference's step and the host's compaction, and
whole runs, hybrid ones included, with their verdicts, counts, traces,
warnings, log lines and por.* counters.  Every comparison is bit-exact
(tolerance 0)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc import native_store as jstore
from jaxmc import obs as jobs
from jaxmc.backend.bfs import TpuExplorer, _take_rows_fast
from jaxmc.compile.vspec import ModeError as JModeError
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import load_model as jload
from jaxmc_torch import native_store as tstore
from jaxmc_torch import obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.compile.kernel2 import OV_PACK
from jaxmc_torch.compile.vspec import ModeError as TModeError
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

POR_COUNTERS = ("por.ample_states", "por.full_states")
POR_GAUGES = ("por.enabled", "por.engine", "por.ample_ratio",
              "por.device_masked_arms", "por.reduced_states",
              "por.disabled_reason")

TRANSFER_SMALL = """SPECIFICATION Spec
INVARIANT AliceBounded
CONSTANTS
  Procs = {p1, p2}
  MaxMoney = 4
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
# the store copy
# ---------------------------------------------------------------------------

def _fps(rng, n, pool=None):
    x = rng.integers(-2**31, 2**31, (n, 4)).astype(np.int32)
    if pool is not None and len(pool):
        pick = rng.random(n) < 0.4
        x[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
    return x


def test_store_copy_matches_reference_store():
    """Insert masks (in-batch duplicates, earlier members), contains,
    len, and dump/load round trips: the port's store equals the
    reference's on the same batches."""
    assert tstore.is_available(), tstore.build_error()
    assert os.path.relpath(tstore._SO, ROOT).startswith(
        os.path.join("jaxmc_torch", "kernels", "_build"))
    rng = np.random.default_rng(7)
    sj, st = jstore.FingerprintStore(), tstore.FingerprintStore()
    seen = np.zeros((0, 4), np.int32)
    for n in (0, 1, 17, 1000, 5000, 333):
        b = _fps(rng, n, seen)
        if n > 3:
            b[n // 2] = b[1]                     # an in-batch duplicate
        q = _fps(rng, 300, seen)
        np.testing.assert_array_equal(st.contains(q), sj.contains(q))
        mj, mt = sj.insert(b), st.insert(b)
        np.testing.assert_array_equal(mt, mj)
        assert len(st) == len(sj)
        seen = np.concatenate([seen, b])
    dj, dt = sj.dump(), st.dump()
    np.testing.assert_array_equal(dt, dj)
    s2 = tstore.FingerprintStore()
    s2.load(dj)
    assert len(s2) == len(sj)
    q = _fps(rng, 2000, seen)
    np.testing.assert_array_equal(s2.contains(q), sj.contains(q))
    with pytest.raises(ValueError, match="sorted-unique"):
        tstore.FingerprintStore().load(dj[::-1].copy())


# ---------------------------------------------------------------------------
# K7's twin
# ---------------------------------------------------------------------------

def _epilogue_oracle(en, aok, ov, fcount, keys, cand, pack_ovf, inv, exp):
    """The reference's masks (_hstep_core) and the host's reads of them
    (_run_host_seen), in numpy."""
    A, CH = en.shape
    fvalid = np.arange(CH) < fcount
    valid = en & fvalid[None, :]
    ab = (~aok) & fvalid[None, :]
    base = int(np.where(fvalid[None, :], ov, 0).max(initial=0))
    code = base if base else (OV_PACK if pack_ovf else 0)
    dead = fvalid & ~en.any(axis=0)
    vidx = np.nonzero(valid.reshape(-1))[0]
    return dict(scalars=[len(vidx), code, int(ab.any()),
                         int(np.argmax(ab)) if ab.any() else 0,
                         int(dead.any()),
                         int(np.argmax(dead)) if dead.any() else 0],
                dead=dead, idx=vidx, fps=keys[vidx][:, 1:],
                rows=cand[vidx], inv_ok=inv[vidx], explore=exp[vidx])


@pytest.mark.parametrize("A,CH,fcount,p", [
    (13, 64, 64, 0.3), (33, 256, 200, 0.5), (7, 1024, 0, 0.5),
    (5, 128, 128, 0.0), (5, 128, 128, 1.0), (0, 64, 40, 0.5),
    (1, 64, 1, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hstep_epilogue_twin_matches_reference_reads(A, CH, fcount, p,
                                                     seed):
    rng = np.random.default_rng(seed * 100 + A)
    C = A * CH
    en = rng.random((A, CH)) < p
    aok = rng.random((A, CH)) > (0.02 if seed else 0.0)
    ov = np.where(rng.random((A, CH)) < 0.01 * seed,
                  rng.integers(1, 4, (A, CH)), 0).astype(np.int32)
    keys = rng.integers(-2**31, 2**31, (C, 5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (C, 3)).astype(np.int32)
    inv = rng.random(C) < 0.9
    exp = rng.random(C) < 0.8
    for pack_ovf in (False, True):
        want = _epilogue_oracle(en, aok, ov, fcount, keys, cand, pack_ovf,
                                inv, exp)
        t = [torch.as_tensor(x) for x in (en, aok, ov)]
        args = (*t, fcount, torch.as_tensor(keys), torch.as_tensor(cand),
                torch.tensor(pack_ovf), OV_PACK, torch.as_tensor(inv),
                torch.as_tensor(exp))
        for f in (ops.hstep_epilogue_twin, ops.hstep_epilogue):
            got = f(*args)
            assert got["scalars"].tolist() == want["scalars"]
            nv = want["scalars"][0]
            for k in ("dead", "idx", "fps", "rows", "inv_ok", "explore"):
                g = got[k] if k == "dead" else got[k][:nv]
                np.testing.assert_array_equal(g.numpy(), want[k],
                                              err_msg=k)


def _transfer_busiest_chunk(CH):
    """Run the reference's host-seen search of transfer_scaled and keep
    the chunk with the most valid candidates: its input frontier block
    and the reference step's outputs for it."""
    mj = jload(_spec("transfer_scaled.tla"), None, False)
    ej = TpuExplorer(mj, host_seen=True, chunk=CH, store_trace=False)
    best = {}
    inner_get = ej._get_hstep

    def get_hstep(fc):
        hstep = inner_get(fc)

        def wrapped(frontier_p, fcount):
            out = hstep(frontier_p, fcount)
            gen = int(out["gen"])
            if gen > best.get("gen", -1):
                best.update(gen=gen, frontier=np.array(frontier_p),
                            fcount=int(fcount),
                            out={k: np.asarray(v) for k, v in out.items()})
            return out
        wrapped.is_async = getattr(hstep, "is_async", False)
        return wrapped
    ej._get_hstep = get_hstep
    r = ej.run()
    assert (r.distinct, r.generated, r.diameter) == (153701, 311153, 9)
    return ej, best


def test_hstep_matches_reference_chunk_of_transfer_scaled():
    """One chunk of transfer_scaled's busiest level, carried from the
    reference's frontier: the port's step (K1, the emitter, K2 fp128,
    the predicates, K7's twin) gives the scalars and compacted arrays
    the reference's host reads from its step's outputs."""
    CH = 2048
    ej, best = _transfer_busiest_chunk(CH)
    et = TorchExplorer(tload(_spec("transfer_scaled.tla")), device="cpu",
                       host_seen=True, chunk=CH)
    for name in ("word", "shift", "mask", "bias", "allowed", "sent_code",
                 "full"):
        np.testing.assert_array_equal(getattr(et.plan, name),
                                      np.asarray(getattr(ej.plan, name)))
    assert (et.A, et.K, et.PW) == (ej.A, ej.K, ej.PW)
    oj = best["out"]
    got = et._hstep(torch.as_tensor(best["frontier"]), best["fcount"])
    cvalid = oj["cvalid"]
    vidx = np.nonzero(cvalid)[0]
    ab = oj["assert_bad"]
    dead = oj["dead"]
    assert got["scalars"].tolist() == [
        int(oj["gen"]), int(oj["overflow"]), int(ab.any()),
        int(np.argmax(ab)) if ab.any() else 0, int(dead.any()),
        int(np.argmax(dead)) if dead.any() else 0]
    assert len(vidx) == int(oj["gen"]) > 1000
    np.testing.assert_array_equal(got["dead"].numpy(), dead)
    np.testing.assert_array_equal(got["idx"].numpy(), vidx)
    np.testing.assert_array_equal(got["fps"].numpy(),
                                  oj["keys"][vidx][:, 1:])
    np.testing.assert_array_equal(
        got["rows"].numpy(),
        _take_rows_fast(jnp.asarray(oj["cand"]), vidx))
    np.testing.assert_array_equal(got["inv_ok"].numpy(),
                                  oj["inv_ok"][vidx])
    np.testing.assert_array_equal(got["explore"].numpy(),
                                  oj["explore"][vidx])


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

# the port's log lines of the last run_both (equal to the reference's)
LOG: list = []
# the reference's telemetry of the last run_both
REF_TEL: list = [None]


def run_both(spec, cfg=None, no_deadlock=False, ref_env=None, **kw):
    """The reference and the port, both host_seen=True, on the same
    spec: verdict, counts, diameter, warnings, the trace (rendered by
    both packages' format_trace), the log lines and the por.* counters
    must be equal.  `ref_env` holds environment variables set for the
    reference's run only."""
    tel = REF_TEL[0] = jobs.Telemetry()
    jlog, tlog = [], []
    saved = {k: os.environ.get(k) for k in (ref_env or {})}
    os.environ.update(ref_env or {})
    try:
        with jobs.use(tel):
            ej = TpuExplorer(jload(spec, cfg, no_deadlock), log=jlog.append,
                             host_seen=True, progress_every=1e9, **kw)
            rj = ej.run()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    ttel = tobs.reset()
    et = TorchExplorer(tload(spec, cfg, no_deadlock=no_deadlock),
                       device="cpu", log=tlog.append, host_seen=True,
                       progress_every=1e9, **kw)
    rt = et.run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert rt.truncated == rj.truncated
    assert rt.warnings == rj.warnings
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name) == (vj.kind, vj.name)
        assert [lbl for _, lbl in vt.trace] == [lbl for _, lbl in vj.trace]
        assert tformat(vt) == jformat(vj)
    assert tlog == jlog
    LOG[:] = tlog
    for name in POR_COUNTERS:
        assert ttel.counters.get(name) == tel.counters.get(name), name
    for name in POR_GAUGES:
        assert ttel.gauges.get(name) == tel.gauges.get(name), name
    return ej, et, rj, rt, ttel


CHUNKS = [64, 2048]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("spec,cfg,nd,want", [
    ("constoy.tla", "constoy.cfg", False, (True, 43, 21)),
    ("batchtoy.tla", "batchtoy_a.cfg", False, None),
    ("batchtoy.tla", "batchtoy_b.cfg", False, None),
    ("batchtoy.tla", "batchtoy_c.cfg", False, None),
    ("batchtoy.tla", "batchtoy_d.cfg", False, None),
    ("batchtoy.tla", "batchtoy_bad.cfg", False, (False, 6, 6)),
    ("symtoy.tla", "symtoy.cfg", True, (True, 33, 22)),
    ("viewtoy.tla", "viewtoy.cfg", False, (True, 11, 5)),
    ("viewtoy_scaled.tla", "viewtoy_scaled.cfg", False,
     (True, 239617, 18432)),
])
def test_whole_runs_match_reference(spec, cfg, nd, want, chunk):
    *_, rt, _ = run_both(_spec(spec), _spec(cfg), nd, chunk=chunk)
    if want is not None:
        assert (rt.ok, rt.generated, rt.distinct) == want


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pcal_intro_buggy_assert_trace(chunk):
    """The assert verdict stops mid-level, so its counts depend on the
    chunk: they are compared with the reference at the same chunk."""
    *_, rt, _ = run_both(_spec("pcal_intro_buggy.tla"), chunk=chunk)
    assert rt.violation.kind == "assert"
    assert len(rt.violation.trace) == 6


@pytest.mark.parametrize("chunk", CHUNKS)
def test_transfer_scaled_max_states_truncation(chunk):
    *_, rt, _ = run_both(_spec("transfer_scaled.tla"), max_states=5000,
                         chunk=chunk)
    assert rt.truncated and rt.distinct >= 5000


def test_transfer_scaled_full():
    *_, rt, _ = run_both(_spec("transfer_scaled.tla"))
    assert (rt.distinct, rt.generated, rt.diameter) == (153701, 311153, 9)


@pytest.mark.slow
def test_transfer_scaled_full_chunk_64():
    *_, rt, _ = run_both(_spec("transfer_scaled.tla"), chunk=64)
    assert (rt.distinct, rt.generated, rt.diameter) == (153701, 311153, 9)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("spec,cfg,nd,kind", [
    ("portoy.tla", "portoy.cfg", False, "deadlock"),
    ("portoy.tla", "portoy_ok.cfg", True, None),
    ("portoy.tla", "portoy_bad.cfg", False, "invariant"),
    ("msgstoy.tla", "msgstoy.cfg", True, None),
])
def test_por_runs_match_reference(spec, cfg, nd, kind, chunk):
    """--por under host_seen: the ample check probes the native store
    chunk by chunk, so the counts may depend on the chunk; the por.*
    counters equal the reference's at the same chunk."""
    *_, rt, tel = run_both(_spec(spec), _spec(cfg), nd, por=True,
                           chunk=chunk)
    assert (rt.violation.kind if rt.violation else None) == kind
    assert tel.gauges["por.enabled"] is True
    assert tel.gauges["por.engine"] == "device"


# ---------------------------------------------------------------------------
# hybrid execution
# ---------------------------------------------------------------------------

def _fb(eng):
    return [(arm.label or "Next", why) for arm, why in eng.fb_arms]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_interparm_toy_hybrid(chunk):
    ej, et, rj, rt, tel = run_both(_spec("interparm_toy.tla"),
                                   _spec("interparm_toy.cfg"), chunk=chunk)
    assert (rt.ok, rt.generated, rt.distinct) == (True, 29, 19)
    assert _fb(et) == _fb(ej) and [a for a, _ in _fb(et)] == ["Pick"]
    assert et.hybrid and et.A == ej.A >= 1
    assert tel.gauges["expand.mode"] == "hybrid"


@pytest.mark.parametrize("chunk", CHUNKS)
def test_every_arm_interpreted(chunk, tmp_path):
    spec, cfg = _fixture(tmp_path, "allinterp")
    ej, et, rj, rt, tel = run_both(spec, cfg, chunk=chunk)
    assert et.A == ej.A == 0 and _fb(et) == _fb(ej)
    assert rt.ok and rt.distinct > 3
    assert tel.gauges["expand.mode"] == "interp-arms"
    assert "hybrid: EVERY action arm fell back to the interpreter — the " \
           "device does hashing/dedup only on this model" in LOG


def test_interparm_toy_refused_in_level_mode_as_in_reference():
    """Without host_seen the hybrid spec is refused with the
    reference's text, word for word."""
    with pytest.raises(JModeError) as ej:
        TpuExplorer(jload(_spec("interparm_toy.tla"),
                          _spec("interparm_toy.cfg"), False))
    with pytest.raises(TModeError) as et:
        TorchExplorer(tload(_spec("interparm_toy.tla"),
                            _spec("interparm_toy.cfg")), device="cpu")
    assert str(et.value) == str(ej.value)


ARMGRAN = """---- MODULE armgran ----
EXTENDS Naturals
VARIABLES x, h
RECURSIVE Fib(_)
Fib(n) == IF n <= 1 THEN n ELSE Fib(n - 1) + Fib(n - 2)
Init == x = 0 /\\ h = {}
Bump == x < 6 /\\ x' = x + 1
Drop == x > 2 /\\ x' = x - 2
Weird == x = 6 /\\ x' = Fib(x) % 5
Next == /\\ Bump \\/ Drop \\/ Weird
        /\\ h' = h \\cup {x}
====
"""

# an invariant and a constraint the compiler rejects: both evaluate on
# the host over the new rows
PREDEM = """---- MODULE predem ----
EXTENDS Naturals, FiniteSets
VARIABLES x, s
Init == x = 0 /\\ s = {}
Bump == x < 5 /\\ x' = x + 1 /\\ s' = s \\cup {x}
Shrink == x > 0 /\\ x' = x - 1 /\\ s' = s \\ {x}
Next == Bump \\/ Shrink
Spec == Init /\\ [][Next]_<<x, s>>
SmallPower == Cardinality(SUBSET s) <= 16
Bounded == Cardinality(SUBSET s) < 32
TinyPower == Cardinality(SUBSET s) <= 4
====
"""


FIXTURES = os.path.join(ROOT, "jaxmc_torch", "fixtures")


def _fixture(tmp_path, name):
    """A fixture of jaxmc_torch/fixtures/ (also run by chip_smoke.py),
    written as text into tmp_path: deepvar (the reference's adaptive
    relayout test, a record first reached at depth 10) and guarddem
    (interparm_toy with Pick's uncompilable conjunct behind a guard:
    the arm compiles by demoting that conjunct and its abort fires at
    x = 2; the engine first tries its three adaptive relayouts, as a
    fired expression recovery counts as an observation gap, then the
    last engine demotes the arm to the interpreter and restarts) and
    allinterp (every arm outside the compiler: the chunk step has no
    instances and the device only keys the interpreter's rows)."""
    texts = []
    for ext in ("tla", "cfg"):
        with open(os.path.join(FIXTURES, f"{name}.{ext}")) as fh:
            texts.append(fh.read())
    return _write(tmp_path, name, *texts)


def _write(tmp_path, name, tla, cfg):
    (tmp_path / f"{name}.tla").write_text(tla)
    (tmp_path / f"{name}.cfg").write_text(cfg)
    return str(tmp_path / f"{name}.tla"), str(tmp_path / f"{name}.cfg")


def test_armgran_demotes_one_arm_and_keeps_siblings(tmp_path):
    spec, cfg = _write(tmp_path, "armgran", ARMGRAN,
                       "INIT Init\nNEXT Next\nCHECK_DEADLOCK FALSE\n")
    ej, et, rj, rt, _ = run_both(spec, cfg)
    assert rt.ok and (rt.generated, rt.distinct) == (40, 25)
    assert _fb(et) == _fb(ej)
    assert [a for a, _ in _fb(et)] == ["Weird"]
    assert "RecursionError" in _fb(et)[0][1] or "recurs" in _fb(et)[0][1]
    assert et.A == ej.A >= 2 and len(et.arms) == 3


def test_deepvar_adaptive_relayout(tmp_path):
    spec, cfg = _fixture(tmp_path, "deepvar")
    ej, et, rj, rt, ttel = run_both(spec, cfg, sample_cfg=(3, 2, 3))
    assert rt.ok and (rt.generated, rt.distinct) == (12, 11)
    assert ttel.counters.get("expand.relayouts") == 1
    assert not et.fb_arms
    assert sum("hybrid: adaptive relayout" in ln for ln in LOG) == 1


def test_guard_demotion_restart(tmp_path):
    spec, cfg = _fixture(tmp_path, "guarddem")
    tlog = []
    et0 = TorchExplorer(tload(spec, cfg), device="cpu", host_seen=True,
                        log=tlog.append)
    assert not et0.fb_arms and et0._demotable == [1]
    assert et0.compiled[1].demoted_guards == [
        "SUBSET of symbolic set", "expression recovery engaged"]
    ej, et, rj, rt, ttel = run_both(spec, cfg)
    assert rt.ok and (rt.generated, rt.distinct) == (17, 11)
    assert ttel.counters.get("expand.relayouts") == 3
    assert ttel.counters.get("expand.recovery_demotions") == 1
    assert LOG.count("hybrid: demotion abort — falling ['Pick'] back to "
                     "the interpreter and restarting") == 1
    assert sum("hybrid: adaptive relayout" in ln for ln in LOG) == 3


@pytest.mark.parametrize("inv,want", [("SmallPower", None),
                                      ("TinyPower", "invariant")])
def test_demoted_invariant_and_constraint(tmp_path, inv, want):
    spec, cfg = _write(tmp_path, "predem", PREDEM,
                       f"SPECIFICATION Spec\nINVARIANT {inv}\n"
                       f"CONSTRAINT Bounded\nCHECK_DEADLOCK FALSE\n")
    ej, et, rj, rt, _ = run_both(spec, cfg)
    assert [n for n, _, _ in et.fb_invs] == [inv]
    assert [n for n, _, _ in et.fb_cons] == ["Bounded"]
    assert [r for _, _, r in et.fb_invs] == [r for _, _, r in ej.fb_invs]
    assert (rt.violation.kind if rt.violation else None) == want


# ---------------------------------------------------------------------------
# the split path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["transfer_small", "msgstoy_por"])
def test_split_path_matches_reference(case, tmp_path):
    """The reference's grouped split step (JAXMC_FUSED_MAX_INSTANCES=4,
    set for the reference only: predicates deferred to new rows,
    provenance order restored by scatter) against the port's single
    fused step: the same counts, traces, log lines and counters."""
    if case == "transfer_small":
        (tmp_path / "t.cfg").write_text(TRANSFER_SMALL)
        args = (_spec("transfer_scaled.tla"), str(tmp_path / "t.cfg"))
        kw = dict(chunk=64)
    else:
        args = (_spec("msgstoy.tla"), _spec("msgstoy.cfg"), True)
        kw = dict(por=True)
    ej, et, rj, rt, ttel = run_both(
        *args, ref_env={"JAXMC_FUSED_MAX_INSTANCES": "4"}, **kw)
    assert et.A == ej.A > 4
    assert REF_TEL[0].gauges["expand.fused_groups"] > 1
    assert "expand.fused_groups" not in ttel.gauges


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli_lines(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    # the throughput line carries the wall and the backend's name
    lines = [ln for ln in out.out.splitlines() if "states/sec" not in ln]
    return rc, lines, out.err


def test_cli_host_seen_prints_the_reference_lines(capsys):
    from jaxmc.cli import main as jmain
    from jaxmc_torch.cli import main as tmain
    spec = _spec("interparm_toy.tla")
    rj, lj, _ = _cli_lines(jmain, ["check", spec, "--backend", "jax",
                                   "--platform", "cpu", "--host-seen",
                                   "--chunk", "64"], capsys)
    rt, lt, _ = _cli_lines(tmain, ["check", spec, "--device", "cpu",
                                   "--host-seen", "--chunk", "64"], capsys)
    assert rt == rj == 0
    assert lt == lj
    assert "19 distinct states found" in "\n".join(lt)


@pytest.mark.parametrize("extra,item", [
    (["--resident"], "mutually exclusive"),
    (["--seen", "exact"], "incompatible with the resident/host_seen"),
])
def test_cli_combined_refusals_keep_reference_texts(extra, item, capsys):
    from jaxmc.cli import main as jmain
    from jaxmc_torch.cli import main as tmain
    spec = _spec("constoy.tla")
    rj, _, ej = _cli_lines(jmain, ["check", spec, "--backend", "jax",
                                   "--platform", "cpu", "--host-seen"]
                           + extra, capsys)
    rt, _, et = _cli_lines(tmain, ["check", spec, "--device", "cpu",
                                   "--host-seen"] + extra, capsys)
    assert rt == rj == 2
    assert item in et and et.strip() == ej.strip()


def test_cli_seen_cap_is_ignored_under_host_seen(capsys):
    from jaxmc_torch.cli import main as tmain
    rc, lines, _ = _cli_lines(tmain, ["check", _spec("constoy.tla"),
                                      "--device", "cpu", "--host-seen",
                                      "--seen-cap", "64"], capsys)
    assert rc == 0
    assert "-- host_seen: --seen-cap/JAXMC_SEEN_CAP is ignored here " \
           "(the native fingerprint store is host-resident; tier spill " \
           "applies to the device-table modes)" in lines
    assert "43 states generated, 21 distinct states found, 0 states " \
           "left on queue." in lines


# ---------------------------------------------------------------------------
# build-time refusals and demotions
# ---------------------------------------------------------------------------

def test_host_seen_without_the_store_refuses_with_the_reference_text(
        monkeypatch):
    """No fallback: when the store cannot be built, host_seen=True
    raises the reference's CompileError text."""
    from jaxmc_torch.compile.vspec import CompileError
    monkeypatch.setattr(tstore, "is_available", lambda: False)
    monkeypatch.setattr(tstore, "build_error", lambda: "g++ not found")
    with pytest.raises(CompileError) as e:
        TorchExplorer(tload(_spec("constoy.tla")), device="cpu",
                      host_seen=True)
    assert str(e.value) == "host_seen requires the native store: " \
                           "g++ not found"


def test_pred_trace_budget_demotes_predicates(monkeypatch):
    """JAXMC_PRED_TRACE_BUDGET=0 demotes every predicate to the host
    interpreter under host_seen (both packages), and none in the level
    mode, which would rather keep a slow compiled predicate."""
    monkeypatch.setenv("JAXMC_PRED_TRACE_BUDGET", "0")
    ej, et, rj, rt, _ = run_both(_spec("batchtoy.tla"),
                                 _spec("batchtoy_bad.cfg"))
    assert [n for n, _, _ in et.fb_invs] == [n for n, _, _ in ej.fb_invs]
    assert et.fb_invs and not et.inv_fns
    assert "JAXMC_PRED_TRACE_BUDGET" in et.fb_invs[0][2]
    assert rt.violation.kind == "invariant"
    level = TorchExplorer(tload(_spec("batchtoy.tla"),
                                _spec("batchtoy_bad.cfg")), device="cpu")
    assert not level.fb_invs and level.inv_fns
