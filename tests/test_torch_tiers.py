"""The out-of-core seen tiers of the torch port against the JAX
reference: the port's copy of TieredSeen against jaxmc's on the same
spills and probes, and `--seen-cap` runs of the level and resident
engines (TorchExplorer against TpuExplorer on JAX's CPU) on the
ooc_scaled rung: counts, verdicts, traces, tier statistics and every
log line, the spill lines among them.  Every comparison is bit-exact
(tolerance 0)."""

import os

import numpy as np
import pytest
import torch

from jaxmc import faults as jfaults
from jaxmc import obs as jobs
from jaxmc.backend.bfs import TpuExplorer
from jaxmc.backend.tiers import TieredSeen as JTiered
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import load_model as jload
from jaxmc_torch import faults as tfaults
from jaxmc_torch import obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.backend.tiers import TieredSeen as TTiered
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

#: the ooc_scaled rung's pins (generated, distinct; jaxmc/corpus.py)
OOC_WANT = (12289, 3072)
#: about 17% of the rung's states on the device, and a host budget
#: small enough that the disk tier is used
OOC_CAP = 512
OOC_HOST_KEYS = 1024
# the pieces of a tier stats record that are not wall times
STATS = ("host_keys", "disk_keys", "host_runs", "disk_runs", "spills",
         "compactions", "io_degraded")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """One intra-op torch thread, and no ambient tier or fault knobs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("JAXMC_SEEN_CAP", "JAXMC_TIER_HOST_KEYS", "JAXMC_SPILL_DIR",
              "JAXMC_FAULTS", "JAXMC_FAULTS_STATE"):
        monkeypatch.delenv(k, raising=False)
    jfaults._CACHE = tfaults._CACHE = None
    yield
    _fresh_fault_budget()
    torch.set_num_threads(n)


def _spec(name):
    return os.path.join(SPECS, name)


def _fresh_fault_budget():
    """A fault's `n=` budget is shared across processes through a state
    directory: give the port's run the budget the reference's spent."""
    os.environ.pop("JAXMC_FAULTS_STATE", None)
    jfaults._CACHE = tfaults._CACHE = None


def _stats(st):
    return {k: st.get(k) for k in STATS}


# ---------------------------------------------------------------------------
# the TieredSeen copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd,host_budget", [(4, 1 << 22), (3, 600),
                                            (1, 250)])
def test_tiered_seen_copy_matches_reference(kd, host_budget, tmp_path):
    """Sorted runs spilled one by one (host compaction past four runs,
    disk flushes past the host budget, disk compaction past six runs),
    probes of members and non-members after each spill, and the
    statistics and log lines: the copy equals the reference."""
    rng = np.random.default_rng(kd)
    jl, tl = [], []
    j = JTiered(kd, host_budget_keys=host_budget,
                spill_dir=str(tmp_path / "j"), log=jl.append)
    t = TTiered(kd, host_budget_keys=host_budget,
                spill_dir=str(tmp_path / "t"), log=tl.append)
    seen = np.zeros((0, kd), np.int32)
    for step in range(14):
        run = np.unique(rng.integers(-2**31, 2**31, (int(rng.integers(
            1, 200)), kd), dtype=np.int64).astype(np.int32), axis=0)
        # sorted signed-lexicographically, the device's key order
        run = run[np.lexsort(tuple(run[:, i] for i in reversed(range(kd))))]
        j.spill(run)
        t.spill(run)
        seen = np.concatenate([seen, run])
        q = np.concatenate([
            seen[rng.integers(0, len(seen), 100)],
            rng.integers(-2**31, 2**31, (100, kd), dtype=np.int64)
            .astype(np.int32)])
        np.testing.assert_array_equal(t.probe(q), j.probe(q))
        assert (len(t), t.host_keys, t.disk_keys, t.active) == \
            (len(j), j.host_keys, j.disk_keys, j.active)
        assert _stats(t.stats()) == _stats(j.stats())
    assert t.disk_keys > 0 or host_budget > 10000
    assert tl == jl


def test_tier_io_error_degrades_like_the_reference(tmp_path, monkeypatch):
    """The tier_io_error fault site (the port's copy of faults.py): a
    failed disk write leaves the store host-only, with the reference's
    degrade record and the same probes."""
    monkeypatch.setenv("JAXMC_FAULTS", "tier_io_error:op=write")
    jfaults._CACHE = tfaults._CACHE = None
    rng = np.random.default_rng(3)
    j = JTiered(2, host_budget_keys=50, spill_dir=str(tmp_path / "j"))
    t = TTiered(2, host_budget_keys=50, spill_dir=str(tmp_path / "t"))
    runs = [np.unique(rng.integers(-99, 99, (40, 2)).astype(np.int32),
                      axis=0) for _ in range(3)]
    for r in runs:
        j.spill(r)
    _fresh_fault_budget()
    for r in runs:
        t.spill(r)
    assert t.io_degraded and "tier_io_error" in t.io_degraded
    assert _stats(t.stats()) == _stats(j.stats())
    assert t.disk_keys == 0
    q = np.concatenate(runs + [np.zeros((5, 2), np.int32)])
    np.testing.assert_array_equal(t.probe(q), j.probe(q))


# ---------------------------------------------------------------------------
# capped runs of the engines
# ---------------------------------------------------------------------------

def run_both(spec, cfg, tmp_path, **kw):
    """The reference and the port on the same spec with a device seen
    cap: counts, verdict, trace, tier statistics (less wall times) and
    every log line must be equal."""
    jlog, tlog = [], []
    with jobs.use(jobs.Telemetry()):
        rj = TpuExplorer(jload(spec, cfg, False), log=jlog.append,
                         cap_profile=False, progress_every=1e9,
                         spill_dir=str(tmp_path / "j"), **kw).run()
    _fresh_fault_budget()
    tobs.reset()
    rt = TorchExplorer(tload(spec, cfg), device="cpu", log=tlog.append,
                       progress_every=1e9, spill_dir=str(tmp_path / "t"),
                       **kw).run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter, rt.truncated) \
        == (rj.ok, rj.generated, rj.distinct, rj.diameter, rj.truncated)
    assert rt.warnings == rj.warnings
    assert (rt.seen_mode, rt.collision_p) == (rj.seen_mode, rj.collision_p)
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        assert tformat(rt.violation) == jformat(rj.violation)
    assert _stats(rt.tiers) == _stats(rj.tiers)
    assert tlog == jlog
    return rt


@pytest.mark.parametrize("kw", [dict(), dict(resident=True, chunk=256)],
                         ids=["level", "resident"])
def test_ooc_scaled_spills_both_tiers_exact(kw, tmp_path):
    rt = run_both(_spec("ooc_scaled.tla"), _spec("ooc_scaled.cfg"),
                  tmp_path, seen_cap=OOC_CAP, host_tier_keys=OOC_HOST_KEYS,
                  **kw)
    assert rt.ok and not rt.truncated
    assert (rt.generated, rt.distinct) == OOC_WANT
    assert rt.tiers["spills"] > 0 and rt.tiers["disk_keys"] > 0


def test_ooc_scaled_bad_invariant_trace_on_the_level_engine(tmp_path):
    rt = run_both(_spec("ooc_scaled.tla"), _spec("ooc_scaled_bad.cfg"),
                  tmp_path, seen_cap=OOC_CAP, host_tier_keys=OOC_HOST_KEYS)
    assert rt.violation.kind == "invariant"
    assert rt.violation.name == "NoMeet"
    assert rt.tiers and rt.tiers["spills"] > 0
    assert len(rt.violation.trace) == rt.diameter + 1


def test_engine_io_degrade_keeps_exact_counts(tmp_path, monkeypatch):
    monkeypatch.setenv("JAXMC_FAULTS", "tier_io_error:op=write")
    jfaults._CACHE = tfaults._CACHE = None
    rt = run_both(_spec("ooc_scaled.tla"), _spec("ooc_scaled.cfg"),
                  tmp_path, seen_cap=OOC_CAP, host_tier_keys=OOC_HOST_KEYS)
    assert (rt.generated, rt.distinct) == OOC_WANT
    assert rt.tiers.get("io_degraded") and rt.tiers["disk_keys"] == 0


def test_tier_host_keys_env_as_in_the_reference(tmp_path, monkeypatch):
    """JAXMC_TIER_HOST_KEYS sets the host budget when the caller gives
    none (here with the cap from JAXMC_SEEN_CAP)."""
    monkeypatch.setenv("JAXMC_TIER_HOST_KEYS", str(OOC_HOST_KEYS))
    monkeypatch.setenv("JAXMC_SEEN_CAP", str(OOC_CAP))
    rt = run_both(_spec("ooc_scaled.tla"), _spec("ooc_scaled.cfg"),
                  tmp_path)
    assert (rt.generated, rt.distinct) == OOC_WANT
    assert rt.tiers["disk_keys"] > 0


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, [ln for ln in out if "states/sec" not in ln]


@pytest.mark.parametrize("extra", [[], ["--resident", "--chunk", "256"]],
                         ids=["level", "resident"])
def test_cli_seen_cap_prints_the_reference_lines(extra, tmp_path, capsys,
                                                 monkeypatch):
    from jaxmc.cli import main as jmain
    from jaxmc_torch.cli import main as tmain
    monkeypatch.setenv("JAXMC_TIER_HOST_KEYS", str(OOC_HOST_KEYS))
    monkeypatch.setenv("JAXMC_PROFILE_STORE", str(tmp_path / "prof"))
    spec, cfg = _spec("ooc_scaled.tla"), _spec("ooc_scaled.cfg")
    common = ["check", spec, "--cfg", cfg, "--seen-cap", str(OOC_CAP)]
    rj, lj = _cli(jmain, common + ["--backend", "jax", "--platform", "cpu",
                                   "--seen-spill", str(tmp_path / "j")]
                  + extra, capsys)
    rt, lt = _cli(tmain, common + ["--device", "cpu", "--seen-spill",
                                   str(tmp_path / "t")] + extra, capsys)
    assert rt == rj == 0
    keep = [ln for ln in lj if not ln.startswith("-- capacity profile")]
    assert lt == keep
    assert "12289 states generated, 3072 distinct states found, 0 states " \
           "left on queue." in lt
