"""The port's corpus sweep (jaxmc_torch/corpus.py) against the
reference's (jaxmc/corpus.py), on the CPU.

- CASES equals the reference's manifest field by field;
- run_case(case, "jax", device="cpu") gives the reference's status,
  expansion mode and detail line (the build wall masked) on repo-local
  cases: the hybrid interparm_toy, the derived interp-arms pin of
  dyntoy, the symmetry notes of symtoy and symid, an invariant
  violation, VIEW and pcal_intro_buggy's assert; the mode pins (a slide,
  an improvement, the pinned interp-arms build skip) and a predictor
  regression;
- a case that needs the reference corpus skips with a named reason where
  it is absent;
- sweep() writes the jaxmc.sweep-metrics/1 artifact and the reference's
  log lines; a case also runs in a child process."""

import dataclasses
import json
import os
import re

import pytest
import torch

from jaxmc import corpus as jc
from jaxmc_torch import corpus as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases run against the reference (cfg basenames)
RUN = ("interparm_toy.cfg", "dyntoy.cfg", "symtoy.cfg", "symid.cfg",
       "constoy.cfg", "portoy_bad.cfg", "viewtoy.cfg",
       "specs/pcal_intro_buggy.tla")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _find(cases, key):
    return next(c for c in cases
                if (c.cfg and os.path.basename(c.cfg) == key)
                or c.spec == key)


def _mask(detail):
    return re.sub(r"\[build \d+\.\ds", "[build Xs", detail)


def _needs_native():
    from jaxmc import native_store as jns
    from jaxmc_torch import native_store as tns
    if not (jns.is_available() and tns.is_available()):
        pytest.skip("hybrid needs the native store (g++)")


def test_manifest_equals_reference():
    assert len(tc.CASES) == len(jc.CASES)
    for t, j in zip(tc.CASES, jc.CASES):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tc._MODE_ORDER == jc._MODE_ORDER
    assert tc.case_for_cfg("constoy.cfg") == tc.CASES[
        jc.CASES.index(jc.case_for_cfg("constoy.cfg"))]


@pytest.mark.parametrize("key", RUN)
def test_run_case_matches_reference(key):
    _needs_native()
    sj, dj, rj, mj = jc.run_case(_find(jc.CASES, key), backend="jax")
    st, dt, rt, mt = tc.run_case(_find(tc.CASES, key), backend="jax",
                                 device="cpu")
    assert (st, mt) == (sj, mj)
    assert st == "pass", dt
    assert _mask(dt) == _mask(dj)
    assert (rt.distinct, rt.generated) == (rj.distinct, rj.generated)


def test_reference_rooted_case_skips_with_its_reason(monkeypatch):
    monkeypatch.setattr(tc, "REFERENCE", os.path.join(ROOT, "no-such-dir"))
    for key in ("MCtextbookSI_small.cfg", "pcal_intro.tla"):
        s, d, r, m = tc.run_case(_find(tc.CASES, key), backend="jax",
                                 device="cpu")
        assert (s, r, m) == ("skip", None, None)
        assert d == f"reference corpus not mounted at {tc.REFERENCE}"


def test_reference_is_read_only_from_the_environment(monkeypatch, capsys):
    """Unset JAXMC_REFERENCE means no corpus: the port looks nowhere
    around its checkout, and every reference-rooted case, rung and lint
    pair skips with the named reason."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "JAXMC_REFERENCE"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jaxmc_torch.corpus as c; print(c.REFERENCE)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    assert out.stdout == "None\n"
    monkeypatch.setattr(tc, "REFERENCE", None)
    why = "reference corpus not mounted (JAXMC_REFERENCE unset)"
    assert tc.reference_missing() == why and not tc.have_reference()
    for key in ("MCtextbookSI_small.cfg", "pcal_intro.tla"):
        s, d, r, m = tc.run_case(_find(tc.CASES, key), backend="jax",
                                 device="cpu")
        assert (s, d, r, m) == ("skip", why, None, None)
    with pytest.raises(FileNotFoundError, match="JAXMC_REFERENCE unset"):
        _find(tc.CASES, "pcal_intro.tla").spec_path()
    # repo-rooted lookups still resolve
    assert tc.case_for_cfg("constoy.cfg").root == "repo"
    from jaxmc_torch import meshbench
    assert meshbench._needs_reference(
        "specs/MCraftMicro.tla", "specs/MCraft_3s_bench.cfg") == why
    assert meshbench._needs_reference("specs/constoy.tla", None) is None
    from jaxmc_torch.analyze.__main__ import main as amain
    assert amain(["lint-corpus"]) == 0
    skips = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[SKIP]")]
    assert skips and all(ln.endswith(f": {why}") for ln in skips)


@pytest.mark.parametrize("change,want", [
    # a slide toward the interpreter fails before the search
    (("interparm_toy.cfg", dict(mode="compiled")),
     "REGRESSION: expansion mode slid from pinned 'compiled' to 'hybrid'"),
    # the measured interp-arms pin skips every build
    (("symtoy.cfg", dict(mode="interp-arms")), "0/4 arms compiled"),
    # an improvement passes with the manifest note
    (("symtoy.cfg", dict(mode="hybrid")), "update the manifest"),
], ids=["slide", "pinned", "improved"])
def test_mode_pins_match_reference(change, want):
    _needs_native()
    key, kw = change
    sj, dj, rj, mj = jc.run_case(
        dataclasses.replace(_find(jc.CASES, key), **kw), backend="jax")
    st, dt, rt, mt = tc.run_case(
        dataclasses.replace(_find(tc.CASES, key), **kw), backend="jax",
        device="cpu")
    assert (st, mt, rt is None) == (sj, mj, rj is None)
    assert _mask(dt) == _mask(dj)
    assert want in dt


def test_predictor_regression_fails_the_derived_pin(monkeypatch):
    _needs_native()
    from jaxmc_torch.backend import bfs
    monkeypatch.setattr(bfs, "predict_arm_demotions", lambda m, arms: {})
    s, d, r, mode = tc.run_case(_find(tc.CASES, "dyntoy.cfg"),
                                backend="jax", device="cpu")
    assert s == "fail" and r is None
    assert d.startswith("PREDICTOR REGRESSION: pin_derived case predicted "
                        "only 0/2 arm demotions")


SWEEP = ("constoy.cfg", "dyntoy.cfg", "portoy_bad.cfg", "linttoy.cfg",
         "MCtextbookSI_small.cfg")


def _masked_log(lines):
    out = []
    for ln in lines:
        ln = _mask(ln)
        ln = re.sub(r"\(\d+\.\ds\)$", "(Xs)", ln)
        ln = re.sub(r"\(\d+\.\ds, backend", "(Xs, backend", ln)
        out.append(ln)
    return out


def test_sweep_writes_the_artifact(tmp_path, monkeypatch):
    _needs_native()
    monkeypatch.setattr(tc, "CASES", [_find(tc.CASES, k) for k in SWEEP])
    monkeypatch.setattr(tc, "REFERENCE", str(tmp_path / "absent"))
    lines = []
    out = tmp_path / "sweep.json"
    fails = tc.sweep(backend="jax", log=lines.append, isolate=False,
                     metrics_out=str(out), device="cpu")
    assert fails == 0, lines
    art = json.loads(out.read_text())
    assert art["schema"] == "jaxmc.sweep-metrics/1"
    assert art["backend"] == "jax" and art["isolated"] is False
    assert art["platform"] is None
    # linttoy never sweeps
    assert [c["case"] for c in art["cases"]] == \
        [c.cfg or c.spec for c in tc.CASES if not c.lint_only]
    assert art["tallies"] == {"pass": 3, "fail": 0, "skip": 1, "total": 4,
                              "expected_violations": 1}
    assert art["modes"] == {"compiled": 2, "hybrid": 0, "interp-arms": 1}
    # the reference's log lines on the cases both can run, and its
    # summary line's form
    jlines = []
    monkeypatch.setattr(jc, "CASES", [_find(jc.CASES, k) for k in SWEEP
                                      if k != "MCtextbookSI_small.cfg"])
    jc.sweep(backend="jax", log=jlines.append, isolate=False)
    ran = [ln for ln in lines if "MCtextbookSI" not in ln]
    assert _masked_log(ran[:-2]) == _masked_log(jlines[:-1])
    assert lines[-2].startswith("4 corpus models: 3 pass (1 expected-"
                                "violation), 1 SKIP (outside jax subset), "
                                "0 FAIL (")
    assert lines[-2].endswith("backend=jax); expansion modes: 2 "
                              "fully-compiled / 0 hybrid / 1 "
                              "all-interp-arms")
    assert lines[-1] == f"sweep metrics written to {out}"


def test_isolated_case_runs_in_a_child(monkeypatch):
    """The child process imports only jaxmc_torch and runs on the device
    it is given."""
    # the child's torch pool shares the box with other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    idx = tc.CASES.index(_find(tc.CASES, "constoy.cfg"))
    s, d, mode = tc._run_case_isolated(idx, "jax", 240.0, "cpu")
    assert (s, mode) == ("pass", "compiled"), d
    assert d.startswith("43 generated / 21 distinct (ok) [build ")
