"""The port's static analysis against the reference's (jaxmc/analyze):
demotion prediction, the linter and `python -m jaxmc_torch.analyze`.

- predict_arm_demotions gives the reference's verdicts (arm label ->
  reason string) on every repo-local corpus pair and on the reference's
  prediction fixtures (interparm_toy, dyntoy and the quantifier-domain
  spec written here);
- a predicted arm demotes with the build-time reason and log line, the
  engine never grounds it, and the `analyze.*` telemetry equals the
  reference's engine build;
- lint_pair's diagnostics equal the reference's on every repo-local
  pair, linttoy (every class) included;
- `python -m jaxmc_torch.analyze lint | lint-corpus | pylint` exit
  with the reference's codes and print its lines."""

import os

import pytest

from jaxmc import obs as jobs
from jaxmc.analyze import lint_pair as jlint
from jaxmc.analyze import predict_arm_demotions as jpredict
from jaxmc.analyze.__main__ import main as jmain
from jaxmc.compile.ground import split_arms as jsplit
from jaxmc.corpus import CASES as JCASES
from jaxmc.session import load_model as jload
from jaxmc_torch import obs as tobs
from jaxmc_torch.analyze import lint_pair as tlint
from jaxmc_torch.analyze import predict_arm_demotions as tpredict
from jaxmc_torch.analyze.__main__ import main as tmain
from jaxmc_torch.compile.ground import split_arms as tsplit
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
LINTTOY = os.path.join(SPECS, "linttoy.tla")
LINTTOY_CFG = os.path.join(SPECS, "linttoy.cfg")

# the repo-local pairs of the manifest (no reference corpus needed)
LOCAL = [c for c in JCASES if c.root == "repo" and not c.includes]
LOCAL_IDS = [os.path.basename(c.cfg or c.spec) for c in LOCAL]

QUANTTOY = r"""
--------------------------- MODULE quanttoy ---------------------------
EXTENDS Naturals
VARIABLES n

Init == n = 0

OverNat == /\ \A m \in Nat : m >= 0
           /\ n' = n + 1

Unbounded == /\ \A m : m = m
             /\ n' = n

Next == OverNat \/ Unbounded

Spec == Init /\ [][Next]_<<n>>
=======================================================================
"""
FIXTURES = {"quanttoy": QUANTTOY}


def _cfg_of(case):
    return case.cfg_path()


def _verdicts(load, split, predict, spec, cfg, no_deadlock=False):
    m = load(spec, cfg, no_deadlock)
    arms = split(m)
    return {(arms[i].label or "Next"): r
            for i, r in predict(m, arms).items()}


@pytest.mark.parametrize("case", [c for c in LOCAL if not c.lint_only],
                         ids=[i for c, i in zip(LOCAL, LOCAL_IDS)
                              if not c.lint_only])
def test_predictions_match_reference_on_the_corpus(case):
    args = (case.spec_path(), _cfg_of(case), case.no_deadlock)
    want = _verdicts(jload, jsplit, jpredict, *args)
    assert _verdicts(tload, tsplit, tpredict, *args) == want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_predictions_match_reference_on_fixtures(name, tmp_path):
    spec = tmp_path / f"{name}.tla"
    spec.write_text(FIXTURES[name])
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text("SPECIFICATION Spec\n")
    want = _verdicts(jload, jsplit, jpredict, str(spec), str(cfg), True)
    assert want, "the fixture must draw a verdict"
    assert _verdicts(tload, tsplit, tpredict, str(spec), str(cfg),
                     True) == want


def _engines(name, predict, monkeypatch):
    """The reference's and the port's hybrid engine builds of
    specs/NAME with prediction on or off: (fb_arms as label/reason
    pairs, log lines, analyze.* telemetry, arms the port grounded)."""
    from jaxmc.backend.bfs import TpuExplorer
    from jaxmc_torch.backend import bfs as tbfs
    monkeypatch.setenv("JAXMC_ANALYZE_PREDICT", "1" if predict else "0")
    spec = os.path.join(SPECS, f"{name}.tla")
    cfg = os.path.join(SPECS, f"{name}.cfg")
    from jaxmc_torch.compile.ground import ground_arm as real
    out = []
    grounded = []

    def spy(model, arm, **kw):
        grounded.append(arm.label)
        return real(model, arm, **kw)

    monkeypatch.setattr(tbfs, "ground_arm", spy)
    for mk, obs_mod, tel in (
            (lambda m, log: TpuExplorer(m, log=log, store_trace=False,
                                        host_seen=True),
             jobs, jobs.Telemetry()),
            (lambda m, log: tbfs.TorchExplorer(m, log=log, device="cpu",
                                               store_trace=False,
                                               host_seen=True),
             tobs, tobs.Telemetry())):
        lines = []
        load = jload if obs_mod is jobs else tload
        with obs_mod.use(tel):
            ex = mk(load(spec, cfg, False), lines.append)
        out.append(([(a.label, r) for a, r in ex.fb_arms],
                    [ln for ln in lines if "interp-demoted" in ln],
                    {k: v for k, v in list(tel.counters.items())
                     + list(tel.gauges.items())
                     if k.startswith("analyze.")},
                    [p["name"] for p in tel.summary()["phases"]
                     if p["name"] == "analyze_arms"],
                    ex.arm_verdicts))
    return out[0], out[1], grounded


@pytest.mark.parametrize("name,arms", [("interparm_toy", {"Pick"}),
                                       ("dyntoy", {"Pair", "Relay"})])
def test_predicted_demotion_is_the_build_time_demotion(name, arms,
                                                       monkeypatch):
    from jaxmc import native_store as jns
    from jaxmc_torch import native_store as tns
    if not (jns.is_available() and tns.is_available()):
        pytest.skip("hybrid needs the native store (g++)")
    ref_p, port_p, grounded_p = _engines(name, True, monkeypatch)
    ref_b, port_b, grounded_b = _engines(name, False, monkeypatch)
    # the demotion table and its log lines: equal on both paths, in both
    # packages
    assert port_p[0] == port_b[0] == ref_p[0] == ref_b[0]
    assert port_p[1] == port_b[1] == ref_p[1]
    assert {a for a, _ in port_p[0]} == arms
    # the telemetry of the prediction: the reference's names and values
    assert port_p[2] == ref_p[2]
    assert port_p[2]["analyze.predicted_demotions"] == len(arms)
    assert port_p[3] == ref_p[3] == ["analyze_arms"]
    assert port_p[4] == ref_p[4] and not port_b[4]
    # no build is attempted for a predicted arm
    assert not arms & set(grounded_p)
    assert arms <= set(grounded_b)


def test_pinned_engine_skips_every_build(monkeypatch):
    from jaxmc_torch.backend import bfs as tbfs
    grounded = []
    monkeypatch.setattr(tbfs, "ground_arm",
                        lambda *a, **kw: grounded.append(a) or [])
    spec = os.path.join(SPECS, "symtoy")
    ex = tbfs.TorchExplorer(tload(spec + ".tla", spec + ".cfg", True),
                            device="cpu", store_trace=False,
                            host_seen=True, pin_interp_arms=True)
    assert not grounded and ex.A == 0 and ex.arm_verdicts == {}
    assert {r for _, r in ex.fb_arms} == {
        "pinned interp-arms (corpus manifest): kernel construction "
        "skipped"}
    assert ex.run().distinct == 22


def _diag_rows(diags):
    return [(d.code, d.severity, d.message, os.path.basename(d.path or ""),
             d.line, d.render()) for d in diags]


@pytest.mark.parametrize("case", LOCAL, ids=LOCAL_IDS)
def test_lint_matches_reference(case):
    args = (case.spec_path(), _cfg_of(case), tuple(case.include_dirs()))
    want = _diag_rows(jlint(*args))
    assert _diag_rows(tlint(*args)) == want
    if case.lint_only:
        assert {r[0] for r in want} == set(case.lint_expect)


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv,rc", [
    (["lint", os.path.join(SPECS, "viewtoy.tla")], 0),
    (["lint", LINTTOY, LINTTOY_CFG], 2),
    (["lint", "WARNCFG"], 1),
    (["lint", "WARNCFG", "--errors-only"], 0),
    (["lint-corpus"], 0),
    (["pylint", "PORTDIR"], 0),
], ids=["clean", "errors", "warnings", "errors_only", "lint_corpus",
        "pylint"])
def test_analyze_cli_matches_reference(argv, rc, tmp_path, capsys,
                                      monkeypatch):
    # warnings only: a cfg that assigns Ghost and names defined
    # invariants only
    cfg2 = tmp_path / "linttoy.cfg"
    cfg2.write_text(
        "SPECIFICATION Spec\nINVARIANT TypeInv HazInv\n"
        "SYMMETRY Perms\nCONSTANTS\n  P = {a1, a2}\n  Limit = 4\n"
        "  Unused = 7\n  Ghost = 9\n")

    def argv_for(pkg):
        out = []
        for a in argv:
            if a == "WARNCFG":
                out += [LINTTOY, str(cfg2)]
            elif a == "PORTDIR":
                # each package's own analyze sources
                out.append(os.path.join(ROOT, pkg, "analyze"))
            else:
                out.append(a)
        return out

    if argv[0] == "lint-corpus":
        # both packages look for the same corpus (the port has no
        # default path for it)
        from jaxmc import corpus as jc
        from jaxmc_torch import corpus as tc
        monkeypatch.setattr(jc, "REFERENCE",
                            tc.REFERENCE or str(tmp_path / "absent"))
    rj, oj, _ = _cli(jmain, argv_for("jaxmc"), capsys)
    rt, ot, et = _cli(tmain, argv_for("jaxmc_torch"), capsys)
    assert rt == rj == rc
    if argv[0] == "lint-corpus":
        # the skip lines name each package's reference path: compare the
        # verdicts of the pairs that ran, and the summary
        def ran(text):
            return [ln for ln in text.splitlines()
                    if not ln.startswith("[SKIP]")]
        assert ran(ot) == ran(oj)
        assert ot.count("[SKIP]") == oj.count("[SKIP]")
    else:
        assert ot == oj
    if argv[0] == "pylint":
        assert "0 findings" in et
