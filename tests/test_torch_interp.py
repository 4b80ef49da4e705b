"""The port's interpreter engines (copies of jaxmc/engine/explore.py and
jaxmc/engine/parallel.py under jaxmc_torch/engine/) against the JAX
package's on the CPU: the serial Explorer and the ParallelExplorer with
two workers give the same verdicts, counts, traces, warnings and por.*
counters, write the same interpreter checkpoints, and resume them to
the same totals."""

import os

import numpy as np
import pytest
import torch

from jaxmc_torch import drain, faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
# the reference's PROPERTY modules (tests/test_jax_backend.py, class
# TestLevelRankMergeParity): a refinement that fails with a trace and a
# liveness property under weak fairness
RMBAD = """---- MODULE rmbad ----
EXTENDS Naturals
VARIABLE hr
HCini == hr \\in 1..12
HCnxt == hr' = IF hr >= 11 THEN 1 ELSE hr + 2
HC == HCini /\\ [][HCnxt]_hr
Jump == hr' = IF hr = 12 THEN 1 ELSE hr + 1
JumpSpec == HCini /\\ [][Jump]_hr
====
"""
RMLIVE = """---- MODULE rmlive ----
EXTENDS Naturals
VARIABLE hr
Init == hr \\in 1..4
Next == hr' = (hr % 12) + 1
Spec == Init /\\ [][Next]_hr /\\ WF_hr(Next)
Cycles == []<><<Next>>_hr
====
"""
PROPS = {"rmbad": (RMBAD, "SPECIFICATION HC\nPROPERTY JumpSpec\n"
                          "CHECK_DEADLOCK FALSE\n"),
         "rmlive": (RMLIVE, "SPECIFICATION Spec\nPROPERTY Cycles\n"
                            "CHECK_DEADLOCK FALSE\n")}

# (spec, cfg, max_states, por); None: a module of PROPS
CASES = {
    "transfer_scaled_cut": (os.path.join(SPECS, "transfer_scaled.tla"),
                            None, 20000, False),
    "pcal_intro_buggy": (os.path.join(SPECS, "pcal_intro_buggy.tla"),
                         None, None, False),
    "portoy_por": (os.path.join(SPECS, "portoy.tla"),
                   os.path.join(SPECS, "portoy_ok.cfg"), None, True),
    "rmbad": (None, None, None, False),
    "rmlive": (None, None, None, False),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("JAXMC_FAULTS", raising=False)
    faults.reset_for_tests()
    drain.clear()
    yield
    drain.clear()
    torch.set_num_threads(n)


def _models(spec, cfg):
    from jaxmc.session import load_model as jload
    from jaxmc_torch.session import load_model
    return (jload(spec, cfg, False, [SPECS]),
            load_model(spec, cfg, includes=[SPECS]))


def _engines(workers):
    from jaxmc.engine.explore import Explorer as JExplorer
    from jaxmc.engine.parallel import ParallelExplorer as JParallel
    from jaxmc_torch.engine.explore import Explorer
    from jaxmc_torch.engine.parallel import ParallelExplorer
    if workers == 1:
        return JExplorer, Explorer
    return (lambda m, **k: JParallel(m, workers=workers, **k),
            lambda m, **k: ParallelExplorer(m, workers=workers, **k))


def _run(ctor, model, tel_mod, tel, **kw):
    logs = []
    if hasattr(tel_mod, "use"):
        with tel_mod.use(tel):
            r = ctor(model, log=logs.append, **kw).run()
    else:
        with tel_mod.use_local(tel):
            r = ctor(model, log=logs.append, **kw).run()
    return r, logs


def summary(r):
    """Verdict, counts, warnings and the trace with its values as TLA+
    text, so a result of either package compares with the other's."""
    v = r.violation
    trace = v and [(sorted((k, repr(x)) for k, x in st.items()), label)
                   for st, label in v.trace]
    return (r.ok, r.distinct, r.generated, r.diameter, r.truncated,
            list(r.warnings), v and (v.kind, v.name, v.message, trace))


POR_KEYS = ("por.enabled", "por.ample_states", "por.full_states",
            "por.reduced_states", "por.disabled_reason")


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_interp_engine_matches_reference(case, workers, tmp_path):
    from jaxmc import obs as jobs
    from jaxmc_torch import obs as tobs
    spec, cfg, max_states, por = CASES[case]
    if spec is None:
        text, cfg_text = PROPS[case]
        spec, cfg = str(tmp_path / f"{case}.tla"), str(tmp_path / "p.cfg")
        with open(spec, "w") as fh:
            fh.write(text)
        with open(cfg, "w") as fh:
            fh.write(cfg_text)
    jm, tm = _models(spec, cfg)
    jctor, tctor = _engines(1 if por else workers)
    kw = dict(max_states=max_states)
    if por:
        kw["por"] = True
    jtel, ttel = jobs.Telemetry(), tobs.Telemetry()
    rj, jlogs = _run(jctor, jm, jobs, jtel, **kw)
    rt, tlogs = _run(tctor, tm, tobs, ttel, **kw)
    assert summary(rt) == summary(rj)
    assert tlogs == jlogs
    got = {k: ttel.counters.get(k, ttel.gauges.get(k)) for k in POR_KEYS}
    want = {k: jtel.counters.get(k, jtel.gauges.get(k)) for k in POR_KEYS}
    assert got == want
    if por:
        assert got["por.enabled"] and got["por.ample_states"] > 0


def _same(a, b, path="payload"):
    """Field by field; numpy arrays by value, TLA+ values by class name
    and text."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    elif type(a).__module__.startswith(("jaxmc.", "jaxmc_torch.")):
        assert type(a).__name__ == type(b).__name__, path
        assert repr(a) == repr(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("workers", [1, 2])
def test_interp_checkpoint_equals_reference_and_resumes(workers, tmp_path):
    """A state-limit truncation checkpoints the in-flight state in both
    packages alike (the states pickled as each package's own values, so
    each package resumes its own file); both resume to the uninterrupted
    run's verdict, counts and trace (pcal_intro_buggy's assertion, 9,097
    / 6,164)."""
    from jaxmc import obs as jobs
    from jaxmc_torch import obs as tobs
    from jaxmc_torch.engine.ckpt import load_checkpoint
    spec = os.path.join(SPECS, "pcal_intro_buggy.tla")
    jm, tm = _models(spec, None)
    jctor, tctor = _engines(workers)
    full, _ = _run(tctor, tm, tobs, tobs.Telemetry())
    jm, tm = _models(spec, None)
    pj, pt = str(tmp_path / "ref.ck"), str(tmp_path / "port.ck")
    kw = dict(max_states=3000, checkpoint_every=0.0)
    rj, _ = _run(jctor, jm, jobs, jobs.Telemetry(), checkpoint_path=pj,
                 **kw)
    rt, _ = _run(tctor, tm, tobs, tobs.Telemetry(), checkpoint_path=pt,
                 **kw)
    assert summary(rt) == summary(rj) and rt.truncated
    hj, a = load_checkpoint(pj, kind="interp")
    ht, b = load_checkpoint(pt, kind="interp")
    assert hj["meta"] == ht["meta"]
    _same(b, a)
    jm, tm = _models(spec, None)
    rt2, tlogs = _run(tctor, tm, tobs, tobs.Telemetry(), resume_from=pt)
    assert summary(rt2)[:4] == summary(full)[:4]
    assert summary(rt2)[6] == summary(full)[6]
    assert (rt2.generated, rt2.distinct) == (9097, 6164)
    assert any(ln.startswith("Resumed from") for ln in tlogs)
    rj2, _ = _run(jctor, jm, jobs, jobs.Telemetry(), resume_from=pj)
    assert summary(rj2) == summary(rt2)


def test_interp_drain_then_resume(tmp_path):
    """The serial engine's drain poll: a drained run checkpoints and
    resumes to the same totals."""
    from jaxmc_torch.engine.explore import Explorer
    from jaxmc_torch.session import load_model
    spec = os.path.join(SPECS, "pcal_intro_buggy.tla")
    full = Explorer(load_model(spec)).run()
    ck = str(tmp_path / "d.ck")

    def log(line):
        if line.startswith("Progress("):
            drain.request("test drain")

    r1 = Explorer(load_model(spec), checkpoint_path=ck, log=log,
                  progress_every=0.0).run()
    assert r1.drained and r1.truncated
    drain.clear()
    r2 = Explorer(load_model(spec), resume_from=ck).run()
    assert summary(r2) == summary(full)


def test_cli_interp_backend(capsys, tmp_path):
    """`--backend interp` runs the interpreter (serial, or --workers 2)
    with the reference's lines; it resumes a device run's `.host`
    snapshot."""
    from jaxmc_torch.cli import main
    spec = os.path.join(SPECS, "pcal_intro_buggy.tla")
    for extra in ([], ["--workers", "2"]):
        assert main(["check", spec, "--backend", "interp", "--quiet"]
                    + extra) == 1
        out = capsys.readouterr().out
        assert "9097 states generated, 6164 distinct states found" in out
        assert "backend=interp" in out
        assert "Error: Assertion failed" in out
    ck = str(tmp_path / "t.ck")
    assert main(["check", spec, "--device", "cpu", "--max-states", "3000",
                 "--checkpoint", ck, "--checkpoint-every", "0",
                 "--quiet"]) == 0
    capsys.readouterr()
    assert main(["check", spec, "--backend", "interp", "--workers", "2",
                 "--resume", ck + ".host", "--quiet"]) == 1
    out = capsys.readouterr().out
    assert "backend=interp" in out and "Error: Assertion failed" in out
