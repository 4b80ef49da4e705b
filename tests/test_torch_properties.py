"""Temporal and refinement PROPERTYs on the torch port's level and
host-seen engines (hybrid included) against the JAX reference's
TpuExplorer in the same mode on JAX's CPU, and against the reference
interpreter: verdicts, counts, property names, traces (states and
labels) and warnings.  Also the edge site of K8's twin against
np.nonzero on masks made from a numpy seed.  Every comparison is exact
(tolerance 0)."""

import os

import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import TpuExplorer
from jaxmc.compile.vspec import CompileError as JCompileError
from jaxmc.compile.vspec import ModeError as JModeError
from jaxmc.engine.explore import Explorer
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.front.cfg import ModelConfig as JCfg
from jaxmc.session import load_model as jload
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.compile.vspec import CompileError as TCompileError
from jaxmc_torch.compile.vspec import ModeError as TModeError
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.front.cfg import ModelConfig as TCfg
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
FIX = os.path.join(ROOT, "jaxmc_torch", "fixtures")

# the reference's inline modules (tests/test_jax_backend.py, class
# TestLevelRankMergeParity)
RMHC = """---- MODULE rmhc ----
EXTENDS Naturals
VARIABLE hr
HCini == hr \\in 1..12
HCnxt == hr' = IF hr = 12 THEN 1 ELSE hr + 1
HC == HCini /\\ [][HCnxt]_hr
====
"""
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
TEXTS = {"rmhc": RMHC, "rmbad": RMBAD, "rmlive": RMLIVE}

# (case, module, cfg fields): a ModelConfig for the inline modules, or
# a transfer_props cfg cut to MaxMoney 3
CASES = {
    "rmhc": ("rmhc", dict(specification="HC", properties=["HC"],
                          check_deadlock=False)),
    "rmbad": ("rmbad", dict(specification="HC", properties=["JumpSpec"],
                            check_deadlock=False)),
    "rmlive_wf": ("rmlive", dict(specification="Spec",
                                 properties=["Cycles"],
                                 check_deadlock=False)),
    "rmlive_nowf": ("rmlive", dict(init="Init", next="Next",
                                   properties=["Cycles"],
                                   check_deadlock=False)),
    "tp_monotone": ("transfer_props", "monotone"),
    "tp_frozen": ("transfer_props", "frozen"),
    "tp_live": ("transfer_props", "live"),
    "tp_nolive": ("transfer_props", "nolive"),
}
MODES = {"level": dict(host_seen=False),
         "hs4": dict(host_seen=True, chunk=4),
         "hs2048": dict(host_seen=True, chunk=2048)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs on one intra-op thread: several test workers
    share the machine, and oversubscribed OpenMP pools stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("props")
    for nm, text in TEXTS.items():
        (d / f"{nm}.tla").write_text(text)
    for n in ("monotone", "frozen", "live", "nolive"):
        with open(os.path.join(FIX, f"transfer_props_{n}.cfg")) as fh:
            cfg = fh.read().replace("MaxMoney = 12", "MaxMoney = 3")
        (d / f"tp_{n}.cfg").write_text(cfg)
    return d


def _models(case_dir, case):
    """(reference model, port model) of a case."""
    mod, how = CASES[case]
    if mod == "transfer_props":
        spec = os.path.join(FIX, "transfer_props.tla")
        cfg = str(case_dir / f"tp_{how}.cfg")
        return (jload(spec, cfg, False, [SPECS]),
                tload(spec, cfg, False, [SPECS]))
    from jaxmc.sem.modules import Loader as JL, bind_model as jbind
    from jaxmc_torch.sem.modules import Loader as TL, bind_model as tbind
    spec = str(case_dir / f"{mod}.tla")
    return (jbind(JL([str(case_dir)]).load_path(spec), JCfg(**how)),
            tbind(TL([str(case_dir)]).load_path(spec), TCfg(**how)))


def _tup(r, fmt):
    v = None
    if r.violation is not None:
        # the states through the trace printer (the two packages' value
        # classes differ), the labels as they are
        v = (r.violation.kind, r.violation.name, r.violation.message,
             [lab for _st, lab in r.violation.trace], fmt(r.violation))
    return (r.ok, r.distinct, r.generated, r.diameter, bool(r.truncated),
            list(r.warnings), v)


_REF = {}


def _ref(case_dir, case, mode, **kw):
    key = (case, mode, tuple(sorted(kw.items())))
    if key not in _REF:
        jm, _ = _models(case_dir, case)
        _REF[key] = TpuExplorer(jm, **MODES[mode], **kw).run()
    return _REF[key]


# the verdict each case must reach (so a parity pass cannot hide a
# wrong verdict both sides share)
EXPECT = {"rmhc": (True, None), "rmbad": (False, "JumpSpec"),
          "rmlive_wf": (True, None), "rmlive_nowf": (False, "Cycles"),
          "tp_monotone": (True, None), "tp_frozen": (False, "Frozen"),
          "tp_live": (True, None), "tp_nolive": (False, "AllDone")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_property_runs_match_reference(case_dir, case, mode):
    rj = _ref(case_dir, case, mode)
    _, tm = _models(case_dir, case)
    rt = TorchExplorer(tm, device="cpu", **MODES[mode]).run()
    assert _tup(rt, tformat) == _tup(rj, jformat)
    ok, name = EXPECT[case]
    assert rt.ok is ok
    if name is not None:
        assert rt.violation.kind == "property"
        assert rt.violation.name == name


@pytest.mark.parametrize("case", list(CASES))
def test_property_verdicts_match_the_interpreter(case_dir, case):
    jm, tm = _models(case_dir, case)
    ri = Explorer(jm).run()
    rt = TorchExplorer(tm, device="cpu").run()
    assert rt.ok == ri.ok
    if ri.ok:
        assert (rt.distinct, rt.generated) == (ri.distinct, ri.generated)
    else:
        assert (rt.violation.kind, rt.violation.name) == \
            (ri.violation.kind, ri.violation.name)


@pytest.mark.parametrize("mode", ["level", "hs2048"])
def test_por_with_a_property_warns_as_the_reference(case_dir, mode):
    rj = _ref(case_dir, "tp_live", mode, por=True)
    _, tm = _models(case_dir, "tp_live")
    rt = TorchExplorer(tm, device="cpu", por=True, **MODES[mode]).run()
    assert _tup(rt, tformat) == _tup(rj, jformat)
    assert any(w.startswith("--por requested but reduction disabled")
               for w in rt.warnings)


@pytest.mark.parametrize("mode", ["level", "hs4"])
def test_truncated_search_skips_the_temporal_check(case_dir, mode):
    rj = _ref(case_dir, "tp_nolive", mode, max_states=300)
    _, tm = _models(case_dir, "tp_nolive")
    rt = TorchExplorer(tm, device="cpu", max_states=300,
                       **MODES[mode]).run()
    assert _tup(rt, tformat) == _tup(rj, jformat)
    assert rt.ok and rt.truncated
    assert "temporal properties NOT checked: the search was truncated " \
           "(behavior graph incomplete)" in rt.warnings


@pytest.mark.parametrize("case", ["rmbad", "rmlive_wf"])
def test_resident_refusals_are_unchanged(case_dir, case):
    jm, tm = _models(case_dir, case)
    with pytest.raises(JModeError) as ej:
        TpuExplorer(jm, resident=True)
    with pytest.raises(TModeError) as et:
        TorchExplorer(tm, device="cpu", resident=True)
    assert str(et.value) == str(ej.value)
    assert "resident mode cannot check" in str(et.value)


INTERPARM_PROPS = {
    "frozen": ("Frozen == Init /\\ [][s' = s]_<<x, s>>", "Frozen", ""),
    "live": ("Live == []<>(x > 0)", "Live", ""),
    "grow": ("Grow == Init /\\ [][x' >= x]_<<x, s>>", "Grow", ""),
    "cons": ("Frozen == Init /\\ [][s' = s]_<<x, s>>", "Frozen",
             "CONSTRAINT Small\n"),
}


@pytest.mark.parametrize("which", list(INTERPARM_PROPS))
def test_hybrid_model_with_a_property(which, tmp_path):
    """interparm_toy (its Pick arm demotes to the interpreter) with a
    PROPERTY: the hybrid engine's edges and refinement equal the
    reference's; with an uncompilable CONSTRAINT too, both refuse with
    the same text."""
    body, name, extra = INTERPARM_PROPS[which]
    with open(os.path.join(SPECS, "interparm_toy.tla")) as fh:
        text = fh.read()
    text = text.replace(
        "=========================================================================",
        body + "\nSmall == Cardinality(SUBSET s) < 64\n" + "=" * 73)
    (tmp_path / "interparm_toy.tla").write_text(text)
    (tmp_path / "ip.cfg").write_text(
        f"SPECIFICATION Spec\nINVARIANT TypeInv\nPROPERTY {name}\n"
        f"{extra}CHECK_DEADLOCK FALSE\n")
    spec, cfg = str(tmp_path / "interparm_toy.tla"), str(tmp_path / "ip.cfg")
    if extra:
        with pytest.raises(JCompileError) as ej:
            TpuExplorer(jload(spec, cfg, False), host_seen=True, chunk=64)
        with pytest.raises(TCompileError) as et:
            TorchExplorer(tload(spec, cfg), device="cpu", host_seen=True,
                          chunk=64)
        assert str(et.value) == str(ej.value)
        assert "uncompilable CONSTRAINT together with temporal" in \
            str(et.value)
        return
    rj = TpuExplorer(jload(spec, cfg, False), host_seen=True,
                     chunk=64).run()
    rt = TorchExplorer(tload(spec, cfg), device="cpu", host_seen=True,
                       chunk=64).run()
    assert _tup(rt, tformat) == _tup(rj, jformat)
    assert rt.ok is (which == "grow")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("C,p", [(1, 0.5), (257, 0.0), (4096, 0.3),
                                 (65536, 0.9)])
def test_edge_site_twin_matches_nonzero(seed, C, p):
    """K8 at the `edges` site is the stable partition of the kept mask,
    uncapped: its first `count` entries are np.nonzero of the mask, in
    order."""
    rng = np.random.default_rng(seed * 7919 + C)
    mask = rng.random(C) < p
    idx, sc = ops.resident_compact(torch.as_tensor(mask), C, site="edges")
    n = int(sc[0])
    want = np.nonzero(mask)[0]
    assert n == len(want)
    np.testing.assert_array_equal(idx[:n].numpy(), want)
    # the rest are the dropped entries, in order: a permutation
    assert sorted(idx.tolist()) == list(range(C))
