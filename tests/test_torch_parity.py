"""Whole runs of the torch level engine (TorchExplorer, device="cpu")
against the JAX level engine (TpuExplorer on the CPU): the verdict,
generated/distinct/diameter, the violation's kind and name, and the
trace's states and labels must be identical.  One level step of each
package from the same seen table and frontier (handed over with
jaxmc_torch.carry) must agree in every output field."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from jaxmc.backend.bfs import TpuExplorer
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.front.cfg import parse_cfg as jparse
from jaxmc.sem.values import fmt as jfmt
from jaxmc.sem.modules import Loader as JLoader, bind_model as jbind
from jaxmc_torch import carry
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.front.cfg import parse_cfg as tparse
from jaxmc_torch.sem.values import fmt as tfmt
from jaxmc_torch.sem.modules import Loader as TLoader, bind_model as tbind

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")

TRANSFER_SMALL = """SPECIFICATION Spec
INVARIANT AliceBounded
CONSTANTS
  Procs = {p1, p2}
  MaxMoney = 4
"""


def _models(spec, cfg_text=None, tweak=None):
    """(reference model, port model) of one spec and cfg text."""
    out = []
    for Loader, bind, parse in ((JLoader, jbind, jparse),
                                (TLoader, tbind, tparse)):
        cfg = parse(cfg_text) if cfg_text is not None else None
        if cfg is not None and tweak:
            tweak(cfg)
        mod = Loader([os.path.dirname(spec)]).load_path(spec)
        if cfg is None:
            from importlib import import_module
            pkg = "jaxmc" if bind is jbind else "jaxmc_torch"
            cfg = import_module(pkg + ".front.cfg").ModelConfig(
                specification="Spec")
        out.append(bind(mod, cfg))
    return out


def _cfg(name):
    with open(os.path.join(SPECS, name)) as fh:
        return fh.read()


def _assert_parity(rj, rt):
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert rt.truncated == rj.truncated
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name) == (vj.kind, vj.name)
        assert [lbl for _, lbl in vt.trace] == [lbl for _, lbl in vj.trace]
        # states of the two packages are values of two value domains:
        # compare them rendered, variable by variable
        assert [{k: tfmt(v) for k, v in st.items()} for st, _ in vt.trace] \
            == [{k: jfmt(v) for k, v in st.items()} for st, _ in vj.trace]
        assert tformat(vt) == jformat(vj)


def _run_both(mj, mt, **kw):
    rj = TpuExplorer(mj, **kw).run()
    rt = TorchExplorer(mt, device="cpu", **kw).run()
    _assert_parity(rj, rt)
    return rj, rt


@pytest.mark.parametrize("cfg", ["batchtoy_a.cfg", "batchtoy_b.cfg",
                                 "batchtoy_c.cfg", "batchtoy_d.cfg"])
def test_batchtoy_family(cfg):
    mj, mt = _models(os.path.join(SPECS, "batchtoy.tla"), _cfg(cfg))
    rj, _ = _run_both(mj, mt)
    assert rj.ok


def test_constoy():
    mj, mt = _models(os.path.join(SPECS, "constoy.tla"), _cfg("constoy.cfg"))
    rj, _ = _run_both(mj, mt)
    assert (rj.ok, rj.generated, rj.distinct, rj.diameter) == \
        (True, 43, 21, 5)


def test_batchtoy_bad_invariant_trace():
    mj, mt = _models(os.path.join(SPECS, "batchtoy.tla"),
                     _cfg("batchtoy_bad.cfg"))
    rj, rt = _run_both(mj, mt)
    assert rt.violation.kind == "invariant"
    assert (rt.generated, rt.distinct, len(rt.violation.trace)) == (6, 6, 6)


def test_constoy_assert_inside_constraint_refused_alike():
    """An Assert inside a CONSTRAINT does not compile (Assert in
    expression position); the reference level engine refuses the spec
    as one needing hybrid execution, and the port refuses it with the
    same message (host_seen=True runs it)."""
    from jaxmc.compile.vspec import ModeError as JModeError
    from jaxmc_torch.compile.vspec import ModeError as TModeError

    def tweak(cfg):
        cfg.constraints = ["AssertBound"]
    mj, mt = _models(os.path.join(SPECS, "constoy.tla"), _cfg("constoy.cfg"),
                     tweak)
    with pytest.raises(JModeError) as ej:
        TpuExplorer(mj)
    with pytest.raises(TModeError) as et:
        TorchExplorer(mt, device="cpu")
    assert str(et.value).startswith(str(ej.value))
    assert "Assert in expression position" in str(et.value)


def test_pcal_intro_buggy_assert_trace():
    mj, mt = _models(os.path.join(SPECS, "pcal_intro_buggy.tla"))
    rj, rt = _run_both(mj, mt)
    assert rt.violation.kind == "assert"
    assert (rt.generated, rt.distinct, len(rt.violation.trace)) == \
        (9040, 6135, 6)


@pytest.mark.parametrize("seen_mode", ["auto", "fingerprint"])
def test_transfer_scaled_reduced(tmp_path, seen_mode):
    cfg = tmp_path / "transfer_small.cfg"
    cfg.write_text(TRANSFER_SMALL)
    mj, mt = _models(os.path.join(SPECS, "transfer_scaled.tla"),
                     cfg.read_text())
    rj, rt = _run_both(mj, mt, seen_mode=seen_mode)
    assert rt.ok and rt.seen_mode == ("fingerprint" if seen_mode ==
                                      "fingerprint" else "exact")


def test_max_states_truncation():
    mj, mt = _models(os.path.join(SPECS, "transfer_scaled.tla"),
                     TRANSFER_SMALL)
    rj, rt = _run_both(mj, mt, max_states=100)
    assert rt.truncated and rt.distinct >= 100


def test_one_level_step_from_carried_state():
    """Two levels of transfer_scaled: each package's step runs from the
    same (seen, frontier), carried over as numpy; every output field of
    the port's step equals the reference's."""
    mj, mt = _models(os.path.join(SPECS, "transfer_scaled.tla"),
                     TRANSFER_SMALL)
    ej = TpuExplorer(mj)
    et = TorchExplorer(mt, device="cpu")
    # the lane plan handed over as numpy gives the port the same plan
    plan = carry.plan_from_numpy({k: np.array(getattr(ej.plan, k))
                                  for k in carry.PLAN_FIELDS})
    for name in ("word", "shift", "mask", "bias", "allowed", "sent_code",
                 "full"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(et.plan, name))
    et.plan, et.pt = plan, plan.tensors("cpu")

    init_rows, explored, n_init, err = ej._prepare_init(0.0, [])
    assert err is None
    keys, packed, _ = ej._host_keys(init_rows)
    FC, SC = 256, 4096
    seen = np.full((SC, ej.K), 2**31 - 1, np.int32)
    order = np.lexsort(tuple(keys[:, i] for i in reversed(range(ej.K))))
    seen[:n_init] = keys[order]
    frontier = np.full((FC, ej.PW), 2**31 - 1, np.int32)
    frontier[:len(explored)] = packed[explored]
    seen_count, fcount = n_init, len(explored)
    for _level in range(2):
        assert seen_count + ej.A * FC <= SC
        oj = ej._get_step(SC, FC)(jnp.asarray(seen), seen_count,
                                  jnp.asarray(frontier), fcount)
        s_t, sc_t, f_t, fc_t = carry.level_state_from_numpy(
            seen, seen_count, frontier, fcount, "cpu")
        ot = et.level_step(s_t, sc_t, f_t, fc_t)
        (ovc, a_any, _a, _f, d_any, _d, gen, front_count, seen_count2,
         inv_any, inv_idx, inv_which) = ot["scalars"].tolist()
        assert ovc == int(oj["overflow"])
        assert gen == int(oj["gen"])
        assert front_count == int(oj["front_count"])
        assert seen_count2 == int(oj["seen_count"])
        assert (inv_any, inv_idx, inv_which) == (
            int(oj["inv_bad_any"]), int(oj["inv_bad_idx"]),
            int(oj["inv_bad_which"]))
        assert a_any == int(np.asarray(oj["assert_bad"]).any())
        assert d_any == int(np.asarray(oj["dead"]).any())
        for name in ("seen", "front_rows", "front_prov", "dead",
                     "assert_bad"):
            np.testing.assert_array_equal(ot[name].numpy(),
                                          np.asarray(oj[name]),
                                          err_msg=name)
        seen = np.asarray(oj["seen"])
        seen_count = int(oj["seen_count"])
        frontier = np.full((FC, ej.PW), 2**31 - 1, np.int32)
        frontier[:front_count] = np.asarray(oj["front_rows"])[:front_count]
        fcount = front_count
        assert fcount > 0


@pytest.mark.parametrize("spec,cfg", [
    ("constoy.tla", "constoy.cfg"),
    ("pcal_intro_buggy.tla", None),
])
def test_sample_states_match_reference(spec, cfg):
    """The layout sample (engine/simulate.py sample_states, seeded
    random.Random(0)) is the same states in the same order in both
    packages, so both build the same lane plan from it."""
    from jaxmc.engine.simulate import sample_states as jsample
    from jaxmc_torch.engine.simulate import sample_states as tsample
    mj, mt = _models(os.path.join(SPECS, spec), _cfg(cfg) if cfg else None)
    sj, st = jsample(mj), tsample(mt)
    assert len(st) == len(sj) > 0
    assert [{k: tfmt(v) for k, v in s.items()} for s in st] == \
        [{k: jfmt(v) for k, v in s.items()} for s in sj]


@pytest.mark.parametrize("kind,name,message,n_states", [
    ("invariant", "Inv", "", 2),
    ("property", "Live", "stutters forever", 2),
    ("assert", "Assert", "x > 0", 1),
    ("deadlock", "Deadlock", "", 3),
    ("error", "seen-table overflow", "grow SC", 0),
    ("constraint-eval", "Bound", "", 1),
])
def test_format_trace_matches_reference(kind, name, message, n_states):
    """Every violation kind renders as the reference renders it: the
    heading, the state numbering and labels, and the sorted variables."""
    from jaxmc.engine.explore import Violation as JViolation
    from jaxmc_torch.engine.explore import Violation as TViolation
    trace = [({"y": i % 2 == 0, "x": i, "s": "ab"[i % 2]},
              "Initial predicate" if i == 0 else f"Step{i}")
             for i in range(n_states)]
    vj = JViolation(kind, name, trace, message)
    vt = TViolation(kind, name, trace, message)
    assert tformat(vt) == jformat(vj)


@pytest.mark.parametrize("spec,cfg,kw", [
    ("symtoy.tla", "symtoy.cfg", {}),
    ("viewtoy.tla", "viewtoy.cfg", {}),
    ("portoy.tla", "portoy.cfg", {"por": True}),
    ("portoy.tla", "portoy_bad.cfg", {"por": True}),
])
def test_reduction_modes_match_reference_with_traces(spec, cfg, kw):
    """SYMMETRY, VIEW and --por whole runs: verdict, counts and every
    trace state, rendered variable by variable."""
    def tweak(c):
        c.check_deadlock = not spec.startswith("symtoy")
    mj, mt = _models(os.path.join(SPECS, spec), _cfg(cfg), tweak)
    rj, rt = _run_both(mj, mt, **kw)
    assert rt.warnings == rj.warnings == []


@pytest.mark.slow
def test_transfer_scaled_full_pins():
    """The corpus pins (jaxmc/corpus.py): 153,701 distinct, 311,153
    generated, diameter 9, on both engines."""
    mj, mt = _models(os.path.join(SPECS, "transfer_scaled.tla"),
                     _cfg("transfer_scaled.cfg"))
    rj, rt = _run_both(mj, mt, store_trace=False)
    assert (rt.distinct, rt.generated, rt.diameter) == (153701, 311153, 9)
