"""Device partial-order reduction (--por) on the torch level engine
against the JAX reference: the persistent-set mask twin against
bfs._por_mask on inputs made from a numpy seed, one level step from a
carried state, and whole runs against TpuExplorer(por=True) with their
verdicts, counts, traces, warnings and por.* counters.  Bit-exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc import obs as jobs
from jaxmc.backend.bfs import TpuExplorer, _por_mask
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import load_model as jload
from jaxmc_torch import carry, obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")
SENT = 2**31 - 1

POR_COUNTERS = ("por.ample_states", "por.full_states")
POR_GAUGES = ("por.enabled", "por.engine", "por.ample_ratio",
              "por.device_masked_arms", "por.reduced_states",
              "por.disabled_reason")


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


@pytest.mark.parametrize("seed,inst_arm,n_arms", [
    (1, [0, 1, 2, 3], 4),
    # slotted kernels give one instance row per slot: arms repeat
    (2, [0, 0, 0, 1, 2, 2, 3, 4, 4, 4, 4], 5),
    (3, [2, 2, 0, 1, 1, 3], 6),
])
@pytest.mark.parametrize("FC", [1, 37, 256])
def test_por_mask_twin_matches_reference(seed, inst_arm, n_arms, FC):
    rng = np.random.default_rng(seed * 1000 + FC)
    A = len(inst_arm)
    inst = np.asarray(inst_arm, np.int32)
    for trial in range(4):
        cvalid = rng.random(A * FC) < (0.2, 0.5, 0.9, 1.0)[trial]
        found = rng.random(A * FC) < (0.1, 0.3, 0.05, 0.5)[trial]
        safe = rng.random(n_arms) < 0.6
        safe[rng.integers(0, n_arms)] = True
        kj, aj, ej = _por_mask(jnp.asarray(found), jnp.asarray(cvalid),
                               jnp.asarray(inst), jnp.asarray(safe), A, FC)
        args = (torch.as_tensor(found), torch.as_tensor(cvalid),
                torch.as_tensor(inst), torch.as_tensor(safe), A, FC)
        for f in (ops.por_mask_twin, ops.por_mask):
            kt, at, et, mt = f(*args)
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            assert (int(at), int(et)) == (int(aj), int(ej))
            assert int(mt) == int(np.sum(cvalid & ~np.asarray(kj)))


def test_por_mask_refuses_more_arms_than_the_kernel_takes():
    n = ops.POR_MAX_ARMS + 1
    with pytest.raises(ValueError, match="at most"):
        ops.por_mask(torch.zeros(1, dtype=torch.bool),
                     torch.zeros(1, dtype=torch.bool),
                     torch.zeros(1, dtype=torch.int32),
                     torch.zeros(n, dtype=torch.bool), 1, 1)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def run_both(spec, cfg, no_deadlock=False, **kw):
    tel = jobs.Telemetry()
    with jobs.use(tel):
        rj = TpuExplorer(jload(spec, cfg, no_deadlock), **kw).run()
    ttel = tobs.reset()
    rt = TorchExplorer(tload(spec, cfg, no_deadlock=no_deadlock),
                       device="cpu", **kw).run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert rt.warnings == rj.warnings
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name) == (vj.kind, vj.name)
        assert tformat(vt) == jformat(vj)
    for name in POR_COUNTERS:
        assert ttel.counters.get(name) == tel.counters.get(name), name
    for name in POR_GAUGES:
        assert ttel.gauges.get(name) == tel.gauges.get(name), name
    return rj, rt, ttel


@pytest.mark.parametrize("cfg,no_deadlock,kind", [
    ("portoy.cfg", False, "deadlock"),
    ("portoy_ok.cfg", True, None),
    ("portoy_bad.cfg", False, "invariant"),
])
def test_portoy_with_por_matches_reference(cfg, no_deadlock, kind):
    rj, rt, tel = run_both(_spec("portoy.tla"), _spec(cfg), no_deadlock,
                           por=True)
    assert (rt.violation.kind if rt.violation else None) == kind
    assert tel.gauges["por.enabled"] is True
    if kind is None:
        assert (rt.generated, rt.distinct) == (14, 14)
        assert tel.counters["por.ample_states"] > 0


def test_msgstoy_with_por_matches_reference():
    """msgstoy's Send arms are slotted over the message table: several
    instance rows map to one arm in the plan's inst_arm."""
    rj, rt, tel = run_both(_spec("msgstoy.tla"), _spec("msgstoy.cfg"),
                           True, por=True)
    assert rt.ok and rt.distinct < 324
    assert tel.gauges["por.device_masked_arms"] > 0


def test_por_with_symmetry_is_refused_as_in_reference():
    rj, rt, tel = run_both(_spec("symtoy.tla"), _spec("symtoy.cfg"), True,
                           por=True)
    assert rt.warnings == ["--por requested but reduction disabled: "
                           "cfg SYMMETRY (two reductions would compose "
                           "unsoundly) (running unreduced)"]
    assert (rt.generated, rt.distinct) == (33, 22)
    assert tel.gauges["por.enabled"] is False


def test_por_with_independence_off_is_refused_as_in_reference(monkeypatch):
    monkeypatch.setenv("JAXMC_ANALYZE_INDEP", "0")
    rj, rt, _ = run_both(_spec("portoy.tla"), _spec("portoy_ok.cfg"), True,
                         por=True)
    assert "JAXMC_ANALYZE_INDEP=0" in rt.warnings[0]
    assert (rt.generated, rt.distinct) == (366, 150)


def test_one_por_level_step_from_carried_state():
    """Each package's level step from the same seen table and frontier
    (carried as numpy), with the POR filter on: every output field and
    the three POR counts agree."""
    spec, cfg = _spec("msgstoy.tla"), _spec("msgstoy.cfg")
    ej = TpuExplorer(jload(spec, cfg, True), por=True)
    et = TorchExplorer(tload(spec, cfg, no_deadlock=True), device="cpu",
                       por=True)
    assert ej._por_plan() is not None and et._por_plan() is not None
    np.testing.assert_array_equal(et._por_memo["inst_arm"],
                                  ej._por_memo["inst_arm"])
    np.testing.assert_array_equal(et._por_memo["arm_safe"],
                                  ej._por_memo["arm_safe"])
    init_rows, explored, n_init, err = ej._prepare_init(0.0, [])
    keys, packed, _ = ej._host_keys(init_rows)
    FC, SC = 256, 8192
    seen = np.full((SC, ej.K), SENT, np.int32)
    order = np.lexsort(tuple(keys[:, i] for i in reversed(range(ej.K))))
    seen[:n_init] = keys[order]
    frontier = np.full((FC, ej.PW), SENT, np.int32)
    frontier[:len(explored)] = packed[explored]
    seen_count, fcount = n_init, len(explored)
    masked = 0
    for _level in range(4):
        assert seen_count + ej.A * FC <= SC
        oj = ej._get_step(SC, FC)(jnp.asarray(seen), seen_count,
                                  jnp.asarray(frontier), fcount)
        ot = et.level_step(*carry.level_state_from_numpy(
            seen, seen_count, frontier, fcount, "cpu"))
        vals = ot["scalars"].tolist()
        assert vals[6:9] == [int(oj["gen"]), int(oj["front_count"]),
                             int(oj["seen_count"])]
        assert vals[12:] == [int(oj["por_ample"]), int(oj["por_expanded"]),
                             int(oj["por_masked"])]
        masked += vals[14]
        for name in ("seen", "front_rows", "front_prov"):
            np.testing.assert_array_equal(ot[name].numpy(),
                                          np.asarray(oj[name]),
                                          err_msg=name)
        seen = np.asarray(oj["seen"])
        seen_count = int(oj["seen_count"])
        frontier = np.full((FC, ej.PW), SENT, np.int32)
        frontier[:vals[7]] = np.asarray(oj["front_rows"])[:vals[7]]
        fcount = vals[7]
    assert masked > 0


def test_cli_por_prints_the_reduced_counts(capsys):
    from jaxmc_torch.cli import main
    rc = main(["check", _spec("portoy.tla"), "--cfg", _spec("portoy_ok.cfg"),
               "--device", "cpu", "--no-deadlock", "--por"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "-- por: " in out
    assert "14 states generated, 14 distinct states found" in out
