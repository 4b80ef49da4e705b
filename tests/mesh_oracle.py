"""The JAX reference's MeshExplorer as a test oracle for the torch port,
shared by tests/test_torch_mesh*.py.

`jax_mesh` is a pytest fixture: a factory that builds the reference's
MeshExplorer over the first D virtual CPU devices (tests/conftest.py
makes 8), with capacity profiles off.  The reference's resident step
calls `shard_map(..., check_rep=False)` (jaxmc/backend/mesh.py:1291,
:1459); jax releases that renamed the keyword to `check_vma` reject it.
Only then, the fixture monkeypatches MeshExplorer._shard_map with a
wrapper that passes the same flag under the new name.  It changes how
the reference's own call is made, not what it computes, and no file of
jaxmc/ is edited.

`run_both` runs one model through the reference and the port and
asserts that every compared surface agrees."""

import inspect
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

MESH_GAUGES = ("mesh.exchange", "mesh.devices", "mesh.merge",
               "mesh.a2a_gamma", "mesh.a2a_spill", "mesh.a2a_max_bucket",
               "mesh.shard_balance", "fingerprint.occupancy")
POR_COUNTERS = ("por.ample_states", "por.full_states")
POR_GAUGES = ("por.enabled", "por.engine", "por.ample_ratio",
              "por.device_masked_arms", "por.reduced_states",
              "por.disabled_reason")


def _renaming(shard_map):
    def wrapped(f, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        return shard_map(f, **kw)
    return wrapped


@pytest.fixture
def jax_mesh(monkeypatch, tmp_path):
    import jax
    from jax.sharding import Mesh
    from jaxmc.backend import mesh as jm

    monkeypatch.setenv("JAXMC_PROFILE_STORE", str(tmp_path / "prof"))
    sm = getattr(jax, "shard_map", None)
    if sm is not None and \
            "check_rep" not in inspect.signature(sm).parameters:
        orig = jm.MeshExplorer._shard_map
        monkeypatch.setattr(jm.MeshExplorer, "_shard_map",
                            lambda self: _renaming(orig(self)))

    def make(model, D, **kw):
        kw.setdefault("cap_profile", False)
        mesh = Mesh(np.array(jax.devices()[:D]), ("d",))
        return jm.MeshExplorer(model, mesh=mesh, **kw)

    return make


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU runs on one intra-op thread: several test workers
    share the machine, and oversubscribed OpenMP pools stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_path(name):
    return os.path.join(SPECS, name)


def _grew(lines):
    return [ln for ln in lines if ln.startswith("-- mesh: growing")]


def run_both(jax_mesh, spec, cfg=None, D=2, exchange="a2a",
             no_deadlock=False, gamma=None, **kw):
    """The reference and the port on the same model; verdict, counts,
    trace, warnings, growth lines, mesh.* gauges and por.* counters must
    agree.  Returns (reference result, port result, port telemetry)."""
    from jaxmc import obs as jobs
    from jaxmc.engine.explore import format_trace as jformat
    from jaxmc.session import load_model as jload
    from jaxmc_torch import obs as tobs
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.engine.explore import format_trace as tformat
    from jaxmc_torch.session import load_model as tload
    jlog, tlog = [], []
    tel = jobs.Telemetry()
    with jobs.use(tel):
        jm = jax_mesh(jload(spec, cfg, no_deadlock), D, exchange=exchange,
                      log=jlog.append, **kw)
        if gamma is not None:
            jm._a2a_gamma = gamma
        rj = jm.run()
    ttel = tobs.reset()
    tm = MeshExplorer(tload(spec, cfg, no_deadlock=no_deadlock), shards=D,
                      device="cpu", exchange=exchange, log=tlog.append, **kw)
    if gamma is not None:
        tm._a2a_gamma = gamma
    rt = tm.run()
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter, rt.truncated) \
        == (rj.ok, rj.generated, rj.distinct, rj.diameter, rj.truncated)
    assert rt.warnings == rj.warnings
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name, vt.message) == (vj.kind, vj.name,
                                                  vj.message)
        assert tformat(vt) == jformat(vj)
    assert _grew(tlog) == _grew(jlog)
    for name in MESH_GAUGES + POR_GAUGES:
        assert ttel.gauges.get(name) == tel.gauges.get(name), name
    for name in POR_COUNTERS:
        assert ttel.counters.get(name) == tel.counters.get(name), name
    if rj.tiers is not None:
        drop = ("probe_wall_s",)
        assert {k: v for k, v in rt.tiers.items() if k not in drop} == \
            {k: v for k, v in rj.tiers.items() if k not in drop}
    # one level per dispatch: one host read per level record, and one
    # for a level that stops on a deadlock or an assert before its record
    v = rt.violation
    extra = int(v is not None and v.kind in ("deadlock", "assert"))
    assert ttel.counters["mesh.host_syncs"] == len(ttel.levels) + extra
    return rj, rt, ttel
