"""The mesh engine's host loop and its single-shard form, held against
the torch port's own engines: the JAX reference's mesh host loop does
not run on this jax (its scan carry types differ; ROADMAP C.1), so

  * temporal and refinement PROPERTYs (which force the host loop) on
    transfer_props at MaxMoney 3, D = 2, against the port's level
    engine: verdict, property name, counts, diameter, trace length;
  * the host loop (JAXMC_MESH_RESIDENT=0, both exchanges) against the
    resident loop: counts and traces equal;
  * D = 1 against the level engine on models with and without a
    violation;
  * a drain (resident loop) and a truncation (host loop) checkpoint
    resumed to the uninterrupted run.

Exact (tolerance 0)."""

import os

import pytest
import torch

from jaxmc_torch import obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.backend.mesh import MeshExplorer
from jaxmc_torch.engine.explore import format_trace
from jaxmc_torch.session import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
FIX = os.path.join(ROOT, "jaxmc_torch", "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs on one intra-op thread: several test workers
    share the machine, and oversubscribed OpenMP pools stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(r, trace=True):
    v = r.violation
    return (r.ok, r.generated, r.distinct, r.diameter, v and v.kind,
            v and v.name, v and len(v.trace),
            v and format_trace(v) if trace else None)


def _props_model(name, tmp_path):
    with open(os.path.join(FIX, f"transfer_props_{name}.cfg")) as fh:
        cfg = fh.read().replace("MaxMoney = 12", "MaxMoney = 3")
    path = tmp_path / f"transfer_props_{name}.cfg"
    path.write_text(cfg)
    return lambda: load_model(os.path.join(FIX, "transfer_props.tla"),
                              str(path), includes=(SPECS,))


@pytest.mark.parametrize("name,want", [
    ("monotone", (True, None)), ("frozen", (False, "Frozen")),
    ("live", (True, None)), ("nolive", (False, "AllDone"))])
@pytest.mark.parametrize("exchange", ["a2a", "gather"])
def test_property_verdicts_match_the_level_engine(tmp_path, name, want,
                                                  exchange):
    make = _props_model(name, tmp_path)
    tobs.reset()
    lvl = TorchExplorer(make(), device="cpu").run()
    tel = tobs.reset()
    log = []
    mr = MeshExplorer(make(), shards=2, device="cpu", exchange=exchange,
                      log=log.append).run()
    assert (mr.ok, mr.violation and mr.violation.name) == want
    # the per-level state order differs between the two engines (key
    # order on the mesh, provenance order on the level engine), so a
    # refinement trace may take another path of the same length
    assert _summary(mr, trace=False) == _summary(lvl, trace=False)
    assert mr.warnings[1:] == lvl.warnings[1:]
    assert any("loop=host" in ln for ln in log)
    assert tel.counters.get("mesh.host_syncs") is None


@pytest.mark.parametrize("spec,cfg,exchange", [
    ("pcal_intro_buggy.tla", None, "a2a"),
    ("pcal_intro_buggy.tla", None, "gather"),
    ("batchtoy.tla", "batchtoy_bad.cfg", "a2a"),
    ("constoy.tla", None, "gather")])
def test_host_loop_matches_the_resident_loop(monkeypatch, spec, cfg,
                                             exchange):
    def run():
        m = load_model(os.path.join(SPECS, spec),
                       cfg and os.path.join(SPECS, cfg))
        return MeshExplorer(m, shards=2, device="cpu",
                            exchange=exchange).run()

    res = run()
    monkeypatch.setenv("JAXMC_MESH_RESIDENT", "0")
    host = run()
    assert _summary(host) == _summary(res)


def test_host_loop_refuses_por_by_name(monkeypatch):
    monkeypatch.setenv("JAXMC_MESH_RESIDENT", "0")
    m = load_model(os.path.join(SPECS, "portoy.tla"),
                   os.path.join(SPECS, "portoy_ok.cfg"), no_deadlock=True)
    r = MeshExplorer(m, shards=2, device="cpu", por=True).run()
    assert any("mesh host loop active" in w for w in r.warnings)
    ref = TorchExplorer(load_model(os.path.join(SPECS, "portoy.tla"),
                                   os.path.join(SPECS, "portoy_ok.cfg"),
                                   no_deadlock=True), device="cpu").run()
    assert (r.generated, r.distinct) == (ref.generated, ref.distinct)


@pytest.mark.parametrize("spec,cfg,no_deadlock", [
    ("transfer_scaled.tla", None, False),
    ("pcal_intro_buggy.tla", None, False),
    ("symtoy.tla", "symtoy.cfg", True),
    ("batchtoy.tla", "batchtoy_bad.cfg", False)])
def test_one_shard_matches_the_level_engine(spec, cfg, no_deadlock):
    """D = 1: counts and verdicts equal to the level engine's; the one
    shard's exchange is the gather of its own block."""
    def make():
        return load_model(os.path.join(SPECS, spec),
                          cfg and os.path.join(SPECS, cfg),
                          no_deadlock=no_deadlock)

    lvl = TorchExplorer(make(), device="cpu").run()
    me = MeshExplorer(make(), shards=1, device="cpu")
    assert me.exchange == "gather"
    mr = me.run()
    assert _summary(mr, trace=False)[:7] == _summary(lvl, trace=False)[:7]


@pytest.mark.parametrize("resident", [True, False])
def test_drain_at_a_level_boundary_then_resume(monkeypatch, tmp_path,
                                               resident):
    """A drain request stops the mesh at the next level boundary with a
    checkpoint (the resident loop) and the resume finishes with the
    uninterrupted run's verdict, counts and trace; the host loop's
    truncation checkpoint resumes the same way."""
    from jaxmc_torch import drain
    spec = os.path.join(SPECS, "pcal_intro_buggy.tla")
    full = MeshExplorer(load_model(spec), shards=4, device="cpu").run()
    ck = str(tmp_path / "m.ck")
    if not resident:
        monkeypatch.setenv("JAXMC_MESH_RESIDENT", "0")
        r1 = MeshExplorer(load_model(spec), shards=4, device="cpu",
                          max_states=2000, checkpoint_path=ck).run()
        assert r1.truncated and not r1.drained
    else:
        def log(line):
            if line.startswith("Progress(3)"):
                drain.request("test drain")

        drain.clear()
        try:
            r1 = MeshExplorer(load_model(spec), shards=4, device="cpu",
                              checkpoint_path=ck, progress_every=0.0,
                              log=log).run()
        finally:
            drain.clear()
        assert r1.drained and r1.trunc_reason == "drain"
        assert f"run drained before completion (test drain); resume " \
               f"with --resume {ck}" in r1.warnings
    assert 0 < r1.distinct < full.distinct
    r2 = MeshExplorer(load_model(spec), shards=4, device="cpu",
                      resume_from=ck).run()
    assert _summary(r2) == _summary(full)
