"""The mesh's phase probe (MeshExplorer.probe_phase_walls) and the
scaling bench (`python -m jaxmc_torch.meshbench bench`), on the CPU.

- At D = 2 on constoy, after a run, the port's probe gives the
  reference's result keys, level counts, `mesh.phase_*` gauge names and
  per-level `mesh.phase_walls` event keys.  The reference runs through
  mesh_oracle's `check_rep` -> `check_vma` rename; its probe's own
  shard_maps pass neither keyword, and on this jax the default
  `check_vma=True` rejects their scan carries, so the fixture passes
  `check_vma=False` there (how the reference's call is made, not what it
  computes; no file of jaxmc/ is edited).
- On constoy and symtoy_scaled the probe's rank merge and full-sort
  merge give equal outputs on the same inputs at every probed level,
  and the probe consumes no counts (a run after it is unchanged).
- `meshbench bench --device cpu --devices 1,2` on constoy writes a valid
  jaxmc.multichip/1 artifact whose points carry phase_walls, and passes
  its gates.  Walls are never compared."""

import inspect
import json

import numpy as np
import pytest
import torch

from mesh_oracle import one_torch_thread, spec_path  # noqa: F401

PROBE_GAUGES = {"mesh.phase_levels", "mesh.phase_expand_s",
                "mesh.phase_exchange_s", "mesh.phase_merge_s",
                "mesh.phase_merge_rank_s", "mesh.phase_merge_fullsort_s"}


@pytest.fixture
def jax_probe_mesh(monkeypatch, tmp_path):
    import jax
    from jax.sharding import Mesh
    from jaxmc.backend import mesh as jm

    monkeypatch.setenv("JAXMC_PROFILE_STORE", str(tmp_path / "prof"))
    sm = getattr(jax, "shard_map", None)
    if sm is not None and \
            "check_rep" not in inspect.signature(sm).parameters:
        orig = jm.MeshExplorer._shard_map

        def renaming(self):
            inner = orig(self)

            def wrapped(f, **kw):
                kw["check_vma"] = kw.pop("check_rep", False)
                return inner(f, **kw)
            return wrapped
        monkeypatch.setattr(jm.MeshExplorer, "_shard_map", renaming)

    def make(model, D, **kw):
        kw.setdefault("cap_profile", False)
        mesh = Mesh(np.array(jax.devices()[:D]), ("d",))
        return jm.MeshExplorer(model, mesh=mesh, **kw)

    return make


def _probe_events(tel):
    return [e for e in tel.recent_events() if e["ev"] == "mesh.phase_walls"]


def test_probe_matches_reference_keys(jax_probe_mesh, one_torch_thread):
    from jaxmc import obs as jobs
    from jaxmc.session import load_model as jload
    from jaxmc_torch import obs as tobs
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.session import load_model as tload
    spec, cfg = spec_path("constoy.tla"), spec_path("constoy.cfg")
    jtel = jobs.Telemetry()
    with jobs.use(jtel):
        jme = jax_probe_mesh(jload(spec, cfg, False), 2, store_trace=False)
        rj = jme.run()
        pj = jme.probe_phase_walls()
    ttel = tobs.reset()
    tme = MeshExplorer(tload(spec, cfg), shards=2, device="cpu",
                       store_trace=False)
    rt = tme.run()
    pt = tme.probe_phase_walls()
    assert (rt.distinct, rt.generated) == (rj.distinct, rj.generated)
    assert set(pt) == set(pj)
    assert (pt["levels"], pt.get("step_levels")) == \
        (pj["levels"], pj.get("step_levels"))
    assert pt["merge_s"] == pt["merge_rank_s"]
    tg = {k for k in ttel.gauges if k.startswith("mesh.phase_")}
    jg = {k for k in jtel.gauges if k.startswith("mesh.phase_")}
    assert tg == jg and PROBE_GAUGES <= tg
    assert ttel.gauges["mesh.phase_levels"] == pt["levels"]
    te, je = _probe_events(ttel), _probe_events(jtel)
    assert [e["level"] for e in te] == [e["level"] for e in je]
    assert [sorted(set(e) - {"t", "tid"}) for e in te] == \
        [sorted(set(e) - {"t", "tid"}) for e in je]
    assert len(te) >= pt["levels"]


@pytest.mark.parametrize("spec,cfg,nd", [
    ("constoy.tla", "constoy.cfg", False),
    ("symtoy_scaled.tla", "symtoy_scaled.cfg", True),
], ids=["constoy", "symtoy_scaled"])
def test_probe_merges_agree_and_consume_no_counts(spec, cfg, nd,
                                                  monkeypatch,
                                                  one_torch_thread):
    from jaxmc_torch import obs as tobs
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.session import load_model as tload
    calls = []
    real = MeshExplorer._merge

    def spy(self, *a, merge=None, **kw):
        out = real(self, *a, merge=merge, **kw)
        calls.append((merge, out))
        return out

    tobs.reset()
    me = MeshExplorer(tload(spec_path(spec), spec_path(cfg),
                            no_deadlock=nd), shards=2, device="cpu",
                      store_trace=False)
    r1 = me.run()
    monkeypatch.setattr(MeshExplorer, "_merge", spy)
    out = me.probe_phase_walls()
    monkeypatch.undo()
    assert out["levels"] >= 1
    probe = [c for c in calls if c[0] is not None]
    # one merge per shard and strategy: the warm-up pass and each level
    assert len(probe) == 2 * 2 * (out["levels"] + 1) or \
        len(probe) == 2 * 2 * (out["levels"] + 2)
    ranks = [o for m, o in probe if m == "rank"]
    fulls = [o for m, o in probe if m == "fullsort"]
    for a, b in zip(ranks, fulls):
        n = int(a["seen_count2"])
        assert n == int(b["seen_count2"])
        assert torch.equal(a["seen2"][:n], b["seen2"][:n])
        f = int(a["front_count"])
        assert f == int(b["front_count"])
        assert torch.equal(a["front_rows"][:f], b["front_rows"][:f])
        assert torch.equal(a["front_src"][:f], b["front_src"][:f])
    r2 = me.run()
    assert (r2.distinct, r2.generated, r2.diameter) == \
        (r1.distinct, r1.generated, r1.diameter)


def test_meshbench_bench_writes_the_artifact(tmp_path, capsys, monkeypatch):
    from jaxmc.obs.report import load_record
    from jaxmc_torch.meshbench import main
    # the children's torch pools share the box with other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = main(["bench", "--devices", "1,2", "--rung", "specs/constoy.tla",
               "--device", "cpu", "--out-dir", str(tmp_path),
               "--timeout", "240"])
    out = capsys.readouterr().out
    assert rc == 0, out
    path = tmp_path / "jaxmc_torch_multichip.json"
    assert f"meshbench: wrote {path} (ok, 1 rungs)" in out
    art = json.loads(path.read_text())
    assert art["schema"] == "jaxmc.multichip/1" and art["ok"]
    assert art["platform"] == "cpu" and art["devices_swept"] == [1, 2]
    (rung,) = art["rungs"]
    assert rung["rung"] == "constoy"
    for D, pt in zip((1, 2), rung["curve"]):
        assert pt["devices"] == D
        assert (pt["distinct"], pt["generated"]) == (21, 43)
        assert pt["window_recompiles"] == 0
        assert pt["host_syncs"] <= pt["levels"]
        pw = pt["phase_walls"]
        assert {"levels", "expand_s", "exchange_s", "merge_rank_s",
                "merge_fullsort_s", "merge_s"} <= set(pw)
        # no kernel runs on the CPU: the probe's launches are all 0
        assert not any(pt["phase_launches"].values())
    assert rung["curve"][0]["exchange"] == "gather"
    assert rung["curve"][1]["exchange"] == "a2a"
    # the reference's reader takes the artifact as a multichip record
    rec = load_record(str(path))
    assert rec["kind"] == "multichip"
    assert set(rec["curve"]) == {"constoy@D1", "constoy@D2"}
    assert "MESHBENCH point constoy D=1" in out
