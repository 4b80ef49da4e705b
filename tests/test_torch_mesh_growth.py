"""The torch port's MeshExplorer against the JAX reference's where the
mesh grows, spills and resumes: a pinned small valid-candidate block
(VC growth), the mesh_skew fault sized into the a2a spill window, and a
truncation checkpoint resumed to the full run's counts and trace — in
both packages.  Bit-exact (tests/mesh_oracle.py run_both)."""

import pytest

from jaxmc import faults as jfaults
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import load_model as jload
from jaxmc_torch import faults as tfaults
from jaxmc_torch.backend.mesh import MeshExplorer
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.session import load_model as tload
from mesh_oracle import (jax_mesh, one_torch_thread, run_both,  # noqa: F401
                         spec_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_vc_growth_matches_reference(jax_mesh, monkeypatch):
    """JAXMC_MESH_VC pins a small valid-candidate block: the VC growth
    redo follows the observed need, as the reference's."""
    monkeypatch.setenv("JAXMC_MESH_VC", "64")
    _, _, ttel = run_both(jax_mesh, spec_path("pcal_intro_buggy.tla"), D=2)
    assert any("VC->" in (lv.get("redo") or "") for lv in ttel.levels)


@pytest.fixture
def skewed(monkeypatch):
    """The mesh_skew fault armed for two engine builds (the packages
    share its budget through JAXMC_FAULTS_STATE: one build each)."""
    def arm():
        monkeypatch.setenv("JAXMC_FAULTS", "mesh_skew:n=2")
        monkeypatch.delenv("JAXMC_FAULTS_STATE", raising=False)
        for f in (jfaults, tfaults):
            f.reset_for_tests()
    yield arm
    for f in (jfaults, tfaults):
        f.reset_for_tests()


def test_mesh_skew_forced_spill_matches_reference(jax_mesh, skewed):
    """The mesh_skew fault routes every state to shard 0.  A first run
    measures the widest destination bucket; a second pins FC and sizes
    gamma so that bucket lands in the spill window (B < need <= B + SB),
    as the reference's TestForcedSpill does: the spill buckets drain it,
    and counts, trace, spill rows and gamma equal the reference's."""
    spec = spec_path("pcal_intro_buggy.tla")
    skewed()
    _, r1, tel1 = run_both(jax_mesh, spec, D=4)
    assert tel1.gauges["mesh.shard_balance"] == 4.0
    assert tel1.gauges["mesh.a2a_spill"] == 0
    lv = [(r["max_bucket"], r["fc"]) for r in tel1.levels
          if r.get("max_bucket")]
    fcmax = max(fc for _, fc in lv)
    mb = max(v for v, _ in lv)
    A = MeshExplorer(tload(spec), shards=4, device="cpu").A
    skewed()
    _, r2, tel2 = run_both(jax_mesh, spec, D=4,
                           gamma=(mb - 1) * 4 / (A * fcmax),
                           mesh_caps={"SC": 1 << 15, "FC": fcmax,
                                      "TRL": 16, "GAM16": 1})
    assert tel2.gauges["mesh.a2a_spill"] > 0
    assert [s for s, _ in r2.violation.trace] == \
        [s for s, _ in r1.violation.trace]


def test_truncate_checkpoint_resume_matches_reference(jax_mesh, tmp_path):
    """A truncation leaves a mesh checkpoint; the resumed run finishes
    with the uninterrupted run's counts and trace, in both packages."""
    spec = spec_path("pcal_intro_buggy.tla")
    full = MeshExplorer(tload(spec), shards=4, device="cpu").run()
    for tag in ("ref", "port"):
        ck = str(tmp_path / f"{tag}.ck")
        kw = dict(max_states=2000, checkpoint_path=ck)
        if tag == "ref":
            r1 = jax_mesh(jload(spec, None, False), 4, **kw).run()
            r2 = jax_mesh(jload(spec, None, False), 4, resume_from=ck).run()
            fmt = jformat
        else:
            r1 = MeshExplorer(tload(spec), shards=4, device="cpu",
                              **kw).run()
            r2 = MeshExplorer(tload(spec), shards=4, device="cpu",
                              resume_from=ck).run()
            fmt = tformat
        assert r1.truncated and (r1.generated, r1.distinct) == (2800, 2400)
        assert (r2.generated, r2.distinct, r2.violation.kind) == \
            (full.generated, full.distinct, "assert")
        assert fmt(r2.violation) == tformat(full.violation)
    # each package resumes the other's checkpoint: one payload, one
    # layout signature
    r3 = MeshExplorer(tload(spec), shards=4, device="cpu",
                      resume_from=str(tmp_path / "ref.ck")).run()
    assert tformat(r3.violation) == tformat(full.violation)
    r4 = jax_mesh(jload(spec, None, False), 4,
                  resume_from=str(tmp_path / "port.ck")).run()
    assert jformat(r4.violation) == tformat(full.violation)
