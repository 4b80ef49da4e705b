"""The torch port's MeshExplorer against the JAX reference's under a
device seen cap (--seen-cap on ooc_scaled, the corpus's out-of-core
rung, at the reference's acceptance settings: cap 512, a host budget of
1,024 keys): the per-shard tier spills, the disk flushes, the cold-tier
filter and the counts; and the a2a bucket factor's growth redo
(tests/mesh_oracle.py run_both).  Bit-exact."""

import pytest

from mesh_oracle import (jax_mesh, one_torch_thread, run_both,  # noqa: F401
                         spec_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_seen_tiers_match_reference(jax_mesh):
    """--seen-cap on the mesh: each shard's device tier is the cap over
    D; when one fills, every shard's sorted prefix spills to the cold
    tiers and the level is redone, and the cold-tier filter drops
    frontier rows whose keys were spilled — the same spills, flushes,
    tier sizes and counts as the reference's."""
    _, rt, _ = run_both(jax_mesh, spec_path("ooc_scaled.tla"), D=2,
                        seen_cap=512, host_tier_keys=1024)
    assert (rt.generated, rt.distinct) == (12289, 3072)
    assert rt.tiers["spills"] > 0 and rt.tiers["disk_keys"] > 0


def test_gamma_growth_matches_reference(jax_mesh):
    """A bucket factor far below the need: the a2a buckets and their
    spill overflow at the first level, which is rolled back and redone
    with gamma grown straight to the observed per-destination need."""
    _, _, ttel = run_both(jax_mesh, spec_path("pcal_intro_buggy.tla"), D=4,
                          gamma=0.05)
    assert any("gamma->" in (lv.get("redo") or "") for lv in ttel.levels)
    assert ttel.gauges["mesh.a2a_gamma"] > 0.05
