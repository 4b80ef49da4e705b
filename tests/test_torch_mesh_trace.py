"""The torch port's MeshExplorer against the JAX reference's on
pcal_intro_buggy: its assert violation and counterexample trace, and the
growth redos from the small starting caps (FC, SC, VC), at D = 2 and 4
on both exchanges and both merges (the shared surfaces of
tests/mesh_oracle.py run_both).  Bit-exact."""

import pytest

from mesh_oracle import (jax_mesh, one_torch_thread, run_both,  # noqa: F401
                         spec_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("D,exchange,merge", [
    (2, "a2a", "rank"), (4, "gather", "rank"), (2, "gather", "fullsort"),
    (4, "a2a", "fullsort")])
def test_pcal_intro_buggy_trace_matches_reference(jax_mesh, monkeypatch, D,
                                                  exchange, merge):
    """The assert violation, its trace and the growth from the small
    starting caps (FC, SC, VC) — the rank merge's VC growth included."""
    if merge == "fullsort":
        monkeypatch.setenv("JAXMC_MESH_RANKMERGE", "0")
    _, rt, ttel = run_both(jax_mesh, spec_path("pcal_intro_buggy.tla"), D=D,
                           exchange=exchange)
    assert (rt.generated, rt.distinct) == (9040, 6135)
    assert rt.violation.kind == "assert" and len(rt.violation.trace) == 6
    assert any(lv.get("redo") for lv in ttel.levels)
