"""The sharded mesh engine of the torch port (MeshExplorer with D shards
on one device) against the JAX reference's (MeshExplorer over D virtual
CPU devices, cap_profile=False) on JAX's CPU: both exchanges, both
merges, at D = 2 and 4 — verdict, generated, distinct, diameter, the
violation's name and trace, warnings, the `-- mesh: growing` lines, the
mesh.* gauges and the por.* counters.  Bit-exact (tolerance 0).

The reference's resident step passes `check_rep=` to shard_map, which
this jax names `check_vma=`; the `jax_mesh` fixture renames the keyword
on the test side (no file of jaxmc/ changes).  Where the reference does
not run here (its host loop; the skewed spill past its buckets), the
port is held against its own level engine instead
(tests/test_torch_mesh_host.py).  pcal_intro_buggy's trace is held in
tests/test_torch_mesh_trace.py, growth, spill and resume in
tests/test_torch_mesh_growth.py."""

import numpy as np
import pytest
import torch

from jaxmc_torch.backend.mesh import MeshExplorer
from jaxmc_torch.session import load_model as tload
from mesh_oracle import (jax_mesh, one_torch_thread, run_both,  # noqa: F401
                         spec_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("merge", ["rank", "fullsort"])
@pytest.mark.parametrize("exchange", ["a2a", "gather"])
@pytest.mark.parametrize("D", [2, 4])
def test_constoy_matches_reference(jax_mesh, monkeypatch, D, exchange,
                                   merge):
    if merge == "fullsort":
        monkeypatch.setenv("JAXMC_MESH_RANKMERGE", "0")
    _, rt, _ = run_both(jax_mesh, spec_path("constoy.tla"), D=D,
                        exchange=exchange)
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (True, 43, 21, 5)


@pytest.mark.parametrize("spec,cfg,D,exchange,no_deadlock", [
    ("symtoy.tla", "symtoy.cfg", 2, "a2a", True),
    ("viewtoy.tla", "viewtoy.cfg", 4, "gather", False),
    ("batchtoy.tla", "batchtoy_bad.cfg", 4, "a2a", False)])
def test_reductions_and_invariants_match_reference(jax_mesh, spec, cfg, D,
                                                   exchange, no_deadlock):
    """SYMMETRY, VIEW and a named invariant violation with its trace."""
    run_both(jax_mesh, spec_path(spec), spec_path(cfg), D=D, exchange=exchange,
             no_deadlock=no_deadlock)


@pytest.mark.parametrize("cfg,no_deadlock,D", [
    ("portoy.cfg", False, 2), ("portoy_ok.cfg", True, 4),
    ("portoy_bad.cfg", False, 4)])
def test_portoy_por_matches_reference(jax_mesh, cfg, no_deadlock, D):
    """Mesh POR: the all-shard probe, the summed verdicts and the ample
    mask before the exchange — counts, traces and por.* counters."""
    _, _, ttel = run_both(jax_mesh, spec_path("portoy.tla"), spec_path(cfg), D=D,
                          no_deadlock=no_deadlock, por=True)
    assert ttel.gauges["por.enabled"] is True


def test_defaults_and_refusals(monkeypatch):
    """a2a for D > 1, gather for D = 1, JAXMC_MESH_EXCHANGE below an
    explicit argument, the full-sort switch, --seen exact refused."""
    from jaxmc_torch.compile.vspec import ModeError
    m = tload(spec_path("constoy.tla"))
    assert MeshExplorer(m, shards=2, device="cpu").exchange == "a2a"
    assert MeshExplorer(m, shards=1, device="cpu").exchange == "gather"
    assert MeshExplorer(m, device="cpu").D == 1
    monkeypatch.setenv("JAXMC_MESH_EXCHANGE", "gather")
    me = MeshExplorer(m, shards=4, device="cpu")
    assert (me.exchange, me._exchange_src) == ("gather",
                                               "JAXMC_MESH_EXCHANGE")
    assert MeshExplorer(m, shards=4, device="cpu",
                        exchange="a2a").exchange == "a2a"
    monkeypatch.setenv("JAXMC_MESH_RANKMERGE", "0")
    assert MeshExplorer(m, shards=2, device="cpu").merge == "fullsort"
    with pytest.raises(ModeError, match="seen exact"):
        MeshExplorer(m, shards=2, device="cpu", seen_mode="exact")
    with pytest.raises(ValueError, match="exchange"):
        MeshExplorer(m, shards=2, device="cpu", exchange="ring")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MeshExplorer(m, shards=2)


def test_owner_formula_host_and_device_agree():
    """One ownership formula: the host's and K13's twin over the same
    key lane 1, and shard 0 for every key under the skew fault."""
    from jaxmc_torch.kernels import ops
    me = MeshExplorer(tload(spec_path("constoy.tla")), shards=4, device="cpu")
    keys = np.random.default_rng(7).integers(
        -2**31, 2**31 - 1, (500, 5)).astype(np.int32)
    host = me._owner_from_keys(keys)
    dev = ops.mesh_owner_twin(torch.as_tensor(keys[:, 1]), 4, False)
    np.testing.assert_array_equal(host, dev.numpy())
    me._skew = True
    assert (me._owner_from_keys(keys) == 0).all()
