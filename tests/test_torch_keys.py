"""Dedup keys of the torch port against the JAX reference: the
fingerprint128 twin and TorchExplorer._keys_of against
jaxmc.backend.bfs, bit for bit, on rows made from a fixed seed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.bfs import TpuExplorer, fingerprint128
from jaxmc.session import load_model as jload
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")
SENT = 2**31 - 1


@pytest.mark.parametrize("width", [1, 2, 7, 40])
def test_fingerprint128_twin_matches_reference(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(-2**31, 2**31, (300, width)).astype(np.int32)
    rows[::7, 0] = SENT                        # SENTINEL words
    rows[1::5] = -rows[1::5] - 1               # negatives
    want = np.asarray(fingerprint128(jnp.asarray(rows)))
    got = ops.fingerprint128_twin(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, want)


def _engines(spec, cfg, seen_mode):
    kw = dict(seen_mode=seen_mode)
    ej = TpuExplorer(jload(os.path.join(SPECS, spec),
                           os.path.join(SPECS, cfg), False), **kw)
    et = TorchExplorer(tload(os.path.join(SPECS, spec),
                             os.path.join(SPECS, cfg), False),
                       device="cpu", **kw)
    return ej, et


def _candidate_block(ej, n, seed):
    """A level step's candidate block: successor rows of real states
    (invalid rows SENTINEL-filled, as the step fills them)."""
    from jaxmc.engine.simulate import sample_states
    rows = np.stack([ej.layout.encode(s) for s in sample_states(
        ej.model, bfs_states=n, n_walks=5, walk_depth=20)])
    rng = np.random.default_rng(seed)
    rows = rows[rng.integers(0, len(rows), n)]
    valid = rng.random(n) < 0.7
    rows[~valid] = SENT
    return rows, valid


@pytest.mark.parametrize("seen_mode", ["exact", "fingerprint"])
@pytest.mark.parametrize("spec,cfg", [
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("batchtoy.tla", "batchtoy_a.cfg"),
    # the key basis is the packed orbit minimum (SYMMETRY) and the view
    # lanes (VIEW)
    ("symtoy_scaled.tla", "symtoy_scaled.cfg"),
    ("viewtoy_scaled.tla", "viewtoy_scaled.cfg"),
])
def test_keys_of_matches_reference(spec, cfg, seen_mode):
    ej, et = _engines(spec, cfg, seen_mode)
    assert (et.W, et.PW, et.K, et.fp_mode) == (ej.W, ej.PW, ej.K, ej.fp_mode)
    rows, valid = _candidate_block(ej, 400, seed=11)
    kj, pj, oj = ej._keys_of(jnp.asarray(rows), jnp.asarray(valid))
    kt, pt, ot = et._keys_of(torch.as_tensor(rows), torch.as_tensor(valid))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert bool(ot) == bool(oj) is False
    # host boundary path (init rows)
    hj = ej._host_keys(rows[valid][:50])
    ht = et._host_keys(rows[valid][:50])
    for a, b in zip(ht[:2], hj[:2]):
        np.testing.assert_array_equal(a, b)
    assert ht[2] == hj[2]


def test_keys_of_pack_overflow_is_validity_masked():
    ej, et = _engines("transfer_scaled.tla", "transfer_scaled.cfg", "auto")
    rows, valid = _candidate_block(ej, 64, seed=5)
    lane = int(np.nonzero(~ej.plan.full)[0][0])
    hi = int(ej.plan.bias[lane] + ej.plan.allowed[lane])
    bad_invalid = rows.copy()
    bad_invalid[~valid, lane] = hi + 5          # out of range, but invalid
    for r, want in ((bad_invalid, False),):
        kj, _, oj = ej._keys_of(jnp.asarray(r), jnp.asarray(valid))
        kt, _, ot = et._keys_of(torch.as_tensor(r), torch.as_tensor(valid))
        assert bool(ot) == bool(oj) == want
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    bad_valid = rows.copy()
    first = int(np.nonzero(valid)[0][0])
    bad_valid[first, lane] = hi + 5
    _, _, oj = ej._keys_of(jnp.asarray(bad_valid), jnp.asarray(valid))
    _, _, ot = et._keys_of(torch.as_tensor(bad_valid),
                           torch.as_tensor(valid))
    assert bool(ot) == bool(oj) is True


@pytest.mark.parametrize("fp", [False, True])
def test_keys_of_basis_twin_matches_reference_key_build(fp):
    """ops.keys_of with a separate basis: the packed basis (SYMMETRY) and
    the raw basis (VIEW) give the reference's key build over that basis
    (bfs._keys_of: pack, SENTINEL where invalid, fingerprint128), while
    the packed output stays the raw rows'."""
    ej, et = _engines("transfer_scaled.tla", "transfer_scaled.cfg", "auto")
    rows, valid = _candidate_block(ej, 200, seed=13)
    rng = np.random.default_rng(17)
    other = rows[valid][rng.integers(0, int(valid.sum()), len(rows))]
    other[~valid] = SENT
    r, v = torch.as_tensor(rows), torch.as_tensor(valid)
    pj = np.asarray(ej.plan.pack_rows(jnp.asarray(other))[0])
    view = np.ascontiguousarray(rows[:, :3])
    for basis, packed_basis, kb in ((other, True, pj), (view, False, view)):
        k, p, o = ops.keys_of(r, v, et.pt, fp, et.plan.identity,
                              basis=torch.as_tensor(basis),
                              basis_packed=packed_basis)
        want = np.asarray(fingerprint128(jnp.asarray(kb))) if fp else kb
        want = np.where(valid[:, None], want, SENT)
        np.testing.assert_array_equal(k.numpy()[:, 1:], want)
        np.testing.assert_array_equal(k.numpy()[:, 0], np.where(valid, 0, 1))
        np.testing.assert_array_equal(
            p.numpy(), np.where(valid[:, None], np.asarray(
                ej.plan.pack_rows(jnp.asarray(rows))[0]), SENT))
        assert not bool(o)
