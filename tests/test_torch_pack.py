"""Lane plans and the pack/unpack twins of the torch port, held against
the JAX reference (jaxmc/compile/pack.py) bit for bit.

Rows are made with numpy from a fixed seed and handed to both packages
as numpy; every comparison is exact (all arithmetic is int32)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.compile import pack as jpack
from jaxmc_torch.compile import pack as tpack
from jaxmc_torch.kernels import ops

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")
SENT = 2**31 - 1
PLAN_ARRAYS = ("word", "shift", "bits", "mask", "bias", "allowed",
               "sent_code", "guarded", "proven", "full")


def _layouts(spec, cfg):
    """Both packages' Layout2 for one model, built the engines' way."""
    from jaxmc.session import load_model as jload
    from jaxmc_torch.session import load_model as tload
    out = []
    for load, pkg in ((jload, "jaxmc"), (tload, "jaxmc_torch")):
        import importlib
        sim = importlib.import_module(pkg + ".engine.simulate")
        k2 = importlib.import_module(pkg + ".compile.kernel2")
        vs = importlib.import_module(pkg + ".compile.vspec")
        an = importlib.import_module(pkg + ".analyze")
        model = load(os.path.join(SPECS, spec), os.path.join(SPECS, cfg),
                     False)
        sampled = sim.sample_states(model, bfs_states=800, n_walks=40,
                                    walk_depth=60)
        rep = an.infer_state_bounds(model)
        sb = rep.element_bounds() if rep is not None else None
        out.append(k2.build_layout2(model, sampled, vs.Bounds(),
                                    static_bounds=sb))
    return out


@pytest.mark.parametrize("spec,cfg", [
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("constoy.tla", "constoy.cfg"),
    ("batchtoy.tla", "batchtoy_a.cfg"),
])
def test_build_lane_plan_matches_reference(spec, cfg):
    lj, lt = _layouts(spec, cfg)
    pj, pt = lj.plan, lt.plan
    assert (pt.width, pt.packed_width, pt.identity) == \
        (pj.width, pj.packed_width, pj.identity)
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name),
                                      err_msg=name)
    assert pt.signature() == pj.signature()


def _mixed_plans(pack):
    """One plan per package from the same lane classes: structural
    lanes, observed-range (guarded) lanes, SENTINEL-capable lanes and
    never-observed lanes that stay full 32-bit words."""
    LC = pack._LaneClass
    classes = [LC(0, 1, False, False, False),          # bool
               LC(0, 6, False, True, False),           # enum, sentinel ok
               LC(None, None, True, False, False),     # observed int
               LC(None, None, True, True, True),       # observed, sentinel
               LC(None, None, True, False, False),     # never observed
               LC(-3, 40, True, False, False, proven=True),
               LC(None, None, True, False, False)]     # never observed
    W = len(classes)
    obs_lo = np.asarray([0, 0, -5, 0, 0, -3, 0], np.int64)
    obs_hi = np.asarray([1, 6, 9, 3, 0, 40, 0], np.int64)
    seen = np.asarray([True, True, True, True, False, True, False])
    return pack.LanePlan(W, classes, obs_lo, obs_hi, seen)


def _rows(plan, n, seed):
    """Rows in range for every lane, with SENTINEL on sentinel lanes and
    arbitrary (sign bit set) values on full lanes."""
    rng = np.random.default_rng(seed)
    W = plan.width
    rows = np.zeros((n, W), np.int64)
    for i in range(W):
        if plan.full[i]:
            rows[:, i] = rng.integers(-2**31, 2**31, n)
        else:
            rows[:, i] = plan.bias[i] + rng.integers(
                0, max(int(plan.allowed[i]), 0) + 1, n)
            if plan.sent_code[i] >= 0:
                hit = rng.random(n) < 0.3
                rows[hit, i] = SENT
                rows[~hit, i] = np.minimum(rows[~hit, i], plan.bias[i]
                                           + plan.sent_code[i] - 1)
    return rows.astype(np.int32)


def test_mixed_plan_arrays_match():
    pj, pt = _mixed_plans(jpack), _mixed_plans(tpack)
    assert pt.packed_width == pj.packed_width < pt.width
    assert pt.full.any() and (pt.sent_code >= 0).any()
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_twins_match_reference(seed):
    pj, pt = _mixed_plans(jpack), _mixed_plans(tpack)
    rows = _rows(pj, 500, seed)
    # full lanes with the sign bit set, and SENTINEL lanes, are present
    assert (rows[:, pj.full] < 0).any()
    assert (rows == SENT).any()
    jp, jo = pj.pack_rows(jnp.asarray(rows))
    tp, to = pt.pack_rows(torch.as_tensor(rows))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert not to.any()
    ju = pj.unpack_rows(jp)
    tu = pt.unpack_rows(tp)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tu.numpy(), rows)
    # the host (numpy) halves agree with the device halves
    np.testing.assert_array_equal(pt.pack_np(rows), tp.numpy())


@pytest.mark.parametrize("seed", [3, 4])
def test_pack_overflow_flags_match_reference(seed):
    pj, pt = _mixed_plans(jpack), _mixed_plans(tpack)
    rows = _rows(pj, 400, seed)
    rng = np.random.default_rng(seed)
    guarded = np.nonzero(~pj.full)[0]
    for r in range(0, 400, 3):   # every third row: one lane out of range
        i = guarded[rng.integers(len(guarded))]
        hi = int(pj.bias[i] + pj.allowed[i])
        rows[r, i] = hi + 1 + int(rng.integers(0, 1000)) \
            if rng.random() < 0.5 else int(pj.bias[i]) - 1 - int(
                rng.integers(0, 1000))
        if rows[r, i] == SENT:
            rows[r, i] -= 1
    jp, jo = pj.pack_rows(jnp.asarray(rows))
    tp, to = pt.pack_rows(torch.as_tensor(rows))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert to.numpy().sum() == len(range(0, 400, 3))


@pytest.mark.parametrize("seed", [5, 6])
def test_keys_of_row_flags_match_reference(seed):
    """K2's per-row overflow output (LanePlan.pack_rows reads it on the
    card) through the CPU path of the wrapper: the reference's per-row
    ovf masked by validity, its OR as pack_ovf, the packed words of the
    valid rows and SENTINEL words for the others."""
    pj, pt = _mixed_plans(jpack), _mixed_plans(tpack)
    rows = _rows(pj, 300, seed)
    rng = np.random.default_rng(seed)
    guarded = np.nonzero(~pj.full)[0]
    for r in range(0, 300, 4):   # every fourth row: one lane too large
        i = guarded[rng.integers(len(guarded))]
        rows[r, i] = int(pj.bias[i] + pj.allowed[i]) + 1
    valid = rng.random(300) < 0.7
    jp, jo = pj.pack_rows(jnp.asarray(rows))
    jo = np.asarray(jo) & valid
    keys, packed, pack_ovf, row_ovf = ops.keys_of(
        torch.as_tensor(rows), torch.as_tensor(valid), pt.tensors("cpu"),
        False, False, row_ovf=True)
    np.testing.assert_array_equal(row_ovf.numpy(), jo)
    assert bool(pack_ovf) == bool(jo.any()) is True
    np.testing.assert_array_equal(packed.numpy()[valid],
                                  np.asarray(jp)[valid])
    assert (packed.numpy()[~valid] == SENT).all()
    np.testing.assert_array_equal(keys.numpy()[:, 0], np.where(valid, 0, 1))


def test_identity_plan_passes_rows_through():
    pt = tpack.identity_plan(5)
    rows = torch.as_tensor(np.random.default_rng(7).integers(
        -2**31, 2**31, (9, 5)).astype(np.int32))
    p, o = pt.pack_rows(rows)
    assert p is rows and not o.any()
    assert pt.unpack_rows(p) is p


def test_twins_on_transfer_scaled_rows():
    """The engine's plan on real sampled rows: the twins and the
    reference give the same packed words and lanes."""
    lj, lt = _layouts("transfer_scaled.tla", "transfer_scaled.cfg")
    from jaxmc_torch.engine.simulate import sample_states
    from jaxmc_torch.session import load_model
    model = load_model(os.path.join(SPECS, "transfer_scaled.tla"),
                       os.path.join(SPECS, "transfer_scaled.cfg"), False)
    rows = np.stack([lt.encode(s) for s in
                     sample_states(model, bfs_states=300, n_walks=5,
                                   walk_depth=10)])
    jp, _ = lj.plan.pack_rows(jnp.asarray(rows))
    pt = lt.plan.tensors("cpu")
    tp, _ = ops.pack_rows_twin(torch.as_tensor(rows), pt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        ops.unpack_rows_twin(tp, pt).numpy(), rows)
