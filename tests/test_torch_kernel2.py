"""The batch-first transition-kernel compiler of the torch port against
jaxmc/compile/kernel2.py: for every grounded instance, (en, aok, ov,
succ) of the port's compiled action over a sampled frontier equals
jax.vmap of the reference kernel on the same rows; compiled invariants
and constraints agree likewise.  Fixture by fixture, bit for bit."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SPECS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "specs")


def _build(pkg, spec, cfg):
    sess = importlib.import_module(pkg + ".session")
    sim = importlib.import_module(pkg + ".engine.simulate")
    k2 = importlib.import_module(pkg + ".compile.kernel2")
    vs = importlib.import_module(pkg + ".compile.vspec")
    gr = importlib.import_module(pkg + ".compile.ground")
    an = importlib.import_module(pkg + ".analyze")
    model = sess.load_model(os.path.join(SPECS, spec),
                            os.path.join(SPECS, cfg) if cfg else None,
                            False)
    sampled = sim.sample_states(model, bfs_states=800, n_walks=40,
                                walk_depth=60)
    rep = an.infer_state_bounds(model)
    sb = rep.element_bounds() if rep is not None else None
    lay = k2.build_layout2(model, sampled, vs.Bounds(), static_bounds=sb)
    kc = k2.KernelCtx(model, lay, vs.Bounds())
    cas = [k2.compile_action2(kc, ga)
           for arm in gr.split_arms(model)
           for ga in gr.ground_arm(model, arm, dyn_slots=vs.Bounds().kv_cap)]
    preds = [(nm, k2.compile_predicate2(kc, ex))
             for nm, ex in list(model.invariants) + list(model.constraints)]
    return lay, cas, preds, sampled, kc


FIXTURES = [
    ("constoy.tla", "constoy.cfg"),
    ("batchtoy.tla", "batchtoy_a.cfg"),
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("pcal_intro_buggy.tla", None),
    # containers: message tables with a slotted \E arm, sequences
    ("msgstoy.tla", "msgstoy.cfg"),
    ("portoy.tla", "portoy.cfg"),
]


@pytest.mark.parametrize("spec,cfg", FIXTURES)
def test_actions_match_reference(spec, cfg):
    lj, casj, predsj, sampled, _ = _build("jaxmc", spec, cfg)
    lt, cast, predst, _, _ = _build("jaxmc_torch", spec, cfg)
    assert (lt.width, lt.plan.packed_width) == (lj.width,
                                                lj.plan.packed_width)
    assert [c.label for c in cast] == [c.label for c in casj]
    rng = np.random.default_rng(0)
    enc = np.stack([lj.encode(s) for s in sampled])
    rows = enc[rng.integers(0, len(enc), 256)]
    n_enabled = 0
    for a, b in zip(casj, cast):
        assert a.n_slots == b.n_slots
        for slot in (range(a.n_slots) if a.n_slots else [None]):
            if slot is None:
                rj = jax.vmap(a.fn)(jnp.asarray(rows))
                rt = b.fn(torch.as_tensor(rows))
            else:
                rj = jax.vmap(a.fn, in_axes=(0, None))(
                    jnp.asarray(rows), jnp.int32(slot))
                rt = b.fn(torch.as_tensor(rows), slot)
            for x, y, nm in zip(rj, rt, ("en", "aok", "ov", "succ")):
                np.testing.assert_array_equal(
                    y.numpy(), np.asarray(x),
                    err_msg=f"{a.label} slot={slot} {nm}")
            n_enabled += int(np.asarray(rj[0]).sum())
    assert n_enabled > 0
    for (nj, fj), (nt, ft) in zip(predsj, predst):
        assert nj == nt
        np.testing.assert_array_equal(
            ft(torch.as_tensor(rows)).numpy(),
            np.asarray(jax.vmap(fj)(jnp.asarray(rows))), err_msg=nj)


def test_uncompilable_construct_raises_compile_error():
    """A construct outside the compilable subset raises CompileError
    naming it, as the reference does — never a wrong value."""
    from jaxmc_torch.compile import kernel2 as k2
    from jaxmc_torch.compile.vspec import CompileError
    from jaxmc_torch.front import tla_ast as A
    lt, _, _, _, kc = _build("jaxmc_torch", "constoy.tla", "constoy.cfg")
    subset = A.OpApp("SUBSET", (A.Ident("a"),))   # SUBSET of a state var
    f = k2.compile_predicate2(kc, A.OpApp("\\in", (A.Ident("a"), subset)))
    with pytest.raises(CompileError, match="SUBSET"):
        f(torch.zeros((1, lt.width), dtype=torch.int32))
