"""K13 mesh_route and K14 mesh_scalars of the torch port (their twins,
and their wrappers, which take the twin on the CPU) against the JAX
reference's own functions on the same inputs made from a numpy seed:

  K13  jaxmc/backend/mesh.py _route_fn's closures, run under shard_map
       on the virtual CPU devices — the a2a exchange (buckets, spill
       buckets, overflow, source indices) and the gather exchange;
  K14  _mk_level_tail, run under shard_map with its route, merge and
       invariant scan stubbed to hand it each shard's partials: the
       reference's own psum / pmax / pmin make the scalar vector and
       the localization vectors.

Bit-exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jaxmc.backend import mesh as jm
from jaxmc_torch.kernels import ops
from mesh_oracle import jax_mesh  # noqa: F401

SENT = 2**31 - 1
K, PW = 5, 3


def _fake(D, exchange="a2a", gamma=2.0, skew=False, **attrs):
    """A reference MeshExplorer with only the attributes these closures
    read (no model is compiled)."""
    me = object.__new__(jm.MeshExplorer)
    me.D, me.K, me.PW = D, K, PW
    me.exchange, me._a2a_gamma, me._skew = exchange, gamma, skew
    for k, v in attrs.items():
        setattr(me, k, v)
    return me


def _mesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("d",))


def _candidates(D, C, p, seed):
    """[D, C, K] keys, [D, C, PW] rows and [D, C] validity in the
    shapes K2 gives them: invalid rows are [1, SENTINEL...] / SENTINEL."""
    rng = np.random.default_rng(seed)
    valid = rng.random((D, C)) < p
    keys = rng.integers(-2**31, 2**31 - 1, (D, C, K)).astype(np.int32)
    keys[..., 0] = 0
    keys[~valid] = SENT
    keys[~valid, 0] = 1
    cand = rng.integers(-2**31, 2**31 - 1, (D, C, PW)).astype(np.int32)
    cand[~valid] = SENT
    return keys, cand, valid


def _ref_route(me, C, FC, keys, cand, valid):
    """The reference's route closure over the mesh: per shard (gkeys,
    gcand, gsrc, spill, a2a_ovf, maxdest, evalid), and (R, B, SB)."""
    D = me.D
    route, R, B, SB = me._route_fn(C, FC)

    def f(ck, cd, cv):
        out = route(ck.reshape(C, K), cd.reshape(C, PW), cv.reshape(C),
                    lax.axis_index("d"))
        gk, gc, gs, sp, ov, md, ev = out
        return (gk[None], gc[None], gs[None], sp.reshape(1),
                ov.astype(jnp.int32).reshape(1), md.reshape(1), ev[None])

    sm = me._shard_map()
    out = jax.jit(sm(f, mesh=_mesh(D), in_specs=(P("d"),) * 3,
                     out_specs=(P("d"),) * 7, check_rep=False))(
        jnp.asarray(keys), jnp.asarray(cand), jnp.asarray(valid))
    return [np.asarray(x) for x in out], (R, B, SB)


@pytest.mark.parametrize("D,FC,A,p,gamma,skew", [
    (2, 64, 3, 0.5, 2.0, False),
    (4, 64, 3, 0.5, 2.0, False),
    # a small gamma: rows spill past B, and past B + SB they overflow
    (4, 64, 3, 0.9, 0.3, False),
    (2, 128, 2, 0.7, 0.6, False),
    # every row to shard 0: the skewed spill
    (4, 64, 3, 0.3, 2.0, True),
    (4, 32, 5, 1.0, 1.0, True),
    (1, 64, 3, 0.5, 2.0, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_route_a2a_twin_matches_reference(jax_mesh, D, FC, A, p, gamma,
                                          skew, seed):
    C = A * FC
    keys, cand, valid = _candidates(D, C, p, seed * 31 + D)
    me = _fake(D, "a2a", gamma, skew)
    (gk, gc, gs, sp, ov, md, _ev), (R, B, SB) = _ref_route(
        me, C, FC, keys, cand, valid)
    args = (torch.as_tensor(keys), torch.as_tensor(cand),
            torch.as_tensor(valid), D, B, SB, skew)
    for f in (ops.mesh_route_twin, ops.mesh_route):
        ok, oc, osrc, stats = f(*args)
        assert tuple(ok.shape) == (D, R, K)
        np.testing.assert_array_equal(ok.numpy(), gk)
        np.testing.assert_array_equal(oc.numpy(), gc)
        np.testing.assert_array_equal(osrc.numpy(), gs)
        np.testing.assert_array_equal(stats.numpy(),
                                      np.stack([sp, ov, md], axis=1))
    if gamma < 1 and not skew:
        assert sp.sum() > 0


@pytest.mark.parametrize("D,skew", [(2, False), (4, False), (4, True)])
def test_route_gather_twin_matches_reference(jax_mesh, D, skew):
    FC, A = 64, 3
    C = A * FC
    keys, cand, valid = _candidates(D, C, 0.4, D)
    me = _fake(D, "gather", skew=skew)
    (gk, gc, gs, sp, ov, md, ev), (R, B, SB) = _ref_route(
        me, C, FC, keys, cand, valid)
    assert (R, B, SB) == (D * C, 0, 0)
    allk = torch.as_tensor(keys.reshape(D * C, K))
    for f in (ops.mesh_route_gather_twin, ops.mesh_route_gather):
        ok, evalid = f(allk, D, 0, D, skew)
        np.testing.assert_array_equal(ok.numpy(), gk)
        for d in range(D):
            np.testing.assert_array_equal(evalid.numpy(), ev[d])
        # one shard's slice, as a process of the multi-process runner
        # asks for its own
        ok1, _ = f(allk, D, D - 1, 1, skew)
        np.testing.assert_array_equal(ok1.numpy()[0], gk[D - 1])
    # the packed rows are the all_gather itself: one shared block
    for d in range(D):
        np.testing.assert_array_equal(gc[d], cand.reshape(D * C, PW))
        np.testing.assert_array_equal(gs[d], np.arange(R))
    assert not sp.any() and not ov.any() and not md.any()


@pytest.mark.parametrize("gamma", [2.0, 0.4])
def test_route_send_layout_is_the_exchanged_receive_layout(gamma):
    """K13's send layout (one source per process), put through the
    all_to_all's exchange of main and spill buckets, is its receive
    layout: what the multi-process runner relies on."""
    D, FC, A = 4, 64, 3
    C = A * FC
    keys, cand, valid = _candidates(D, C, 0.8, 5)
    B = max(1, int(np.ceil(C * gamma / D)), FC // D)
    SB = max(1, B // 4)
    t = [torch.as_tensor(x) for x in (keys, cand, valid)]
    recv = ops.mesh_route(*t, D, B, SB)
    sends = [ops.mesh_route(t[0][s:s + 1], t[1][s:s + 1], t[2][s:s + 1], D,
                            B, SB, src_lo=s, send=True) for s in range(D)]
    for d in range(D):
        for i in range(3):
            got = torch.cat(
                [sends[s][i][0][d * B:(d + 1) * B] for s in range(D)]
                + [sends[s][i][0][D * B + d * SB:D * B + (d + 1) * SB]
                   for s in range(D)])
            np.testing.assert_array_equal(got.numpy(), recv[i][d].numpy())
    np.testing.assert_array_equal(
        torch.cat([s[3] for s in sends]).numpy(), recv[3].numpy())


def _partials(D, FC, SC, seed):
    """Random per-shard partials in their ranges (MESH_PARTIALS order);
    the POR columns stay 0: the reference's tail makes those itself."""
    rng = np.random.default_rng(seed)
    cols = {
        "gen": rng.integers(0, 1000, D),
        "front": rng.integers(0, FC + 3 * (seed % 2), D),
        "seen": rng.integers(0, SC + 3 * (seed % 3 == 1), D),
        "spill": rng.integers(0, 50, D),
        "maxdest": rng.integers(0, 300, D),
        "vneed": rng.integers(0, 700, D),
        "ovc": np.where(rng.random(D) < 0.2, rng.integers(1, 4, D), 0),
        "dead": rng.random(D) < 0.3,
        "dead_slot": rng.integers(0, FC, D),
        "assert": rng.random(D) < 0.3,
        "asrt_a": rng.integers(0, 5, D),
        "asrt_f": rng.integers(0, FC, D),
        "inv_which": np.where(rng.random(D) < 0.4, rng.integers(0, 3, D),
                              SENT),
        "inv_slot": rng.integers(-1, FC, D),
        "a2a_ovf": rng.random(D) < 0.2,
        "v_ovf": rng.random(D) < 0.2}
    part = np.zeros((D, len(ops.MESH_PARTIALS)), np.int32)
    for i, name in enumerate(ops.MESH_PARTIALS):
        if name in cols:
            part[:, i] = cols[name]
    return part


def _ref_tail(D, FC, SC, TRL, part, t_ovf):
    """The reference's _mk_level_tail over the mesh, its route, merge
    and invariant scan stubbed to return each shard's partials; returns
    its (scal [NS], aux [D, NA])."""
    col = {n: i for i, n in enumerate(ops.MESH_PARTIALS)}
    me = _fake(D, por=False, A=1)

    def f(prow):
        p = prow[0]

        def route(ckeys, cand, cvalid, m):
            return (None, None, None, p[col["spill"]],
                    p[col["a2a_ovf"]] != 0, p[col["maxdest"]], None)

        def merge(seen_keys, seen_count, gk, gc, gs):
            return dict(front_rows=jnp.zeros((FC, PW), jnp.int32),
                        front_rows_u=None,
                        front_count=p[col["front"]],
                        front_src=jnp.zeros((FC,), jnp.int32),
                        seen2=seen_keys, seen_count2=p[col["seen"]],
                        v_ovf=p[col["v_ovf"]] != 0,
                        v_need=p[col["vneed"]])

        me._inv_scan = lambda *a: (p[col["inv_which"]], p[col["inv_slot"]])
        tail = me._mk_level_tail(SC, FC, TRL, FC, route, merge, True)
        out = tail(jnp.zeros((SC, K), jnp.int32), jnp.int32(0),
                   jnp.zeros((FC, PW), jnp.int32), jnp.int32(0),
                   jnp.zeros((TRL, FC, PW), jnp.int32),
                   jnp.zeros((TRL, FC), jnp.int32),
                   jnp.int32(TRL if t_ovf else 0), jnp.int32(0),
                   jnp.int32(0), lax.axis_index("d"), None, None, None,
                   p[col["gen"]], p[col["ovc"]], p[col["dead"]] != 0,
                   p[col["dead_slot"]], p[col["assert"]] != 0,
                   p[col["asrt_a"]], p[col["asrt_f"]])
        scal, aux = out[8], out[9]
        return scal[None], aux[None]

    sm = me._shard_map()
    scal, aux = jax.jit(sm(f, mesh=_mesh(D), in_specs=(P("d"),),
                           out_specs=(P("d"), P("d")), check_rep=False))(
        jnp.asarray(part))
    scal = np.asarray(scal)
    for d in range(D):  # replicated
        np.testing.assert_array_equal(scal[d], scal[0])
    return scal[0], np.asarray(aux)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_scalars_twin_matches_reference_tail(jax_mesh, D, seed):
    FC, SC, TRL = 64, 256, 4
    part = _partials(D, FC, SC, seed * 7 + D)
    t_ovf = seed % 2
    scal, aux = _ref_tail(D, FC, SC, TRL, part, t_ovf)
    NS, NA = len(ops.MESH_REDUCE), len(ops.MESH_AUX)
    for f in (ops.mesh_scalars_twin, ops.mesh_scalars):
        out = f(torch.as_tensor(part), FC, SC, t_ovf).numpy()
        np.testing.assert_array_equal(out[:NS], scal)
        np.testing.assert_array_equal(out[NS:NS + D * NA].reshape(D, NA),
                                      aux)
        np.testing.assert_array_equal(out[NS + D * NA:].reshape(part.shape),
                                      part)


def test_scalars_sum_the_por_columns_and_wrap_as_int32():
    """The POR sums (made inside the reference's tail, so not in the
    test above) and the int32 wrap of a psum."""
    part = np.zeros((3, len(ops.MESH_PARTIALS)), np.int32)
    c = {n: i for i, n in enumerate(ops.MESH_PARTIALS)}
    part[:, c["por_ample"]] = [1, 2, 3]
    part[:, c["por_expanded"]] = [10, 20, 30]
    part[:, c["por_masked"]] = [7, 0, 5]
    part[:, c["gen"]] = [2**31 - 1, 1, 0]
    part[:, c["inv_which"]] = SENT
    out = ops.mesh_scalars(torch.as_tensor(part), 64, 256, 0).numpy()
    red = [n for n, _ in ops.MESH_REDUCE]
    assert out[18:21].tolist() == [6, 60, 12]
    assert red[18:21] == ["por_ample", "por_expanded", "por_masked"]
    assert out[0] == -2**31
