"""The level engine's full-sort step (JAXMC_LEVEL_RANKMERGE=0, ROADMAP
B.7f) in the port: K11 fullsort_dedup's twin against the reference
branch's ops (jaxmc/backend/bfs.py:1820-1851) on random sorted keys,
and whole runs against the port's rank path and the reference's
full-sort run.

What the two merges must agree on: counts, verdicts, traces, the next
frontier's order and the seen table's live prefix, bit for bit (all
read through each run's last periodic checkpoint).  Against the
reference's full-sort run the seen prefix is compared as a set of keys:
the reference carries the duplicate candidate keys its stable
partition leaves past the prefix into the next level's sort, where they
are kept again, so its prefix holds repeats (its seen count grows past
the distinct keys); the port marks those rows invalid before the sort."""

import os

import numpy as np
import pytest
import torch

from jaxmc_torch import faults, obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.engine.ckpt import load_checkpoint
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SENT = 2**31 - 1


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("JAXMC_LEVEL_RANKMERGE", "JAXMC_SEEN_CAP",
              "JAXMC_TIER_HOST_KEYS", "JAXMC_FAULTS", "JAXMC_FAULTS_STATE"):
        monkeypatch.delenv(k, raising=False)
    faults.reset_for_tests()
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K11's twin against the reference branch's ops
# ---------------------------------------------------------------------------

def _reference_branch(seen_keys, ckeys, SC, C, K):
    """The reference's full-sort branch, its jnp lines as written in
    jaxmc/backend/bfs.py:1820-1851 (inside the jitted step there)."""
    import jax.numpy as jnp
    from jax import lax
    allk = jnp.concatenate([seen_keys, ckeys])
    flag = jnp.concatenate([jnp.zeros(SC, jnp.int32),
                            jnp.ones(C, jnp.int32)])
    idx0 = jnp.arange(SC + C, dtype=jnp.int32)
    ops_ = tuple(allk[:, i] for i in range(K)) + (flag, idx0)
    sorted_ = lax.sort(ops_, num_keys=K + 1, is_stable=True)
    skeys = jnp.stack(sorted_[:K], axis=1)
    sflag = sorted_[K]
    perm = sorted_[K + 1]
    cidx = perm - SC
    rvalid = skeys[:, 0] == 0
    neq_prev = jnp.concatenate([
        jnp.array([True]), jnp.any(skeys[1:] != skeys[:-1], axis=1)])
    new = (sflag == 1) & rvalid & neq_prev
    new_count = jnp.sum(new)
    comp = lax.sort(((1 - new.astype(jnp.int32)), cidx), num_keys=1,
                    is_stable=True)
    new_cidx = comp[1][:C]
    keep = ((sflag == 0) & rvalid) | new
    comp3 = lax.sort(((1 - keep.astype(jnp.int32)),) +
                     tuple(skeys[:, i] for i in range(K)), num_keys=1,
                     is_stable=True)
    seen2 = jnp.stack(comp3[1:], axis=1)[:SC]
    seen_count2 = jnp.sum(keep)
    return (np.asarray(skeys), np.asarray(sflag), np.asarray(perm),
            np.asarray(new_cidx), np.asarray(seen2),
            (int(new_count), int(seen_count2)))


def _random_tables(seed, SC, C, K, seen_count):
    """A sorted seen table (valid prefix of seen_count rows, the rest
    invalid) and C candidate keys: duplicates of seen keys, repeats among
    themselves and invalid rows (validity lane 1)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-3, 4, size=(seen_count + C, K - 1), dtype=np.int32)
    seen = np.full((SC, K), SENT, np.int32)
    sv = np.unique(pool[:seen_count], axis=0)
    seen[:len(sv), 0] = 0
    seen[:len(sv), 1:] = sv
    cand = np.zeros((C, K), np.int32)
    pick = rng.integers(0, len(pool), size=C)
    cand[:, 1:] = pool[pick]
    bad = rng.random(C) < 0.2
    cand[bad, 0] = 1
    cand[bad, 1:] = SENT
    return seen, len(sv), cand


@pytest.mark.parametrize("seed,SC,C,K", [(0, 64, 32, 3), (1, 256, 192, 5),
                                         (2, 128, 1, 2), (3, 512, 512, 3),
                                         (4, 1024, 700, 4), (5, 64, 0, 3)])
def test_fullsort_twin_matches_the_reference_branch(seed, SC, C, K):
    seen, n_seen, cand = _random_tables(seed, SC, C, K, SC // 3)
    skeys, sflag, perm, new_cidx, seen2, counts = _reference_branch(
        seen, cand, SC, C, K)
    args = (torch.as_tensor(skeys), torch.as_tensor(sflag),
            torch.as_tensor(perm), SC, C)
    for f in (ops.fullsort_dedup_twin, ops.fullsort_dedup):
        nc, s2, cn = f(*args)
        assert (int(cn[0]), int(cn[1])) == counts
        np.testing.assert_array_equal(nc.numpy(), new_cidx)
        np.testing.assert_array_equal(s2.numpy(), seen2)
    # the port's sort (the LSD chain over the K key words, concatenation
    # order standing for the flag) gives the reference's permutation
    allk = torch.as_tensor(np.concatenate([seen, cand]))
    p = ops.lsd_sort(allk)
    np.testing.assert_array_equal(p.to(torch.int32).numpy(), perm)


def test_fullsort_wrapper_checks_shapes():
    k = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="SC 3 \\+ C 2"):
        ops.fullsort_dedup(k, v, v, 3, 2)
    with pytest.raises(TypeError):
        ops.fullsort_dedup(k, v.to(torch.int64), v, 2, 2)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

CASES = {
    # (spec, cfg, engine kwargs, environment)
    "transfer_scaled_cut": ("transfer_scaled.tla", None,
                            dict(max_states=20000), {}),
    "pcal_intro_buggy": ("pcal_intro_buggy.tla", None, {}, {}),
    "batchtoy_bad": ("batchtoy.tla", "batchtoy_bad.cfg", {}, {}),
    "portoy_por": ("portoy.tla", "portoy_ok.cfg", dict(por=True), {}),
    "msgstoy_por": ("msgstoy.tla", "msgstoy.cfg", dict(por=True), {}),
    "ooc_seen_cap": ("ooc_scaled.tla", "ooc_scaled.cfg",
                     dict(seen_cap=512),
                     {"JAXMC_TIER_HOST_KEYS": "1024"}),
    "symtoy": ("symtoy.tla", "symtoy.cfg", {}, {}),
}
NO_DEADLOCK = {"portoy_por", "symtoy", "msgstoy_por"}


def _summary(r):
    v = r.violation
    trace = v and [(sorted((k, repr(x)) for k, x in st.items()), label)
                   for st, label in v.trace]
    return (r.ok, r.distinct, r.generated, r.diameter, r.truncated,
            list(r.warnings), v and (v.kind, v.name, v.message, trace))


def _port_run(case, flag, tmp_path, monkeypatch, twins=False):
    spec, cfg, kw, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("JAXMC_LEVEL_RANKMERGE", flag)
    ck = str(tmp_path / f"port{flag}{'t' if twins else ''}.ck")
    tel = tobs.reset()
    r = TorchExplorer(
        load_model(os.path.join(SPECS, spec),
                   os.path.join(SPECS, cfg) if cfg else None,
                   no_deadlock=case in NO_DEADLOCK),
        device="cpu", twins=twins, checkpoint_path=ck,
        checkpoint_every=0.0, **kw).run()
    payload = load_checkpoint(ck, kind="device")[1] \
        if os.path.exists(ck) else None
    return r, payload, dict(tel.counters)


def _same_level_state(a, b):
    """The two runs' last periodic checkpoints: frontier order, seen
    prefix, trace levels and frontier maps, bit for bit."""
    assert (a is None) == (b is None)
    if a is None:
        return
    for k in ("distinct", "generated", "depth", "layout_sig"):
        assert a[k] == b[k], k
    for k in ("frontier", "seen"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["trace_levels"] is None) == (b["trace_levels"] is None)
    for (ra, pa, fa), (rb, pb, fb) in zip(a["trace_levels"] or [],
                                          b["trace_levels"] or []):
        np.testing.assert_array_equal(ra, rb)
        assert fa == fb and (pa is None) == (pb is None)
        if pa is not None:
            np.testing.assert_array_equal(pa, pb)
    for ma, mb in zip(a["frontier_maps"] or [], b["frontier_maps"] or []):
        np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("case", list(CASES))
def test_fullsort_equals_the_rank_path(case, tmp_path, monkeypatch):
    rank, pr, cr = _port_run(case, "1", tmp_path, monkeypatch)
    full, pf, cf = _port_run(case, "0", tmp_path, monkeypatch)
    assert _summary(full) == _summary(rank)
    _same_level_state(pf, pr)
    por = {k: v for k, v in cr.items() if k.startswith("por.")}
    assert {k: v for k, v in cf.items() if k.startswith("por.")} == por
    if case.endswith("_por"):
        assert por.get("por.ample_states", 0) > 0
    if case == "ooc_seen_cap":
        assert full.tiers is not None and full.tiers["spills"] > 0
        assert full.tiers["spills"] == rank.tiers["spills"]


def test_fullsort_twins_equal_the_rank_path(tmp_path, monkeypatch):
    """twins=True runs K11's twin in the step: the same run."""
    rank, pr, _ = _port_run("pcal_intro_buggy", "1", tmp_path,
                            monkeypatch)
    full, pf, _ = _port_run("pcal_intro_buggy", "0", tmp_path,
                            monkeypatch, twins=True)
    assert _summary(full) == _summary(rank)
    _same_level_state(pf, pr)


@pytest.mark.parametrize("case", ["transfer_scaled_cut", "pcal_intro_buggy",
                                  "portoy_por", "ooc_seen_cap"])
def test_fullsort_equals_the_reference_fullsort(case, tmp_path,
                                                monkeypatch):
    from jaxmc import obs as jobs
    from jaxmc.session import load_model as jload
    from jaxmc.tpu.bfs import TpuExplorer
    full, pf, cf = _port_run(case, "0", tmp_path, monkeypatch)
    spec, cfg, kw, _env = CASES[case]
    ck = str(tmp_path / "ref.ck")
    jtel = jobs.Telemetry()
    with jobs.use(jtel):
        rj = TpuExplorer(jload(os.path.join(SPECS, spec),
                               os.path.join(SPECS, cfg) if cfg else None,
                               case in NO_DEADLOCK),
                         checkpoint_path=ck, checkpoint_every=0.0,
                         **kw).run()
    assert _summary(full) == _summary(rj)
    for k, v in cf.items():
        if k.startswith("por."):
            assert jtel.counters.get(k) == v, k
    pj = load_checkpoint(ck, kind="device")[1] if os.path.exists(ck) \
        else None
    if pj is None:
        assert pf is None
        return
    # frontier order, traces and counts bit for bit; the seen prefix as
    # a set (the reference's holds repeated keys, see the module text)
    seen_j = pj.pop("seen")
    seen_t = pf.pop("seen")
    pj = dict(pj, seen=np.unique(seen_j, axis=0))
    _same_level_state(dict(pf, seen=seen_t), pj)
    assert len(seen_j) >= len(seen_t)
