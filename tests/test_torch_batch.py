"""Cross-model batching in the torch port (backend/batch.py, K10's twin)
against the JAX reference's BatchCheckEngine on JAX's CPU and against
solo host-seen runs: per-member results (verdict, counts, traces),
occupancy, the donor's lane plan, the refusal texts, the batch
profiles, a predicate compiled with lifted constants, and the batched
epilogue's twin against B calls of K7's twin on inputs made from a
numpy seed with ragged counts and an idle lane.  Every comparison is
exact (tolerance 0)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc.backend.batch import BatchCheckEngine as JBatch
from jaxmc.backend.batch import BatchIncompatible as JIncompatible
from jaxmc.backend.bfs import TpuExplorer
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import SessionConfig as JCfg
from jaxmc.session import batch_profile as jprofile
from jaxmc.session import load_model as jload
from jaxmc_torch.backend.batch import BatchCheckEngine as TBatch
from jaxmc_torch.backend.batch import BatchIncompatible as TIncompatible
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.compile.kernel2 import OV_PACK
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import SessionConfig as TCfg
from jaxmc_torch.session import batch_profile as tprofile
from jaxmc_torch.session import load_model as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
BT = os.path.join(SPECS, "batchtoy.tla")
MT = os.path.join(SPECS, "msgstoy.tla")
VARIANTS = ("a", "b", "c", "d", "bad")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def btcfg(v):
    return os.path.join(SPECS, f"batchtoy_{v}.cfg")


def jcfg(spec, cfg, **kw):
    return JCfg(spec=spec, cfg=cfg, backend="jax", platform="cpu",
                host_seen=True, **kw)


def tcfg(spec, cfg, **kw):
    return TCfg(spec=spec, cfg=cfg, backend="jax", platform="cpu",
                host_seen=True, device="cpu", **kw)


def _tup(r, fmt):
    v = None
    if r.violation is not None:
        v = (r.violation.kind, r.violation.name, r.violation.message,
             [lab for _st, lab in r.violation.trace], fmt(r.violation))
    return (r.ok, r.distinct, r.generated, r.diameter, bool(r.truncated),
            list(r.warnings), v)


def _cohorts(jcfgs, tcfgs):
    jb = JBatch(jcfgs).build()
    jm = jb.run()
    tb = TBatch(tcfgs).build()
    tm = tb.run()
    return jb, jm, tb, tm


@pytest.fixture(scope="module")
def batchtoy():
    return _cohorts([jcfg(BT, btcfg(v)) for v in VARIANTS],
                    [tcfg(BT, btcfg(v)) for v in VARIANTS])


def test_batchtoy_cohort_matches_reference(batchtoy):
    jb, jm, tb, tm = batchtoy
    assert tb.lift_names == jb.lift_names == \
        ("Bound", "Limit", "Step", "WrapCap")
    assert tb.dispatcher.max_width == jb.dispatcher.max_width == 5
    assert tb.dispatcher.dispatches == jb.dispatcher.dispatches
    assert tm[0].engine.plan.batch_descriptor() == \
        jm[0].engine.plan.batch_descriptor()
    for v, a, b in zip(VARIANTS, jm, tm):
        assert a.error is None and b.error is None, (v, b.error)
        assert _tup(b.result, tformat) == _tup(a.result, jformat), v
    bad = tm[VARIANTS.index("bad")].result
    assert bad.violation.kind == "invariant"
    assert bad.violation.name == "InBound"
    assert len({m.result.distinct for m in tm}) == 5


@pytest.mark.parametrize("v", VARIANTS)
def test_batchtoy_members_match_solo(batchtoy, v):
    _jb, _jm, _tb, tm = batchtoy
    solo = TorchExplorer(tload(BT, btcfg(v)), host_seen=True,
                         device="cpu").run()
    assert _tup(tm[VARIANTS.index(v)].result, tformat) == \
        _tup(solo, tformat)


def test_followers_share_the_donor(batchtoy):
    _jb, _jm, tb, tm = batchtoy
    donor = tm[0].engine
    for mem in tm[1:]:
        assert mem.engine.compiled is donor.compiled
        assert mem.engine.layout is donor.layout
        assert mem.engine.kc is donor.kc
        assert mem.engine.model is mem.model
    assert tb.engine_builds == 1


def _msgstoy_cfgs(tmp, procs, T, caps):
    out = []
    for cap in caps:
        p = tmp / f"msgstoy_cap{cap}_T{T}.cfg"
        p.write_text("INIT Init\nNEXT Next\nINVARIANT DoneOK\nCONSTANTS\n"
                     f"  Procs = {{{', '.join(procs)}}}\n  Cap = {cap}\n"
                     f"  T = {T}\n  P1 = p1\nCHECK_DEADLOCK FALSE\n")
        out.append(str(p))
    return out


@pytest.fixture(scope="module")
def msgstoy(tmp_path_factory):
    """The reference's msgstoy cohort (tests/test_batch.py): msgstoy.cfg
    (Cap 2) with Cap 3; `msgs` is a per-process table, so the donor
    layout depends on the merged per-element bounds."""
    cfg3 = tmp_path_factory.mktemp("msgstoy") / "cap3.cfg"
    cfg3.write_text("INIT Init\nNEXT Next\nINVARIANT DoneOK\n"
                    "CONSTANTS\n  Procs = {p1, p2, p3}\n  Cap = 3\n"
                    "  T = 2\n  P1 = p1\n")
    cfgs = [os.path.join(SPECS, "msgstoy.cfg"), str(cfg3)]
    res = _cohorts([jcfg(MT, c) for c in cfgs], [tcfg(MT, c) for c in cfgs])
    solos = []
    for c in cfgs:
        eng = TorchExplorer(tload(MT, c), host_seen=True, device="cpu")
        solos.append((eng.run(), eng.plan.batch_descriptor()))
    return res, solos


def test_msgstoy_cohort_matches_reference_and_solo(msgstoy):
    (jb, jm, tb, tm), solos = msgstoy
    assert tb.lift_names == jb.lift_names
    assert "Cap" in tb.lift_names
    assert tm[0].engine.plan.batch_descriptor() == \
        jm[0].engine.plan.batch_descriptor()
    for a, b, (s, _d) in zip(jm, tm, solos):
        assert b.error is None, b.error
        assert _tup(b.result, tformat) == _tup(a.result, jformat)
        assert _tup(b.result, tformat) == _tup(s, tformat)


def test_msgstoy_donor_plan_and_proofs(msgstoy):
    (_jb, jm, _tb, tm), solos = msgstoy
    donor = tm[0].engine.plan.batch_descriptor()
    assert donor["bits_per_state"] <= max(d["bits_per_state"]
                                          for _, d in solos)
    assert donor["proven_lanes"] >= min(d["proven_lanes"]
                                        for _, d in solos)
    rep = tm[0].engine.model._bounds_report
    eb = rep.element_bounds()
    assert eb["msgs"].rng.all == (0, 3)
    assert "clock" not in rep.lane_bounds()
    assert eb["clock"].dom is not None


def test_msgstoy_four_process_pins(tmp_path):
    """The chip cohort's formula, (Cap+1)^(4+T) + (Cap+1)^(3+T) distinct
    states for Procs {p1..p4}, against the reference's host-seen engine
    at T 2, and the port's cohort at the same T."""
    procs = ["p1", "p2", "p3", "p4"]
    cfgs = _msgstoy_cfgs(tmp_path, procs, 2, (1, 2, 3))
    tm = TBatch([tcfg(MT, c) for c in cfgs]).build().run()
    for cap, c, mem in zip((1, 2, 3), cfgs, tm):
        want = (cap + 1) ** 6 + (cap + 1) ** 5
        rj = TpuExplorer(jload(MT, c, False), host_seen=True).run()
        assert rj.ok and rj.distinct == want
        assert mem.error is None
        assert _tup(mem.result, tformat) == _tup(rj, jformat)


def test_incompatible_cohorts_refused_alike():
    other = os.path.join(SPECS, "transfer_scaled.tla")
    with pytest.raises(JIncompatible) as ej:
        JBatch([jcfg(BT, btcfg("a")), jcfg(other, None)]).build()
    with pytest.raises(TIncompatible) as et:
        TBatch([tcfg(BT, btcfg("a")), tcfg(other, None)]).build()
    assert str(et.value) == str(ej.value)
    with pytest.raises(JIncompatible) as ej:
        JBatch([jcfg(BT, btcfg("a")),
                jcfg(BT, btcfg("b"), max_states=7)]).build()
    with pytest.raises(TIncompatible) as et:
        TBatch([tcfg(BT, btcfg("a")),
                tcfg(BT, btcfg("b"), max_states=7)]).build()
    assert str(et.value) == str(ej.value)
    assert "member option 'max_states' differs" in str(et.value)


PROP_TLA = """---- MODULE bprop ----
EXTENDS Naturals
CONSTANT Lim
VARIABLE x
Init == x = 0
Next == x < Lim /\\ x' = x + 1
Spec == Init /\\ [][Next]_x
Mono == Init /\\ [][x' >= x]_x
Live == []<>(x = 0)
====
"""


@pytest.mark.parametrize("case", ["refinement", "temporal", "seen_cap",
                                  "level"])
def test_batch_block_reasons_match_reference(case, tmp_path):
    (tmp_path / "bprop.tla").write_text(PROP_TLA)
    prop = {"refinement": "PROPERTY Mono\n",
            "temporal": "PROPERTY Live\n"}.get(case, "")
    (tmp_path / "bprop.cfg").write_text(
        f"SPECIFICATION Spec\n{prop}CONSTANT Lim = 3\n"
        f"CHECK_DEADLOCK FALSE\n")
    spec = str(tmp_path / "bprop.tla")
    kw = dict(host_seen=case != "level")
    if case == "seen_cap":
        kw["seen_cap"] = 64
    rj = TpuExplorer(jload(spec, None, False), **kw).batch_block_reason()
    rt = TorchExplorer(tload(spec), device="cpu",
                       **kw).batch_block_reason()
    assert rt == rj
    assert rt is not None


def test_batch_profiles_match_reference(tmp_path):
    for v in VARIANTS:
        pj = jprofile(jcfg(BT, btcfg(v)))
        pt = tprofile(tcfg(BT, btcfg(v)))
        assert (pt.bsig, pt.lift, pt.cost_estimate) == \
            (pj.bsig, pj.lift, pj.cost_estimate)
    assert tprofile(TCfg(spec=BT, cfg=btcfg("a"))) is None  # interp
    assert tprofile(tcfg(BT, btcfg("a"), por=True)) is None


@pytest.mark.parametrize("cvec", [(13, 11, 2, 3), (5, 40, 7, 1)])
def test_lifted_predicate_matches_reference(cvec):
    """InBound (x =< Bound) and StateCap (wraps =< WrapCap) compiled with
    the four batchtoy constants lifted, evaluated over rows from a seed
    with each constant vector, in the port and in the reference."""
    lift = ("Bound", "Limit", "Step", "WrapCap")
    je = TpuExplorer(jload(BT, btcfg("a"), False), host_seen=True,
                     lift_consts=lift)
    te = TorchExplorer(tload(BT, btcfg("a")), host_seen=True, device="cpu",
                       lift_consts=lift)
    rng = np.random.default_rng(sum(cvec))
    rows = rng.integers(0, 45, (257, te.W)).astype(np.int32)
    cj = jnp.asarray(np.asarray(cvec, np.int32))
    for (nj, fj), (nt, ft), in zip(je.inv_fns + je.constraint_fns,
                                   te.inv_fns + te.constraint_fns):
        assert nj == nt
        want = np.asarray(jax.vmap(
            lambda r, f=fj: je._traced_with(f, cj, r))(jnp.asarray(rows)))
        te._set_const_lanes(torch.as_tensor(
            np.tile(np.asarray(cvec, np.int32), (len(rows), 1))))
        try:
            got = ft(torch.as_tensor(rows)).numpy()
        finally:
            te._set_const_lanes(None)
        np.testing.assert_array_equal(got, want)


def test_lifted_constant_in_a_static_position_is_refused_alike(tmp_path):
    """A lifted name where compilation needs a static value (an interval
    bound) fails the build in both, and BatchCheckEngine names it."""
    (tmp_path / "lst.tla").write_text(
        "---- MODULE lst ----\nEXTENDS Naturals\nCONSTANT N\nVARIABLE x\n"
        "Init == x = 0\nNext == \\E i \\in 1..N : x' = i\n"
        "Spec == Init /\\ [][Next]_x\n====\n")
    (tmp_path / "lst.cfg").write_text("SPECIFICATION Spec\nCONSTANT N = 3\n"
                                      "CHECK_DEADLOCK FALSE\n")
    spec = str(tmp_path / "lst.tla")
    rj = TpuExplorer(jload(spec, None, False), host_seen=True,
                     lift_consts=("N",))
    rt = TorchExplorer(tload(spec), host_seen=True, device="cpu",
                       lift_consts=("N",))
    assert [a.label for a, _ in rt.fb_arms] == \
        [a.label for a, _ in rj.fb_arms]
    assert [r for _, r in rt.fb_arms] == [r for _, r in rj.fb_arms]
    assert rt.batch_block_reason() == rj.batch_block_reason()


def _epilogue_inputs(rng, B, A, CH, PW, fcounts):
    en = rng.random((B, A, CH)) < 0.4
    aok = rng.random((B, A, CH)) < 0.97
    ov = np.where(rng.random((B, A, CH)) < 0.01,
                  rng.integers(1, 4, (B, A, CH)), 0).astype(np.int32)
    C = A * CH
    keys = rng.integers(-2**31, 2**31, (B * C, 5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (B * C, PW)).astype(np.int32)
    povf = rng.random(B) < 0.3
    inv = rng.random(B * C) < 0.9
    exp = rng.random(B * C) < 0.8
    t = torch.as_tensor
    return (t(en), t(aok), t(ov), t(np.asarray(fcounts, np.int32)),
            t(keys), t(cand), t(povf), OV_PACK, t(inv), t(exp))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,A,CH,PW", [(1, 3, 64, 2), (3, 13, 64, 2),
                                       (4, 5, 256, 7)])
def test_batch_epilogue_twin_is_k7_per_member(seed, B, A, CH, PW):
    rng = np.random.default_rng(seed * 101 + B * 7 + A)
    fcounts = list(rng.integers(1, CH + 1, B))
    fcounts[seed % B] = 0  # one idle lane
    args = _epilogue_inputs(rng, B, A, CH, PW, fcounts)
    en, aok, ov, fc, keys, cand, povf, ovp, inv, exp = args
    out = ops.batch_epilogue(*args)  # a CPU tensor: the twin
    C = A * CH
    offs = out["offsets"].tolist()
    assert offs[0] == 0 and len(offs) == B + 1
    for b in range(B):
        sl = slice(b * C, (b + 1) * C)
        k7 = ops.hstep_epilogue_twin(en[b], aok[b], ov[b], fcounts[b],
                                     keys[sl], cand[sl], povf[b], ovp,
                                     inv[sl], exp[sl])
        assert out["scalars"][b].tolist() == k7["scalars"].tolist()
        assert torch.equal(out["dead"][b], k7["dead"])
        lo, hi = offs[b], offs[b + 1]
        assert hi - lo == int(k7["scalars"][0])
        for k in ("idx", "fps", "rows", "inv_ok", "explore"):
            assert torch.equal(out[k][lo:hi], k7[k]), k
        if fcounts[b] == 0:
            assert out["scalars"][b][0] == 0 and out["scalars"][b][4] == 0


def test_batchbench_parity_and_occupancy_on_the_cpu(capsys):
    """The bench's cold cohort and (here over the cold cfgs, to keep the
    run short) its warm rung: parity and full occupancy; the verdict
    line follows the throughput gate."""
    from jaxmc_torch.batchbench import COLD_CFGS, DEFAULT_SPEC, run_leg
    lines = []
    rc = run_leg(DEFAULT_SPEC, COLD_CFGS, COLD_CFGS[:2], device="cpu",
                 log=lines.append)
    last = lines[-1]
    assert "occupancy 4/4 | parity bit-identical" in last, lines
    assert rc == (0 if last.startswith("BATCH-CHECK PASS") else 1)
    assert not any("FAIL [" in ln for ln in lines)
