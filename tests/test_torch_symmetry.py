"""cfg SYMMETRY and VIEW on the torch level engine against the JAX
reference: the orbit canonicaliser (its batch-first twin and the program
the CUDA kernel K5 interprets) against jax.vmap(build_canon2(...)) on
rows made from a numpy seed, _keys_of in its VIEW, SYMMETRY and
SYMMETRY+VIEW branches, and whole runs against TpuExplorer.  Bit-exact
throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxmc import obs as jobs
from jaxmc.backend.bfs import TpuExplorer
from jaxmc.compile.kernel2 import build_layout2 as jbuild_layout
from jaxmc.compile.symmetry2 import build_canon2 as jbuild_canon
from jaxmc.compile.vspec import Bounds as JBounds
from jaxmc.engine.explore import format_trace as jformat
from jaxmc.engine.simulate import sample_states as jsample
from jaxmc.session import load_model as jload
from jaxmc_torch import obs as tobs
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.compile.kernel2 import build_layout2 as tbuild_layout
from jaxmc_torch.compile.symmetry2 import HEADER
from jaxmc_torch.compile.symmetry2 import build_canon2 as tbuild_canon
from jaxmc_torch.compile.vspec import Bounds as TBounds
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.engine.simulate import sample_states as tsample
from jaxmc_torch.kernels import ops
from jaxmc_torch.session import load_model as tload
from jaxmc_torch.sem.values import fmt as tfmt
from jaxmc.sem.values import fmt as jfmt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SENT = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs on one intra-op thread: several test workers
    share the machine, and oversubscribed OpenMP pools stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every container kind the canonicaliser transforms (seq, growset,
# union, pfcn, kvtable), in a fixture of the port
KINDS = os.path.join(ROOT, "jaxmc_torch", "fixtures", "symkinds")

# symtoy with a VIEW that forgets `owner` and `used`: SYMMETRY and VIEW
# together
SYMVIEW_CFG = """SPECIFICATION Spec
CONSTANTS
  P = {p1, p2, p3}
  None = None
SYMMETRY Perms
VIEW V
INVARIANT TypeInv
"""


def _spec(name):
    return os.path.join(SPECS, name)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _symview_spec(tmp_path):
    with open(_spec("symtoy.tla")) as fh:
        text = fh.read().replace("MODULE symtoy ", "MODULE symview ")
    text = text.replace("Spec == ", "V == turns\n\nSpec == ")
    return (_write(tmp_path, "symview.tla", text),
            _write(tmp_path, "symview.cfg", SYMVIEW_CFG))


def _random_rows(layout, n, seed, extra=()):
    """Encoded sample states and rows of small random lane values: count
    lanes, union tags, present bits and enum indices both inside and
    past their ranges, some SENTINEL lanes."""
    rng = np.random.default_rng(seed)
    W = layout.width
    rows = rng.integers(-2, 14, (n, W)).astype(np.int32)
    rows[rng.random((n, W)) < 0.05] = SENT
    enc = [np.asarray(layout.encode(s), np.int32) for s in extra]
    return np.concatenate([np.stack(enc), rows]) if enc else rows


def run_program(blob, rows):
    """The K5 program interpreted in numpy, row by row (the format is
    documented in jaxmc_torch/compile/symmetry2.py)."""
    P, U, W = (int(x) for x in blob[:3])
    o = [int(x) for x in blob[3:11]]
    pl = blob[o[0]:o[1]]
    lops = blob[o[1]:o[2]].reshape(-1, 3)
    alts = blob[o[2]:o[3]].reshape(-1, 4)
    conds = blob[o[3]:o[4]].reshape(-1, 3)
    ps = blob[o[4]:o[5]]
    sorts = blob[o[5]:o[6]].reshape(-1, 6)
    tabs = blob[o[6]:o[7]].reshape(P, U)
    assert o[7] == len(blob) and o[0] == HEADER

    def holds(inp, c0, nc):
        for lane, op, k in conds[c0:c0 + nc]:
            v = inp[lane]
            if not (v > k if op == 0 else v == k):
                return False
        return True

    out = rows.copy()
    for r, inp in enumerate(rows):
        best = list(inp)
        for p in range(P):
            cand = list(inp)
            for out_lane, a0, na in lops[pl[p]:pl[p + 1]]:
                for src, use_tab, c0, nc in alts[a0:a0 + na]:
                    if holds(inp, c0, nc):
                        v = int(inp[src])
                        if use_tab and v != SENT:
                            v = int(tabs[p][min(max(v, 0), U - 1)])
                        cand[out_lane] = v
                        break
            for off, nrow, rw, kc, c0, nc in sorts[ps[p]:ps[p + 1]]:
                if holds(inp, c0, nc):
                    blk = [cand[off + j * rw:off + (j + 1) * rw]
                           for j in range(nrow)]
                    blk.sort(key=lambda b: tuple(b[:kc]))   # stable
                    cand[off:off + nrow * rw] = sum(blk, [])
            if tuple(cand) < tuple(best):
                best = cand
        out[r] = best
    return out


def _layout_pair(spec, cfg):
    """Both packages' layouts from their own layout samples."""
    mj, mt = jload(spec, cfg, False), tload(spec, cfg)
    sj = list(jsample(mj))
    lj = jbuild_layout(mj, sj, JBounds())
    lt = tbuild_layout(mt, list(tsample(mt)), TBounds())
    return mj, mt, lj, lt, sj


def _assert_layouts_equal(lj, lt):
    assert list(lj.vars) == list(lt.vars)
    assert [repr(lj.specs[v]) for v in lj.vars] == \
        [repr(lt.specs[v]) for v in lt.vars]
    assert [jfmt(v) for v in lj.uni.values] == \
        [tfmt(v) for v in lt.uni.values]
    assert lj.width == lt.width


def _check_canon(mj, mt, lj, lt, rows):
    want = np.asarray(jbuild_canon(mj, lj)(jnp.asarray(rows)))
    canon = tbuild_canon(mt, lt)
    got = canon.twin(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(run_program(canon.program, rows), want)
    # the kernel's wrapper on the CPU: the twin, invalid rows untouched
    valid = np.arange(len(rows)) % 3 != 0
    got = ops.canon_rows(torch.as_tensor(rows), torch.as_tensor(valid),
                         canon).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[~valid], rows[~valid])
    return canon


@pytest.mark.parametrize("spec,cfg", [
    ("symtoy.tla", "symtoy.cfg"),
    ("symtoy_multiinit.tla", "symtoy_multiinit.cfg"),
    ("symtoy_scaled.tla", "symtoy_scaled.cfg"),
])
def test_canon_matches_reference_on_fixture_layouts(spec, cfg):
    mj, mt, lj, lt, sampled = _layout_pair(_spec(spec), _spec(cfg))
    _assert_layouts_equal(lj, lt)
    rows = _random_rows(lj, 150, seed=3, extra=sampled[:60])
    canon = _check_canon(mj, mt, lj, lt, rows)
    assert canon.n_perms == 5      # Permutations of 3 processes


def test_canon_matches_reference_on_every_container_kind():
    mj, mt, lj, lt, sampled = _layout_pair(KINDS + ".tla", KINDS + ".cfg")
    _assert_layouts_equal(lj, lt)
    kinds = {lj.specs[v].kind for v in lj.vars}
    assert kinds == {"seq", "growset", "union", "pfcn", "kvtable"}
    rows = _random_rows(lj, 120, seed=7, extra=sampled[:80])
    canon = _check_canon(mj, mt, lj, lt, rows)
    # the program guards on each kind's lane: count (seq, growset,
    # kvtable), present bit (pfcn), tag (union); and re-sorts blocks
    o = [int(x) for x in canon.program[3:11]]
    ops_used = set(canon.program[o[3]:o[4]].reshape(-1, 3)[:, 1].tolist())
    assert ops_used == {0, 1}
    assert o[6] > o[5]                  # sort blocks present


def test_identity_group_builds_no_canonicaliser():
    mt = tload(_spec("symid.tla"), _spec("symid.cfg"))
    lt = tbuild_layout(mt, list(tsample(mt)), TBounds())
    assert tbuild_canon(mt, lt) is None


# ---------------------------------------------------------------------------
# _keys_of: VIEW, SYMMETRY, SYMMETRY+VIEW
# ---------------------------------------------------------------------------

def _engines(spec, cfg, **kw):
    ej = TpuExplorer(jload(spec, cfg, False), **kw)
    et = TorchExplorer(tload(spec, cfg), device="cpu", **kw)
    assert (et.W, et.PW, et.K, et.fp_mode, et.key_width) == \
        (ej.W, ej.PW, ej.K, ej.fp_mode, ej.key_width)
    return ej, et


def _block(ej, n, seed):
    rows = np.stack([ej.layout.encode(s) for s in jsample(
        ej.model, bfs_states=n, n_walks=5, walk_depth=20)])
    rng = np.random.default_rng(seed)
    rows = rows[rng.integers(0, len(rows), n)].astype(np.int32)
    valid = rng.random(n) < 0.7
    rows[~valid] = SENT
    return rows, valid


def _keys_equal(ej, et, rows, valid):
    kj, pj, oj = ej._keys_of(jnp.asarray(rows), jnp.asarray(valid))
    kt, pt, ot = et._keys_of(torch.as_tensor(rows), torch.as_tensor(valid))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert bool(ot) == bool(oj)
    return bool(ot)


@pytest.mark.parametrize("seen_mode", ["auto", "fingerprint"])
@pytest.mark.parametrize("case", ["view", "symmetry", "symmetry+view"])
def test_keys_of_branches_match_reference(case, seen_mode, tmp_path):
    if case == "view":
        spec, cfg = _spec("viewtoy_scaled.tla"), _spec("viewtoy_scaled.cfg")
    elif case == "symmetry":
        spec, cfg = _spec("symtoy_scaled.tla"), _spec("symtoy_scaled.cfg")
    else:
        spec, cfg = _symview_spec(tmp_path)
    ej, et = _engines(spec, cfg, seen_mode=seen_mode)
    assert (et.view_fn is not None) == ("view" in case)
    assert (et.canon is not None) == ("symmetry" in case)
    rows, valid = _block(ej, 300, seed=19)
    assert _keys_equal(ej, et, rows, valid) is False
    hj = ej._host_keys(rows[valid][:40])
    ht = et._host_keys(rows[valid][:40])
    for a, b in zip(ht[:2], hj[:2]):
        np.testing.assert_array_equal(a, b)


def test_pack_overflow_of_a_canonical_row_matches_reference():
    """A permutation moves values across lanes, so a canonical row can
    leave a lane's range that no raw row leaves: with one turns lane's
    range cut to its lowest value in both plans, a valid row whose raw
    lanes all fit and whose orbit minimum does not must raise pack_ovf
    in both packages (the run then ends in OV_PACK)."""
    ej, et = _engines(_spec("symtoy_scaled.tla"), _spec("symtoy_scaled.cfg"))
    lay = ej.layout
    lane = sum(lay.specs[v].width
               for v in lay.vars[:list(lay.vars).index("turns")])
    assert not ej.plan.full[lane]               # turns[p1]
    for plan in (ej.plan, et.plan):
        plan.allowed = np.array(plan.allowed)
        plan.allowed[lane] = 0
    et.plan.__dict__.pop("_tensor_cache", None)
    et.pt = et.plan.tensors("cpu")
    canon = jbuild_canon(ej.model, ej.layout)
    rows, valid = _block(ej, 400, seed=23)
    raw_ok = np.asarray(~ej.plan.pack_rows(jnp.asarray(rows))[1])
    canon_bad = np.asarray(ej.plan.pack_rows(canon(jnp.asarray(rows)))[1])
    pick = np.nonzero(valid & raw_ok & canon_bad)[0]
    assert len(pick) > 0
    one = np.zeros(len(rows), bool)
    one[pick[0]] = True
    assert _keys_equal(ej, et, rows, one) is True
    # the same row invalid: no overflow
    assert _keys_equal(ej, et, rows, np.zeros(len(rows), bool)) is False


# ---------------------------------------------------------------------------
# whole runs against TpuExplorer
# ---------------------------------------------------------------------------

def _assert_parity(rj, rt):
    assert (rt.ok, rt.generated, rt.distinct, rt.diameter) == \
        (rj.ok, rj.generated, rj.distinct, rj.diameter)
    assert rt.warnings == rj.warnings
    assert (rt.violation is None) == (rj.violation is None)
    if rj.violation is not None:
        vj, vt = rj.violation, rt.violation
        assert (vt.kind, vt.name) == (vj.kind, vj.name)
        assert [lbl for _, lbl in vt.trace] == [lbl for _, lbl in vj.trace]
        assert tformat(vt) == jformat(vj)


def run_both(spec, cfg, no_deadlock=False, **kw):
    """(reference result, port result, reference telemetry, port
    telemetry) of one spec and cfg."""
    tel = jobs.Telemetry()
    with jobs.use(tel):
        rj = TpuExplorer(jload(spec, cfg, no_deadlock), **kw).run()
    ttel = tobs.reset()
    rt = TorchExplorer(tload(spec, cfg, no_deadlock=no_deadlock),
                       device="cpu", **kw).run()
    _assert_parity(rj, rt)
    return rj, rt, tel, ttel


@pytest.mark.parametrize("spec,cfg,no_deadlock,want", [
    ("symtoy.tla", "symtoy.cfg", True, (33, 22)),
    ("symid.tla", "symid.cfg", False, (4, 4)),
    ("symtoy_multiinit.tla", "symtoy_multiinit.cfg", True, None),
    ("symtoy_scaled.tla", "symtoy_scaled.cfg", True, (65365, 10725)),
    ("viewtoy.tla", "viewtoy.cfg", False, (11, 5)),
    ("viewtoy_scaled.tla", "viewtoy_scaled.cfg", False, (239617, 18432)),
])
def test_whole_runs_match_reference(spec, cfg, no_deadlock, want):
    rj, rt, tel, ttel = run_both(_spec(spec), _spec(cfg), no_deadlock,
                                 store_trace=False)
    assert rt.ok and rt.warnings == []
    if want is not None:
        assert (rt.generated, rt.distinct) == want
    assert ttel.gauges["dedup.mode"] == tel.gauges["dedup.mode"]


def test_symmetry_and_view_together_match_reference(tmp_path):
    spec, cfg = _symview_spec(tmp_path)
    rj, rt, _, _ = run_both(spec, cfg, no_deadlock=True)
    assert rt.ok and rt.distinct < 22


def test_group_limit_runs_unreduced_with_the_reference_warning(
        monkeypatch):
    monkeypatch.setenv("JAXMC_SYM_GROUP_LIMIT", "1")
    rj, rt, _, _ = run_both(_spec("symtoy.tla"), _spec("symtoy.cfg"),
                            no_deadlock=True)
    assert len(rt.warnings) == 1
    assert rt.warnings[0].startswith("cfg SYMMETRY NOT applied")
    assert "JAXMC_SYM_GROUP_LIMIT" in rt.warnings[0]
    assert rt.distinct > 22


def test_symmetry_invariant_violation_trace_matches_reference(tmp_path):
    """A violated invariant under SYMMETRY: same verdict, counts and
    trace (the stored rows are raw states, the init row canonical)."""
    cfg = _write(tmp_path, "symtoy_bad.cfg", """SPECIFICATION Spec
CONSTANTS
  P = {p1, p2, p3}
  None = None
SYMMETRY Perms
INVARIANT Small
""")
    with open(_spec("symtoy.tla")) as fh:
        text = fh.read().replace("MODULE symtoy ", "MODULE symbad ")
    text = text.replace("Spec == ",
                        "Small == \\A p \\in P : turns[p] < 2\n\nSpec == ")
    spec = _write(tmp_path, "symbad.tla", text)
    rj, rt, _, _ = run_both(spec, cfg, no_deadlock=True)
    assert rt.violation.kind == "invariant" and rt.violation.name == "Small"
