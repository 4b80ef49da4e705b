"""The generated transition kernels (K15 gen_expand, K16 gen_pred, K17
gen_value) on the CPU.  compile/cgen.py writes one C++ source per engine
that nvcc builds for the card; the same source compiles as plain C++17,
so g++ builds it here and the tests call its host entry points, the very
row functions the card runs.  Their outputs must equal the port's
emitter and jax.vmap of the reference's compiled unit bit for bit, on
every row; op-level cases pin the lanes semantics (int32 wrap, floor
division, clamped gathers, the int64 sum, argmax ties); every public
lanes function and BL operator has a trace rule and a codegen rule; the
source is deterministic; and whole searches that route _expand and the
predicates through the host build give the emitter's runs."""

import ctypes
import hashlib
import importlib
import inspect
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the host build of the "
                                       "generated source needs it")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


# ---------------------------------------------------------------------------
# the host build (a test harness: the port itself builds with nvcc)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("genhost"))


def host_lib(source: str, out_dir: str) -> ctypes.CDLL:
    d = os.path.join(out_dir, hashlib.sha256(source.encode()).hexdigest()
                     [:16])
    so = os.path.join(d, "libgen.so")
    if not os.path.exists(so):
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "gen.cu")
        with open(src, "w") as fh:
            fh.write(source)
        subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-Wall", "-Werror", "-Wno-unused-variable",
                        "-Wno-unused-function", "-x", "c++", src, "-o", so],
                       check=True)
    lib = ctypes.CDLL(so)
    lib.jmc_gen_expand_host.argtypes = [_P, _P, _I64, _P, ctypes.c_int,
                                        _I64, ctypes.c_int, _P, _P, _P, _P]
    lib.jmc_gen_pred_host.argtypes = [ctypes.c_int, _P, _P, _I64, _I64, _P]
    lib.jmc_gen_value_host.argtypes = [_P, _P, _I64, _I64, _P]
    return lib


def _p(a: np.ndarray):
    return _P(a.ctypes.data)


def _cv(gm, cvals, n):
    """(table, rows per table row), as kernels/ops.py passes them."""
    if cvals is None or not gm.L:
        return np.zeros((1, 1), np.int32), 1
    cv = np.ascontiguousarray(np.asarray(cvals), np.int32)
    return cv, n // cv.shape[0]


def host_expand(lib, gm, rows, units, cvals=None, G=None):
    """K15's host entry: the kernel's blocks of gm.meta["tile"] rows with
    `G` instances each (the wrapper's ops.gen_groups by default)."""
    from jaxmc_torch.kernels import ops
    rows = np.ascontiguousarray(rows, np.int32)
    units = np.ascontiguousarray(units, np.int32)
    A, N, W = len(units), rows.shape[0], gm.W
    T = gm.meta["tile"]
    if G is None:
        G = ops.gen_groups(A, -(-N // T)) if T else A
    en = np.zeros((A, N), np.uint8)
    aok = np.zeros((A, N), np.uint8)
    ov = np.zeros((A, N), np.int32)
    succ = np.zeros((A, N, W), np.int32)
    cv, cs = _cv(gm, cvals, N)
    assert lib.jmc_gen_expand_host(_p(rows), _p(cv), cs, _p(units), A, N, G,
                                   _p(en), _p(aok), _p(ov), _p(succ)) == 0
    return en.astype(bool), aok.astype(bool), ov, succ


def host_pred(lib, gm, which, rows, cvals=None):
    rows = np.ascontiguousarray(rows, np.int32)
    N = rows.shape[0]
    out = np.zeros(N, np.uint8)
    cv, cs = _cv(gm, cvals, N)
    lib.jmc_gen_pred_host(which, _p(rows), _p(cv), cs, N, _p(out))
    return out.astype(bool)


def host_value(lib, gm, rows, cvals=None):
    rows = np.ascontiguousarray(rows, np.int32)
    N = rows.shape[0]
    out = np.zeros((N, gm.VW), np.int32)
    cv, cs = _cv(gm, cvals, N)
    lib.jmc_gen_value_host(_p(rows), _p(cv), cs, N, _p(out))
    return out


# ---------------------------------------------------------------------------
# models: the port's compiled units and the reference's, on one layout
# ---------------------------------------------------------------------------

def _path(name, base=SPECS):
    if name is None:
        return None
    return name if os.path.isabs(name) else os.path.join(base, name)


def _build(pkg, spec, cfg):
    sess = importlib.import_module(pkg + ".session")
    sim = importlib.import_module(pkg + ".engine.simulate")
    k2 = importlib.import_module(pkg + ".compile.kernel2")
    vs = importlib.import_module(pkg + ".compile.vspec")
    gr = importlib.import_module(pkg + ".compile.ground")
    an = importlib.import_module(pkg + ".analyze")
    model = sess.load_model(_path(spec), _path(cfg), False)
    sampled = sim.sample_states(model, bfs_states=800, n_walks=40,
                                walk_depth=60)
    rep = an.infer_state_bounds(model)
    sb = rep.element_bounds() if rep is not None else None
    lay = k2.build_layout2(model, sampled, vs.Bounds(), static_bounds=sb)
    kc = k2.KernelCtx(model, lay, vs.Bounds())
    cas = []
    for arm in gr.split_arms(model):
        try:
            gas = gr.ground_arm(model, arm, dyn_slots=vs.Bounds().kv_cap)
            got = [k2.compile_action2(kc, ga) for ga in gas]
            zero = np.zeros((1, lay.width), np.int32)
            for ca in got:
                for s in (range(ca.n_slots) if ca.n_slots else [None]):
                    if pkg == "jaxmc_torch":
                        args = (torch.as_tensor(zero),) + \
                            (() if s is None else (s,))
                        ca.fn(*args)
                    else:
                        jax.eval_shape(ca.fn, jnp.asarray(zero[0]),
                                       *(() if s is None
                                         else (jnp.int32(s),)))
        except vs.CompileError:
            continue        # a demoted arm (hybrid): interpreted
        cas += got
    preds = [(nm, k2.compile_predicate2(kc, ex))
             for nm, ex in list(model.invariants) + list(model.constraints)]
    view = k2.compile_value2(kc, model.view) \
        if getattr(model, "view", None) is not None else None
    return lay, cas, preds, view, sampled, kc


FIXTURES = [
    ("constoy.tla", "constoy.cfg"),
    ("batchtoy.tla", "batchtoy_a.cfg"),
    ("transfer_scaled.tla", "transfer_scaled.cfg"),
    ("pcal_intro_buggy.tla", None),
    ("msgstoy.tla", "msgstoy.cfg"),          # a slotted \E arm
    ("portoy.tla", "portoy.cfg"),
    ("symtoy.tla", "symtoy.cfg"),            # SYMMETRY model's actions
    ("viewtoy.tla", "viewtoy.cfg"),          # K17
    ("interparm_toy.tla", "interparm_toy.cfg"),  # hybrid: compiled arms
]


@pytest.mark.parametrize("spec,cfg", FIXTURES)
def test_generated_units_match_emitter_and_reference(spec, cfg, host_dir):
    from jaxmc_torch.compile import cgen
    lj, casj, predsj, viewj, sampled, _ = _build("jaxmc", spec, cfg)
    lt, cast, predst, viewt, _, kc = _build("jaxmc_torch", spec, cfg)
    assert [c.label for c in cast] == [c.label for c in casj]
    gm = cgen.build_module(kc, lt.width, cast, predst, viewt)
    lib = host_lib(gm.source, host_dir)
    rng = np.random.default_rng(0)
    enc = np.stack([lj.encode(s) for s in sampled])
    rows = enc[rng.integers(0, len(enc), 256)].astype(np.int32)
    A = len(gm.actions)
    en, aok, ov, succ = host_expand(lib, gm, rows, np.arange(A))
    i = 0
    for a, b in zip(casj, cast):
        for slot in (range(a.n_slots) if a.n_slots else [None]):
            if slot is None:
                rj = jax.vmap(a.fn)(jnp.asarray(rows))
                rt = b.fn(torch.as_tensor(rows))
            else:
                rj = jax.vmap(a.fn, in_axes=(0, None))(
                    jnp.asarray(rows), jnp.int32(slot))
                rt = b.fn(torch.as_tensor(rows), slot)
            for g, x, y, nm in zip((en[i], aok[i], ov[i], succ[i]), rj, rt,
                                   ("en", "aok", "ov", "succ")):
                msg = f"{b.label} slot={slot} {nm}"
                np.testing.assert_array_equal(g, y.numpy(), err_msg=msg)
                np.testing.assert_array_equal(g, np.asarray(x), err_msg=msg)
            i += 1
    assert i == A
    assert en.sum() > 0
    for w, ((nj, fj), (nt, ft)) in enumerate(zip(predsj, predst)):
        g = host_pred(lib, gm, w, rows)
        np.testing.assert_array_equal(g, ft(torch.as_tensor(rows)).numpy(),
                                      err_msg=nt)
        np.testing.assert_array_equal(
            g, np.asarray(jax.vmap(fj)(jnp.asarray(rows))), err_msg=nj)
    assert (viewt is None) == (viewj is None) == (gm.value is None)
    if viewt is not None:
        g = host_value(lib, gm, rows)
        np.testing.assert_array_equal(
            g, viewt(torch.as_tensor(rows)).numpy().reshape(len(rows), -1))
        np.testing.assert_array_equal(
            g, np.asarray(jax.vmap(viewj)(jnp.asarray(rows))).reshape(
                len(rows), -1))


def test_lifted_constants_match_emitter(host_dir):
    """A batchtoy cohort engine compiles its CONSTANTs as lifted lanes:
    the generated units read them per row (each row its own member's
    value) and equal the emitter with the same lanes installed."""
    from jaxmc_torch.analyze.bounds import liftable_constants
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.compile.lanes import BL
    from jaxmc_torch.session import load_model
    models = [load_model(_path("batchtoy.tla"), _path(f"batchtoy_{c}.cfg"))
              for c in "abcd"]
    lift = liftable_constants(models[0])
    assert lift, "the batchtoy cohort lifts no constant"
    eng = TorchExplorer(models[0], device="cpu", host_seen=True,
                        lift_consts=lift)
    gm = cgen.build_module(eng.kc, eng.W, eng.compiled,
                           list(eng.inv_fns) + list(eng.constraint_fns),
                           eng.view_fn, eng._lift_names)
    assert gm.L == len(lift) > 0
    lib = host_lib(gm.source, host_dir)
    cvecs = np.asarray([[int(m.defs[n]) for n in lift] for m in models],
                       np.int32)
    rng = np.random.default_rng(1)
    rows = np.stack([eng.layout.encode(s) for s in eng.init_states])
    rows = rows[rng.integers(0, len(rows), 64)].astype(np.int32)
    rows[:, :] += rng.integers(-2, 3, rows.shape).astype(np.int32)
    per_row = cvecs[rng.integers(0, len(models), len(rows))]
    t = torch.as_tensor(rows)
    eng.kc.const_lanes = {nm: BL(torch.as_tensor(per_row[:, j]))
                          for j, nm in enumerate(eng._lift_names)}
    try:
        want = eng._expand(t)
        want_p = [f(t) for _, f in eng.inv_fns + eng.constraint_fns]
    finally:
        eng.kc.const_lanes = {}
    got = host_expand(lib, gm, rows, np.arange(len(gm.actions)), per_row)
    for g, w, nm in zip(got, want, ("en", "aok", "ov", "succ")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=nm)
    for w, want_w in enumerate(want_p):
        np.testing.assert_array_equal(host_pred(lib, gm, w, rows, per_row),
                                      want_w.numpy())
    # one member's values for every row, and one member per 16 rows
    for table in (cvecs[2:3], cvecs):
        got = host_expand(lib, gm, rows, np.arange(len(gm.actions)), table)
        each = np.repeat(table, len(rows) // len(table), axis=0)
        eng.kc.const_lanes = {nm: BL(torch.as_tensor(each[:, j]))
                              for j, nm in enumerate(eng._lift_names)}
        try:
            want = eng._expand(t)
        finally:
            eng.kc.const_lanes = {}
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# op level: every lanes function and BL operator, with edge cases
# ---------------------------------------------------------------------------

INT_MIN, INT_MAX = -2**31, 2**31 - 1
EDGE = np.asarray([
    [INT_MIN, -1, 7, -7, 0, 3, INT_MAX, 2],
    [INT_MAX, 1, -2, 2, 0, -3, INT_MIN, 40],
    [-7, 2, -2, 0, 5, 9, 1, -1],
    [7, -2, 2, 0, -5, -9, -1, 31],
    [0, 0, 0, 0, 0, 0, 0, 0],
    [3, 3, 3, 1, 3, 2, 3, 3],
    [-1, -3, 1, 4, 7, 11, -6, 5],
    [5, 8, 100, -100, 9, -9, 2, -31],
], np.int32)


REV = np.arange(7, -1, -1)       # a static gather reversing the row


def _cases():
    """name -> fn(row BL) -> BL: one case per lanes function and BL
    operator (several for the ones with edge cases)."""
    from jaxmc_torch.compile import lanes as L
    c = {}
    c["BL.__add__"] = lambda r: r + r[1:2]
    c["BL.__radd__"] = lambda r: 5 + r
    c["BL.__sub__"] = lambda r: r - r[REV]
    c["BL.__rsub__"] = lambda r: INT_MIN - r
    c["BL.__mul__"] = lambda r: r * r[0]
    c["BL.__rmul__"] = lambda r: 65537 * r
    c["BL.__floordiv__"] = lambda r: r // r[REV]
    c["BL.__rfloordiv__"] = lambda r: -7 // r
    c["BL.__mod__"] = lambda r: r % r[REV]
    c["BL.__rmod__"] = lambda r: 7 % r
    c["BL.__lt__"] = lambda r: r < r[3]
    c["BL.__le__"] = lambda r: r <= 3
    c["BL.__gt__"] = lambda r: r > r[REV]
    c["BL.__ge__"] = lambda r: r >= np.arange(8)
    c["BL.__eq__"] = lambda r: r == r[5]
    c["BL.__ne__"] = lambda r: r != 0
    c["BL.__and__"] = lambda r: r & r[REV]
    c["BL.__rand__"] = lambda r: np.int32(6) & r
    c["BL.__or__"] = lambda r: (r > 0) | (r < -5)
    c["BL.__ror__"] = lambda r: 1 | r
    c["BL.__xor__"] = lambda r: r ^ (r > 2)
    c["BL.__invert__"] = lambda r: L.concatenate([~r, (~(r > 0)).astype(
        L.int32)])
    c["BL.__neg__"] = lambda r: -r
    c["BL.__getitem__"] = lambda r: L.concatenate(
        [r[2:6], r[::3], r[-1:], r.reshape(2, 4)[:, 1],
         r.reshape(2, 4)[1]])
    c["BL.__getitem__:traced"] = lambda r: r.reshape(2, 4)[r[0] % 3, 1:]
    c["BL.__getitem__:array"] = lambda r: r[np.asarray([7, 0, 0, 3])]
    c["BL.__iter__"] = lambda r: L.concatenate([x.reshape(1) for x in r])
    c["BL.astype"] = lambda r: L.concatenate([
        r.astype(L.bool_).astype(L.int32), (r > 1).astype(L.int32)])
    c["BL.reshape"] = lambda r: r.reshape(4, 2)[:, 0] + r.reshape((2, 4))[0]
    c["asarray"] = lambda r: L.asarray(r > 0, L.int32) + L.asarray([1, 2, 3,
                                                                    4, 5, 6,
                                                                    7, 8])
    c["zeros"] = lambda r: L.zeros(8) + r
    c["arange"] = lambda r: L.arange(8) * r
    c["reshape"] = lambda r: L.sum(L.reshape(r, (2, 4)), axis=1)
    c["where"] = lambda r: L.where(r > 0, r, r > -2)
    c["where:scalars"] = lambda r: L.where(r[0], 4, True)
    c["where:int_cond"] = lambda r: L.where(r % 2, r > 3, r < 0)
    c["concatenate"] = lambda r: L.concatenate(
        [L.reshape(r, (2, 4)), np.ones((1, 4), np.int32)], axis=0)
    c["concatenate:axis1"] = lambda r: L.concatenate(
        [L.reshape(r, (4, 2)), L.reshape(r > 0, (4, 2))], axis=1)
    c["all"] = lambda r: L.concatenate([L.all(r > -3).reshape(1),
                                        L.all(L.reshape(r, (2, 4)) != 0,
                                              axis=0)])
    c["any"] = lambda r: L.concatenate([L.any(r == 3).reshape(1),
                                        L.any(L.reshape(r, (4, 2)), axis=1)])
    c["sum"] = lambda r: L.sum(r).reshape(1)       # int64 sum, wrapped
    c["sum:bool"] = lambda r: L.sum(L.reshape(r > 0, (2, 4)), axis=-1)
    c["sum:wide"] = lambda r: L.sum(L.reshape(r * L.arange(1, 9), (2, 4))
                                    * 7, axis=1)
    c["argmax"] = lambda r: L.argmax(r).reshape(1)   # first maximum
    c["argmax:ties"] = lambda r: L.argmax(L.reshape(r == r[1], (2, 4)),
                                          axis=1)
    c["take"] = lambda r: L.take(np.asarray([10, 20, 30, 40]), r)
    c["take:traced"] = lambda r: L.take(r, r[REV])     # clamped
    c["take_along_axis"] = lambda r: L.take_along_axis(
        L.reshape(r, (2, 4)), L.reshape(r[REV], (2, 4)), axis=1)
    c["take_along_axis:axis0"] = lambda r: L.take_along_axis(
        L.reshape(r, (4, 2)), L.reshape(r % 5, (4, 2)), axis=0)
    c["clip"] = lambda r: L.clip(r, -3, 9)
    c["maximum"] = lambda r: L.maximum(r, r[REV])
    c["minimum"] = lambda r: L.minimum(r, 2)
    c["floor_divide"] = lambda r: L.floor_divide(r, r[1])
    c["mod"] = lambda r: L.mod(-r, r[REV])
    c["power"] = lambda r: L.power(r, r[REV] % 33 - 2)
    c["power:neg"] = lambda r: L.power(r, L.arange(8) - 5)
    c["negative"] = lambda r: L.negative(r)
    c["logical_not"] = lambda r: L.logical_not(r)
    c["logical_and"] = lambda r: L.logical_and(r, r > 1)
    c["logical_or"] = lambda r: L.logical_or(r > 5, r[0])
    c["equal"] = lambda r: L.equal(r, 3)
    c["less"] = lambda r: L.less(r, r[REV])
    c["less_equal"] = lambda r: L.less_equal(2, r)
    c["greater"] = lambda r: L.greater(r, -1)
    c["greater_equal"] = lambda r: L.greater_equal(r, r[2])
    c["add"] = lambda r: L.add(r, INT_MAX)
    c["subtract"] = lambda r: L.subtract(r, (r > 0).astype(L.int32))
    c["multiply"] = lambda r: L.multiply(r, r)
    c["BL.__add__:broadcast_2d"] = lambda r: L.reshape(r, (2, 1, 4)) + \
        L.reshape(r[0:3], (3, 1))
    c["sum:big_loops"] = lambda r: L.sum(
        L.where(L.arange(64) % (r[7] % 7 + 1) == 0, L.arange(64) * r[0],
                L.take(r, L.arange(64) % 9)))
    return c


# lanes names with no per-row operation to trace: the context and the
# block type, the entry and exit of a unit, dtype names
NOT_OPS = {"on_device", "BL", "rows_of", "int32", "bool_"}


def _public_ops():
    from jaxmc_torch.compile import lanes as L
    names = {n for n, v in vars(L).items()
             if not n.startswith("_") and n not in NOT_OPS
             and callable(v) and not inspect.isclass(v)
             and getattr(v, "__module__", L.__name__) == L.__name__}
    meth = {f"BL.{n}" for n, v in vars(L.BL).items()
            if callable(v) and (not n.startswith("_") or (
                n.startswith("__") and n not in (
                    "__init__", "__len__", "__bool__", "__repr__",
                    "__getattribute__")))
            and n not in ("_bin",)}
    return names | meth


def test_every_lanes_operation_has_a_case():
    """Coverage: every public lanes function and BL operator has a case
    (named `op` or `op:variant`), so each has a trace rule and a codegen
    rule that the cases below run."""
    have = {n.split(":")[0] for n in _cases()}
    missing = sorted(_public_ops() - have)
    assert not missing, f"lanes operations without a case: {missing}"
    assert not have - _public_ops(), sorted(have - _public_ops())


def _run_case(fn, host_dir):
    from jaxmc_torch.compile import cgen, lanes as L, trace as tr

    def unit(rows):
        with L.on_device(rows.device):
            out = fn(L.BL(rows))
            return L.rows_of(out, rows.shape[0])

    u = cgen.Unit("value", "case", unit)
    u.cap = tr.capture(unit, EDGE.shape[1])
    src, meta = cgen.generate([u], EDGE.shape[1], 0)
    gm = type("GM", (), {"W": EDGE.shape[1], "L": 0, "VW": meta["VW"]})()
    got = host_value(host_lib(src, host_dir), gm, EDGE)
    want = unit(torch.as_tensor(EDGE))
    return got, want.reshape(len(EDGE), -1)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_lanes_operation_matches_eager(name, host_dir):
    """The graph of each operation, written as C++ and built with g++,
    equals the eager lanes operation on edge-case rows (INT_MIN,
    INT_MAX, zero and negative divisors, out-of-range indices)."""
    got, want = _run_case(_cases()[name], host_dir)
    np.testing.assert_array_equal(got, want.to(torch.int32).numpy(),
                                  err_msg=name)


def test_edge_semantics_are_the_lanes_rules(host_dir):
    """The values the generated code gives at the edges, spelled out."""
    from jaxmc_torch.compile import lanes as L
    got, _ = _run_case(lambda r: L.concatenate([
        (r[0] // r[1]).reshape(1),     # INT_MIN // -1 wraps to INT_MIN
        (r[0] % r[1]).reshape(1),      # INT_MIN % -1 == 0
        (r[2] // r[4]).reshape(1),     # zero divisor -> 0
        (r[2] % r[4]).reshape(1),
        (r[2] // r[3]).reshape(1),     # floor: 7 // -7 == -1
        (r[6] + r[5]).reshape(1),      # INT_MAX + 3 wraps
        (-r[0]).reshape(1),            # -INT_MIN wraps
        L.take(r, r[6]).reshape(1),    # index INT_MAX clamps to 7
        L.take(r, r[0]).reshape(1),    # index INT_MIN clamps to 0
        L.sum(L.concatenate([r[6:7], r[6:7], r[5:6]])).reshape(1),
        L.argmax(L.asarray([1, 3, 3, 0]) + r[4]).reshape(1)]), host_dir)
    assert got[0].tolist() == [INT_MIN, 0, 0, 0, -1, INT_MIN + 2, INT_MIN,
                               2, INT_MIN, 1, 1]


@pytest.mark.parametrize("spec,cfg", [
    ("pcal_intro_buggy.tla", None),          # W 13, odd
    ("msgstoy.tla", "msgstoy.cfg"),          # slotted instances
])
def test_host_build_runs_small_tiles_and_the_direct_kernel(
        spec, cfg, host_dir, monkeypatch):
    """The host entry runs K15's blocks: tiles of 8 rows (TILE_SMEM cut
    to fit 8) over 3T + 5 rows at every grouping and for one instance,
    and rows too wide to stage (the direct kernel, JMC_TILE 0), equal to
    the emitter."""
    from jaxmc_torch.compile import cgen
    lt, cast, predst, viewt, sampled, kc = _build("jaxmc_torch", spec, cfg)
    W = lt.width
    rng = np.random.default_rng(4)
    enc = np.stack([lt.encode(s) for s in sampled]).astype(np.int32)
    rows = enc[rng.integers(0, len(enc), 29)]
    for smem, smax, T in ((cgen.tile_bytes(W, 8), cgen.SMEM_MAX, 8),
                          (0, 0, 0)):
        monkeypatch.setattr(cgen, "TILE_SMEM", smem)
        monkeypatch.setattr(cgen, "SMEM_MAX", smax)
        gm = cgen.build_module(kc, W, cast, predst, viewt)
        assert gm.meta["tile"] == T and f"#define JMC_TILE {T}\n" in \
            gm.source
        lib = host_lib(gm.source, host_dir)
        A = len(gm.actions)
        units = np.arange(A, dtype=np.int32)
        want = [x.numpy() for x in ops_twin(gm, rows, units)]
        for G in sorted({1, 2, A - 1, A} - {0}):
            for g, w in zip(host_expand(lib, gm, rows, units, G=G), want):
                np.testing.assert_array_equal(g, w)
        one = units[A // 2:A // 2 + 1]
        for g, w in zip(host_expand(lib, gm, rows[:5], one),
                        ops_twin(gm, rows[:5], one)):
            np.testing.assert_array_equal(g, w.numpy())


def ops_twin(gm, rows, units):
    from jaxmc_torch.kernels import ops
    return ops.gen_expand_twin(gm, torch.as_tensor(rows),
                               torch.as_tensor(units))


def test_source_is_deterministic():
    """One model, two captures: the same source bytes (the build cache
    hits)."""
    from jaxmc_torch.compile import cgen
    srcs = []
    for _ in range(2):
        lt, cast, predst, viewt, _, kc = _build("jaxmc_torch", "msgstoy.tla",
                                                "msgstoy.cfg")
        srcs.append(cgen.build_module(kc, lt.width, cast, predst,
                                      viewt).source)
    assert srcs[0] == srcs[1]
    assert "jmc_gen_expand" in srcs[0] and "slot 0" in srcs[0]


def test_untranslatable_unit_names_itself():
    """A unit the capture cannot record raises GenError with its
    label; the emitter is not run in its place."""
    from jaxmc_torch.compile import cgen
    lt, cast, predst, viewt, _, kc = _build("jaxmc_torch", "constoy.tla",
                                            "constoy.cfg")

    def bad(rows):
        raise TypeError("no rule")

    with pytest.raises(cgen.GenError, match="pred Broken"):
        cgen.build_module(kc, lt.width, cast, [("Broken", bad)], None)


def test_failed_build_names_the_unit(tmp_path, monkeypatch):
    """A build that fails raises naming the unit nvcc's error points
    at; a missing nvcc raises too.  Nothing runs the emitter instead."""
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.kernels import build
    lt, cast, predst, viewt, _, kc = _build("jaxmc_torch", "constoy.tla",
                                            "constoy.cfg")
    gm = cgen.build_module(kc, lt.width, cast, predst, viewt)
    first, _last, label = gm.meta["lines"][1]
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho 'gen.cu({first + 2}): error: no'\n"
                    f"exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "GEN_ROOT", str(tmp_path / "gen"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match=label.replace("[", r"\[")):
        gm.load()
    assert gm.lib is None

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", missing)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gm.load()


# ---------------------------------------------------------------------------
# whole searches through the host build
# ---------------------------------------------------------------------------

class HostRouting:
    """on(): every TorchExplorer built afterwards generates its units and
    routes K15-K17 to the g++ build of its source (on the CPU the engine
    otherwise keeps the emitter); `counts` are their calls."""

    def __init__(self, monkeypatch, out_dir):
        self.mp, self.out_dir = monkeypatch, out_dir
        self.counts = {"expand": 0, "pred": 0, "value": 0}

    def on(self):
        from jaxmc_torch.backend import bfs
        from jaxmc_torch.compile import cgen
        from jaxmc_torch.kernels import ops
        init = bfs.TorchExplorer.__init__
        counts, out_dir = self.counts, self.out_dir

        def init2(eng, *a, **kw):
            init(eng, *a, **kw)
            if eng._gen is None and kw.get("donor") is None:
                eng._build_gen()

        def load(gm):
            if gm.lib is None:
                gm.lib = host_lib(gm.source, out_dir)
            return gm.lib

        def np_(x):
            return None if x is None else x.numpy()

        def expand(gm, rows, units, cvals=None):
            counts["expand"] += 1
            return tuple(torch.as_tensor(x) for x in host_expand(
                gm.load(), gm, rows.numpy(), units.numpy(), np_(cvals)))

        def pred(gm, which, rows, cvals=None):
            counts["pred"] += 1
            return torch.as_tensor(host_pred(gm.load(), gm, which,
                                             rows.numpy(), np_(cvals)))

        def value(gm, rows, cvals=None):
            counts["value"] += 1
            return torch.as_tensor(host_value(gm.load(), gm, rows.numpy(),
                                              np_(cvals)))

        self.mp.setattr(bfs.TorchExplorer, "__init__", init2)
        self.mp.setattr(cgen.GenModule, "load", load)
        self.mp.setattr(ops, "gen_expand", expand)
        self.mp.setattr(ops, "gen_pred", pred)
        self.mp.setattr(ops, "gen_value", value)


@pytest.fixture
def routing(monkeypatch, host_dir):
    return HostRouting(monkeypatch, host_dir)


def _summary(r):
    from jaxmc_torch.engine.explore import format_trace
    v = r.violation
    return (r.ok, r.generated, r.distinct, r.diameter, v and v.kind,
            v and v.name, v and format_trace(v), tuple(r.warnings))


def _search(spec, cfg, lines, no_deadlock=False, mesh=False, **kw):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.session import load_model
    m = load_model(_path(spec), _path(cfg), no_deadlock)
    cls = MeshExplorer if mesh else TorchExplorer
    return _summary(cls(m, device="cpu", log=lines.append, **kw).run())


ENGINE_CASES = [
    ("constoy.tla", "constoy.cfg", {}, ("expand", "pred")),
    ("batchtoy.tla", "batchtoy_bad.cfg", {}, ("expand", "pred")),
    ("pcal_intro_buggy.tla", None, dict(resident=True, chunk=2048),
     ("expand",)),
    ("msgstoy.tla", "msgstoy.cfg", dict(host_seen=True, chunk=512),
     ("expand", "pred")),
    ("symtoy.tla", "symtoy.cfg", dict(no_deadlock=True), ("expand",)),
    ("viewtoy.tla", "viewtoy.cfg", {}, ("expand", "value")),
    ("portoy.tla", "portoy_bad.cfg", dict(por=True), ("expand", "pred")),
    ("interparm_toy.tla", "interparm_toy.cfg", dict(host_seen=True),
     ("expand",)),
    ("msgstoy.tla", "msgstoy.cfg", dict(mesh=True, shards=2, por=True),
     ("expand", "pred")),
]


@pytest.mark.parametrize("spec,cfg,kw,need", ENGINE_CASES)
def test_search_through_generated_units(spec, cfg, kw, need, routing):
    """The level, resident, host-seen and mesh engines (SYMMETRY, VIEW,
    --por, a hybrid spec) with every _expand and predicate on the generated
    units equal the emitter's run: verdict, counts, trace, log."""
    emit_lines, gen_lines = [], []
    want = _search(spec, cfg, emit_lines, **kw)
    routing.on()
    got = _search(spec, cfg, gen_lines, **kw)
    assert all(routing.counts[k] > 0 for k in need), routing.counts
    assert got == want
    assert gen_lines == emit_lines


def test_batch_cohort_through_generated_units(routing):
    """The batchtoy cohort (lifted constants, one shared program) with
    K15/K16 on the generated units: each member equal to its run on the
    emitter."""
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.session import SessionConfig

    def run():
        cfgs = [SessionConfig(spec=_path("batchtoy.tla"),
                              cfg=_path(f"batchtoy_{c}.cfg"),
                              host_seen=True, device="cpu")
                for c in "abcd"]
        eng = BatchCheckEngine(cfgs).build()
        assert eng.lift_names
        return [_summary(mem.result) for mem in eng.run()]

    want = run()
    routing.on()
    got = run()
    assert routing.counts["expand"] > 0 and routing.counts["pred"] > 0
    assert got == want
