"""The port's CheckSession stages against the reference's
(jaxmc/session.py), on the CPU.

parse -> analyze -> compile -> explore, then explore again with
`resume_from` (the warm session's re-run), must give the reference
session's counts, verdict, trace and describe() fields at every stage:
transfer_scaled truncated by `max_states` (the re-run resumes its
last level checkpoint) and pcal_intro_buggy (an assert with a trace).
The strict analyze refusal holds on every later call and no engine is
built behind it."""

import os

import pytest
import torch

from jaxmc.engine.explore import format_trace as jformat
from jaxmc.session import AnalyzeError as JAnalyzeError
from jaxmc.session import CheckSession as JSession
from jaxmc.session import SessionConfig as JCfg
from jaxmc_torch.engine.explore import format_trace as tformat
from jaxmc_torch.session import AnalyzeError, CheckSession, SessionConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
LINTTOY = os.path.join(SPECS, "linttoy.tla")
LINTTOY_CFG = os.path.join(SPECS, "linttoy.cfg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(r):
    v = r.violation
    return (r.ok, r.distinct, r.generated, r.diameter, bool(r.truncated),
            list(r.warnings), v and (v.kind, v.name, v.message))


def _sessions(spec, tmp_path, **kw):
    ck = {}
    for side in ("ref", "port"):
        ck[side] = str(tmp_path / f"{side}.ck") \
            if kw.get("max_states") else None
    # backend "jax" names the device engine in both packages: the
    # reference's on the CPU platform, the port's on the CPU device
    js = JSession(JCfg(spec=spec, backend="jax", platform="cpu",
                       checkpoint=ck["ref"], analyze="warn",
                       **{k: v for k, v in kw.items()}))
    ts = CheckSession(SessionConfig(spec=spec, backend="jax", device="cpu",
                                    checkpoint=ck["port"], analyze="warn",
                                    **kw))
    return js, ts, ck


def _describe(sess, ck):
    d = dict(sess.describe())
    # the checkpoint paths differ by name only
    assert d.pop("checkpoint") == ck
    return d


@pytest.mark.parametrize("spec,kw", [
    # a checkpoint at every level boundary: the re-run resumes the last
    ("transfer_scaled.tla", dict(max_states=20000, no_trace=True,
                                 checkpoint_every=0.0)),
    ("pcal_intro_buggy.tla", {}),
], ids=["transfer_scaled_max_states", "pcal_intro_buggy"])
def test_stage_chain_matches_reference(spec, kw, tmp_path):
    js, ts, ck = _sessions(os.path.join(SPECS, spec), tmp_path, **kw)
    assert _describe(ts, ck["port"]) == _describe(js, ck["ref"])
    # parse
    assert ts.parse() == js.parse() == "model"
    assert ts.stage == js.stage == "parse"
    # analyze (warn): the same diagnostics, stage advanced
    assert [d.render() for d in ts.analyze()] == \
        [d.render() for d in js.analyze()]
    assert ts.stage == js.stage == "analyze"
    # compile: an engine and the same layout signature
    ts.compile()
    js.compile()
    assert ts.stage == js.stage == "compile"
    assert ts.layout_sig == js.layout_sig and ts.layout_sig
    assert _describe(ts, ck["port"]) == _describe(js, ck["ref"])
    # explore
    rt, rj = ts.explore(), js.explore()
    assert _summary(rt) == _summary(rj)
    if rj.violation is not None:
        assert tformat(rt.violation) == jformat(rj.violation)
    assert _describe(ts, ck["port"]) == _describe(js, ck["ref"])
    assert ts.describe()["explore_count"] == 1
    if kw.get("max_states"):
        assert rt.truncated and os.path.exists(ck["port"])
        # the warm re-run: resume the last checkpoint through the engine
        # already built
        rt2 = ts.explore(resume_from=ck["port"])
        rj2 = js.explore(resume_from=ck["ref"])
        assert _summary(rt2) == _summary(rj2)
        assert ts.engine.resume_from == ck["port"]
        assert _describe(ts, ck["port"]) == _describe(js, ck["ref"])
        assert ts.describe()["explore_count"] == 2


def test_strict_refusal_holds_on_every_call():
    want = JSession(JCfg(spec=LINTTOY, cfg=LINTTOY_CFG, analyze="strict"))
    sess = CheckSession(SessionConfig(spec=LINTTOY, cfg=LINTTOY_CFG,
                                      analyze="strict", device="cpu"))
    with pytest.raises(JAnalyzeError) as wj:
        want.analyze()
    for call in (sess.analyze, sess.analyze, sess.compile, sess.explore):
        # compile and explore reach the refusal through the stage chain
        # (or the cfg's own bind error first): no engine, ever
        with pytest.raises(Exception) as ei:
            call()
        if call is sess.analyze:
            assert isinstance(ei.value, AnalyzeError)
            assert str(ei.value) == str(wj.value)
            assert [d.render() for d in ei.value.diagnostics] == \
                [d.render() for d in wj.value.diagnostics]
        assert sess.engine is None
