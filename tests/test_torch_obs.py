"""The port's metrics artifact and trace against the reference's.

`python -m jaxmc check --backend jax --platform cpu` and `python -m
jaxmc_torch check --device cpu`, both with --metrics-out and --trace, on
pcal_intro_buggy (an assert with a trace) and transfer_scaled truncated
at 20,000 states.  The result blocks, the level records (index and
counts), the phase names in order, the level engine's dispatch sites
(names and dispatch counts), the HBM model's buffers and stdout must be
equal; the port's artifact and every line of its trace must pass the
REFERENCE's own validate_summary and validate_trace_event.  Exact
everywhere, walls excepted: `wall_s` fields are dropped, and in stdout
the throughput line's states/sec, backend name and wall and the ETA
suffix's seconds are masked (the backend name is `jax` against
`torch:cpu` by design).  Every span of the reference has its
counterpart in the port, the demotion prediction's `analyze_arms`
included, so the phase lists are equal."""

import contextlib
import io
import json
import os
import re

import pytest

from jaxmc.cli import main as jmain
from jaxmc.obs.schema import validate_summary, validate_trace_event
from jaxmc_torch.cli import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

CASES = {
    "pcal_intro_buggy": (["pcal_intro_buggy.tla"], 1),
    "transfer_scaled_20000": (["transfer_scaled.tla", "--max-states",
                               "20000"], 0),
}
_RUNS = {}


def _mask(text):
    """stdout with the wall digits masked: the throughput line's tail
    and the ETA suffix's seconds."""
    text = re.sub(r"\(\d+ states/sec, backend=[^,]+, wall [0-9.]+s\)",
                  "(<rate>, <backend>, <wall>)", text)
    return re.sub(r"ETA [0-9.]+[smh]", "ETA <t>", text)


def _run(main, argv, tmp, tag):
    m, t = os.path.join(tmp, f"{tag}.json"), os.path.join(tmp,
                                                           f"{tag}.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["check"] + argv + ["--metrics-out", m, "--trace", t])
    with open(m) as fh:
        summary = json.load(fh)
    with open(t) as fh:
        events = [json.loads(ln) for ln in fh]
    return rc, out.getvalue(), summary, events


@pytest.fixture
def runs(request, tmp_path_factory):
    """Both packages' runs of a case, once per case for the module."""
    case = request.param
    if case not in _RUNS:
        args, want_rc = CASES[case]
        argv = [os.path.join(SPECS, args[0])] + args[1:]
        tmp = str(tmp_path_factory.mktemp(case))
        ref = _run(jmain, argv + ["--backend", "jax", "--platform", "cpu"],
                   tmp, "ref")
        port = _run(tmain, argv + ["--device", "cpu"], tmp, "port")
        assert ref[0] == port[0] == want_rc
        _RUNS[case] = (ref, port)
    return _RUNS[case]


def _result(s):
    return {k: v for k, v in s["result"].items() if k != "wall_s"}


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_result_blocks_are_equal(runs):
    ref, port = runs
    assert _result(port[2]) == _result(ref[2])


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_level_records_agree(runs):
    ref, port = runs

    def counts(s):
        return [{k: v for k, v in r.items() if k != "wall_s"}
                for r in s["levels"]]
    assert counts(port[2]) == counts(ref[2])
    assert [r["level"] for r in port[2]["levels"]] == \
        list(range(len(port[2]["levels"])))


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_phase_names_in_order(runs):
    ref, port = runs
    want = [p["name"] for p in ref[2]["phases"]]
    assert [p["name"] for p in port[2]["phases"]] == want


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_level_engine_sites_and_buffers(runs):
    """The always-on cheap profiler's sites (names and dispatches) and
    the HBM model (buffer names, sizes, peak)."""
    ref, port = runs
    rp, pp = ref[2]["prof"], port[2]["prof"]
    assert pp["mode"] == rp["mode"] == "cheap"
    assert {n: s["dispatches"] for n, s in pp["sites"].items()} == \
        {n: s["dispatches"] for n, s in rp["sites"].items()}
    assert pp["hbm"]["buffers"] == rp["hbm"]["buffers"]
    assert pp["hbm"]["peak_bytes"] == rp["hbm"]["peak_bytes"]


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_artifact_passes_the_reference_schema(runs):
    _ref, port = runs
    validate_summary(port[2], check_run=True)
    for e in port[3]:
        validate_trace_event(e)
    evs = [e["ev"] for e in port[3]]
    assert evs[:2] == ["proc_meta", "run_start"] and evs[-1] == "run_end"
    assert sum(e == "level" for e in evs) == len(port[2]["levels"])
    env = port[2]["env"]
    assert env["platform"] == "cpu" and env["jax_version"] is None
    assert env["torch_version"]


@pytest.mark.parametrize("runs", list(CASES), indirect=True)
def test_stdout_is_equal(runs):
    ref, port = runs
    assert "ETA" in port[1] or "est." in port[1]
    assert _mask(port[1]) == _mask(ref[1])
