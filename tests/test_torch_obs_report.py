"""`python -m jaxmc_torch.obs` against `python -m jaxmc.obs` over the
same artifacts, and the copied watchdog and ledger against the
reference's.

Two metrics artifacts and traces of constoy with --profile, one written
by each package's CLI (the reference's on `--backend jax --platform
cpu`, the port's on `--device cpu`).  `report`, `diff`, `top`,
`timeline` and `history` (over a ledger each package imports both
artifacts into) must print byte-identical text from the two packages.
The watchdog's heartbeat and stall events under a fake clock must be
equal (the trace id and the process's RSS dropped), and so must the
ledger lines each package appends; with JAXMC_LEDGER=off neither
package writes one.  All comparisons are exact."""

import contextlib
import io
import json
import os

import pytest

from jaxmc import obs as jobs
from jaxmc.cli import main as jmain
from jaxmc.obs import ledger as jledger
from jaxmc.obs.report import main as jreport
from jaxmc_torch import obs as tobs
from jaxmc_torch.cli import main as tmain
from jaxmc_torch.obs import ledger as tledger
from jaxmc_torch.obs.report import main as treport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "constoy.tla")
_ART = {}


@pytest.fixture
def art(tmp_path_factory):
    """{"ref"|"port": (metrics path, trace path)}, written once."""
    if not _ART:
        tmp = tmp_path_factory.mktemp("artifacts")
        for tag, main, extra in (
                ("ref", jmain, ["--backend", "jax", "--platform", "cpu"]),
                ("port", tmain, ["--device", "cpu"])):
            m, t = str(tmp / f"{tag}.json"), str(tmp / f"{tag}.jsonl")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = main(["check", SPEC, "--metrics-out", m, "--trace", t,
                           "--profile"] + extra)
            assert rc == 0
            _ART[tag] = (m, t)
    return _ART


def _both(argv):
    outs = []
    for main in (jreport, treport):
        buf = io.StringIO()
        rc = main(argv, out=buf)
        outs.append((rc, buf.getvalue()))
    return outs


@pytest.mark.parametrize("which", ["ref", "port"])
@pytest.mark.parametrize("cmd", ["report", "top"])
def test_one_artifact_renders_identically(art, cmd, which):
    (rj, oj), (rt, ot) = _both([cmd, art[which][0]])
    assert rj == rt == 0
    assert ot == oj and ot


def test_diff_renders_identically(art):
    (rj, oj), (rt, ot) = _both(["diff", art["ref"][0], art["port"][0]])
    assert rj == rt
    assert ot == oj and ot


def test_timeline_renders_identically(art):
    (rj, oj), (rt, ot) = _both(["timeline", art["ref"][1], art["port"][1],
                                "--limit", "0"])
    assert rj == rt == 0
    assert ot == oj and ot


def test_history_renders_identically(art, tmp_path):
    """Each package imports both artifacts into a fresh ledger at the
    same path (the path is printed), then renders it."""
    led = tmp_path / "ledger.jsonl"
    outs = []
    for main in (jreport, treport):
        if led.exists():
            led.unlink()
        buf = io.StringIO()
        rc = main(["history", "--ledger", str(led), "--import",
                   art["ref"][0], art["port"][0]], out=buf)
        outs.append((rc, buf.getvalue(), led.read_text()))
    assert outs[0][0] == outs[1][0] == 0
    assert outs[1][1] == outs[0][1] and outs[1][1]
    assert outs[1][2] == outs[0][2] and outs[1][2].count("\n") == 2


def test_ledger_lines_and_ledger_off(art, tmp_path, monkeypatch):
    with open(art["port"][0]) as fh:
        summary = json.load(fh)
    lines = []
    for tag, led in (("ref", jledger), ("port", tledger)):
        path = str(tmp_path / f"{tag}.jsonl")
        monkeypatch.setenv("JAXMC_LEDGER", path)
        assert led.append_summary(summary, source=art["port"][0])
        with open(path) as fh:
            lines.append(fh.read())
    assert lines[0] == lines[1] and lines[0].count("\n") == 1
    monkeypatch.setenv("JAXMC_LEDGER", "off")
    for led in (jledger, tledger):
        assert led.ledger_path() is None
        assert led.append_summary(summary, source=art["port"][0]) is False
    assert sorted(os.listdir(tmp_path)) == ["port.jsonl", "ref.jsonl"]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _watch(pkg):
    """A fake-clock run: two levels, a wedged span, beats before,
    during and after the stall; the recorder's events and the stall
    lines."""
    clk = Clock()
    tel = pkg.Telemetry(clock=clk)
    msgs = []
    wd = pkg.Watchdog(tel, interval=5.0, stall_factor=3.0, min_stall_s=4.0,
                      on_stall=msgs.append, clock=clk)
    with tel.span("search"):
        tel.level(0, frontier=1, generated=2, new=2, distinct=3, wall_s=1.0)
        clk.t += 1.0
        tel.level(1, frontier=2, generated=4, new=1, distinct=4, wall_s=1.0)
        tel.prof.note_buffer("level.seen", 4096)
        wd._tick(clk())
        sp = tel.span("wedged")
        sp.__enter__()
        for dt in (2.0, 3.0, 2.0, 5.0):
            clk.t += dt
            wd._tick(clk())
        sp.__exit__(None, None, None)
        clk.t += 1.0
        wd._tick(clk())
    evs = [{k: v for k, v in e.items() if k not in ("tid", "rss_bytes")}
           for e in tel.recent_events() if e["ev"] not in ("proc_meta",)]
    return evs, msgs, dict(tel.counters), dict(tel.gauges)


def test_watchdog_heartbeats_and_stalls_are_equal():
    ref, port = _watch(jobs), _watch(tobs)
    assert port == ref
    evs, msgs = port[0], port[1]
    assert sum(e["ev"] == "heartbeat" for e in evs) == 6
    assert sum(e["ev"] == "stall" for e in evs) == 1
    assert len(msgs) == 1 and "open: search > wedged" in msgs[0]
    assert all(e.get("device_mem_bytes") == 4096 for e in evs
               if e["ev"] == "heartbeat")
