"""The port's device profiler (jaxmc_torch/obs/prof.py).

- Profiling on against off: the port's CLI with `--profile` and without
  it (telemetry live both ways) gives the same exit code, stdout (wall
  digits masked), result block, level counts and trace events (times and
  walls dropped) on the level, host-seen and resident engines.
- The Profiler's rollup under a fake clock, as tests/test_prof.py drives
  the reference's: counts, walls, bytes, the dominant site, the
  call-time recorder, the HBM watermark, the snapshot and attribution.
- The HBM model's buffer names equal the reference engine's on the
  level and resident engines.
- A kernel build inside a call counts as that site's `recompiles`: a
  stand-in nvcc (a shell script that writes its output file) builds
  every source into a temporary build root.
All comparisons are exact; walls are compared only under the fake
clock."""

import contextlib
import io
import json
import os
import re
import stat

import numpy as np
import pytest
import torch

from jaxmc_torch import obs
from jaxmc_torch.cli import main as tmain
from jaxmc_torch.obs.prof import Profiler, attribution, wrap
from jaxmc_torch.obs.schema import PORT_ABSENT_SITES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

ENGINES = {"level": [], "host_seen": ["--host-seen"],
           "resident": ["--resident", "--chunk", "2048"]}
SPECS_ON_OFF = {"pcal_intro_buggy": ["pcal_intro_buggy.tla"],
                "transfer_scaled_20000": ["transfer_scaled.tla",
                                          "--max-states", "20000"]}
# trace-event keys that carry times, walls or process identity
_TIMING = {"t", "t0", "wall_s", "mono", "pid", "argv", "psid",
           "parent_span", "tid", "env", "meta", "rss_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _mask(text):
    text = re.sub(r"\(\d+ states/sec, backend=[^,]+, wall [0-9.]+s\)",
                  "(<rate>, <wall>)", text)
    return re.sub(r"ETA [0-9.]+[smh]", "ETA <t>", text)


def _events(path):
    out = []
    with open(path) as fh:
        for ln in fh:
            e = json.loads(ln)
            if e["ev"] in ("heartbeat", "stall"):
                continue  # the watchdog's beats follow the wall clock
            e = {k: v for k, v in e.items() if k not in _TIMING}
            if "msg" in e:
                e["msg"] = _mask(e["msg"])
            out.append(e)
    return out


def _cli(argv, tmp, tag):
    m, t = os.path.join(tmp, f"{tag}.json"), os.path.join(tmp,
                                                           f"{tag}.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain(["check"] + argv + ["--device", "cpu", "--metrics-out",
                                       m, "--trace", t])
    with open(m) as fh:
        summary = json.load(fh)
    return rc, _mask(buf.getvalue()), summary, _events(t)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("spec", list(SPECS_ON_OFF))
def test_profile_on_and_off_are_bit_identical(spec, engine, tmp_path):
    argv = [os.path.join(SPECS, SPECS_ON_OFF[spec][0])] + \
        SPECS_ON_OFF[spec][1:] + ENGINES[engine]
    off = _cli(argv, str(tmp_path), "off")
    on = _cli(argv + ["--profile"], str(tmp_path), "on")
    assert on[0] == off[0]
    assert on[1] == off[1]
    for s in (on[2], off[2]):
        s["result"].pop("wall_s")
        for r in s["levels"]:
            r.pop("wall_s", None)
    assert on[2]["result"] == off[2]["result"]
    assert on[2]["levels"] == off[2]["levels"]
    assert on[3] == off[3]
    # the profile is the difference: synchronised walls and bytes on,
    # dispatch counts only off, the same sites either way
    pon, poff = on[2]["prof"], off[2]["prof"]
    assert (pon["mode"], poff["mode"]) == ("wall", "cheap")
    assert {n: s["dispatches"] for n, s in pon["sites"].items()} == \
        {n: s["dispatches"] for n, s in poff["sites"].items()}
    assert all("wall_s" in s and "arg_bytes" in s
               for s in pon["sites"].values())
    assert not any("wall_s" in s for s in poff["sites"].values())
    site = {"level": "bfs.level_step", "host_seen": "bfs.hstep",
            "resident": "bfs.resident_run"}[engine]
    assert pon["sites"][site]["dispatches"] >= 1
    # the reference's split-step sites have no counterpart (obs/schema.py)
    assert not set(pon["sites"]) & set(PORT_ABSENT_SITES)


class TestRollup:
    def test_wall_mode_counts_walls_and_bytes(self):
        clk = Clock()
        p = Profiler(mode=Profiler.WALL, clock=clk)
        arr = torch.zeros(16, dtype=torch.int32)

        def fn(x):
            clk.t += 0.25
            return {"a": x, "b": [x, np.zeros(4, np.int32)]}

        for i in range(1, 4):
            out = p.record("t.site", fn, (arr,), {})
            assert out["a"] is arr
            st = p.sites["t.site"]
            assert st.dispatches == i
            assert st.wall_s == pytest.approx(0.25 * i)
            assert st.arg_bytes == 64 * i
            assert st.res_bytes == (64 + 64 + 16) * i
            assert st.recompiles == 0

    def test_cheap_mode_counts_only(self):
        p = Profiler()
        arr = torch.zeros(8, dtype=torch.int32)
        for _ in range(5):
            p.record("t.site", lambda x: x, (arr,), {})
        st = p.sites["t.site"]
        assert st.dispatches == 5
        assert st.wall_s == 0.0 and st.arg_bytes == 0
        assert st.as_dict() == {"dispatches": 5, "recompiles": 0}

    def test_dominant_site_prefers_wall_then_dispatches(self):
        p = Profiler()
        assert p.dominant_site() is None
        p._site("a").dispatches = 9
        p._site("b").dispatches = 1
        assert p.dominant_site() == ("a", 0.9)
        p._site("b").wall_s = 3.0
        p._site("a").wall_s = 1.0
        name, share = p.dominant_site()
        assert name == "b" and share == pytest.approx(0.75)

    def test_wrap_resolves_recorder_at_call_time(self):
        calls = []
        wrapped = wrap("t.wrapped", lambda x: calls.append(x) or x)
        assert wrapped(1) == 1  # NullTelemetry: pass-through
        tel = obs.Telemetry()
        with obs.use(tel):
            wrapped(2)
            wrapped(3)
        assert calls == [1, 2, 3]
        assert tel.prof.sites["t.wrapped"].dispatches == 2
        assert wrapped.profiler_site == "t.wrapped"

    def test_hbm_watermark_and_module_level_note(self):
        p = Profiler()
        p.note_buffer("seen", 1000)
        p.note_buffer("frontier", 500)
        p.note_buffer("seen", 200)
        p.drop_buffer("frontier")
        assert p.hbm_current_bytes() == 200 and p.hbm_peak_bytes == 1500
        assert p.hbm_buffers() == {"seen": 200}
        obs.note_buffer("orphan", 99)  # NullTelemetry: a no-op
        tel = obs.Telemetry()
        with obs.use(tel):
            obs.note_buffer("live", 42)
        assert tel.prof.hbm_buffers() == {"live": 42}

    def test_snapshot_summary_and_attribution(self):
        assert Profiler().snapshot() is None
        assert Profiler().snapshot(force=True)["sites"] == {}
        tel = obs.Telemetry(clock=Clock())
        tel.prof.mode = Profiler.WALL
        clk = Clock()
        tel.prof._clock = clk

        def fn(x):
            clk.t += 0.5
            return x

        with obs.use(tel):
            with tel.span("search"):
                tel._clock.t += 2.0
                wrap("t.hot", fn)(torch.zeros(4, dtype=torch.int32))
        s = tel.summary()
        assert s["schema"] == "jaxmc.metrics/4"
        site = s["prof"]["sites"]["t.hot"]
        assert site == {"dispatches": 1, "recompiles": 0, "wall_s": 0.5,
                        "arg_bytes": 16, "res_bytes": 16}
        # CUDA was never initialised: no measured peak on the CPU
        assert "measured_peak_bytes" not in s["prof"]["hbm"]
        att = attribution(s)
        assert att == {"attributed_wall_s": 0.5, "search_wall_s": 2.0,
                       "share": 0.25}


@pytest.mark.parametrize("engine", ["level", "resident"])
def test_hbm_buffer_names_match_the_reference(engine):
    from jaxmc import obs as jobs
    from jaxmc.backend.bfs import TpuExplorer
    from jaxmc.session import load_model as jload
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model as tload
    spec = os.path.join(SPECS, "constoy.tla")
    kw = {"resident": True} if engine == "resident" else {}
    jtel = jobs.Telemetry()
    with jobs.use(jtel):
        TpuExplorer(jload(spec, None, False), cap_profile=False,
                    **kw).run()
    ttel = obs.Telemetry()
    with obs.use(ttel):
        TorchExplorer(tload(spec), device="cpu", **kw).run()
    want = jtel.prof.hbm_buffers()
    assert set(ttel.prof.hbm_buffers()) == set(want)
    assert set(want) == {f"{engine}.{b}" for b in (
        ("seen", "frontier") if engine == "level" else
        ("seen", "frontier", "accumulator", "candidates"))}
    if engine == "level":
        assert ttel.prof.hbm_buffers() == want


def test_a_build_inside_a_call_counts_as_recompiles(tmp_path,
                                                    monkeypatch):
    from jaxmc_torch.kernels import build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    site = wrap("t.build", build.build_all)
    other = wrap("t.other", lambda: None)
    tel = obs.Telemetry()
    with obs.use(tel):
        other()
        site()        # every source is built inside this call
        site()        # all built: nothing to do
        other()
    assert tel.prof.sites["t.build"].dispatches == 2
    assert tel.prof.sites["t.build"].recompiles == len(build.SOURCES)
    assert tel.prof.sites["t.other"].recompiles == 0
