"""Checkpoints, resume and drain on the port's level, host-seen and
resident engines (jaxmc_torch/backend/bfs.py), held against the JAX
reference's TpuExplorer on the CPU and against the port's own
uninterrupted runs.

Each engine: the device checkpoint equals the reference's field by
field at the same truncation point; a truncation, a drain at a level
boundary and a `run_kill` crash each resume to the uninterrupted run's
totals, verdict and trace; the interpreter-format `.host` snapshot
resumes in the port's ParallelExplorer to the reference's totals.  A
completed resident checkpoint replays its verdict without running a
level; the batched resume guard refuses a solo checkpoint as the
reference does."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jaxmc_torch import drain, faults
from jaxmc_torch.backend.bfs import TorchExplorer
from jaxmc_torch.engine.ckpt import load_checkpoint
from jaxmc_torch.session import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SPEC = os.path.join(SPECS, "transfer_scaled.tla")
PINS = (True, 153701, 311153, 9)  # jaxmc/corpus.py transfer_scaled
CUT = 20000
CH = 4096
ENGINES = {"level": {}, "host_seen": dict(host_seen=True, chunk=CH),
           "resident": dict(resident=True, chunk=CH)}
FLAGS = {"level": [], "host_seen": ["--host-seen", "--chunk", str(CH)],
         "resident": ["--resident", "--chunk", str(CH)]}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    # a fault's n= budget lives in JAXMC_FAULTS_STATE and a drain request
    # is process-wide: neither may leak between runs; one intra-op torch
    # thread, as the suite's other engine files run
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("JAXMC_FAULTS", raising=False)
    faults.reset_for_tests()
    (tmp_path / "faults").mkdir()
    monkeypatch.setenv("JAXMC_FAULTS_STATE", str(tmp_path / "faults"))
    drain.clear()
    yield
    drain.clear()
    faults.reset_for_tests()
    torch.set_num_threads(n)


def port(engine, spec=SPEC, cfg=None, **kw):
    return TorchExplorer(load_model(spec, cfg), device="cpu",
                         **ENGINES[engine], **kw)


def ref(engine, spec=SPEC, cfg=None, **kw):
    from jaxmc.session import load_model as jload
    from jaxmc.tpu.bfs import TpuExplorer
    extra = dict(cap_profile=False) if engine == "resident" else {}
    return TpuExplorer(jload(spec, cfg, False), **ENGINES[engine],
                       **extra, **kw)


def summary(r):
    """Verdict, counts and the trace, its values as TLA+ text (so a
    result of either package compares with the other's)."""
    v = r.violation
    trace = v and [(sorted((k, repr(x)) for k, x in st.items()), label)
                   for st, label in v.trace]
    return (r.ok, r.distinct, r.generated, r.diameter,
            v and (v.kind, v.name, v.message, trace))


def assert_equal_payload(a, b, path="payload"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_equal_payload(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_payload(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.array_equal(a, b), path
    elif type(a).__module__.startswith(("jaxmc.", "jaxmc_torch.")):
        # a TLA+ value of one package against the same value of the
        # other: the same class name and the same canonical text
        assert type(a).__name__ == type(b).__name__, path
        assert repr(a) == repr(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_device_checkpoint_equals_reference(engine, tmp_path):
    """At the same truncation point the two packages write the same
    checkpoint: seen table (or store), frontier, trace levels, frontier
    maps, counts, depth and layout signature.  The resident engine's
    `caps` is each package's own growth state (the port keeps no
    capacity profiles and grows from its own starting caps)."""
    pj, pt = str(tmp_path / "ref.ck"), str(tmp_path / "port.ck")
    rj = ref(engine, max_states=CUT, checkpoint_path=pj,
             checkpoint_every=0.0).run()
    rt = port(engine, max_states=CUT, checkpoint_path=pt,
              checkpoint_every=0.0).run()
    assert summary(rt) == summary(rj) and rt.truncated
    hj, a = load_checkpoint(pj, kind="device")
    ht, b = load_checkpoint(pt, kind="device")
    assert hj["meta"] == ht["meta"]
    if engine == "resident":
        assert set(a.pop("caps")) == set(b.pop("caps"))
    assert_equal_payload(b, a)
    if engine != "resident":
        # the interpreter-format host snapshots too
        _, sa = load_checkpoint(pj + ".host", kind="interp")
        _, sb = load_checkpoint(pt + ".host", kind="interp")
        assert_equal_payload(sb, sa)
    else:
        assert not os.path.exists(pt + ".host")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_truncate_then_resume_equals_uninterrupted(engine, tmp_path):
    ck = str(tmp_path / "t.ck")
    logs = []
    r1 = port(engine, max_states=CUT, checkpoint_path=ck,
              checkpoint_every=0.0).run()
    assert r1.truncated and r1.distinct >= CUT
    r2 = port(engine, resume_from=ck, log=logs.append).run()
    assert summary(r2) == PINS + (None,)
    assert any(ln.startswith(f"Resumed from {ck}: ") for ln in logs)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_truncate_then_resume_keeps_the_trace(engine, tmp_path):
    """pcal_intro_buggy's assertion: a run resumed from a level before
    it reports the uninterrupted run's verdict, counts and trace (the
    resident engine names the state, as uninterrupted)."""
    spec = os.path.join(SPECS, "pcal_intro_buggy.tla")
    full = port(engine, spec=spec).run()
    assert full.violation.kind == "assert"
    ck = str(tmp_path / "p.ck")
    r1 = port(engine, spec=spec, max_states=1500, checkpoint_path=ck,
              checkpoint_every=0.0).run()
    assert r1.truncated and r1.ok
    r2 = port(engine, spec=spec, resume_from=ck).run()
    assert summary(r2) == summary(full)
    # the reference resumed from the port's checkpoint agrees
    rj = ref(engine, spec=spec, resume_from=ck).run()
    assert summary(rj) == summary(full)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_drain_at_a_level_boundary_then_resume(engine, tmp_path):
    ck = str(tmp_path / "d.ck")

    def log(line):
        if line.startswith("Progress(3)"):
            drain.request("test drain")

    r1 = port(engine, checkpoint_path=ck, progress_every=0.0,
              log=log).run()
    assert r1.ok and r1.truncated and r1.drained
    assert r1.trunc_reason == "drain"
    assert f"run drained before completion (test drain); resume with " \
           f"--resume {ck}" in r1.warnings
    assert 0 < r1.distinct < PINS[1]
    drain.clear()
    r2 = port(engine, resume_from=ck).run()
    assert summary(r2) == PINS + (None,)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_run_kill_then_resume_from_the_last_checkpoint(engine, tmp_path):
    """A SIGKILL entering level 5 (JAXMC_FAULTS=run_kill:level=5) in a
    CLI subprocess, then a resume from its last periodic checkpoint."""
    ck = str(tmp_path / "k.ck")
    (tmp_path / "kill-faults").mkdir()
    env = dict(os.environ, JAXMC_FAULTS="run_kill:level=5",
               JAXMC_FAULTS_STATE=str(tmp_path / "kill-faults"))
    p = subprocess.run(
        [sys.executable, "-m", "jaxmc_torch", "check", SPEC, "--device",
         "cpu", "--checkpoint", ck, "--checkpoint-every", "0", "--quiet"]
        + FLAGS[engine], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=180)
    assert p.returncode == -9, (p.returncode, p.stderr)
    _, payload = load_checkpoint(ck, kind="device")
    assert payload["depth"] == 5 and payload["mode"] == engine
    r = port(engine, resume_from=ck).run()
    assert summary(r) == PINS + (None,)


@pytest.mark.parametrize("engine", ["level", "host_seen"])
def test_host_snapshot_resumes_in_parallel_explorer(engine, tmp_path):
    """The `.host` snapshot of a device run resumes in the port's
    ParallelExplorer (two workers) to the reference's totals."""
    from jaxmc_torch.engine.parallel import ParallelExplorer
    ck = str(tmp_path / "h.ck")

    def log(line):
        # one snapshot, late: the CPU resume has three small levels left
        if line.startswith("Progress(7)"):
            drain.request("test drain")

    assert port(engine, checkpoint_path=ck, progress_every=0.0,
                log=log).run().drained
    drain.clear()
    logs = []
    r = ParallelExplorer(load_model(SPEC), workers=2,
                         resume_from=ck + ".host", log=logs.append).run()
    assert (r.ok, r.distinct, r.generated, r.diameter) == PINS
    assert any("Resumed from" in ln for ln in logs)


def test_no_host_snapshot_without_traces(tmp_path):
    ck = str(tmp_path / "n.ck")
    port("level", max_states=CUT, checkpoint_path=ck, checkpoint_every=0.0,
         store_trace=False).run()
    assert os.path.exists(ck) and not os.path.exists(ck + ".host")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_completed_checkpoint_replays_the_verdict(engine, tmp_path,
                                                  monkeypatch):
    """final_checkpoint writes an empty frontier over the whole seen
    set; resuming it runs no level and replays the totals.  On the
    resident engine nothing is launched: not even the initial states
    are keyed (tests/test_torch_cuda.py counts the launches on the
    card)."""
    ck = str(tmp_path / "f.ck")
    r1 = port(engine, checkpoint_path=ck, final_checkpoint=True).run()
    assert summary(r1) == PINS + (None,)
    for name in ("level_step", "_hstep", "_res_level", "_keys_of"):
        def boom(*a, **k):
            raise AssertionError("a completed checkpoint ran a step")
        if engine == "resident" or name != "_keys_of":
            monkeypatch.setattr(TorchExplorer, name, boom)
    logs = []
    r2 = port(engine, resume_from=ck, log=logs.append).run()
    assert summary(r2) == PINS + (None,)
    assert "Model checking completed. No error has been found." in logs


def test_relayout_after_resume_restarts_without_resuming(tmp_path):
    """deepvar relayouts once at depth 10 under --host-seen.  A run
    resumed from a checkpoint before the abort relayouts, and the
    restarted engine neither resumes (its layout differs) nor writes
    checkpoints: the reference's lines and totals."""
    from jaxmc.session import load_model as jload
    from jaxmc.tpu.bfs import TpuExplorer
    spec = os.path.join(ROOT, "jaxmc_torch", "fixtures", "deepvar.tla")
    ck = str(tmp_path / "r.ck")
    kw = dict(host_seen=True, sample_cfg=(3, 2, 3))
    TorchExplorer(load_model(spec), device="cpu", max_states=5,
                  checkpoint_path=ck, checkpoint_every=0.0, **kw).run()
    out = {}
    for name, mk in (("port", lambda **k: TorchExplorer(
            load_model(spec), device="cpu", **k)),
                     ("ref", lambda **k: TpuExplorer(
                         jload(spec, None, False), **k))):
        logs = []
        r = mk(resume_from=ck, checkpoint_path=ck + "." + name,
               checkpoint_every=0.0, log=logs.append, **kw).run()
        out[name] = (summary(r), [ln for ln in logs
                                  if "hybrid:" in ln or "Resumed" in ln])
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == [ln.replace(ck + ".ref", ck + ".port")
                              for ln in out["ref"][1]]
    assert any("relayout disables checkpointing" in ln
               for ln in out["port"][1])
    assert out["port"][0][:4] == (True, 11, 12, 10)


def test_batch_resume_guard_refuses_a_solo_checkpoint(tmp_path):
    """A msgstoy cohort (Cap 1 with Cap 3, Cap lifted): the Cap 1
    member's solo host-seen checkpoint was packed for its own bounds
    (one packed word), not the cohort's merged ones (two), so it cannot
    seed the cohort.  The member runs fresh, with the reference's line
    and counter, and its result equals its solo run."""
    from jaxmc.backend.batch import BatchCheckEngine as JBatch
    from jaxmc.session import SessionConfig as JCfg
    from jaxmc_torch import obs
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.session import SessionConfig
    spec = os.path.join(SPECS, "msgstoy.tla")
    cfgs = []
    for cap in (1, 3):
        cfgs.append(str(tmp_path / f"cap{cap}.cfg"))
        with open(cfgs[-1], "w") as fh:
            fh.write("INIT Init\nNEXT Next\nINVARIANT DoneOK\n"
                     f"CONSTANTS\n  Procs = {{p1, p2, p3}}\n  Cap = {cap}\n"
                     "  T = 2\n  P1 = p1\n")
    ck = str(tmp_path / "solo.ck")
    # the solo run deadlocks; its checkpoint is the last level boundary
    # before that
    solo = TorchExplorer(load_model(spec, cfgs[0]), device="cpu",
                         host_seen=True, checkpoint_path=ck,
                         checkpoint_every=0.0).run()
    assert solo.violation.kind == "deadlock" and os.path.exists(ck)
    tlogs, jlogs = [], []
    tel = obs.reset()
    members = BatchCheckEngine(
        [SessionConfig(spec=spec, cfg=c, host_seen=True, device="cpu",
                       resume=ck if i == 0 else None)
         for i, c in enumerate(cfgs)], tags=["cap1", "cap3"],
        log=tlogs.append, tel=tel).build().run()
    jmembers = JBatch(
        [JCfg(spec=spec, cfg=c, backend="jax", platform="cpu",
              host_seen=True, resume=ck if i == 0 else None)
         for i, c in enumerate(cfgs)], tags=["cap1", "cap3"],
        log=jlogs.append).build().run()
    refused = [ln for ln in tlogs if "refusing checkpoint" in ln]
    assert refused == [ln for ln in jlogs if "refusing checkpoint" in ln]
    assert len(refused) == 1 and "lane layout differs" in refused[0]
    assert tel.counters.get("batch.resume_refused") == 1
    assert not members[0].resumed and not jmembers[0].resumed
    for mem, jmem in zip(members, jmembers):
        assert mem.error is None and jmem.error is None
        assert summary(mem.result) == summary(jmem.result)
    assert summary(members[0].result) == summary(solo)


def test_batch_member_resumes_its_cohort_checkpoint(tmp_path):
    """A cohort checkpoint (written by the cohort, per member) resumes:
    the member is marked resumed and its totals equal the cohort run's
    uninterrupted ones."""
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.session import SessionConfig
    cks = {v: str(tmp_path / f"{v}.ck") for v in ("a", "b")}

    def cfgs(**kw):
        return [SessionConfig(spec=os.path.join(SPECS, "batchtoy.tla"),
                              cfg=os.path.join(SPECS, f"batchtoy_{v}.cfg"),
                              host_seen=True, device="cpu",
                              **{k: (f(v) if callable(f) else f)
                                 for k, f in kw.items()})
                for v in ("a", "b")]
    full = BatchCheckEngine(cfgs()).build().run()
    BatchCheckEngine(cfgs(checkpoint=lambda v: cks[v],
                          checkpoint_every=0.0,
                          final_checkpoint=True)).build().run()
    resumed = BatchCheckEngine(cfgs(resume=lambda v: cks[v])).build().run()
    for a, b in zip(full, resumed):
        assert b.resumed
        assert summary(b.result)[:4] == summary(a.result)[:4]


def test_cli_sigterm_drains_and_exits_143(tmp_path, capsys):
    """SIGTERM during a CLI run: exit 143 after a checkpoint at the next
    level boundary, the resume hint on stderr; --resume finishes."""
    import signal
    from jaxmc_torch.cli import main
    ck = str(tmp_path / "s.ck")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jaxmc_torch", "check", SPEC, "--device",
         "cpu", "--checkpoint", ck, "--checkpoint-every", "0",
         "--progress-every", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("Progress(1)"):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, (proc.returncode, err)
    assert "Search DRAINED at a safe boundary" in out
    assert f"jaxmc: drained (signal SIGTERM); resume with --resume {ck}" \
        in err
    assert main(["check", SPEC, "--device", "cpu", "--resume", ck,
                 "--quiet"]) == 0
    assert "311153 states generated, 153701 distinct states found" in \
        capsys.readouterr().out


def test_cli_device_failure_exits_2_without_fallback(tmp_path, capsys,
                                                     monkeypatch):
    """A terminal device failure (JAXMC_FAULTS=device_run_fail) ends the
    run with one line naming it: the port never demotes to the CPU."""
    from jaxmc_torch.cli import main
    monkeypatch.setenv("JAXMC_FAULTS", "device_run_fail:level=2")
    faults.reset_for_tests()
    for extra in ([], ["--no-device-fallback"]):
        faults.reset_for_tests()
        (tmp_path / f"f{len(extra)}").mkdir()
        monkeypatch.setenv("JAXMC_FAULTS_STATE",
                           str(tmp_path / f"f{len(extra)}"))
        assert main(["check", SPEC, "--device", "cpu", "--quiet"]
                    + extra) == 2
        err = capsys.readouterr().err
        assert err.count("\n") == 1
        assert "terminal device failure" in err
        assert "device_run_fail" in err

