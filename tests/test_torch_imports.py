"""The port stands alone: no file of jaxmc_torch/ and not chip_smoke.py
imports jax or anything of jaxmc, the engine never falls back to the
CPU by itself, and a CPU engine builds no generated kernel."""

import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "jaxmc_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


def test_port_files_exist():
    files = _port_files()
    assert os.path.exists(files[0])
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jaxmc_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "jaxmc")]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_generated_kernel_modules_are_checked():
    """The capture and the code generator of the generated kernels
    (K15-K17) are port files like any other: no jax, no jaxmc."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"jaxmc_torch/compile/trace.py",
            "jaxmc_torch/compile/cgen.py"} <= rel


def test_session_and_analysis_modules_are_checked():
    """The copies of the session stages, the corpus sweep and the
    static analysis are port files like any other: no jax, no jaxmc."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"jaxmc_torch/corpus.py", "jaxmc_torch/session.py",
            "jaxmc_torch/meshbench.py",
            "jaxmc_torch/analyze/verdicts.py",
            "jaxmc_torch/analyze/lint.py",
            "jaxmc_torch/analyze/pylint.py",
            "jaxmc_torch/analyze/__main__.py",
            "jaxmc_torch/engine/simulate.py"} <= rel


def test_cpu_engine_builds_no_generated_source(monkeypatch):
    """A CPU engine keeps the emitter: no capture, no source, no nvcc."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.kernels import build
    from jaxmc_torch.session import load_model

    def boom(*a, **kw):
        raise AssertionError("generated build on a CPU engine")

    monkeypatch.setattr(cgen, "build_module", boom)
    monkeypatch.setattr(build, "build_generated", boom)
    monkeypatch.setattr(build, "nvcc_path", boom)
    before = build.BUILDS
    spec = os.path.join(ROOT, "specs", "constoy")
    eng = TorchExplorer(load_model(spec + ".tla", spec + ".cfg"),
                        device="cpu")
    assert eng._gen is None
    assert eng.run().distinct == 21
    assert build.BUILDS == before


def test_default_device_is_the_card():
    from jaxmc_torch.backend.bfs import TorchExplorer, resolve_device
    from jaxmc_torch.session import load_model
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    model = load_model(os.path.join(ROOT, "specs", "constoy.tla"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchExplorer(model)
    # asking for the CPU is explicit, and then it runs
    assert TorchExplorer(model, device="cpu").run().distinct == 21


def test_cli_refuses_without_a_card_unless_asked(capsys):
    from jaxmc_torch.cli import main
    spec = os.path.join(ROOT, "specs", "constoy.tla")
    if not torch.cuda.is_available():
        assert main(["check", spec]) == 2
        assert 'device="cpu"' in capsys.readouterr().err
    assert main(["check", spec, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "43 states generated, 21 distinct states found" in out
    assert "Model checking completed. No error has been found." in out


LIVE_TLA = """---- MODULE livetoy ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
Next == x < 2 /\\ x' = x + 1
Spec == Init /\\ [][Next]_x
Live == <>(x = 2)
====
"""


@pytest.mark.parametrize("why,item", [("PROPERTY", "A.7")])
def test_unported_modes_are_refused(why, item, tmp_path):
    """A temporal PROPERTY was refused until ROADMAP A.7 ported it
    (tests/test_torch_properties.py); now no engine refuses it.  A form
    outside the liveness checker's fragment (here <>P) runs with the
    reference's warning, on the level and host-seen engines alike."""
    from jaxmc.backend.bfs import TpuExplorer
    from jaxmc.session import load_model as jload
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    (tmp_path / "livetoy.tla").write_text(LIVE_TLA)
    (tmp_path / "livetoy.cfg").write_text(
        f"SPECIFICATION Spec\n{why} Live\n")
    spec = str(tmp_path / "livetoy.tla")
    for hs in (False, True):
        rt = TorchExplorer(load_model(spec), device="cpu",
                           host_seen=hs).run()
        rj = TpuExplorer(jload(spec, None, False), host_seen=hs).run()
        assert f"ROADMAP {item}" not in " ".join(rt.warnings)
        assert rt.warnings == rj.warnings
        assert "temporal properties NOT checked (unsupported form): " \
               "Live" in rt.warnings
        assert (rt.ok, rt.distinct, rt.generated) == \
            (rj.ok, rj.distinct, rj.generated)


@pytest.mark.parametrize("flag,item", [
    (["--host-seen", "--checkpoint", "x.ck"], "A.15"),
    (["--resident", "--checkpoint", "x.ck"], "A.15"),
    (["--seen-cap", "64", "--resume", "x.ck"], "A.15"),
    (["--checkpoint", "x.ck"], "A.15"),
])
def test_cli_refuses_unported_options_by_item(flag, item, capsys,
                                              tmp_path):
    """These command lines were refused naming ROADMAP A.15 until it
    ported checkpoints and resume.  Now each runs and names no item: a
    --checkpoint line writes its checkpoint at every level boundary
    (--checkpoint-every 0), and the --resume line continues a run that
    the same engine checkpointed."""
    from jaxmc_torch.cli import main
    from jaxmc_torch.engine.ckpt import load_checkpoint
    spec = os.path.join(ROOT, "specs", "constoy.tla")
    ck = str(tmp_path / "x.ck")
    flag = [ck if f == "x.ck" else f for f in flag]
    if "--resume" in flag:
        assert main(["check", spec, "--device", "cpu", "--max-states", "10",
                     "--checkpoint", ck, "--checkpoint-every", "0"]
                    + flag[:2]) == 0
        capsys.readouterr()
    else:
        flag += ["--checkpoint-every", "0"]
    assert main(["check", spec, "--device", "cpu"] + flag) == 0
    out, err = capsys.readouterr()
    assert f"ROADMAP {item}" not in err + out
    assert "43 states generated, 21 distinct states found" in out
    _, payload = load_checkpoint(ck, kind="device")
    assert payload["module"] == "constoy"
    if "--resume" in flag:
        assert f"Resumed from {ck}: " in out


@pytest.mark.parametrize("mod", ["jaxmc_torch.backend.batch",
                                 "jaxmc_torch.batchbench",
                                 "jaxmc_torch.session",
                                 "jaxmc_torch.cli",
                                 "jaxmc_torch.engine.ckpt",
                                 "jaxmc_torch.drain",
                                 "jaxmc_torch.engine.parallel",
                                 "jaxmc_torch.engine.explore",
                                 "jaxmc_torch.obs",
                                 "jaxmc_torch.obs.report",
                                 "jaxmc_torch.obs.prof",
                                 "jaxmc_torch.obs.watchdog",
                                 "jaxmc_torch.obs.ledger",
                                 "jaxmc_torch.obs.timeline",
                                 "jaxmc_torch.backend",
                                 "jaxmc_torch.backend.oracle"])
def test_new_modules_import_without_jax(mod):
    """The batching, session, checkpoint, drain, interpreter,
    observability and backend modules import with jax and jaxmc made
    unimportable (a subprocess with both blocked)."""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'jaxmc'):\n"
            "    sys.modules[m] = None\n"
            f"import {mod}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'jaxmc') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mod", ["jaxmc_torch.obs",
                                 "jaxmc_torch.obs.report",
                                 "jaxmc_torch.backend",
                                 "jaxmc_torch.backend.oracle"])
def test_obs_and_backend_import_without_torch(mod):
    """The report CLI and the backend layer import torch lazily, as the
    reference's import jax lazily: they load with torch unimportable."""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'jaxlib', 'jaxmc'):\n"
            "    sys.modules[m] = None\n"
            f"import {mod}\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
