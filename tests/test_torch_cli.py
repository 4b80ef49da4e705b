"""The port's `check` command against the reference's on the same
inputs: a malformed .tla and .cfg (one `error: <Type>: <msg>` line,
exit 2), an ASSUME-only model held and violated (TLC's
No-Behavior-Spec mode), an MC shim that EXTENDS a spec of another
directory through -I, a PROPERTY, and the reference's other options
(--sample, the capacity floors, --quiet, --progress-every).  Exit codes,
stdout lines (less the throughput line, which carries the wall) and
stderr must be equal."""

import os

import pytest
import torch

from jaxmc.cli import main as jmain
from jaxmc_torch.cli import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if "states/sec" not in ln]
    return rc, lines, out.err


def _both(argv, capsys, ref_extra=("--backend", "jax", "--platform",
                                   "cpu")):
    rj = _run(jmain, ["check"] + argv + list(ref_extra), capsys)
    rt = _run(tmain, ["check"] + argv + ["--device", "cpu"], capsys)
    return rj, rt


def _files(tmp_path):
    (tmp_path / "bad.tla").write_text(
        "---- MODULE bad ----\nEXTENDS Naturals\nVARIABLE x\n== x = 1\n"
        "====\n")
    (tmp_path / "okm.tla").write_text(
        "---- MODULE okm ----\nEXTENDS Naturals\nVARIABLE x\n"
        "Init == x = 0\nNext == x < 2 /\\ x' = x + 1\n====\n")
    (tmp_path / "okm_bad.cfg").write_text("INIT Init\nNEXT\nCONSTANTS = 3\n")
    (tmp_path / "okm_nope.cfg").write_text(
        "INIT Init\nNEXT Next\nINVARIANT Nope\n")
    (tmp_path / "asm.tla").write_text(
        "---- MODULE asm ----\nEXTENDS Naturals\nCONSTANT N\n"
        "ASSUME N > 2\nASSUME Good == N * 2 = 6\n"
        "ASSUME PrintT(<<\"N is\", N>>)\n====\n")
    (tmp_path / "asm.cfg").write_text("CONSTANT N = 3\n")
    (tmp_path / "asm_bad.cfg").write_text("CONSTANT N = 1\n")
    shim = tmp_path / "shim"
    shim.mkdir()
    (shim / "MCshim.tla").write_text(
        "---- MODULE MCshim ----\nEXTENDS transfer_scaled\n"
        "Frozen == Init /\\ [][bob' = bob]_<<alice, bob>>\n====\n")
    (shim / "MCshim.cfg").write_text(
        "SPECIFICATION Spec\nINVARIANT AliceBounded\nCONSTANTS\n"
        "  Procs = {p1, p2}\n  MaxMoney = 3\n")
    (shim / "MCshim_prop.cfg").write_text(
        "SPECIFICATION Spec\nPROPERTY Frozen\nCONSTANTS\n"
        "  Procs = {p1, p2}\n  MaxMoney = 3\n")
    return tmp_path


CASES = {
    # C.3: parse, lex and cfg errors and the reference's type prefix
    "malformed_tla": (["bad.tla"], 2, "error: ParseError: "),
    "malformed_cfg": (["okm.tla", "--cfg", "okm_bad.cfg"], 2,
                      "error: CfgError: "),
    "unknown_invariant": (["okm.tla", "--cfg", "okm_nope.cfg"], 2,
                          "error: EvalError: "),
    "missing_file": (["nothere.tla"], 2, "error: "),
    # C.4: TLC's No-Behavior-Spec mode
    "assumes_held": (["asm.tla"], 0, ""),
    "assumes_violated": (["asm.tla", "--cfg", "asm_bad.cfg"], 1, ""),
    # C.5: -I and the other reference options
    "shim_with_include": (["shim/MCshim.tla", "-I", SPECS], 0, ""),
    "shim_without_include": (["shim/MCshim.tla"], 2,
                             "error: EvalError: module transfer_scaled "
                             "not found"),
    "shim_property": (["shim/MCshim.tla", "--cfg", "shim/MCshim_prop.cfg",
                       "--include", SPECS], 1, ""),
    "options": (["shim/MCshim.tla", "-I", SPECS, "--sample", "50", "5",
                 "10", "--seq-cap", "5", "--grow-cap", "6", "--kv-cap",
                 "7", "--progress-every", "0", "--max-states", "40"],
                0, ""),
    "quiet": (["shim/MCshim.tla", "-I", SPECS, "--quiet"], 0, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(case, tmp_path, capsys, monkeypatch):
    argv, rc, err = CASES[case]
    monkeypatch.chdir(_files(tmp_path))
    (rj, lj, ej), (rt, lt, et) = _both(argv, capsys)
    assert rt == rj == rc
    assert lt == lj
    assert et == ej
    assert et.startswith(err)
    if rc == 2:
        # one line, never a traceback
        assert et.count("\n") == 1 and "Traceback" not in et


def test_assumes_output_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(_files(tmp_path))
    rc, lines, _ = _run(tmain, ["check", "asm.tla", "--device", "cpu"],
                        capsys)
    assert rc == 0
    assert lines == ['<<"N is", 3>>',
                     "3 assumptions checked. No error has been found."]
    rc, lines, _ = _run(tmain, ["check", "asm.tla", "--cfg", "asm_bad.cfg",
                                "--device", "cpu"], capsys)
    assert rc == 1
    assert lines[:2] == [
        "Assumption ASSUME is violated (evaluated to FALSE).",
        "Assumption Good is violated (evaluated to FALSE)."]


def test_quiet_drops_only_the_progress_lines(tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.chdir(_files(tmp_path))
    _, loud, _ = _run(tmain, ["check", "shim/MCshim.tla", "-I", SPECS,
                              "--device", "cpu"], capsys)
    _, quiet, _ = _run(tmain, ["check", "shim/MCshim.tla", "-I", SPECS,
                               "--device", "cpu", "--quiet"], capsys)
    assert any(ln.startswith("Progress(") for ln in loud)
    assert not any(ln.startswith("Progress(") for ln in quiet)
    assert quiet[-1] == loud[-1] == \
        "Model checking completed. No error has been found."
