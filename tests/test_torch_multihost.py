"""The multi-process runner (jaxmc_torch/backend/multihost.py): two gloo
processes on a file:// store, one mesh shard each, against the
single-process MeshExplorer at D = 2 on the CPU — counts, and the
violation with its trace, printed by every process alike.  Exact."""

import os

import pytest
import torch

from jaxmc_torch.backend.mesh import MeshExplorer
from jaxmc_torch.backend.multihost import fmt_trace_line, launch
from jaxmc_torch.session import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")


def _single(spec):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return MeshExplorer(load_model(os.path.join(SPECS, spec)), shards=2,
                            device="cpu").run()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("spec,exchange", [
    ("constoy.tla", "gather"), ("pcal_intro_buggy.tla", "gather"),
    ("pcal_intro_buggy.tla", "a2a")])
def test_two_gloo_processes_match_the_single_process_mesh(spec, exchange):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAXMC_MESH_EXCHANGE=exchange)
    outs = launch(2, ["--spec", os.path.join(SPECS, spec), "--device", "cpu",
                      "--fc", "1024", "--sc", "8192"], timeout=240, env=env)
    r = _single(spec)
    want = []
    v = r.violation
    if v is not None:
        name = v.message if v.kind == "assert" else v.name
        want.append(f"{v.kind} {name} ({len(v.trace)} states)")
        want += [fmt_trace_line(i, st, lab)
                 for i, (st, lab) in enumerate(v.trace)]
    for p, out in enumerate(outs):
        lines = out.splitlines()
        assert lines[-1] == (f"MULTIHOST p{p}: {r.generated} generated / "
                             f"{r.distinct} distinct")
        if want:
            assert lines[0] == f"MHVIOLATION p{p}: {want[0]}"
        assert lines[1:-1] == want[1:]


def test_fixed_capacity_overflow_aborts_loudly():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with pytest.raises(RuntimeError, match="fixed shard capacity"):
        launch(2, ["--spec", os.path.join(SPECS, "pcal_intro_buggy.tla"),
                   "--device", "cpu", "--fc", "256", "--sc", "8192"],
               timeout=240, env=env)


def test_meshbench_check_leg_on_the_cpu(tmp_path, capsys):
    """`python -m jaxmc_torch.meshbench check` on one small rung at
    D = 2: the pinned counts, host_syncs within the level records, and a
    saved baseline for the next run's gate."""
    from jaxmc_torch.corpus import case_for_cfg
    from jaxmc_torch.meshbench import main
    rc = main(["check", "--devices", "2", "--rung", "specs/constoy.tla",
               "--device", "cpu", "--out-dir", str(tmp_path),
               "--timeout", "240"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "MESHBENCH ok constoy D=2 exchange=a2a merge=rank: 43 gen / " \
        "21 distinct" in out
    # the rung has a pin (the corpus manifest's), and it held
    case = case_for_cfg("constoy.cfg")
    assert (case.distinct, case.generated) == (21, 43)
    assert "counts" not in out
    assert list(tmp_path.glob("*constoy_d2.baseline.json"))
