"""The port's copy of the checkpoint container (jaxmc_torch/engine/ckpt.py)
against the reference's cases (tests/test_ckpt.py), and the CLI's
exit-code contract for a missing, damaged or foreign checkpoint.

Each container case runs through the port's copy; the round trip is
also held against the reference's reader and writer, which share the
JMCKPT1 format byte for byte."""

import os
import pickle

import pytest
import torch

from jaxmc_torch.engine.ckpt import (CkptError, load_checkpoint,
                                     load_interp_checkpoint, read_header,
                                     write_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload():
    return {"module": "toy", "vars": ["x"], "states": [{"x": 1}],
            "seen_items": [((1,), 0)], "numbers": list(range(100))}


def test_roundtrip(tmp_path):
    p = str(tmp_path / "c.ck")
    n = write_checkpoint(p, "interp", {"module": "toy"}, _payload())
    assert n == os.path.getsize(p)
    header, payload = load_checkpoint(p, kind="interp")
    assert header["kind"] == "interp"
    assert header["meta"] == {"module": "toy"}
    assert payload == _payload()
    assert read_header(p)["payload_bytes"] == header["payload_bytes"]


def test_format_is_the_reference_format(tmp_path):
    """A file of either package loads in the other, unchanged."""
    from jaxmc.engine import ckpt as ref
    p, q = str(tmp_path / "port.ck"), str(tmp_path / "ref.ck")
    write_checkpoint(p, "device", {"module": "toy"}, _payload())
    ref.write_checkpoint(q, "device", {"module": "toy"}, _payload())
    assert ref.load_checkpoint(p, kind="device")[1] == _payload()
    assert load_checkpoint(q, kind="device")[1] == _payload()
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def _truncate(p):
    size = os.path.getsize(p)
    with open(p, "r+b") as fh:
        fh.truncate(size - size // 3)


def _bitflip(p):
    size = os.path.getsize(p)
    with open(p, "r+b") as fh:
        fh.seek(size - 10)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))


def _garbage(p):
    with open(p, "wb") as fh:
        fh.write(b"this is not a checkpoint at all" * 4)


def _legacy(p):
    # a bare pickle (the format before the container): refused, never
    # unpickled blind
    with open(p, "wb") as fh:
        pickle.dump({"states": [], "seen_items": []}, fh)


@pytest.mark.parametrize("damage,kind,match", [
    ("missing", None, "no checkpoint at"),
    ("truncate", None, "truncated"),
    ("bitflip", None, "integrity check"),
    ("garbage", None, "not a jaxmc checkpoint"),
    ("legacy", None, "not a jaxmc checkpoint"),
    ("kind", "interp", "'device' engine, this run expects 'interp'"),
])
def test_damaged_file_is_refused(damage, kind, match, tmp_path):
    p = str(tmp_path / "c.ck")
    if damage != "missing":
        write_checkpoint(p, "device" if damage == "kind" else "interp",
                         {}, _payload())
    {"truncate": _truncate, "bitflip": _bitflip, "garbage": _garbage,
     "legacy": _legacy}.get(damage, lambda _p: None)(p)
    with pytest.raises(CkptError, match=match):
        load_checkpoint(p, kind=kind)


def test_atomic_write_keeps_previous_on_damage(tmp_path):
    # the tmp+rename protocol: a second write that fails must not
    # destroy the first checkpoint
    p = str(tmp_path / "c.ck")
    write_checkpoint(p, "interp", {}, {"v": 1})
    assert load_checkpoint(p)[1] == {"v": 1}

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("nope")

    with pytest.raises(Exception):
        write_checkpoint(p, "interp", {}, {"v": Unpicklable()})
    assert load_checkpoint(p)[1] == {"v": 1}


@pytest.mark.parametrize("engine", ["interp", "level", "host_seen",
                                    "resident"])
def test_failed_checkpoint_write_does_not_kill_the_search(engine,
                                                          tmp_path):
    """Disk trouble mid-run logs a warning and the search goes on, on
    every engine of the port."""
    from jaxmc_torch import obs
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import Explorer
    from jaxmc_torch.session import load_model
    model = load_model(os.path.join(SPECS, "constoy.tla"))
    bad = str(tmp_path / "absent-dir" / "ck.bin")
    logs = []
    tel = obs.reset()
    if engine == "interp":
        eng = Explorer(model, log=logs.append, checkpoint_path=bad,
                       checkpoint_every=0.0)
    else:
        eng = TorchExplorer(model, log=logs.append, device="cpu",
                            checkpoint_path=bad, checkpoint_every=0.0,
                            host_seen=engine == "host_seen",
                            resident=engine == "resident")
    r = eng.run()
    assert r.ok and (r.generated, r.distinct) == (43, 21)
    assert any("checkpoint write failed" in ln for ln in logs)
    assert tel.counters.get("checkpoint.write_failures", 0) > 0


def test_interp_resume_refuses_another_module(tmp_path):
    from jaxmc_torch.session import load_model
    model = load_model(os.path.join(SPECS, "viewtoy.tla"))
    ck = str(tmp_path / "other.ck")
    write_checkpoint(ck, "interp", {}, {
        "module": "constoy", "vars": ["a", "b"], "states": [],
        "seen_items": []})
    with pytest.raises(CkptError, match="is for module 'constoy'"):
        load_interp_checkpoint(ck, model, model.vars, False)


# ---- the CLI: one line and exit 2 for any checkpoint defect ----

def _ck(tmp_path, capsys, extra=()):
    from jaxmc_torch.cli import main
    ck = str(tmp_path / "run.ck")
    assert main(["check", os.path.join(SPECS, "constoy.tla"), "--device",
                 "cpu", "--max-states", "10", "--checkpoint", ck,
                 "--checkpoint-every", "0", "--quiet"] + list(extra)) == 0
    capsys.readouterr()
    assert os.path.exists(ck)
    return ck


@pytest.mark.parametrize("defect,spec,match", [
    ("missing", "constoy.tla", "no checkpoint at"),
    ("module", "viewtoy.tla", "is for module 'constoy'"),
    ("truncate", "constoy.tla", "truncated"),
    ("checksum", "constoy.tla", "integrity check"),
    ("mode", "constoy.tla", "'level' device mode, this run uses "
                            "'host_seen'"),
])
def test_cli_checkpoint_defect_exits_2(defect, spec, match, tmp_path,
                                       capsys):
    from jaxmc_torch.cli import main
    ck = str(tmp_path / "nope.ck") if defect == "missing" \
        else _ck(tmp_path, capsys)
    if defect == "truncate":
        with open(ck, "r+b") as fh:
            fh.truncate(os.path.getsize(ck) // 2)
    elif defect == "checksum":
        size = os.path.getsize(ck)
        with open(ck, "r+b") as fh:
            fh.seek(size - 8)
            fh.write(b"\x00" * 8)
    extra = ["--host-seen"] if defect == "mode" else []
    rc = main(["check", os.path.join(SPECS, spec), "--device", "cpu",
               "--resume", ck, "--quiet"] + extra)
    err = capsys.readouterr().err
    assert rc == 2
    assert match in err
    assert "Traceback" not in err
    assert err.count("\n") == 1  # one line
