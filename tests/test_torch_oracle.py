"""The preflight oracle and the --backend layer of the port.

- The probe program (B.13: the LSD sort, then K12's twin on the CPU)
  gives the reference probe's value on the same seeded keys: the text
  between `def probe(keys):` and `jp = jax.jit(probe)` of
  jaxmc.backend.oracle._PROBE_SRC is run under jax on the CPU, so the
  reference's own source is what runs.  The twin's `out` and `lo` are
  also held against a numpy recomputation of the reference's steps.
  Exact (int32).
- preflight(candidates=["cpu"]) is live and stamps the reference's
  gauges; a tpu candidate is reported not live.
- `--backend cpu` runs on the CPU; `--backend tpu`, `--backend gpu`
  without CUDA and a --backend that contradicts --device each exit 2
  with one line on stderr (and the metrics artifact's error result);
  `--backend auto` here (no card) chooses cpu and prints the oracle's
  line."""

import json
import os

import numpy as np
import pytest
import torch

from jaxmc_torch import obs
from jaxmc_torch.backend import oracle
from jaxmc_torch.cli import main as tmain
from jaxmc_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "constoy.tla")


def _keys(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(-2**31, 2**31 - 1, (n, 4),
                       dtype=np.int64).astype(np.int32)


def _reference_probe(keys_np):
    """The reference's probe function, from its own source text."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jaxmc.backend import oracle as joracle
    src = joracle._PROBE_SRC
    body = src[src.index("def probe(keys):"):src.index("jp = jax.jit(probe)")]
    n = len(keys_np)
    ns = {"jax": jax, "jnp": jnp, "lax": lax, "N": n,
          "sidx": jnp.arange(n, dtype=jnp.int32)}
    exec(body, ns)  # noqa: S102 — the reference's own probe source
    with jax.default_device(jax.devices("cpu")[0]):
        return int(jax.jit(ns["probe"])(jnp.asarray(keys_np)))


@pytest.mark.parametrize("n,seed", [(8192, 0), (8192, 1), (1000, 2),
                                    (8192, 3)])
def test_probe_value_equals_the_reference(n, seed):
    keys_np = _keys(n, seed)
    if (n, seed) == (8192, 0):
        keys_np = oracle.probe_keys("cpu").numpy()
        np.testing.assert_array_equal(keys_np, _keys(8192, 0))
    got = int(oracle.probe(torch.as_tensor(keys_np)))
    assert got == _reference_probe(keys_np)


def test_twin_out_and_lo_follow_the_reference_steps():
    keys_np = _keys(8192, 4)
    keys = torch.as_tensor(keys_np)
    perm = ops.lsd_sort(keys)
    sk = keys[perm].contiguous()
    out, lo, value = ops.oracle_probe(sk, perm.to(torch.int32), keys)
    # numpy: the stable 4-key sort, the scatter, 14 unguarded steps
    order = np.lexsort(tuple(keys_np[:, j] for j in (3, 2, 1, 0)))
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(out.numpy(), keys_np)
    n = len(keys_np)
    col, key = keys_np[order, 0], keys_np[:, 0]
    l, h = np.zeros(n, np.int64), np.full(n, n, np.int64)
    for _ in range(14):
        mid = (l + h) // 2
        lt = col[np.clip(mid, 0, n - 1)] < key
        l, h = np.where(lt, mid + 1, l), np.where(lt, h, mid)
    np.testing.assert_array_equal(lo.numpy(), l)
    total = (int(keys_np.astype(np.int64).sum()) + int(l.sum())) % 2**32
    assert int(value) == (total - 2**32 if total >= 2**31 else total)
    assert value.dtype == torch.int32 and value.dim() == 0


def test_preflight_cpu_is_live_with_the_reference_gauges():
    tel = obs.Telemetry()
    v = oracle.preflight(tel=tel, candidates=["cpu", "tpu"],
                         use_cache=False)
    assert v["platform"] == "cpu"
    assert v["probes"]["cpu"]["live"] and v["probes"]["cpu"]["devices"] == 1
    assert v["probes"]["tpu"] == {
        "live": False, "error": "not live: the port has no TPU platform"}
    assert tel.gauges["backend.oracle_choice"] == "cpu"
    assert tel.gauges["backend.oracle_probe"] == v["probes"]
    assert tel.gauges["backend.oracle_wall_s"] == v["wall_s"]
    assert oracle.preflight(use_cache=True) is v  # the per-process cache
    oracle.reset_cache_for_tests()


def _cli(argv, capsys, tmp_path=None):
    extra = []
    if tmp_path is not None:
        extra = ["--metrics-out", str(tmp_path / "m.json")]
    rc = tmain(["check", SPEC] + argv + extra)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_backend_cpu_runs_on_the_cpu(capsys):
    rc, out, err = _cli(["--backend", "cpu"], capsys)
    assert rc == 0, err
    assert "backend=torch:cpu" in out and "43 states generated" in out


@pytest.mark.parametrize("argv,needle", [
    (["--backend", "tpu"], "the torch port has no TPU platform"),
    (["--backend", "gpu"], "run on the CPU with --device cpu"),
    (["--backend", "cpu", "--device", "cuda"], "contradicts --device cuda"),
    (["--backend", "gpu", "--device", "cpu"], "contradicts --device cpu"),
])
def test_refused_backends_exit_2_with_one_line(argv, needle, capsys,
                                              tmp_path, monkeypatch):
    # no CUDA device, wherever the test runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _cli(argv, capsys, tmp_path)
    assert rc == 2 and out == ""
    assert err.count("\n") == 1 and err.startswith("error: ") \
        and needle in err, err
    with open(tmp_path / "m.json") as fh:
        m = json.load(fh)
    assert m["result"]["ok"] is False and needle in m["result"]["error"]


def test_backend_auto_chooses_the_cpu_here(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the oracle chooses gpu "
                    "there (tests/test_torch_cuda.py)")
    oracle.reset_cache_for_tests()
    rc, out, err = _cli(["--backend", "auto"], capsys, tmp_path)
    oracle.reset_cache_for_tests()
    assert rc == 0, err
    lines = out.splitlines()
    assert lines[0].startswith("-- backend oracle: cpu (highest-ranked "
                               "live platform of ['cpu']; ")
    assert "backend=torch:cpu" in out
    with open(tmp_path / "m.json") as fh:
        m = json.load(fh)
    assert m["gauges"]["backend.oracle_choice"] == "cpu"
    assert not m["gauges"]["backend.oracle_probe"]["gpu"]["live"]
    assert [p["name"] for p in m["phases"]][:3] == \
        ["load", "parse", "preflight_oracle"]


@pytest.mark.parametrize("fake", [False, True])
def test_oracle_pick_wall_takes_the_fastest_dispatch(fake, monkeypatch):
    # JAXMC_ORACLE_PICK=wall: the live platform with the least dispatch
    # wall wins, whatever its rank (the reference's rule and reason)
    monkeypatch.setenv("JAXMC_ORACLE_PICK", "wall")
    cands = ["cpu"]
    if fake:
        cands = ["gpu", "cpu"]
        probes = {"gpu": {"live": True, "devices": 1, "compile_s": 0.1,
                          "dispatch_s": 0.5, "launches": 2},
                  "cpu": {"live": True, "devices": 1, "compile_s": 0.1,
                          "dispatch_s": 0.01}}
        monkeypatch.setattr(oracle, "_build_kernels", lambda tel: None)
        monkeypatch.setattr(oracle, "probe_platforms",
                            lambda plats, deadline_s: dict(probes))
    tel = obs.Telemetry()
    v = oracle.preflight(tel=tel, candidates=cands, use_cache=False)
    oracle.reset_cache_for_tests()
    assert v["platform"] == "cpu"
    assert v["reason"] == "fastest probe dispatch (JAXMC_ORACLE_PICK=wall)"
    assert tel.gauges["backend.oracle_choice"] == "cpu"
    monkeypatch.delenv("JAXMC_ORACLE_PICK")
    if fake:  # by rank, the same probes choose the card
        v = oracle.preflight(tel=tel, candidates=cands, use_cache=False)
        oracle.reset_cache_for_tests()
        assert v["platform"] == "gpu"


def test_gpu_probe_launch_count_reaches_the_gauge_and_the_line(
        monkeypatch, capsys):
    # the gpu probe child reports K12's launches; the record keeps them
    # and the ORACLE line prints them (a cpu record has none)
    class P:
        returncode = 0
    line = json.dumps({"ok": True, "devices": 1, "platform": "gpu",
                       "compile_s": 0.2, "dispatch_s": 0.001,
                       "import_s": 4.0, "launches": 2})
    rec = oracle._parse_probe(P(), line + "\n", "", "gpu")
    assert rec == {"live": True, "devices": 1, "compile_s": 0.2,
                   "dispatch_s": 0.001, "launches": 2}
    cpu = {"live": True, "devices": 1, "compile_s": 0.3, "dispatch_s": 0.02}
    monkeypatch.setattr(oracle, "preflight", lambda **kw: {
        "platform": "gpu", "probes": {"gpu": rec, "cpu": cpu},
        "wall_s": 5.0, "reason": "highest-ranked live platform of "
                                 "['gpu', 'cpu']"})
    assert oracle.main(["--smoke"]) == 0
    assert capsys.readouterr().out.splitlines()[:2] == [
        "ORACLE gpu live devices=1 compile=0.2s dispatch=0.001s launches=2",
        "ORACLE cpu live devices=1 compile=0.3s dispatch=0.02s"]
