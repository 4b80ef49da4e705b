r"""Mesh parity and scaling harness: `python -m jaxmc_torch.meshbench`.

The port of jaxmc/meshbench.py.  Each leg runs the sharded mesh engine
(backend/mesh.py) on one (spec, D) pair in a child process; the D shards
of a leg share one device (`--device cpu`, or the card, the default).
A rung's pins, starting mesh capacities, deadlock setting and include
directories come from the corpus manifest (corpus.py case_for_cfg);
rungs that need the reference corpus (the MCraft family EXTENDS its
raft.tla) print a parseable `MESHBENCH SKIP` line where it is absent.

Subcommands
  check   D in {2,4} (default) over viewtoy_scaled, symtoy_scaled and
          MCraft_micro: per leg one warm-up run, then the timed run on
          the same engine.  The counts must equal the manifest's pins,
          host_syncs may not exceed the level records (one scalar read a
          level: more means row traffic in the level loop), and each
          leg's metrics artifact gates against a saved baseline with
          `python -m jaxmc_torch.obs diff --fail-on-regress` (the first
          run snapshots it).  `--merge fullsort` runs the leg with
          JAXMC_MESH_RANKMERGE=0, `--exchange` pins the exchange.
  bench   D in {1,2,4,8} (default) over MCraft_3s_bench and
          transfer_scaled: per D one warm-up run, the timed run, then
          MeshExplorer.probe_phase_walls (the expand / exchange / rank
          and full-sort merge walls, each phase a separate timed call).
          Gates: no nvcc build inside the timed window
          (window_recompiles 0), host_syncs <= levels, and the obs diff
          gate.  Writes a jaxmc.multichip/1 artifact (--out, by default
          jaxmc_torch_multichip.json under --out-dir) with each point's
          rates, host syncs, exchange bytes, phase walls and the
          probe's kernel launches and shapes.
  child   one (spec, D) leg; prints one `MESHBENCH_RESULT {json}` line.

    python -m jaxmc_torch.meshbench check --devices 2,4 --device cpu
    python -m jaxmc_torch.meshbench bench --devices 1,2 --device cpu \
        --rung specs/constoy.tla --out-dir DIR
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RESULT_TAG = "MESHBENCH_RESULT "

# the reference's default rung sets (spec paths relative to the repo
# root; a cfg of None is the spec's sibling .cfg)
CHECK_RUNGS = [
    ("specs/viewtoy_scaled.tla", None),
    ("specs/symtoy_scaled.tla", None),
    ("specs/MCraftMicro.tla", "specs/MCraft_micro.cfg"),
]
BENCH_RUNGS = [
    ("specs/MCraftMicro.tla", "specs/MCraft_3s_bench.cfg"),
    ("specs/transfer_scaled.tla", None),
]
# the kernels whose probe launches a bench point reports
PROBE_KERNELS = ("unpack_rows", "gen_expand", "keys_of", "mesh_route",
                 "mesh_route_gather", "resident_compact_mesh_vc",
                 "resident_compact_mesh_front", "seen_probe", "rank_merge",
                 "fullsort_dedup")


def _case(spec: str, cfg: Optional[str]):
    from .corpus import case_for_cfg
    return case_for_cfg(os.path.basename(
        cfg or os.path.splitext(spec)[0] + ".cfg"))


def _needs_reference(spec: str, cfg: Optional[str]) -> Optional[str]:
    """A SKIP reason when this rung cannot load here."""
    from .corpus import reference_missing
    case = _case(spec, cfg)
    if case is not None and case.needs_reference():
        return reference_missing()
    return None


def _leg_name(spec: str, cfg: Optional[str]) -> str:
    return os.path.splitext(os.path.basename(cfg or spec))[0]


def _run_child(spec: str, cfg: Optional[str], devices: int,
               exchange: Optional[str], out_dir: str, device: Optional[str],
               timeout_s: float, merge: Optional[str] = None,
               phase_probe: bool = False) -> Dict:
    name = _leg_name(spec, cfg)
    suffix = f"_{merge}" if merge else ""
    plat = "cpu" if device == "cpu" else "gpu"
    metrics = os.path.join(
        out_dir, f"jaxmc_torch_mesh_{plat}_{name}_d{devices}{suffix}.json")
    cmd = [sys.executable, "-m", "jaxmc_torch.meshbench", "child",
           "--spec", spec, "--devices", str(devices), "--timed",
           "--metrics-out", metrics]
    for flag, val in (("--cfg", cfg), ("--exchange", exchange),
                      ("--merge", merge), ("--device", device)):
        if val:
            cmd += [flag, val]
    if phase_probe:
        cmd += ["--phase-probe"]
    env = dict(os.environ, PYTHONPATH=_REPO)
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO,
                           env=env, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "leg": name, "devices": devices,
                "error": f"timed out after {timeout_s:.0f}s"}
    for line in (p.stdout or "").splitlines():
        if line.startswith(_RESULT_TAG):
            r = json.loads(line[len(_RESULT_TAG):])
            r["leg"] = name
            r["metrics_path"] = metrics
            r["child_wall_s"] = round(time.time() - t0, 3)
            return r
    tail = ((p.stderr or "") + (p.stdout or "")).strip() \
        .splitlines()[-3:] or ["no output"]
    return {"ok": False, "leg": name, "devices": devices,
            "error": f"child rc={p.returncode}: "
                     + " | ".join(t[:160] for t in tail)}


def _gate(metrics_path: str, log=print) -> int:
    """Gate one leg's artifact against its saved baseline (the first run
    snapshots it)."""
    base = metrics_path.replace(".json", ".baseline.json")
    if not os.path.exists(metrics_path):
        return 0
    if not os.path.exists(base):
        import shutil
        shutil.copyfile(metrics_path, base)
        log(f"meshbench: baseline saved -> {base}")
        return 0
    from .obs.report import main as obs_main
    log(f"meshbench: gating {os.path.basename(metrics_path)} vs saved "
        f"baseline")
    return obs_main(["diff", "--fail-on-regress", "--threshold", "25", base,
                     metrics_path])


def cmd_check(args) -> int:
    failures = 0
    for spec, cfg in args.rungs:
        name = _leg_name(spec, cfg)
        skip = _needs_reference(spec, cfg)
        if skip:
            print(f"MESHBENCH SKIP {name}: {skip}")
            continue
        case = _case(spec, cfg)
        for D in args.devices:
            r = _run_child(spec, cfg, D, args.exchange, args.out_dir,
                           args.device, args.timeout, args.merge)
            if not r.get("ok"):
                print(f"MESHBENCH FAIL {name} D={D}: {r.get('error', r)}")
                failures += 1
                continue
            want = (case.generated, case.distinct) if case else None
            got = (r["generated"], r["distinct"])
            if want and want != got:
                print(f"MESHBENCH FAIL {name} D={D}: counts {got} != "
                      f"pinned {want}")
                failures += 1
                continue
            if r["host_syncs"] > r["levels"]:
                # one scalar-vector read per level: more reads than level
                # records means row traffic leaked into the level loop
                print(f"MESHBENCH FAIL {name} D={D}: host_syncs "
                      f"{r['host_syncs']} > levels {r['levels']} "
                      f"(row traffic leaked into the level loop)")
                failures += 1
                continue
            print(f"MESHBENCH ok {name} D={D} exchange={r['exchange']} "
                  f"merge={r['merge']}: {r['generated']} gen / "
                  f"{r['distinct']} distinct ({r['states_per_sec']:,.0f} "
                  f"st/s, host_syncs={r['host_syncs']}, "
                  f"levels={r['levels']}, spill={r.get('a2a_spill', 0)})")
            if _gate(r["metrics_path"]):
                failures += 1
    print(f"meshbench check: {'FAIL' if failures else 'ok'} "
          f"({failures} failing legs)")
    return 1 if failures else 0


_POINT_KEYS = ("devices", "exchange", "merge", "generated", "distinct",
               "diameter", "wall_s", "warmup_wall_s", "states_per_sec",
               "states_per_sec_per_chip", "window_recompiles",
               "host_syncs", "levels", "supersteps", "superstep_levels",
               "exchange_bytes", "exchange_bytes_per_level",
               "phase_walls", "phase_launches", "phase_shapes",
               "a2a_gamma", "a2a_spill",
               "a2a_max_bucket", "shard_balance")


def cmd_bench(args) -> int:
    from . import obs
    rungs_out: List[Dict] = []
    failures = 0
    for spec, cfg in args.rungs:
        name = _leg_name(spec, cfg)
        skip = _needs_reference(spec, cfg)
        if skip:
            print(f"MESHBENCH SKIP {name}: {skip}")
            rungs_out.append({"rung": name, "spec": spec, "cfg": cfg,
                              "skipped": skip})
            continue
        curve: List[Dict] = []
        for D in args.devices:
            r = _run_child(spec, cfg, D, args.exchange, args.out_dir,
                           args.device, args.timeout, args.merge,
                           phase_probe=True)
            if not r.get("ok"):
                print(f"MESHBENCH FAIL {name} D={D}: {r.get('error', r)}")
                failures += 1
                curve.append({"devices": D,
                              "error": r.get("error", "failed")})
                continue
            curve.append({k: r[k] for k in _POINT_KEYS if k in r})
            print(f"MESHBENCH point {name} D={D}: "
                  f"{r['states_per_sec']:,.0f} st/s "
                  f"({r['states_per_sec_per_chip']:,.0f} /shard), "
                  f"recompiles={r['window_recompiles']}, "
                  f"host_syncs={r['host_syncs']}/{r['levels']} lvls, "
                  f"xbytes/lvl={r['exchange_bytes_per_level']:,}, "
                  f"balance={r.get('shard_balance')}, "
                  f"phases={r.get('phase_walls')}")
            if r["window_recompiles"] != 0:
                print(f"MESHBENCH FAIL {name} D={D}: warm run "
                      f"recompiled {r['window_recompiles']}x inside "
                      f"the window")
                failures += 1
            if r["host_syncs"] > r["levels"]:
                print(f"MESHBENCH FAIL {name} D={D}: host_syncs "
                      f"{r['host_syncs']} > levels {r['levels']}")
                failures += 1
            if _gate(r["metrics_path"]):
                failures += 1
        rungs_out.append({"rung": name, "spec": spec, "cfg": cfg,
                          "curve": curve})
    art = {
        "schema": "jaxmc.multichip/1",
        "generated_at": time.time(),
        "mode": "mesh-resident",
        "platform": "cpu" if args.device == "cpu" else "gpu",
        # the shards of every point share one device
        "virtual_devices": True,
        "env": obs.environment_meta(
            "cpu" if args.device == "cpu" else "cuda"),
        "devices_swept": list(args.devices),
        "rungs": rungs_out,
        "ok": failures == 0,
    }
    out = args.out or os.path.join(args.out_dir, "jaxmc_torch_multichip.json")
    obs.write_json_atomic(out, art)
    print(f"meshbench: wrote {out} "
          f"({'FAIL' if failures else 'ok'}, {len(rungs_out)} rungs)")
    return 1 if failures else 0


def cmd_child(args) -> int:
    if args.merge:
        # read at engine build: rank is the default, 0 forces the full sort
        os.environ["JAXMC_MESH_RANKMERGE"] = \
            "0" if args.merge == "fullsort" else "1"
    from . import obs
    from .backend.mesh import MeshExplorer
    from .kernels import build, ops
    from .session import load_model

    spec = args.spec if os.path.isabs(args.spec) \
        else os.path.join(_REPO, args.spec)
    cfg = args.cfg
    if cfg is None:
        guess = os.path.splitext(spec)[0] + ".cfg"
        cfg = guess if os.path.exists(guess) else None
    elif not os.path.isabs(cfg):
        cfg = os.path.join(_REPO, cfg)
    case = _case(spec, cfg)
    model = load_model(spec, cfg,
                       no_deadlock=bool(case and case.no_deadlock),
                       includes=case.include_dirs() if case else ())
    caps = dict(case.mesh_caps) if case and case.mesh_caps else None

    tel = obs.Telemetry(meta={"backend": "torch-mesh",
                              "devices": args.devices})
    with obs.use(tel):
        me = MeshExplorer(model, shards=args.devices, device=args.device,
                          exchange=args.exchange or None,
                          store_trace=args.store_trace, mesh_caps=caps)
        t0 = time.time()
        result = me.run()
        warm_wall = time.time() - t0
        wall = warm_wall
        lvl0, sync0, xb0 = (len(tel.levels),
                            tel.counters.get("mesh.host_syncs", 0),
                            tel.counters.get("mesh.exchange_bytes", 0))
        builds0 = build.BUILDS
        if args.timed:
            # the measured window: a second run on the same engine, every
            # kernel already built
            t0 = time.time()
            result = me.run()
            wall = time.time() - t0
        window_builds = build.BUILDS - builds0
        phase_walls = phase_launches = None
        if args.phase_probe:
            ops.reset_launches()
            phase_walls = me.probe_phase_walls()
            phase_launches = {k: v for k, v in ops.LAUNCHES.items()
                              if k in PROBE_KERNELS}
    timed = bool(args.timed)
    levels = len(tel.levels) - (lvl0 if timed else 0)
    host_syncs = tel.counters.get("mesh.host_syncs", 0) - \
        (sync0 if timed else 0)
    xbytes = tel.counters.get("mesh.exchange_bytes", 0) - \
        (xb0 if timed else 0)
    rate = result.generated / max(wall, 1e-9)
    out = {
        "ok": bool(result.ok),
        "devices": args.devices,
        "device": str(me.device),
        "exchange": me.exchange,
        "merge": me.merge,
        "generated": int(result.generated),
        "distinct": int(result.distinct),
        "diameter": int(result.diameter),
        "truncated": bool(result.truncated),
        "wall_s": round(wall, 6),
        "warmup_wall_s": round(warm_wall, 6),
        "states_per_sec": round(rate, 3),
        # the reference's per-device rate; here the D shards share one
        # device, so it is the rate per shard
        "states_per_sec_per_chip": round(rate / args.devices, 3),
        # nvcc builds inside the timed window (0 once warm)
        "window_recompiles": window_builds if timed else 0,
        "host_syncs": host_syncs,
        # one level per dispatch: a superstep is a level
        "supersteps": host_syncs,
        "levels": levels,
        "exchange_bytes": int(xbytes),
        "exchange_bytes_per_level": int(xbytes / max(levels, 1)),
    }
    if phase_walls:
        out["phase_walls"] = phase_walls
        out["phase_launches"] = phase_launches
        out["phase_shapes"] = tel.gauges.get("mesh.probe_shapes")
    for k, src in (("superstep_levels", "mesh.superstep_levels"),
                   ("a2a_gamma", "mesh.a2a_gamma"),
                   ("a2a_spill", "mesh.a2a_spill"),
                   ("a2a_max_bucket", "mesh.a2a_max_bucket"),
                   ("shard_balance", "mesh.shard_balance")):
        if src in tel.gauges:
            out[k] = tel.gauges[src]
    if args.metrics_out:
        summary = tel.summary(result={
            "ok": bool(result.ok), "distinct": int(result.distinct),
            "generated": int(result.generated),
            "diameter": int(result.diameter),
            "truncated": bool(result.truncated), "wall_s": round(wall, 6)})
        summary["backend"] = "torch"
        summary["spec"] = args.spec
        summary["multichip"] = {k: out[k] for k in
                                ("devices", "exchange", "merge",
                                 "states_per_sec",
                                 "states_per_sec_per_chip",
                                 "window_recompiles", "host_syncs",
                                 "supersteps", "superstep_levels",
                                 "levels", "phase_walls",
                                 "exchange_bytes_per_level")
                                if k in out}
        obs.write_json_atomic(args.metrics_out, summary)
    print(_RESULT_TAG + json.dumps(out), flush=True)
    return 0


def _parse_rungs(vals: Optional[List[str]], default) -> List:
    if not vals:
        return list(default)
    out = []
    for v in vals:
        s, c = v.split("=", 1) if "=" in v else (v, None)
        out.append((s, c))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jaxmc_torch.meshbench",
                                 description="mesh parity and scaling "
                                             "harness")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, dflt_devices):
        p.add_argument("--devices", default=dflt_devices,
                       help="comma-separated shard counts")
        p.add_argument("--exchange", default=None,
                       choices=(None, "a2a", "gather"))
        p.add_argument("--merge", default=None,
                       choices=(None, "rank", "fullsort"))
        p.add_argument("--rung", action="append", default=None,
                       help="spec[=cfg], repeatable (repo-relative)")
        p.add_argument("--device", default=None,
                       help="cpu, or the card (the default)")
        p.add_argument("--out-dir", default=os.environ.get(
            "JAXMC_PROBE_DIR", tempfile.gettempdir()))
        p.add_argument("--timeout", type=float, default=float(
            os.environ.get("JAXMC_MESHBENCH_TIMEOUT", "900")))

    common(sub.add_parser("check", help="parity legs"), "2,4")
    pb = sub.add_parser("bench", help="scaling curve with phase walls")
    common(pb, "1,2,4,8")
    pb.add_argument("--out", default=None,
                    help="the jaxmc.multichip/1 artifact (default: "
                         "jaxmc_torch_multichip.json under --out-dir)")
    pch = sub.add_parser("child")
    pch.add_argument("--spec", required=True)
    pch.add_argument("--cfg", default=None)
    pch.add_argument("--devices", type=int, required=True)
    pch.add_argument("--exchange", default=None)
    pch.add_argument("--merge", default=None,
                     choices=(None, "rank", "fullsort"))
    pch.add_argument("--device", default=None)
    pch.add_argument("--timed", action="store_true")
    pch.add_argument("--phase-probe", action="store_true")
    pch.add_argument("--store-trace", action="store_true")
    pch.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "child":
        return cmd_child(args)
    args.devices = [int(x) for x in str(args.devices).split(",") if x]
    args.rungs = _parse_rungs(
        args.rung, CHECK_RUNGS if args.cmd == "check" else BENCH_RUNGS)
    return cmd_check(args) if args.cmd == "check" else cmd_bench(args)


if __name__ == "__main__":
    sys.exit(main())
