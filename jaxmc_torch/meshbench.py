r"""Mesh parity harness: `python -m jaxmc_torch.meshbench`.

The port of jaxmc/meshbench.py's `check` and `child` subcommands: the
sharded mesh engine (backend/mesh.py) must give each repo-local rung's
pinned counts at every shard count, read at most one scalar vector per
level (host_syncs <= level records: no row traffic in the level loop),
and each leg's metrics artifact gates against a saved baseline with
`python -m jaxmc_torch.obs diff --fail-on-regress` (the first run
snapshots it).  Each leg runs in a child process.  The D shards of a
leg share one device; `--device cpu` runs them on the CPU, the default
is the card.

Subcommands
  check   D in {2,4} (default) over the rungs (viewtoy_scaled and
          symtoy_scaled, the reference's repo-local check rungs, with
          the corpus pins): per leg one warm-up run, then the timed run
          on the same engine.  `--merge fullsort` runs the leg with
          JAXMC_MESH_RANKMERGE=0, `--exchange` pins the exchange.
  child   one (spec, D) leg; prints one `MESHBENCH_RESULT {json}` line.

    python -m jaxmc_torch.meshbench check --devices 2,4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RESULT_TAG = "MESHBENCH_RESULT "

# (spec, cfg) -> (distinct, generated, no_deadlock, starting mesh caps):
# jaxmc/corpus.py's pins and mesh caps of the repo-local rungs
RUNGS: Dict[Tuple[str, Optional[str]], Tuple[int, int, bool, Dict]] = {
    ("specs/viewtoy_scaled.tla", "specs/viewtoy_scaled.cfg"):
        (18432, 239617, False, {"SC": 1 << 16, "FC": 1 << 11, "TRL": 32,
                                "GAM16": 32}),
    ("specs/symtoy_scaled.tla", "specs/symtoy_scaled.cfg"):
        (10725, 65365, True, {"SC": 1 << 15, "FC": 1 << 11, "TRL": 32,
                              "GAM16": 32}),
    ("specs/constoy.tla", "specs/constoy.cfg"): (21, 43, False, {}),
}
CHECK_RUNGS = [("specs/viewtoy_scaled.tla", "specs/viewtoy_scaled.cfg"),
               ("specs/symtoy_scaled.tla", "specs/symtoy_scaled.cfg")]


def _leg_name(spec: str, cfg: Optional[str]) -> str:
    return os.path.splitext(os.path.basename(cfg or spec))[0]


def _default_cfg(spec: str) -> Optional[str]:
    guess = os.path.splitext(spec)[0] + ".cfg"
    return guess if os.path.exists(os.path.join(_REPO, guess)) else None


def _run_child(spec: str, cfg: Optional[str], devices: int,
               exchange: Optional[str], out_dir: str, device: Optional[str],
               timeout_s: float, merge: Optional[str] = None) -> Dict:
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
    snapshots it), as `make bench-check` does."""
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
        pin = RUNGS.get((spec, cfg))
        for D in args.devices:
            r = _run_child(spec, cfg, D, args.exchange, args.out_dir,
                           args.device, args.timeout, args.merge)
            if not r.get("ok"):
                print(f"MESHBENCH FAIL {name} D={D}: {r.get('error', r)}")
                failures += 1
                continue
            got = (r["distinct"], r["generated"])
            if pin and got != pin[:2]:
                print(f"MESHBENCH FAIL {name} D={D}: counts {got} != "
                      f"pinned {pin[:2]}")
                failures += 1
                continue
            if r["host_syncs"] > r["levels"]:
                # one scalar-vector read per level: more reads than level
                # records means row traffic leaked into the level loop
                print(f"MESHBENCH FAIL {name} D={D}: host_syncs "
                      f"{r['host_syncs']} > levels {r['levels']}")
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


def cmd_child(args) -> int:
    if args.merge:
        # read at engine build: rank is the default, 0 forces the full sort
        os.environ["JAXMC_MESH_RANKMERGE"] = \
            "0" if args.merge == "fullsort" else "1"
    from . import obs
    from .backend.mesh import MeshExplorer
    from .kernels import build
    from .session import load_model

    spec = args.spec if os.path.isabs(args.spec) \
        else os.path.join(_REPO, args.spec)
    cfg = args.cfg
    if cfg is None:
        cfg = _default_cfg(args.spec)
    rel_cfg = cfg
    if cfg is not None and not os.path.isabs(cfg):
        cfg = os.path.join(_REPO, cfg)
    _, _, no_deadlock, caps = RUNGS.get((args.spec, rel_cfg),
                                        (0, 0, False, {}))
    model = load_model(spec, cfg, no_deadlock=no_deadlock)

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
        lvl0, sync0 = (len(tel.levels),
                       tel.counters.get("mesh.host_syncs", 0))
        builds0 = build.BUILDS
        if args.timed:
            # the measured window: a second run on the same engine, every
            # kernel already built
            t0 = time.time()
            result = me.run()
            wall = time.time() - t0
    timed = bool(args.timed)
    levels = len(tel.levels) - (lvl0 if timed else 0)
    host_syncs = tel.counters.get("mesh.host_syncs", 0) - \
        (sync0 if timed else 0)
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
        "states_per_sec": round(result.generated / max(wall, 1e-9), 3),
        # nvcc builds inside the timed window (0 once warm)
        "window_recompiles": (build.BUILDS - builds0) if timed else 0,
        "host_syncs": host_syncs,
        "levels": levels,
    }
    for k, src in (("a2a_gamma", "mesh.a2a_gamma"),
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
                                 "states_per_sec", "window_recompiles",
                                 "host_syncs", "levels")}
        obs.write_json_atomic(args.metrics_out, summary)
    print(_RESULT_TAG + json.dumps(out), flush=True)
    return 0


def _parse_rungs(vals: Optional[List[str]]) -> List:
    if not vals:
        return list(CHECK_RUNGS)
    out = []
    for v in vals:
        s, c = v.split("=", 1) if "=" in v else (v, _default_cfg(v))
        out.append((s, c))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jaxmc_torch.meshbench",
                                 description="mesh parity harness")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="parity legs")
    pc.add_argument("--devices", default="2,4",
                    help="comma-separated shard counts")
    pc.add_argument("--exchange", default=None, choices=(None, "a2a",
                                                         "gather"))
    pc.add_argument("--merge", default=None,
                    choices=(None, "rank", "fullsort"))
    pc.add_argument("--rung", action="append", default=None,
                    help="spec[=cfg], repeatable (repo-relative)")
    pc.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    pc.add_argument("--out-dir", default=os.environ.get(
        "JAXMC_PROBE_DIR", tempfile.gettempdir()))
    pc.add_argument("--timeout", type=float, default=float(
        os.environ.get("JAXMC_MESHBENCH_TIMEOUT", "900")))
    pch = sub.add_parser("child")
    pch.add_argument("--spec", required=True)
    pch.add_argument("--cfg", default=None)
    pch.add_argument("--devices", type=int, required=True)
    pch.add_argument("--exchange", default=None)
    pch.add_argument("--merge", default=None,
                     choices=(None, "rank", "fullsort"))
    pch.add_argument("--device", default=None)
    pch.add_argument("--timed", action="store_true")
    pch.add_argument("--store-trace", action="store_true")
    pch.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "child":
        return cmd_child(args)
    args.devices = [int(x) for x in str(args.devices).split(",") if x]
    args.rungs = _parse_rungs(args.rung)
    return cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
