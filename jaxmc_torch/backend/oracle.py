r"""Preflight backend oracle: the port of jaxmc/backend/oracle.py.

`--backend auto` must answer "which live platform should this run use?"
in SECONDS.  The oracle probes each candidate platform with a TINY
representative program (the reference's: a stable 4-key sort, a rank
scatter and a 14-step vectorized lower bound -- the merge kernel's
shape in miniature) inside a TIMEOUT-GUARDED subprocess, because a dead
accelerator hangs at device init, and a hang inside the parent would
defeat the point.

The probe program (`probe`) is B.13: the sort is K18 `sort_keys` and
everything after it is K12 `oracle_probe` on the card, their plain
twins on the CPU.  The parent
builds the kernels (nvcc, host work that never touches the card) in a
`build` span before the probes start, so the gpu probe only loads the
prebuilt library by ctypes and its budget is not spent compiling.

Verdict policy, as the reference's: every platform whose probe
completes inside its budget is LIVE; among live platforms the highest
rank wins (gpu > cpu).  JAXMC_ORACLE_PICK=wall flips to
fastest-dispatch-wins.  The port has no TPU platform: a `tpu` candidate
is reported not live without a probe.

Telemetry:
  gauge backend.oracle_choice   the chosen platform
  gauge backend.oracle_probe    {platform: {live, compile_s,
                                dispatch_s, devices, error?}}; a
                                live gpu probe adds `launches`, K12's
                                count in the probe's process, and
                                `sort_launches`, K18's
  gauge backend.oracle_wall_s   total preflight wall

CLI: `python -m jaxmc_torch.backend.oracle [--smoke] [--deadline S]`
prints one `ORACLE <platform> ...` line per candidate plus the verdict;
--smoke exits non-zero when the oracle blows its deadline or finds no
live platform.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import PLATFORM_RANK

_CANDIDATES = ("gpu", "cpu")
_VERDICT_CACHE: Optional[Dict] = None

# the probe program's shape (the reference's): big enough that a
# pathologically slow backend shows, small enough to finish in ~a second
_PROBE_N = 8192

# the repo root the probe subprocess imports the package from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_PROBE_SRC = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from jaxmc_torch.backend.oracle import _probe_child; "
              "sys.exit(_probe_child(sys.argv[2]))")

_NO_TPU = "not live: the port has no TPU platform"

# the preflight deadline: the reference's 10 s is too short for a fresh
# process to import torch and create its CUDA context (6.0-12.1 s on an
# NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 21; past 8 s one
# gpu probe was cut); a dead device still costs seconds, not a hung
# run.  JAXMC_ORACLE_DEADLINE / JAXMC_ORACLE_PROBE_TIMEOUT override
DEADLINE_S = 30.0


def probe_keys(device="cpu"):
    """The reference's probe input: N x 4 int32 keys from
    np.random.RandomState(0) (jaxmc/backend/oracle.py:67-69)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    keys = rng.randint(-2**31, 2**31 - 1, (_PROBE_N, 4),
                       dtype=np.int64).astype(np.int32)
    return torch.as_tensor(keys, device=device)


def probe(keys):
    """The probe program on `keys` [N, 4] int32: the stable 4-key sort
    with a row-index payload (K18), then K12 (their twins for a CPU
    tensor).  Returns the wrapped int32 checksum, a 0-d tensor."""
    from ..kernels import ops
    sk, perm = ops.sort_keys(keys)
    _out, _lo, value = ops.oracle_probe(sk, perm, keys)
    return value


def _probe_child(platform: str) -> int:
    """The probe subprocess: one JSON line with the reference's keys."""
    t_import = time.time()
    import torch
    t_ready = time.time()
    if platform == "gpu":
        if not torch.cuda.is_available():
            print(json.dumps({"ok": False,
                              "error": "torch sees no CUDA device"}))
            return 0
        device, devices = "cuda", torch.cuda.device_count()
    else:
        device, devices = "cpu", 1
    keys = probe_keys(device)
    t0 = time.time()
    int(probe(keys))  # the read synchronises
    compile_s = time.time() - t0
    t0 = time.time()
    int(probe(keys))
    dispatch_s = time.time() - t0
    r = {"ok": True, "devices": devices, "platform": platform,
         "compile_s": round(compile_s, 4),
         "dispatch_s": round(dispatch_s, 4),
         "import_s": round(t_ready - t_import, 4)}
    if platform == "gpu":
        # K12's and K18's launches in this process: the port's
        # addition, which says the verdict was reached through the
        # kernels
        from ..kernels import ops
        r["launches"] = ops.LAUNCHES["oracle_probe"]
        r["sort_launches"] = ops.LAUNCHES["sort_keys"]
    print(json.dumps(r))
    return 0


def _parse_probe(p: subprocess.Popen, out: str, err: str,
                 platform: str) -> Dict:
    line = (out or "").strip().splitlines()[-1:] or [""]
    try:
        r = json.loads(line[0])
    except ValueError:
        tail = ((err or "") + (out or "")).strip() \
            .splitlines()[-1:] or ["no output"]
        return {"live": False,
                "error": f"probe rc={p.returncode}: {tail[0][:160]}"}
    if not r.get("ok"):
        return {"live": False, "error": r.get("error", "probe failed")}
    if r.get("platform") != platform:
        return {"live": False,
                "error": f"torch delivered {r.get('platform')!r} instead"}
    out = {"live": True, "devices": r.get("devices"),
           "compile_s": r.get("compile_s"),
           "dispatch_s": r.get("dispatch_s")}
    for k in ("launches", "sort_launches"):
        if k in r:
            out[k] = r[k]
    return out


def _build_kernels(tel) -> Optional[str]:
    """Build the CUDA kernels in the parent before the gpu probe starts
    (host work: nvcc, no card), so the probe's budget is spent probing.
    Returns the build error, or None."""
    from ..kernels import build
    with tel.span("build"):
        try:
            build.build_all()
        except (RuntimeError, OSError) as ex:
            return f"not live: kernel build failed ({ex})"
    return None


def probe_platforms(platforms: List[str],
                    deadline_s: float = 8.0) -> Dict[str, Dict]:
    """Probe every candidate CONCURRENTLY under one shared deadline: the
    preflight wall is the SLOWEST probe, not the sum.  Each probe is its
    own subprocess so a wedged device init costs the deadline, never a
    hung run.  A gpu probe loads the built kernels (preflight builds
    them first; a probe that finds none builds them inside its
    budget)."""
    from ..obs import context as trace_context
    env = trace_context.child_env()  # probes join the caller's trace
    out: Dict[str, Dict] = {}
    if "tpu" in platforms:
        out["tpu"] = {"live": False, "error": _NO_TPU}
    t0 = time.time()
    procs: Dict[str, subprocess.Popen] = {}
    for plat in platforms:
        if plat in out:
            continue
        try:
            procs[plat] = subprocess.Popen(
                [sys.executable, "-c", _PROBE_SRC, _ROOT, plat],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)
        except OSError as ex:
            out[plat] = {"live": False,
                         "error": f"probe could not run: {ex}"}
    for plat, p in procs.items():
        left = max(0.1, deadline_s - (time.time() - t0))
        try:
            so, se = p.communicate(timeout=left)
            out[plat] = _parse_probe(p, so, se, plat)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            out[plat] = {"live": False,
                         "error": f"probe wedged past "
                                  f"{deadline_s:.1f}s "
                                  f"(dead driver or device?)"}
    return {plat: out[plat] for plat in platforms}


def preflight(deadline_s: float = DEADLINE_S, tel=None,
              candidates: Optional[List[str]] = None,
              use_cache: bool = True) -> Dict:
    """Probe the candidate platforms and pick the best live one.

    Returns {"platform": str | None, "probes": {plat: probe},
    "wall_s": float, "reason": str}.  The verdict is cached per process;
    `use_cache=False` forces a fresh sweep."""
    global _VERDICT_CACHE
    if use_cache and _VERDICT_CACHE is not None:
        return _VERDICT_CACHE
    from .. import obs
    tel = tel if tel is not None else obs.current()
    cands = list(candidates or _CANDIDATES)
    # the build is set-up, in its own span and outside the deadline
    err = _build_kernels(tel) if "gpu" in cands else None
    t0 = time.time()
    # the probe budget leaves 2 s of the deadline for subprocess spawn
    # and result collection, as the reference's
    budget = float(os.environ.get("JAXMC_ORACLE_PROBE_TIMEOUT",
                                  str(max(1.0, deadline_s - 2.0))))
    probes = probe_platforms([p for p in cands if p != "gpu" or not err],
                             deadline_s=budget)
    if err:
        probes["gpu"] = {"live": False, "error": err}
    probes = {p: probes[p] for p in cands}
    live = [p for p in cands if probes[p].get("live")]
    pick_by_wall = os.environ.get("JAXMC_ORACLE_PICK") == "wall"
    if not live:
        choice, reason = None, "no live platform (all probes failed)"
    elif pick_by_wall:
        choice = min(live,
                     key=lambda p: probes[p].get("dispatch_s") or 1e9)
        reason = "fastest probe dispatch (JAXMC_ORACLE_PICK=wall)"
    else:
        choice = max(live, key=lambda p: PLATFORM_RANK.get(p, 0))
        reason = f"highest-ranked live platform of {live}"
    wall = round(time.time() - t0, 3)
    verdict = {"platform": choice, "probes": probes, "wall_s": wall,
               "reason": reason}
    tel.gauge("backend.oracle_choice", choice or "none")
    tel.gauge("backend.oracle_probe", probes)
    tel.gauge("backend.oracle_wall_s", wall)
    tel.event("backend.oracle", choice=choice, wall_s=wall,
              reason=reason)
    _VERDICT_CACHE = verdict
    return verdict


def reset_cache_for_tests() -> None:
    global _VERDICT_CACHE
    _VERDICT_CACHE = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m jaxmc_torch.backend.oracle",
        description="probe visible platforms, pick the best live one")
    ap.add_argument("--deadline", type=float, default=float(
        os.environ.get("JAXMC_ORACLE_DEADLINE", str(DEADLINE_S))))
    ap.add_argument("--smoke", action="store_true",
                    help="exit 1 unless a live platform was chosen "
                         "inside the deadline")
    args = ap.parse_args(argv)
    v = preflight(deadline_s=args.deadline, use_cache=False)
    for plat, pr in v["probes"].items():
        if pr.get("live"):
            print(f"ORACLE {plat} live devices={pr['devices']} "
                  f"compile={pr['compile_s']}s "
                  f"dispatch={pr['dispatch_s']}s"
                  + "".join(f" {k}={pr[k]}" for k in
                            ("launches", "sort_launches") if k in pr))
        else:
            print(f"ORACLE {plat} SKIP: {pr.get('error')}")
    print(f"ORACLE verdict {v['platform'] or 'none'} "
          f"wall={v['wall_s']}s ({v['reason']})")
    if args.smoke:
        if v["platform"] is None:
            print("ORACLE FAIL: no live platform", file=sys.stderr)
            return 1
        if v["wall_s"] > args.deadline:
            print(f"ORACLE FAIL: preflight took {v['wall_s']}s "
                  f"> deadline {args.deadline}s", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
