r"""Cross-model batching bench leg of the port: `python -m
jaxmc_torch.batchbench [--device cpu]` (the port of jaxmc/batchbench.py).

A cohort of N layout-compatible jobs costs ONE engine (one layout, one
set of compiled units, one batched step per superstep) instead of N.
Over the repo-local batchtoy family (one module, cfgs differing only in
liftable constant values) this runs two legs:

  COLD COHORT (gated): each member solo from cold (model load, layout
  sampling, unit build, search) against ONE BatchCheckEngine (one
  donor build over the union-sampled layout, one batched dispatch
  sequence).  Aggregate cold states/sec must reach GATE_X (default 2.0,
  JAXMC_BATCH_GATE_X) times the sequential rate.

  WARM DEEP RUNG (informational): the batchtoy_bench* rungs, warm
  engines both sides, identical job options.

Per-member counts must be identical between the legs in both, and the
cold cohort must reach full occupancy (every member in one batched
step).  Without the native host store the leg prints a parseable
`BATCH-CHECK SKIP: <reason>` line and exits 0.  The engines run on the
CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_SPEC = os.path.join(_REPO, "specs", "batchtoy.tla")
COLD_CFGS = [os.path.join(_REPO, "specs", f"batchtoy_{v}.cfg")
             for v in ("a", "b", "c", "d")]
WARM_CFGS = [os.path.join(_REPO, "specs", f"batchtoy_bench{i}.cfg")
             for i in (1, 2, 3, 4)]


def _skip(reason: str) -> int:
    print(f"BATCH-CHECK SKIP: {reason}")
    return 0


def _counts(r):
    return (r.ok, r.distinct, r.generated, r.diameter)


def _parity_or_fail(tag: str, cfgs, solo_results, members, log) -> bool:
    for c, sr, mem in zip(cfgs, solo_results, members):
        if mem.error is not None:
            log(f"BATCH-CHECK FAIL [{tag}]: member "
                f"{os.path.basename(c)} errored: {mem.error}")
            return False
        if _counts(sr) != _counts(mem.result):
            log(f"BATCH-CHECK FAIL [{tag}]: {os.path.basename(c)} "
                f"counts diverge: solo {_counts(sr)} vs batched "
                f"{_counts(mem.result)}")
            return False
    return True


def run_leg(spec: str, cold_cfgs: List[str], warm_cfgs: List[str],
            device: Optional[str] = None, log=print) -> int:
    from . import native_store
    if not native_store.is_available():
        return _skip(f"native host store unavailable "
                     f"({native_store.build_error()})")
    from .backend.batch import BatchCheckEngine, BatchIncompatible
    from .backend.bfs import TorchExplorer, resolve_device
    from .session import SessionConfig, load_model

    dev = str(resolve_device(device))

    def sess(c):
        return SessionConfig(spec=spec, cfg=c, backend="torch",
                             host_seen=True, no_trace=True, device=device)

    # ---- COLD COHORT: N full solo colds vs one batched cold --------
    log(f"== batchbench cold cohort: {len(cold_cfgs)} members "
        f"(device {dev}) ==")
    seq_wall = 0.0
    seq_cold = []
    for c in cold_cfgs:
        t0 = time.time()
        m = load_model(spec, c, False)
        ex = TorchExplorer(m, host_seen=True, store_trace=False,
                           device=device)
        r = ex.run()
        w = time.time() - t0
        seq_wall += w
        seq_cold.append(r)
        log(f"   solo cold {os.path.basename(c)}: {w:.2f}s "
            f"({r.distinct} distinct)")
    seq_dis = sum(r.distinct for r in seq_cold)
    seq_rate = seq_dis / max(seq_wall, 1e-9)

    t0 = time.time()
    try:
        be = BatchCheckEngine([sess(c) for c in cold_cfgs]).build()
    except BatchIncompatible as ex:
        log(f"BATCH-CHECK FAIL: cold fixture family not batchable "
            f"({ex})")
        return 1
    members = be.run()
    bat_wall = time.time() - t0
    if not _parity_or_fail("cold", cold_cfgs, seq_cold, members, log):
        return 1
    disp = be.dispatcher
    bat_dis = sum(m.result.distinct for m in members)
    bat_rate = bat_dis / max(bat_wall, 1e-9)
    if disp.max_width < len(cold_cfgs):
        log(f"BATCH-CHECK FAIL: cold occupancy {disp.max_width} < "
            f"{len(cold_cfgs)} (cohort did not share one program)")
        return 1
    cold_ratio = bat_rate / max(seq_rate, 1e-9)
    log(f"   sequential cold: {seq_wall:.2f}s "
        f"({seq_rate:,.0f} states/sec aggregate)")
    log(f"   batched cold:    {bat_wall:.2f}s "
        f"({bat_rate:,.0f} states/sec; occupancy={disp.max_width}, "
        f"one engine build, lifted={','.join(be.lift_names)})")

    # ---- WARM DEEP RUNG: reported ----------------------------------
    log(f"== batchbench warm deep rung: {len(warm_cfgs)} members ==")
    wseq_wall = 0.0
    wseq = []
    for c in warm_cfgs:
        m = load_model(spec, c, False)
        ex = TorchExplorer(m, host_seen=True, store_trace=False,
                           device=device)
        ex.run()  # warm-up, untimed
        t0 = time.time()
        r = ex.run()
        wseq_wall += time.time() - t0
        wseq.append(r)
    try:
        wbe = BatchCheckEngine([sess(c) for c in warm_cfgs]).build()
    except BatchIncompatible as ex:
        log(f"BATCH-CHECK FAIL: warm fixture family not batchable "
            f"({ex})")
        return 1
    wbe.run()  # warm-up, untimed
    t0 = time.time()
    wmembers = wbe.run()
    wbat_wall = time.time() - t0
    if not _parity_or_fail("warm", warm_cfgs, wseq, wmembers, log):
        return 1
    warm_ratio = (sum(r.distinct for r in wseq) / max(wseq_wall, 1e-9))
    warm_ratio = (sum(m.result.distinct for m in wmembers)
                  / max(wbat_wall, 1e-9)) / max(warm_ratio, 1e-9)
    log(f"   warm sequential {wseq_wall:.2f}s vs batched "
        f"{wbat_wall:.2f}s -> {warm_ratio:.2f}x aggregate "
        f"states/sec")

    # ---- the gate ---------------------------------------------------
    gate_x = float(os.environ.get("JAXMC_BATCH_GATE_X", "2.0"))
    verdict = "PASS" if cold_ratio >= gate_x else "FAIL"
    log(f"BATCH-CHECK {verdict}: cold cohort batched/sequential = "
        f"{cold_ratio:.2f}x (gate {gate_x:.1f}x) | warm deep rung = "
        f"{warm_ratio:.2f}x (informational) | occupancy "
        f"{disp.max_width}/{len(cold_cfgs)} | parity bit-identical")
    return 0 if verdict == "PASS" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jaxmc_torch.batchbench",
        description="cross-model batching gate of the torch port")
    ap.add_argument("--spec", default=DEFAULT_SPEC)
    ap.add_argument("--cold-cfgs", nargs="*", default=COLD_CFGS)
    ap.add_argument("--warm-cfgs", nargs="*", default=WARM_CFGS)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the engines run (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run_leg(args.spec, list(args.cold_cfgs), list(args.warm_cfgs),
                   device=args.device)


if __name__ == "__main__":
    sys.exit(main())
