"""Where a level-engine run spends its time on the card.

    python -m jaxmc_torch.levelprof SPEC [--cfg F] [--seen MODE] [--top N]

Builds TorchExplorer on the CUDA card and runs the search three times:
  1. to warm the kernel build and the allocator;
  2. under torch.profiler: the device's busy time is the union of the
     intervals of every kernel, copy and memset it ran, the idle share
     is 1 - busy/wall, and the top kernels are ranked by device time;
  3. with a synchronise after each stage of the level step — unpack
     (K1), expand (the emitter), keys (K2), merge (sort + K3 + K4),
     predicates (CONSTRAINTs and invariants) — and around the whole
     step, so each stage's wall (host dispatch plus its device work),
     the rest of the step and the loop around it add up to the run's.
Prints one JSON line with all of it and the card's name and power
limit.  Runs 2 and 3 add overhead to the wall; the unperturbed wall is
chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

STAGES = ("level.unpack", "level.expand", "level.keys", "level.merge",
          "level.predicates")
STEP = "level.step"


def _device_events(prof):
    """Kernels, copies and memsets (not the device-side spans of the
    stage ranges)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.key not in STAGES and e.key != STEP]


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def staged_engine(model, timed: bool, **kw):
    """A TorchExplorer whose level stages are timed on the host with a
    synchronise after each (timed=True), or only named as profiler
    ranges.  Returns (engine, {stage: seconds})."""
    from torch.profiler import record_function
    from .backend.bfs import TorchExplorer
    acc = {k: 0.0 for k in STAGES + (STEP,)}

    def stage(name, f, *a):
        with record_function(name):
            if not timed:
                return f(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out

    class Staged(TorchExplorer):
        def level_step(self, seen, seen_count, frontier_p, fcount):
            return stage(STEP, super().level_step, seen, seen_count,
                         frontier_p, fcount)

        def _unpack(self, packed):
            return stage("level.unpack", super()._unpack, packed)

        def _expand(self, frontier):
            return stage("level.expand", super()._expand, frontier)

        def _keys_of(self, rows, valid):
            return stage("level.keys", super()._keys_of, rows, valid)

        def _rank_merge(self, seen, seen_count, keys):
            return stage("level.merge", super()._rank_merge, seen,
                         seen_count, keys)

    eng = Staged(model, **kw)

    def staged(f):
        return lambda rows: stage("level.predicates", f, rows)

    eng.constraint_fns = [(n, staged(f)) for n, f in eng.constraint_fns]
    eng.inv_fns = [(n, staged(f)) for n, f in eng.inv_fns]
    return eng, acc


def profile_run(spec, cfg=None, seen_mode="auto", top=12):
    from torch.profiler import ProfilerActivity, profile
    from .session import load_model
    if not torch.cuda.is_available():
        raise RuntimeError("levelprof measures the CUDA card and none is "
                           "available")
    kw = dict(store_trace=False, seen_mode=seen_mode, progress_every=1e9)
    eng, _ = staged_engine(load_model(spec, cfg), False, **kw)
    eng.run()                                   # warm: build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        r = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = _device_events(prof)
    busy_us = _busy_us(dev)
    by_name = {}
    for e in dev:
        n, c = by_name.get(e.key, (0.0, 0))
        by_name[e.key] = (n + e.time_range.elapsed_us(), c + 1)
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]

    eng3, acc = staged_engine(load_model(spec, cfg), True, **kw)
    eng3.run()                                  # same build, warm
    torch.cuda.synchronize()
    for k in acc:
        acc[k] = 0.0
    t0 = time.time()
    r3 = eng3.run()
    torch.cuda.synchronize()
    wall3 = time.time() - t0
    if (r3.distinct, r3.generated) != (r.distinct, r.generated):
        raise AssertionError("staged run's counts differ")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {
        "spec": spec, "cfg": cfg, "seen_mode": r.seen_mode,
        "distinct": r.distinct, "generated": r.generated,
        "diameter": r.diameter,
        "profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "top_device": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                       for k, (us, c) in top_dev],
        "staged_wall_s": wall3,
        "stage_s": {k: acc[k] for k in STAGES},
        # the rest of the level step (new-row gathers, the provenance
        # sort, the verdict scalars) and the host loop around the steps
        "step_rest_s": acc[STEP] - sum(acc[k] for k in STAGES),
        "loop_rest_s": wall3 - acc[STEP],
        "card": smi,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jaxmc_torch.levelprof")
    p.add_argument("spec")
    p.add_argument("--cfg", default=None)
    p.add_argument("--seen", default="auto",
                   choices=("auto", "exact", "fingerprint"))
    p.add_argument("--top", type=int, default=12)
    a = p.parse_args(argv)
    out = profile_run(a.spec, a.cfg, a.seen, a.top)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
