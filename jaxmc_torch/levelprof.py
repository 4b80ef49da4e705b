"""Where a level-engine or host-seen run spends its time on the card.

    python -m jaxmc_torch.levelprof SPEC [--cfg F] [--seen MODE] [--por]
        [--host-seen | --resident] [--chunk N] [--top N]

Builds TorchExplorer on the CUDA card and runs the search three times:
  1. to warm the kernel build and the allocator;
  2. under torch.profiler: the device's busy time is the union of the
     intervals of every kernel, copy and memset it ran, the idle share
     is 1 - busy/wall, and the top kernels are ranked by device time;
  3. with a synchronise after each stage of the level step — unpack
     (K1), expand (the emitter), keys (K2, and the VIEW's emitter),
     canon (K5, under SYMMETRY), por (K3 + K6, with --por), merge
     (sort + K3 + K4), predicates (CONSTRAINTs and invariants) — and
     around the whole
     step, so each stage's wall (host dispatch plus its device work),
     the rest of the step and the loop around it add up to the run's.
     With --host-seen the stages are those of a chunk — unpack (K1),
     expand, keys (K2), predicates (over every candidate), k7 (the
     epilogue), d2h (the scalar and compacted-row reads), store
     (native store insert and contains), fallback (the interpreter's
     arms) — and the step is one chunk (unpack to k7).  With
     --resident the stages are those of a level — unpack (K1), expand,
     k8 (the chunk and explore compactions), keys (K2), canon (K5),
     por (K3 + K6), k9 (the chunk fold), merge (sort + K3 + K4),
     predicates, read (the one summary read) — and the step is one
     level (its chunks and its end, without the read).
Each measured run starts from a cleared initial-state memo, so it
encodes, dedups and checks the initial states as a first run does.
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

STAGES = ("level.unpack", "level.expand", "level.keys", "level.canon",
          "level.por", "level.merge", "level.predicates")
STEP = "level.step"
HS_STAGES = ("hs.unpack", "hs.expand", "hs.keys", "hs.canon",
             "hs.predicates", "hs.k7", "hs.d2h", "hs.store", "hs.fallback")
HS_STEP = "hs.step"
RES_STAGES = ("res.unpack", "res.expand", "res.k8", "res.keys", "res.canon",
              "res.por", "res.k9", "res.merge", "res.predicates", "res.read")
RES_STEP = "res.level"
RANGES = STAGES + (STEP,) + HS_STAGES + (HS_STEP,) + RES_STAGES + \
    (RES_STEP,)


def _device_events(prof):
    """Kernels, copies and memsets (not the device-side spans of the
    stage ranges)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.key not in RANGES]


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
    """A TorchExplorer whose level (or, with host_seen=True, chunk)
    stages are timed on the host with a synchronise after each
    (timed=True), or only named as profiler ranges.  Returns (engine,
    {stage: seconds})."""
    from torch.profiler import record_function
    from . import native_store
    from .backend.bfs import TorchExplorer
    hs = bool(kw.get("host_seen"))
    P = "hs." if hs else ("res." if kw.get("resident") else "level.")
    acc = {k: 0.0 for k in RANGES}
    # the fallback arms unpack, evaluate and key rows themselves: that
    # time stays theirs, not the step stages'
    outer = []

    def stage(name, f, *a):
        with record_function(name):
            if not timed or outer:
                return f(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "hs.fallback":
                outer.append(name)
            try:
                out = f(*a)
            finally:
                if outer:
                    outer.pop()
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out

    class Staged(TorchExplorer):
        def level_step(self, seen, seen_count, frontier_p, fcount):
            return stage(STEP, super().level_step, seen, seen_count,
                         frontier_p, fcount)

        def _hstep(self, frontier_p, fcount):
            return stage(HS_STEP, super()._hstep, frontier_p, fcount)

        def _res_level(self, *a):
            return stage(RES_STEP, super()._res_level, *a)

        def _compact(self, *a, **kw):
            return stage("res.k8", lambda: super(Staged, self)._compact(
                *a, **kw))

        def _fold(self, *a):
            return stage("res.k9", super()._fold, *a)

        def _res_por(self, *a):
            return stage("res.por", super()._res_por, *a)

        def _res_read(self, summary):
            return stage("res.read", super()._res_read, summary)

        def _unpack(self, packed):
            return stage(P + "unpack", super()._unpack, packed)

        def _expand(self, frontier):
            return stage(P + "expand", super()._expand, frontier)

        def _keys_of(self, rows, valid):
            return stage(P + "keys", super()._keys_of, rows, valid)

        def _canon(self, rows, valid):
            return stage(P + "canon", super()._canon, rows, valid)

        def _epilogue(self, *a):
            return stage("hs.k7", super()._epilogue, *a)

        def _d2h(self, tensors, n=None):
            return stage("hs.d2h", super()._d2h, tensors, n)

        def _fb_expand_level(self, *a):
            return stage("hs.fallback", super()._fb_expand_level, *a)

        def _run_host_seen(self):
            # the store is made inside the search: time its calls there
            base = native_store.FingerprintStore

            class TimedStore(base):
                def insert(self, fps):
                    return stage("hs.store", super().insert, fps)

                def contains(self, fps):
                    return stage("hs.store", super().contains, fps)

            native_store.FingerprintStore = TimedStore
            try:
                return super()._run_host_seen()
            finally:
                native_store.FingerprintStore = base

        def _por_filter(self, seen, seen_count, ckeys, cvalid, FC):
            return stage("level.por", super()._por_filter, seen,
                         seen_count, ckeys, cvalid, FC)

        def _rank_merge(self, seen, seen_count, keys):
            return stage(P + "merge", super()._rank_merge, seen,
                         seen_count, keys)

    eng = Staged(model, **kw)

    def staged(f):
        return lambda rows: stage(P + "predicates", f, rows)

    eng.constraint_fns = [(n, staged(f)) for n, f in eng.constraint_fns]
    eng.inv_fns = [(n, staged(f)) for n, f in eng.inv_fns]
    return eng, acc


def profile_run(spec, cfg=None, seen_mode="auto", top=12, por=False,
                host_seen=False, chunk=2048, resident=False):
    from torch.profiler import ProfilerActivity, profile
    from .session import load_model
    if not torch.cuda.is_available():
        raise RuntimeError("levelprof measures the CUDA card and none is "
                           "available")
    kw = dict(store_trace=False, seen_mode=seen_mode, progress_every=1e9,
              por=por)
    if host_seen:
        kw.update(host_seen=True, chunk=chunk)
    if resident:
        kw.update(resident=True, chunk=chunk)
    stages, step = ((HS_STAGES, HS_STEP) if host_seen else
                    (RES_STAGES, RES_STEP) if resident else (STAGES, STEP))
    eng, _ = staged_engine(load_model(spec, cfg), False, **kw)
    eng.run()                                   # warm: build, allocator
    torch.cuda.synchronize()
    eng._init_prep = None                       # measure the init too
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
    eng3._init_prep = None
    for k in acc:
        acc[k] = 0.0
    t0 = time.time()
    r3 = eng3.run()
    torch.cuda.synchronize()
    wall3 = time.time() - t0
    if (r3.distinct, r3.generated) != (r.distinct, r.generated):
        raise AssertionError("staged run's counts differ")
    # the keys stage calls the canon stage inside it: keep them apart
    p = "hs." if host_seen else ("res." if resident else "level.")
    acc[p + "keys"] -= acc[p + "canon"]
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
        "stage_s": {k: acc[k] for k in stages},
        # the rest of the step (level: new-row gathers, the provenance
        # sort, the verdict scalars; host-seen: the masks, the SENTINEL
        # fill) and the host loop around the steps
        "step_rest_s": acc[step] - sum(
            acc[k] for k in stages if k not in (
                "hs.d2h", "hs.store", "hs.fallback", "res.read")),
        "loop_rest_s": wall3 - acc[step] - (sum(
            acc[k] for k in ("hs.d2h", "hs.store", "hs.fallback"))
            if host_seen else acc["res.read"]),
        "card": smi,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jaxmc_torch.levelprof")
    p.add_argument("spec")
    p.add_argument("--cfg", default=None)
    p.add_argument("--seen", default="auto",
                   choices=("auto", "exact", "fingerprint"))
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--por", action="store_true")
    p.add_argument("--host-seen", action="store_true")
    p.add_argument("--resident", action="store_true")
    p.add_argument("--chunk", type=int, default=2048)
    a = p.parse_args(argv)
    out = profile_run(a.spec, a.cfg, a.seen, a.top, a.por, a.host_seen,
                      a.chunk, a.resident)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
