#!/usr/bin/env python3
"""Time this tree's K18 sort_keys and its front_order site (and the
whole rank_merge beside them) against another tree's sorts (an earlier
commit unpacked with `git archive`, whose port sorted with chains of
torch.sort) on the same inputs on one CUDA card, in turns: other, this,
this, other.

    python3 kernel_turns.py OTHER_TREE [--out FILE.json]

The inputs are captured on the card from the level engine, each the
largest call of its search: the merge with the most valid candidate
keys at transfer_scaled ("ts"), its 4-process model ("4p"),
symtoy_scaled_4p ("sym"), viewtoy_scaled_big ("view") and the
4-process model's resident engine at chunk 65,536 ("res"); the fp128
keys of the ts and 4p candidate blocks (K2's hash of the keys_of call
with the most valid rows); the next-frontier order of the widest level
at ts and 4p.  The other tree's sort is its kernels package's
sort_keys, or before K18 its _sort_keys (the lsd_sort chain of
torch.sort and one gather); its
frontier order is torch.sort of the int64 key, the code its level step
ran (this tree's ops.front_order_twin); rank_merge is each tree's own.
OTHER_TREE's kernels package is loaded under another name, so both
trees' kernels (each built from its own sources into its own
kernels/_build/) run in this process on the same tensors.  Each turn
holds both trees' results against the twins bit for bit, then times
each call by CUDA events (the best of three means of 20 calls after 3
at ts, of 5 for rank_merge; at every other site of 5 calls, each after
256 MiB are written over L2), its device time by the profiler (every kernel and memset of the call, the
L2 write excluded) and the host's time a call (enqueueing only).  After
the turns: this tree's K18 calls launch by launch (device time), each
tree's memory a call above the live tensors at 4p, and
the 4-process level run's peak memory (torch.cuda.max_memory_allocated
over its second run) of each tree in a child process.  Prints sort.cu's
ptxas lines, the card's name and power limit and one JSON object."""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PINS_4P = (9394019, 24035597, 12)
FLUSHED = ("4p", "sym", "view", "res")
L2_BYTES = 256 << 20
# a child that runs the 4-process level engine twice and prints its
# counts and the second run's peak memory
PEAK_SRC = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "from jaxmc_torch.backend.bfs import TorchExplorer; "
            "from jaxmc_torch.session import load_model; "
            "e = TorchExplorer(load_model(sys.argv[2], sys.argv[3]), "
            "store_trace=False, progress_every=1e9); e.run(); "
            "torch.cuda.synchronize(); torch.cuda.reset_peak_memory_stats(); "
            "r = e.run(); print(r.distinct, r.generated, r.diameter, "
            "torch.cuda.max_memory_allocated())")


def load_pkg(tree, sub, alias):
    """`tree`'s jaxmc_torch/<sub> package, imported as <alias>."""
    pkg = os.path.join(os.path.abspath(tree), "jaxmc_torch", sub)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def capture(cs):
    """{site: {"merge": (seen, count, keys), "keys": (rows, valid, pt,
    identity), "front": (explore, prov, A, FC)}} from the level
    engine."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    runs = {"ts": ("transfer_scaled.tla", None, cs.PINS, {}),
            "4p": ("transfer_scaled.tla", cs.CFG_4P, PINS_4P, {}),
            "sym": ("symtoy_scaled.tla", cs.CFG_SYM, cs.PINS_SYM, {}),
            "view": ("viewtoy_scaled.tla", cs.CFG_VIEW, cs.PINS_VIEW, {}),
            "res": ("transfer_scaled.tla", cs.CFG_4P, PINS_4P,
                    dict(resident=True, chunk=cs.CHUNK_RES))}
    sites = {}
    for site, (spec, cfg, want, kw) in runs.items():
        box = {}

        class Capture(TorchExplorer):
            def _keys_of(self, rows, valid):
                n = int(valid.sum())
                if n > box.get("keys_n", -1):
                    box["keys_n"] = n
                    box["keys"] = (rows.clone(), valid.clone(), self.pt,
                                   self.plan.identity)
                return super()._keys_of(rows, valid)

            def _rank_merge(self, seen, count, keys):
                n = int((keys[:, 0] == 0).sum())
                if n > box.get("merge_n", -1):
                    box["merge_n"] = n
                    box["merge"] = (seen.clone(), int(count), keys.clone())
                return super()._rank_merge(seen, count, keys)

            def _front_order(self, explore, prov, FC):
                n = (explore.numel(), int(explore.sum()))
                if n > box.get("front_n", (-1, -1)):
                    box["front_n"] = n
                    box["front"] = (explore.clone(), prov.clone(), self.A,
                                    FC)
                return super()._front_order(explore, prov, FC)
        r = Capture(load_model(os.path.join(cs.SPECS, spec), cfg),
                    device=cs.DEVICE, store_trace=False, progress_every=1e9,
                    **kw).run()
        if (r.distinct, r.generated, r.diameter) != want:
            raise AssertionError(f"{site}: counts {r.distinct} / "
                                 f"{r.generated} / {r.diameter} != {want}")
        sites[site] = box
    return sites


def calls(sites, ops, other):
    """{name@site: {"this": f, "other": f, "want": the twins' result}}."""
    other_sort = getattr(other, "sort_keys", None) or other._sort_keys
    out = {}
    for site, box in sites.items():
        seen, count, keys = box["merge"]
        out[f"sort_keys@{site}"] = dict(
            this=lambda k=keys: ops.sort_keys(k),
            other=lambda k=keys: other_sort(k),
            want=ops.sort_keys_twin(keys))
        out[f"rank_merge@{site}"] = dict(
            this=lambda a=(seen, count, keys): ops.rank_merge(*a),
            other=lambda a=(seen, count, keys): other.rank_merge(*a),
            want=ops.rank_merge_twin(seen, count, keys))
        if site in ("ts", "4p"):
            rows, valid, pt, ident = box["keys"]
            kf = ops.keys_of(rows, valid, pt, True, ident)[0].clone()
            out[f"sort_keys_fp128@{site}"] = dict(
                this=lambda k=kf: ops.sort_keys(k),
                other=lambda k=kf: other_sort(k),
                want=ops.sort_keys_twin(kf))
            a = box["front"]
            out[f"front_order@{site}"] = dict(
                this=lambda a=a: ops.front_order(*a),
                other=lambda a=a: ops.front_order_twin(*a),
                want=ops.front_order_twin(*a))
    return out


def _same(x, y):
    if isinstance(x, dict):
        return all(_same(x[k], y[k]) for k in y)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return torch.equal(torch.as_tensor(x).to(torch.int64),
                       torch.as_tensor(y).to(torch.int64))


def host_ms(fn, reps=20):
    """The host's time a call, enqueueing only (no synchronize inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def events_ms(cs, fn, **kw):
    """The best of three means by CUDA events (chip_smoke.cuda_time): a
    stall of the host in one run does not stand for the kernel."""
    return min(cs.cuda_time(fn, **kw) for _ in range(3))


def device_ms(fn, flush, reps=10):
    """The device time of a call: every kernel and memset it ran, from
    the profiler; with `flush`, L2_BYTES are written (a fill, not
    counted) before each call."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(L2_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush:
                buf.fill_(1)
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"
           and "FillFunctor" not in e.key]
    return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3


def turn(cs, fns, who):
    """One tree's numbers at every site; raises if a result differs from
    its twin's."""
    out = {}
    for name, c in fns.items():
        call = c[who]
        if not _same(call(), c["want"]):
            raise AssertionError(f"{name} ({who}) differs from its twin")
        torch.cuda.synchronize()
        flush = name.split("@")[1] in FLUSHED
        reps = 5 if name.startswith("rank") or flush else 20
        out[name] = dict(ms=events_ms(cs, call, flush=flush, reps=reps),
                         host_ms=host_ms(call),
                         device_ms=device_ms(call, flush))
    return out


def tail_rows(keys):
    """The rows equal to the last row: K18's tail key."""
    return (keys == keys[-1]).all(dim=1)


def kept_positions(keys):
    """The digit positions K18's plan keeps: those whose byte varies over
    the rows that are not the tail key."""
    rest = keys[~tail_rows(keys)].to(torch.int64) & 0xFFFFFFFF
    return sum(int(((rest[:, c] >> (8 * b)) & 0xFF).unique().numel() > 1)
               for c in range(keys.shape[1]) for b in range(4))


def shapes(sites):
    """Each site's sizes and byte bounds (chip_smoke.py's counts)."""
    out = {}
    for site, box in sites.items():
        keys = box["merge"][2]
        N, K = keys.shape
        tail = int(tail_rows(keys).sum())
        out[f"sort_keys@{site}"] = dict(N=N, K=K, tail=tail,
                                        kept=kept_positions(keys),
                                        bytes=N * (2 * K + 1) * 4)
        if site in ("ts", "4p"):
            out[f"sort_keys_fp128@{site}"] = dict(N=N, K=5,
                                                  bytes=N * 11 * 4)
            explore, prov, A, FC = box["front"]
            C = explore.numel()
            out[f"front_order@{site}"] = dict(
                C=C, A=A, FC=FC, explored=int(explore.sum()),
                b=(C - 1).bit_length(), bytes=C * 13)
    return out


def launch_times(fn, reps=5):
    """This tree's K18 call launch by launch: each kernel's mean device
    time in ms, in launch order (the profiler's events of `reps` calls,
    L2 written over before each)."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(L2_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            buf.fill_(1)
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA"
                  and "sort_" in e.key), key=lambda e: e.time_range.start)
    per = len(evs) // reps
    names = [e.key.split("sort_", 1)[1].split("_kernel")[0]
             for e in evs[:per]]
    return [[names[i], sum(evs[c * per + i].time_range.elapsed_us()
                           for c in range(reps)) / reps / 1e3]
            for i in range(per)]


def engine_peak(tree, cs):
    """(distinct, generated, diameter, peak bytes) of the 4-process level
    run on `tree`'s port, in a child process."""
    p = subprocess.run([sys.executable, "-c", PEAK_SRC,
                        os.path.abspath(tree),
                        os.path.join(cs.SPECS, "transfer_scaled.tla"),
                        cs.CFG_4P], capture_output=True, text=True,
                       timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"peak run on {tree}: {p.stderr[-2000:]}")
    return [int(x) for x in p.stdout.split()[-4:]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other tree (its root directory)")
    ap.add_argument("--out", help="also write the JSON object here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaxmc_torch.kernels import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    load_pkg(a.other, "kernels", "other_kernels")
    other = importlib.import_module("other_kernels.ops")
    t0 = time.time()
    sites = capture(cs)
    shp = shapes(sites)
    print(json.dumps({"shapes": shp}), flush=True)
    fns = calls(sites, ops, other)
    torch.cuda.synchronize()
    print(f"captured in {time.time() - t0:.1f}s", flush=True)
    runs = []
    for who in ("other", "this", "this", "other"):
        runs.append(dict(tree=who, **turn(cs, fns, who)))
        print(json.dumps(runs[-1]), flush=True)
    launches = {name: launch_times(fns[name]["this"]) for name in fns
                if not name.startswith("rank")}
    print(json.dumps({"launch_times": launches}), flush=True)
    memory = {f"{name}@4p": {who: cs._peak_of(fns[f"{name}@4p"][who])
                             for who in ("other", "this")}
              for name in ("sort_keys", "rank_merge", "front_order")}
    print(json.dumps({"memory_a_call": memory}), flush=True)
    del fns, sites
    torch.cuda.empty_cache()
    peaks = {who: engine_peak(tree, cs)
             for who, tree in (("other", a.other), ("this", ROOT))}
    print(json.dumps({"level_4p_peak": peaks}), flush=True)
    build.library("sort")
    ptx = [ln for ln in build.PTXAS.get("sort", [])
           if "Used" in ln or "spill" in ln or "Compiling" in ln]
    res = dict(card=smi, other=os.path.abspath(a.other), shapes=shp,
               runs=runs, launch_times=launches,
               memory_a_call=memory, level_4p_peak=peaks, ptxas=ptx)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(res, fh, indent=1)
    for ln in ptx:
        print(f"[ptxas sort] {ln}")
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
