#!/usr/bin/env python3
"""Time this tree's K4 merge_sorted (and the whole rank_merge beside it)
and K2 keys_of (exact, fp128, canonical and view branches) against
another tree's (an earlier commit unpacked with `git archive`) on the
same inputs on one CUDA card, in turns: other, this, this, other.

    python3 kernel_turns.py OTHER_TREE [--out FILE.json]

The inputs are captured on the card from the level engine, each the
largest call of its search: the merge with the most valid candidate
keys and the keys_of call with the most valid rows, at transfer_scaled
("ts"), its 4-process model ("4p"), symtoy_scaled_4p ("sym": K2's
canonical branch) and viewtoy_scaled_big ("view": K2's view branch);
K2's fp128 branch runs on the ts and 4p rows.  K4 is called on the
sorted keys and their probe as rank_merge calls it.  OTHER_TREE's
kernels package is loaded under another name, so both trees' kernels
(each built from its own sources into its own kernels/_build/) run in
this process on the same tensors.  Each turn holds both trees' results
against the twins bit for bit, then times each call by CUDA events (the
best of three means of 20 calls after 3; at every site but ts one call
at a time after 256 MiB are written over L2), its device time by the
profiler (every kernel and memset of the call, the L2 write excluded)
and the host's time a call (enqueueing only).  K12 oracle_probe and its
library call (torch.searchsorted + index_copy_ + two sums) are timed in
the same turns.  After the turns, this tree's K2 runs at other
geometries (GEOMETRIES: warps a block, rows a warp's tile, listed rows a
pass), and both trees' K2 at the sym and view sites with the captured
validity and with it permuted (the valid rows scattered).  Prints each
build's ptxas lines for keys.cu and merge.cu, the card's name and power
limit and one JSON object."""

import argparse
import contextlib
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
FLUSHED = ("4p", "sym", "view")
L2_BYTES = 256 << 20


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


@contextlib.contextmanager
def keeping_calls(box):
    """While on, the engine's keys_of and rank_merge calls keep their
    inputs (clones) in `box`: the call with the most valid rows
    ("keys": args and keywords) and the merge with the most valid keys
    ("merge": seen, count, keys)."""
    from jaxmc_torch.kernels import ops
    keys_of, rank_merge = ops.keys_of, ops.rank_merge

    def keys2(rows, valid, pt, fp, identity, **kw):
        n = int(valid.sum())
        if n > box.get("keys_n", -1):
            box["keys_n"] = n
            box["keys"] = ((rows.clone(), valid.clone(), pt, fp, identity),
                           {k: v.clone() if isinstance(v, torch.Tensor)
                            else v for k, v in kw.items()})
        return keys_of(rows, valid, pt, fp, identity, **kw)

    def merge2(seen, count, keys):
        n = int((keys[:, 0] == 0).sum())
        if n > box.get("merge_n", -1):
            box["merge_n"] = n
            box["merge"] = (seen.clone(), int(count), keys.clone())
        return rank_merge(seen, count, keys)
    ops.keys_of, ops.rank_merge = keys2, merge2
    try:
        yield box
    finally:
        ops.keys_of, ops.rank_merge = keys_of, rank_merge


def capture(cs):
    """{site: {"keys": ..., "merge": ...}} from the level engine."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    runs = {"ts": ("transfer_scaled.tla", None, cs.PINS),
            "4p": ("transfer_scaled.tla", cs.CFG_4P, PINS_4P),
            "sym": ("symtoy_scaled.tla", cs.CFG_SYM, cs.PINS_SYM),
            "view": ("viewtoy_scaled.tla", cs.CFG_VIEW, cs.PINS_VIEW)}
    sites = {}
    for site, (spec, cfg, want) in runs.items():
        box = {}
        with keeping_calls(box):
            r = TorchExplorer(load_model(os.path.join(cs.SPECS, spec), cfg),
                              device=cs.DEVICE, store_trace=False,
                              progress_every=1e9).run()
        if (r.distinct, r.generated, r.diameter) != want:
            raise AssertionError(f"{site}: counts {r.distinct} / "
                                 f"{r.generated} / {r.diameter} != {want}")
        sites[site] = box
    return sites


def branch(kw):
    """K2's branch of a keys_of call's keywords: its counter's name and
    basis kind (0 the stored row, 1 a packed basis, 2 raw lanes)."""
    if kw.get("basis") is None:
        return "keys_of", 0
    return ("keys_of_canon", 1) if kw.get("basis_packed") else \
        ("keys_of_view", 2)


def calls(ops, sites):
    """{name@site: a function of no argument} for one tree's ops."""
    out = {}
    for site, box in sites.items():
        (rows, valid, pt, fp, ident), kw = box["keys"]
        name, kind = branch(kw)
        out[f"{name}@{site}"] = (
            lambda o=ops, a=(rows, valid, pt, fp, ident), kw=kw:
            o.keys_of(*a, **kw))
        if kind == 0:
            out[f"keys_of_fp128@{site}"] = (
                lambda o=ops, a=(rows, valid, pt, True, ident):
                o.keys_of(*a))
        seen, count, keys, skeys, sidx, found, lb = box["margs"]
        out[f"merge_sorted@{site}"] = (
            lambda o=ops, a=(seen, count, skeys, sidx, found, lb):
            o.merge_sorted(*a))
        out[f"rank_merge@{site}"] = (
            lambda o=ops, a=(seen, count, keys): o.rank_merge(*a))
    return out


def twins(ops, sites):
    """The twins' results for every name@site of calls()."""
    want = {}
    for site, box in sites.items():
        (rows, valid, pt, fp, ident), kw = box["keys"]
        name, kind = branch(kw)
        want[f"{name}@{site}"] = ops.keys_of_twin(rows, valid, pt, fp,
                                                  ident, **kw)
        if kind == 0:
            want[f"keys_of_fp128@{site}"] = ops.keys_of_twin(
                rows, valid, pt, True, ident)
        seen, count, keys, skeys, sidx, found, lb = box["margs"]
        m = ops.merge_sorted_twin(seen, count, skeys, sidx, found, lb)
        want[f"merge_sorted@{site}"] = want[f"rank_merge@{site}"] = m
    return want


def _same(x, y):
    if isinstance(x, dict):
        return all(_same(x[k], y[k]) for k in y)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return torch.equal(torch.as_tensor(x).to(torch.int64),
                       torch.as_tensor(y).to(torch.int64))


def host_ms(fn, reps=50):
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


def turn(cs, fns, want, k12, ops):
    """One tree's numbers at every site; raises if a result differs from
    its twin's."""
    out = {}
    for name, call in fns.items():
        got = call()
        torch.cuda.synchronize()
        if not _same(got, want[name]):
            raise AssertionError(f"{name} differs from its twin")
        flush = name.split("@")[1] in FLUSHED
        out[name] = dict(ms=events_ms(cs, call, flush=flush),
                         host_ms=host_ms(call),
                         device_ms=device_ms(call, flush))

    def k12call():
        return ops.oracle_probe(*k12)
    if not _same(k12call(), want["k12"]):
        raise AssertionError("oracle_probe differs from its twin")
    out["oracle_probe"] = dict(ms=events_ms(cs, k12call, flush=True),
                               host_ms=host_ms(k12call),
                               device_ms=device_ms(k12call, True))
    return out


# K2 geometries (warps a block, rows a warp's tile, listed rows a pass)
# timed after the turns
GEOMETRIES = ((8, 128, 32), (8, 128, 64), (4, 128, 64), (8, 160, 64),
              (8, 192, 64), (4, 256, 64), (8, 256, 64), (4, 256, 128),
              (8, 64, 32))


def geometries(cs, ops, fns, want):
    """This tree's K2 at every site under each of GEOMETRIES, bit for
    bit against the twins: events and device time a call."""
    keep = ops.keys_geometry
    out = {}
    try:
        for g in GEOMETRIES:
            def forced(W, PW, K, bw, kind, budget=None, fp=False, g=g):
                return g + (ops.keys_smem(W, PW, K, bw, kind, *g),)
            ops.keys_geometry = forced
            ops._KEYS_GEOM.clear()
            row = {}
            for name, call in fns.items():
                if not name.startswith("keys_of"):
                    continue
                got = call()
                torch.cuda.synchronize()
                if not _same(got, want[name]):
                    raise AssertionError(f"{name} differs from its twin at "
                                         f"geometry {g}")
                flush = name.split("@")[1] in FLUSHED
                row[name] = dict(ms=events_ms(cs, call, flush=flush),
                                 device_ms=device_ms(call, flush))
            key = "x".join(str(x) for x in g)
            out[key] = row
            print(json.dumps({"geometry": key, **row}), flush=True)
    finally:
        ops.keys_geometry = keep
        ops._KEYS_GEOM.clear()
    return out


def shuffled(cs, sites, trees):
    """Both trees' K2 at the sym and view sites as captured and with the
    validity permuted (seed 0): the runs of valid rows (their count) set
    how well one thread a row reads, so both are timed in turns (other,
    this, this, other), each result bit for bit against the twin."""
    from jaxmc_torch.kernels import ops
    out = {}
    for site in ("sym", "view"):
        (rows, valid, pt, fp, ident), kw = sites[site]["keys"]
        g = torch.Generator(device=valid.device).manual_seed(0)
        perm = torch.randperm(valid.numel(), generator=g,
                              device=valid.device)
        for how, v in (("captured", valid), ("permuted",
                                              valid[perm].contiguous())):
            runs = int((v[1:] != v[:-1]).sum()) // 2 + 1
            want = ops.keys_of_twin(rows, v, pt, fp, ident, **kw)
            row = dict(valid=int(v.sum()), runs=runs, turns=[])
            for who in ("other", "this", "this", "other"):
                o = trees[who][0]

                def call(o=o, v=v):
                    return o.keys_of(rows, v, pt, fp, ident, **kw)
                if not _same(call(), want):
                    raise AssertionError(f"keys_of differs from its twin at "
                                         f"{site}, {how}")
                row["turns"].append(dict(tree=who, ms=events_ms(
                    cs, call, flush=True), device_ms=device_ms(call, True)))
            out[f"{site}_{how}"] = row
            print(json.dumps({f"{site}_{how}": row}), flush=True)
    return out


def k12_library(k12):
    """torch.searchsorted + index_copy_ + two sums: K12's function."""
    sk, perm, keys = k12
    perm64 = perm.to(torch.int64)
    col, key = sk[:, 0].contiguous(), keys[:, 0].contiguous()

    def library():
        lo = torch.searchsorted(col, key).to(torch.int32)
        out = torch.zeros_like(sk).index_copy_(0, perm64, sk)
        return out, lo, out.sum(dtype=torch.int64) + lo.sum(
            dtype=torch.int64)
    return library


def shapes(sites, ops):
    """Each site's sizes and byte bounds (chip_smoke.py's counts)."""
    out = {}
    for site, box in sites.items():
        (rows, valid, pt, fp, ident), kw = box["keys"]
        N, W = rows.shape
        nv, PW = int(valid.sum()), pt["PW"]
        name, kind = branch(kw)
        bw = 0 if kind == 0 else kw["basis"].shape[1]
        for fpk in ((False, True) if kind == 0 else (fp,)):
            K = (4 if fpk else (bw if kind == 2 else PW)) + 1
            warps, RW, P, smem = ops.keys_geometry(
                W, PW, K, bw if kind == 2 else PW, kind, fp=fpk)
            if fpk and kind == 0:
                name = "keys_of_fp128"
            out[f"{name}@{site}"] = dict(
                N=N, valid=nv, W=W, PW=PW, K=K, basis_lanes=bw,
                warps=warps, tile_rows=RW, pass_rows=P, dynamic_smem=smem,
                bytes=N + nv * (W + bw) * 4 + N * (PW + K) * 4)
        seen, count, keys, skeys, sidx, found, lb = box["margs"]
        SC, K = seen.shape
        N = keys.shape[0]
        new = int(ops.merge_sorted_twin(seen, count, skeys, sidx, found,
                                        lb)["new_count"])
        items, tile, rows_b = ops.merge_geometry(K)
        out[f"merge_sorted@{site}"] = dict(
            N=N, seen_count=count, SC=SC, K=K, new=new, tile=tile,
            out_rows=rows_b,
            bytes=count * K * 4 + N * K * 4 + N + new * 8 + SC * K * 4
            + N * 4)
    return out


def ptxas(lines):
    return [ln for ln in lines if "Used" in ln or "spill" in ln
            or "Compiling" in ln]


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
    from jaxmc_torch.backend import oracle
    from jaxmc_torch.kernels import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    load_pkg(a.other, "kernels", "other_kernels")
    other = importlib.import_module("other_kernels.ops")
    obuild = importlib.import_module("other_kernels.build")
    t0 = time.time()
    sites = capture(cs)
    for box in sites.values():
        seen, count, keys = box["merge"]
        skeys, sidx = ops._sort_keys(keys)
        found, lb = ops.seen_probe(seen, count, skeys)
        box["margs"] = (seen, count, keys, skeys, sidx, found.clone(),
                        lb.clone())
    print(f"captured in {time.time() - t0:.1f}s", flush=True)
    want = twins(ops, sites)
    keys = oracle.probe_keys(cs.DEVICE)
    perm = ops.lsd_sort(keys)
    k12 = (keys[perm].contiguous(), perm.to(torch.int32), keys)
    want["k12"] = ops.oracle_probe_twin(*k12)
    torch.cuda.synchronize()
    lib = k12_library(k12)
    trees = {"this": (ops, calls(ops, sites)),
             "other": (other, calls(other, sites))}
    runs = []
    for who in ("other", "this", "this", "other"):
        o, fns = trees[who]
        runs.append(dict(tree=who, **turn(cs, fns, want, k12, o)))
        runs[-1]["library_ms"] = {"oracle_probe": events_ms(cs, lib,
                                                            flush=True)}
        print(json.dumps(runs[-1]), flush=True)
    variants = geometries(cs, ops, trees["this"][1], want)
    scattered = shuffled(cs, sites, trees)
    builds = {src: dict(this=ptxas(build.PTXAS.get(src, [])),
                        other=ptxas(obuild.PTXAS.get(src, [])))
              for src in ("keys", "merge")}
    res = dict(card=smi, other=os.path.abspath(a.other),
               shapes=shapes(sites, ops), builds=builds, runs=runs,
               variants=variants, scattered=scattered)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(res, fh, indent=1)
    for name, b in builds.items():
        for who in ("other", "this"):
            for ln in b[who]:
                print(f"[ptxas {name} {who}] {ln}")
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
