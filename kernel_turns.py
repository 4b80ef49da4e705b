#!/usr/bin/env python3
"""Time this tree's K15 gen_expand and K5 canon_rows against another
tree's (an earlier commit unpacked with `git archive`) on the same
inputs on one CUDA card, in turns: other, this, this, other.

    python3 kernel_turns.py OTHER_TREE [--out FILE.json]

The inputs are captured on the card from the port's engines, each the
largest call a search made: K15 at transfer_scaled ("ts"), the 4-process
model ("4p"), symtoy_scaled_4p ("sym"), msgstoy_scaled --por ("por")
and the msgstoy cohort of chip_smoke.py phase 18 ("cohort", per-row
constants); K5 at symtoy_scaled_4p's level with the most valid rows
("sym") and on 200,000 random rows of the symkinds layout ("kinds",
every container kind, a wide row).  OTHER_TREE's kernels package is
loaded under another name, so both trees' kernels (each built from its
own sources into its own kernels/_build/) run in this process on the
same tensors: K15's other source is this tree's unit functions with
OTHER_TREE's kernels part (compile/cgen.py _kernels).  Each turn holds
both trees' results against the twins bit for bit, then times each call
by CUDA events (the best of three means of 20 calls after 3; at every
site but ts one call at a time after 256 MiB are written over L2), its
device time by the profiler, and the host's time a call (enqueueing
only).  K12 oracle_probe and its library call (torch.searchsorted +
index_copy_ + two sums) are timed in the same turns.  After the turns,
this tree's K15 runs with other instance groupings (gen_groups with
GEN_BLOCKS 1: every instance in the tile's block; 2**30: one instance a
block, the grid walking instances fastest).  Prints each build's ptxas
lines (registers, spills, static shared memory) and its dynamic shared
memory, the card's name and power limit and one JSON object."""

import argparse
import copy
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
GEN_SITES = ("ts", "4p", "sym", "por", "cohort")
CANON_SITES = ("sym", "kinds")
FLUSHED = ("4p", "sym", "por", "cohort", "kinds")


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


def _run(cs, spec, cfg, want, **kw):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    box = {}
    with cs.keeping_largest(box):
        r = TorchExplorer(load_model(os.path.join(cs.SPECS, spec), cfg),
                          device=cs.DEVICE, store_trace=False,
                          progress_every=1e9, **kw).run()
    if (r.distinct, r.generated, r.diameter) != want:
        raise AssertionError(f"{spec} {cfg}: counts {r.distinct} / "
                             f"{r.generated} / {r.diameter} != {want}")
    return box


def capture(cs):
    """{kernel@site: inputs} from the port's engines on the card."""
    from jaxmc_torch.compile.kernel2 import build_layout2
    from jaxmc_torch.compile.symmetry2 import build_canon2
    from jaxmc_torch.compile.vspec import Bounds
    from jaxmc_torch.engine.simulate import sample_states
    from jaxmc_torch.session import load_model
    sites = {}
    ts = os.path.join(cs.SPECS, "transfer_scaled.cfg")
    sites["gen@ts"] = _run(cs, "transfer_scaled.tla", ts, cs.PINS)["gen"]
    sites["gen@4p"] = _run(cs, "transfer_scaled.tla", cs.CFG_4P,
                           PINS_4P)["gen"]
    box = _run(cs, "symtoy_scaled.tla", cs.CFG_SYM, cs.PINS_SYM)
    sites["gen@sym"], sites["canon@sym"] = box["gen"], box["canon"]
    sites["gen@por"] = _run(cs, "msgstoy.tla", cs.CFG_POR, cs.PINS_POR,
                            por=True)["gen"]
    box = {}
    with cs.keeping_largest(box):
        _be, members, *_ = cs._cohort(cs.CFG_BATCH, os.path.join(
            cs.SPECS, "msgstoy.tla"), False)
    if [m.result.distinct for m in members] != cs.PINS_BATCH:
        raise AssertionError("cohort counts differ from the pins")
    sites["gen@cohort"] = box["gen"]
    kinds = os.path.join(cs.FIXTURES, "symkinds")
    m = load_model(kinds + ".tla", kinds + ".cfg")
    lay = build_layout2(m, list(sample_states(m)), Bounds())
    g = torch.Generator(device=cs.DEVICE).manual_seed(0)
    r = torch.randint(-2, 14, (200000, lay.width), generator=g,
                      device=cs.DEVICE, dtype=torch.int32)
    r[torch.rand(r.shape, generator=g, device=cs.DEVICE) < 0.05] = 2**31 - 1
    v = torch.rand(r.shape[0], generator=g, device=cs.DEVICE) < 0.9
    sites["canon@kinds"] = dict(rows=r, valid=v, canon=build_canon2(m, lay))
    return sites


def other_modules(gms, other):
    """OTHER_TREE's copies of the generated modules `gms`: this tree's
    unit functions with OTHER_TREE's kernels part, built by OTHER_TREE's
    build.py (its own launcher signatures and build directory)."""
    from jaxmc_torch.compile import cgen
    ocgen = importlib.import_module(other["compile"].__name__ + ".cgen")
    out = {}
    for site, gm in gms.items():
        mine = cgen._kernels(gm.meta, gm.W, gm.L)
        if not gm.source.endswith(mine):
            raise AssertionError("generated source does not end with its "
                                 "kernels part")
        src = gm.source[:-len(mine)] + ocgen._kernels(gm.meta, gm.W, gm.L)
        og = copy.copy(gm)
        og.source = src
        og.lib = other["build"].build_generated(src)
        og.info = other["build"].GEN_INFO[other["build"].gen_digest(src)]
        out[site] = og
    return out


def _same(x, y):
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return torch.equal(x.to(torch.int64), y.to(torch.int64))


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


def timed(cs, call, key, flush):
    return dict(ms=events_ms(cs, call, flush=flush), host_ms=host_ms(call),
                device_ms=cs.device_ms(call, key, flush=flush))


def turn(cs, ops, gms, sites, want, k12):
    """One tree's numbers on every site; raises if a result differs from
    its twin's."""
    out = {}
    for site in GEN_SITES:
        s, gm = sites["gen@" + site], gms[site]

        def call(s=s, gm=gm):
            return ops.gen_expand(gm, s["rows"], s["units"], s["cv"])
        got = call()
        torch.cuda.synchronize()
        if not _same(got, want["gen@" + site]):
            raise AssertionError(f"gen_expand differs from its twin at "
                                 f"{site}")
        out["gen_expand@" + site] = timed(cs, call, "jmc_gen_expand_k",
                                          site in FLUSHED)
    for site in CANON_SITES:
        s = sites["canon@" + site]

        def call(s=s):
            return ops.canon_rows(s["rows"], s["valid"], s["canon"])
        got = call()
        torch.cuda.synchronize()
        if not _same(got, want["canon@" + site]):
            raise AssertionError(f"canon_rows differs from its twin at "
                                 f"{site}")
        out["canon_rows@" + site] = timed(cs, call, "canon_kernel",
                                          site in FLUSHED)

    def k12call():
        return ops.oracle_probe(*k12)
    if not _same(k12call(), want["k12"]):
        raise AssertionError("oracle_probe differs from its twin")
    out["oracle_probe"] = timed(cs, k12call, "oracle_probe", True)
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


def ptxas(lines, keys):
    return [ln for ln in lines if any(k in ln for k in keys)
            or "Used" in ln or "spill" in ln]


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
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.kernels import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    other = dict(kernels=load_pkg(a.other, "kernels", "other_kernels"),
                 compile=load_pkg(a.other, "compile", "other_compile"))
    other["ops"] = importlib.import_module("other_kernels.ops")
    other["build"] = importlib.import_module("other_kernels.build")
    t0 = time.time()
    sites = capture(cs)
    print(f"captured in {time.time() - t0:.1f}s", flush=True)
    gms = {site: sites["gen@" + site]["gm"] for site in GEN_SITES}
    trees = {"this": (ops, gms),
             "other": (other["ops"], other_modules(gms, other))}
    want = {}
    for site in GEN_SITES:
        s = sites["gen@" + site]
        want["gen@" + site] = ops.gen_expand_twin(s["gm"], s["rows"],
                                                  s["units"], s["cv"])
    for site in CANON_SITES:
        s = sites["canon@" + site]
        want["canon@" + site] = ops.canon_rows_twin(s["rows"], s["valid"],
                                                    s["canon"])
    keys = oracle.probe_keys(cs.DEVICE)
    perm = ops.lsd_sort(keys)
    k12 = (keys[perm].contiguous(), perm.to(torch.int32), keys)
    want["k12"] = ops.oracle_probe_twin(*k12)
    torch.cuda.synchronize()
    lib = k12_library(k12)
    runs = []
    for who in ("other", "this", "this", "other"):
        o, g = trees[who]
        runs.append(dict(tree=who, **turn(cs, o, g, sites, want, k12)))
        runs[-1]["library_ms"] = {"oracle_probe": events_ms(cs, lib,
                                                            flush=True)}
        print(json.dumps(runs[-1]), flush=True)
    # this tree's K15 under other instance groupings
    variants = {}
    keep = ops.GEN_BLOCKS
    try:
        for blocks in (1, keep, 1 << 30):
            ops.GEN_BLOCKS = blocks
            row = {}
            for site in GEN_SITES:
                s, gm = sites["gen@" + site], gms[site]

                def call(s=s, gm=gm):
                    return ops.gen_expand(gm, s["rows"], s["units"], s["cv"])
                if not _same(call(), want["gen@" + site]):
                    raise AssertionError(f"gen_expand differs from its twin "
                                         f"at {site}, GEN_BLOCKS {blocks}")
                A, N = s["units"].shape[0], s["rows"].shape[0]
                T = gm.meta["tile"]
                row[site] = dict(G=ops.gen_groups(A, -(-N // T)),
                                 ms=events_ms(cs, call,
                                              flush=site in FLUSHED),
                                 device_ms=cs.device_ms(
                                     call, "jmc_gen_expand_k",
                                     flush=site in FLUSHED))
            variants[str(blocks)] = row
            print(json.dumps({"GEN_BLOCKS": blocks, **row}), flush=True)
    finally:
        ops.GEN_BLOCKS = keep
    shapes, builds = {}, {}
    for site in GEN_SITES:
        s, gm = sites["gen@" + site], gms[site]
        A, N, W = s["units"].shape[0], s["rows"].shape[0], gm.W
        T = gm.meta["tile"]
        shapes["gen_expand@" + site] = dict(
            N=N, A=A, W=W, T=T, G=ops.gen_groups(A, -(-N // T)),
            per_row_constants=s["cv"] is not None and s["cv"].shape[0] > 1,
            dynamic_smem=cgen.tile_bytes(W, T),
            bytes=N * W * 4 + A * N * (2 + 4 + W * 4))
        builds["gen_expand@" + site] = dict(
            this=ptxas(gm.info.get("ptxas", []), ("expand",)),
            other=ptxas(trees["other"][1][site].info.get("ptxas", []),
                        ("expand",)))
    for site in CANON_SITES:
        s = sites["canon@" + site]
        N, W = s["rows"].shape
        prog = s["canon"].program
        T, staged, smem = ops.canon_geometry(prog)
        shapes["canon_rows@" + site] = dict(
            N=N, valid=int(s["valid"].sum()), W=W,
            perms=s["canon"].n_perms, program_words=len(prog), T=T,
            program_staged=staged, dynamic_smem=smem,
            bytes=N + 2 * N * W * 4)
    builds["canon_rows"] = dict(this=build.PTXAS.get("canon", []),
                                other=other["build"].PTXAS.get("canon", []))
    res = dict(card=smi, other=os.path.abspath(a.other), shapes=shapes,
               builds=builds, runs=runs, variants=variants)
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
