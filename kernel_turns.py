#!/usr/bin/env python3
"""Time this tree's K3 seen_probe and K7 hstep_epilogue against another
tree's (an earlier commit unpacked with `git archive`) on the same
inputs on one CUDA card, in turns: other, this, this, other.

    python3 kernel_turns.py OTHER_TREE [--out FILE.json]

The inputs are captured on the card with chip_smoke.py's engines: K3 at
transfer_scaled's busiest level and the 4-process model's widest level
(the sorted keys rank_merge probes there) and at msgstoy_scaled's
--por site with the most valid candidates; K7 at the chunk with the
most valid candidates of the 4-process model under --host-seen --chunk
65536.  OTHER_TREE's kernels package is loaded under another name, so
both trees' kernels (each built from its own sources into its own
kernels/_build/) run in this process on the same tensors.  Each turn
holds both trees' results against the twins bit for bit, then times:
each kernel by CUDA events (the best of three means of 20 calls after
3; at the 4-process level also one call at a time after L2 is written
over), its
device time by the profiler, the host's time a call (enqueueing only),
the whole rank_merge (LSD sort + K3 + K4)
at the two rank sites, and the library call for the same function
(torch.searchsorted on the data words folded into one int64;
torch.nonzero + two index_select).  Prints the card's name and power
limit and one JSON object."""

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


def load_ops(tree, alias):
    """`tree`'s jaxmc_torch/kernels/ops.py, imported as <alias>.ops (its
    build.py and csrc/ are that tree's)."""
    pkg = os.path.join(os.path.abspath(tree), "jaxmc_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".ops")


def capture(cs):
    """{site: inputs} from the port's engines on the card."""
    from jaxmc_torch.kernels import ops
    sites = {}
    for name, cfg, want in (("ts", os.path.join(cs.SPECS,
                                                "transfer_scaled.cfg"),
                             cs.PINS), ("4p", cs.CFG_4P, PINS_4P)):
        _eng, got = cs.capture_busiest_level(cfg, want)
        seen, count, keys = got["merge"]
        skeys = keys[ops.lsd_sort(keys)].contiguous()
        sites[name] = dict(seen=seen, count=int(count), keys=keys,
                           skeys=skeys)
        del _eng, got
    eng, got = cs.capturing_engine("msgstoy.tla", cs.CFG_POR, por=True)
    r = eng.run()
    if (r.distinct, r.generated, r.diameter) != cs.PINS_POR:
        raise AssertionError(f"msgstoy_scaled counts {r.distinct}")
    seen, count, ckeys, _cvalid, _fc = got["por"]
    sites["por"] = dict(seen=seen, count=int(count), skeys=ckeys)
    del eng, got
    cap = {}
    r = cs.host_seen_engine("transfer_scaled.tla", cs.CFG_4P, cap).run()
    if (r.distinct, r.generated, r.diameter) != PINS_4P:
        raise AssertionError(f"host-seen counts {r.distinct}")
    sites["k7"] = cap["args"]
    return sites


def _same(x, y):
    if isinstance(x, dict):
        return all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return all(_same(a, b) for a, b in zip(x, y))
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


def turn(cs, ops, sites, want):
    """One tree's numbers on every site; raises if a result differs from
    its twin's."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    out = {}
    for name in ("ts", "4p", "por"):
        s = sites[name]
        site = "por" if name == "por" else ""
        args = (s["seen"], s["count"], s["skeys"])

        def call(args=args, site=site):
            return ops.seen_probe(*args, site=site)
        got = call()
        torch.cuda.synchronize()
        if not _same(got, want[name]):
            raise AssertionError(f"seen_probe differs from its twin at "
                                 f"{name}")
        row = dict(ms=events_ms(cs, call), host_ms=host_ms(call),
                   device_ms=cs.device_ms(call, "seen_probe"))
        if name == "4p":
            row["ms_flushed"] = events_ms(cs, call, flush=True)
            row["device_ms_flushed"] = cs.device_ms(call, "seen_probe",
                                                    flush=True)
        if name != "por":
            row["rank_merge_ms"] = cs.cuda_time(
                lambda s=s: ops.rank_merge(s["seen"], s["count"], s["keys"]),
                reps=5)
        out["seen_probe@" + name] = row
    a = list(sites["k7"])
    a.insert(7, OV_PACK)

    def k7():
        return ops.hstep_epilogue(*a)
    got = k7()
    torch.cuda.synchronize()
    nv = int(want["k7"]["scalars"][0])
    for k, v in want["k7"].items():
        g = got[k] if k in ("scalars", "dead") else got[k][:nv]
        w = v if k in ("scalars", "dead") else v[:nv]
        if not _same(g, w):
            raise AssertionError(f"hstep_epilogue {k} differs from its twin")
    out["hstep_epilogue@4p"] = dict(
        ms=events_ms(cs, k7), host_ms=host_ms(k7),
        device_ms=cs.device_ms(k7, "hstep_"))
    return out


def library(cs, sites):
    """The PyTorch calls for the same functions, unused by the port."""
    from jaxmc_torch.kernels import ops
    out = {}
    for name in ("ts", "4p", "por"):
        s = sites[name]
        sf = cs._fold(s["seen"][:s["count"]])
        qf = cs._fold(s["skeys"])
        if sf is not None:
            lb = torch.searchsorted(sf, qf)
            valid = s["skeys"][:, 0] == 0
            want = ops.seen_probe_twin(s["seen"], s["count"], s["skeys"])[1]
            if not torch.equal(lb[valid].to(torch.int32), want[valid]):
                raise AssertionError(f"searchsorted disagrees at {name}")
            out["seen_probe@" + name] = events_ms(
                cs, lambda sf=sf, qf=qf: torch.searchsorted(sf, qf))
    en, _aok, _ov, fcount, keys, cand = sites["k7"][:6]
    fv = torch.arange(en.shape[1], device=en.device) < fcount

    def k7lib():
        idx = torch.nonzero((en & fv[None, :]).reshape(-1)).flatten()
        return keys.index_select(0, idx), cand.index_select(0, idx)
    out["hstep_epilogue@4p"] = events_ms(cs, k7lib)
    return out


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
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"other": load_ops(a.other, "other_kernels"), "this": ops}
    sites = capture(cs)
    want = {n: ops.seen_probe_twin(s["seen"], s["count"], s["skeys"])
            for n, s in sites.items() if n != "k7"}
    k7a = list(sites["k7"])
    k7a.insert(7, OV_PACK)
    want["k7"] = ops.hstep_epilogue_twin(*k7a)
    torch.cuda.synchronize()
    runs = []
    for who in ("other", "this", "this", "other"):
        runs.append(dict(tree=who, **turn(cs, trees[who], sites, want)))
        lib = library(cs, sites)
        runs[-1]["library_ms"] = lib
        print(json.dumps(runs[-1]), flush=True)
    shapes = {n: dict(N=int(s["skeys"].shape[0]), K=int(s["skeys"].shape[1]),
                      count=s["count"], SC=int(s["seen"].shape[0]))
              for n, s in sites.items() if n != "k7"}
    en = sites["k7"][0]
    fv = torch.arange(en.shape[1], device=en.device) < sites["k7"][3]
    shapes["k7"] = dict(A=int(en.shape[0]), CH=int(en.shape[1]),
                        fcount=int(sites["k7"][3]),
                        valid=int((en & fv[None, :]).sum()),
                        PW=int(sites["k7"][5].shape[1]))
    res = dict(card=smi, other=os.path.abspath(a.other), shapes=shapes,
               runs=runs)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
