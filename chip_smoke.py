#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the four
hand-written kernels, holds each against its plain PyTorch twin at the
shapes the level engine gives it, times both, and checks models end to
end through the port's entry points.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure raises; the exit code is then not 0):
  1 device     card name, count, `nvidia-smi` name and power limit
  2 build      nvcc each kernel for sm_90a; print its ptxas line
  3 kernels    capture the widest level's inputs of transfer_scaled on
               the card; each kernel against its twin, bit-exact; times
  4 main path  transfer_scaled (153,701 distinct / 311,153 generated /
               diameter 9) with every launch counter reset just before
               and read just after: each kernel must have run
  5 fp128      the same with seen_mode="fingerprint" (K2's hash path)
  6 verdicts   batchtoy_bad and pcal_intro_buggy on the card equal the
               port's CPU run: verdict, counts and trace
  7 real size  transfer_scaled with 4 processes and MaxMoney 12
               (jaxmc_torch/fixtures/transfer_scaled_4p.cfg): kernels
               against the twins on the card, counts equal; then each
               kernel against its twin again, and timed, at this
               model's widest level (rows named "...@4p")
The last three lines are the `nvidia-smi` name and power limit, the
kernel table as JSON and {"ok": true, "device": {...}}.

Each kernel's bound is its compulsory traffic over the card's memory
rate, or its integer operations over the INT32 rate, whichever is
larger: each input the function needs read once, each output written
once, counted from this run's data (K2 reads only the valid rows, K3
and K4 only the live prefix of the seen table).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SPECS = os.path.join(ROOT, "specs")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
# non-tensor INT32 peak: 64 INT32 lanes per SM and clock, half the
# 128 fp32 lanes that give the data sheet's 67 TFLOP/s fp32
INT_OPS_PER_S = 33.5e12

PINS = (153701, 311153, 9)     # jaxmc/corpus.py transfer_scaled pins
DEVICE = "cuda"
CFG_4P = os.path.join(ROOT, "jaxmc_torch", "fixtures",
                      "transfer_scaled_4p.cfg")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false "
                         "- this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {name} x{count}; nvidia-smi: {smi}")
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name, count, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from jaxmc_torch.kernels import build
    t0 = time.time()
    lines = build.load_all()
    log(f"[2 build] {len(lines)} libraries in {time.time() - t0:.1f}s "
        f"({build.build_dir()})")
    for src, ls in lines.items():
        for ln in ls:
            log(f"[2 build] {src}.cu: {ln}")


# ---------------------------------------------------------------------------
# phase 3: kernels against twins at the main path's shapes
# ---------------------------------------------------------------------------

def _engine(cfg, **kw):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    model = load_model(os.path.join(SPECS, "transfer_scaled.tla"), cfg)
    return TorchExplorer(model, device=DEVICE, **kw)


def capture_busiest_level(cfg, want):
    """Run the search and keep the inputs each kernel saw at the level
    that gives it the most work; the counts must equal `want`."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    got = {}

    class Capture(TorchExplorer):
        # the frontier of the widest level, and the candidate block and
        # merge of the level with the most valid candidates
        def _unpack(self, packed):
            if packed.shape[0] > got.get("unpack_n", -1):
                got["unpack_n"] = packed.shape[0]
                got["unpack"] = packed.clone()
            return super()._unpack(packed)

        def _keys_of(self, rows, valid):
            n = int(valid.sum())
            if n > got.get("keys_n", -1):
                got["keys_n"] = n
                got["keys"] = (rows.clone(), valid.clone())
            return super()._keys_of(rows, valid)

        def _rank_merge(self, seen, seen_count, keys):
            n = int((keys[:, 0] == 0).sum())
            if n > got.get("merge_n", -1):
                got["merge_n"] = n
                got["merge"] = (seen.clone(), seen_count, keys.clone())
            return super()._rank_merge(seen, seen_count, keys)

    model = load_model(os.path.join(SPECS, "transfer_scaled.tla"), cfg)
    eng = Capture(model, device=DEVICE, store_trace=False,
                  progress_every=1e9)
    r = eng.run()
    if (r.distinct, r.generated, r.diameter) != want:
        raise AssertionError(f"capture run counts {r.distinct}/"
                             f"{r.generated}/{r.diameter} != {want}")
    return eng, got


def cuda_time(fn, reps=20, warm=3):
    """Mean ms per call over `reps` calls, CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _max_abs(x, y):
    if isinstance(x, (tuple, list)):
        return max(_max_abs(a, b) for a, b in zip(x, y))
    if isinstance(x, dict):
        return max(_max_abs(x[k], y[k]) for k in x)
    if not isinstance(x, torch.Tensor):
        return abs(int(x) - int(y))
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    if x.shape != y.shape:
        raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def _bound(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels(eng, got, tag="3 kernels", suffix=""):
    """Each kernel against its twin on the captured inputs, bit-exact,
    and timed; one table row per kernel (named with `suffix`)."""
    from jaxmc_torch.kernels import ops
    pt, W, PW = eng.pt, eng.W, eng.PW
    rows_out = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms=None, note=""):
        bms, by = _bound(nbytes, nops)
        name += suffix
        rows_out.append(dict(name=name, route="cuda", source=src,
                             replaces=replaces, launches=0,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by,
                             library_ms=library_ms))
        log(f"[{tag}] {name}: max_abs_err {err}, kernel {ms:.4f} ms, "
            f"twin {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
            + (f", library {library_ms:.4f} ms" if library_ms is not None
               else "") + note)
        if err != 0:
            raise AssertionError(f"{name} differs from its twin")

    # K1 unpack_rows
    packed = got["unpack"]
    N = packed.shape[0]
    k = ops.unpack_rows(packed, pt)
    t = ops.unpack_rows_twin(packed, pt)
    torch.cuda.synchronize()
    record("unpack_rows", "jaxmc_torch/kernels/csrc/unpack.cu",
           "jaxmc/compile/pack.py:421", _max_abs(k, t),
           cuda_time(lambda: ops.unpack_rows(packed, pt)),
           cuda_time(lambda: ops.unpack_rows_twin(packed, pt), reps=5),
           N * PW * 4 + N * W * 4, N * W * 4,
           note=f" [N={N} PW={PW} W={W}]")

    # K2 keys_of, exact and fp128
    rows, valid = got["keys"]
    N = rows.shape[0]
    nv = int(valid.sum())
    for fp in (False, True):
        K = (4 if fp else PW) + 1
        k = ops.keys_of(rows, valid, pt, fp, False)
        t = ops.keys_of_twin(rows, valid, pt, fp, False)
        torch.cuda.synchronize()
        err = _max_abs(list(k), list(t))
        record("keys_of" + ("_fp128" if fp else ""),
               "jaxmc_torch/kernels/csrc/keys.cu",
               "jaxmc/compile/pack.py:441" if not fp
               else "jaxmc/backend/bfs.py:126",
               err,
               cuda_time(lambda: ops.keys_of(rows, valid, pt, fp, False)),
               cuda_time(lambda: ops.keys_of_twin(rows, valid, pt, fp,
                                                  False), reps=3),
               # validity of every row, the lanes of the valid rows;
               # keys and packed words of every row
               N + nv * W * 4 + N * (PW + K) * 4,
               nv * W * 6 + (nv * 4 * (PW * 3 + 5) if fp else 0),
               note=f" [N={N} valid={nv} K={K}]")

    # K3 seen_probe (on the sorted candidate keys, as rank_merge calls it)
    seen, seen_count, keys = got["merge"]
    N, K = keys.shape
    SC = seen.shape[0]
    skeys = keys[ops.lsd_sort(keys)].contiguous()
    k = ops.seen_probe(seen, seen_count, skeys)
    t = ops.seen_probe_twin(seen, seen_count, skeys)
    torch.cuda.synchronize()
    lib_ms = None
    if K == 3:
        # yardstick: torch.searchsorted over the two data words folded
        # into one monotone int64 (the fold is not timed)
        def fold(x):
            return x[:, 1].to(torch.int64) * (1 << 32) + \
                (x[:, 2].to(torch.int64) + (1 << 31))
        sf = fold(seen[:seen_count]).contiguous()
        qf = fold(skeys).contiguous()
        lb_lib = torch.searchsorted(sf, qf)
        if _max_abs(lb_lib, k[1]) != 0:
            raise AssertionError("searchsorted yardstick disagrees")
        lib_ms = cuda_time(lambda: torch.searchsorted(sf, qf))
    probes = max(1, math.ceil(math.log2(max(seen_count, 1) + 1)))
    record("seen_probe", "jaxmc_torch/kernels/csrc/probe.cu",
           "jaxmc/backend/bfs.py:142", _max_abs(list(k), list(t)),
           cuda_time(lambda: ops.seen_probe(seen, seen_count, skeys)),
           cuda_time(lambda: ops.seen_probe_twin(seen, seen_count, skeys),
                     reps=3),
           # the K-1 data words of the live seen rows and of the
           # queries; found and lb written
           (seen_count + N) * (K - 1) * 4 + N * 5,
           N * probes * (K - 1) * 2, library_ms=lib_ms,
           note=f" [N={N} seen_count={seen_count} SC={SC} K={K}]")

    # K4 merge_sorted on the sorted keys and their probe; the whole
    # rank_merge (LSD sort + K3 + K4) is timed beside it for reference
    sidx = ops.lsd_sort(keys).to(torch.int32)
    found, lb = ops.seen_probe(seen, seen_count, skeys)
    names = ("new_count", "nk_sidx", "seen2", "seen_count2")
    k = ops.merge_sorted(seen, seen_count, skeys, sidx, found, lb)
    t = ops.merge_sorted_twin(seen, seen_count, skeys, sidx, found, lb)
    whole = ops.rank_merge(seen, seen_count, keys)
    torch.cuda.synchronize()
    err = max(_max_abs({n: k[n] for n in names}, {n: t[n] for n in names}),
              _max_abs({n: whole[n] for n in names},
                       {n: t[n] for n in names}))
    whole_ms = cuda_time(lambda: ops.rank_merge(seen, seen_count, keys))
    new = int(k["new_count"])
    record("rank_merge", "jaxmc_torch/kernels/csrc/merge.cu",
           "jaxmc/backend/bfs.py:285", err,
           cuda_time(lambda: ops.merge_sorted(seen, seen_count, skeys,
                                              sidx, found, lb)),
           cuda_time(lambda: ops.merge_sorted_twin(seen, seen_count, skeys,
                                                   sidx, found, lb),
                     reps=3),
           # the live seen rows and every sorted key (the duplicate
           # check) read, found of every key, sidx and lb of the new
           # ones; the SC-row table and nk_sidx written
           seen_count * K * 4 + N * K * 4 + N + new * 8 + SC * K * 4
           + N * 4,
           N * (K + 6),
           note=f" [N={N} seen_count={seen_count} SC={SC} K={K} "
                f"new={new}; 3 launches + 2 cumsums; "
                f"whole rank_merge (sort + K3 + K4) {whole_ms:.4f} ms]")
    return rows_out


# ---------------------------------------------------------------------------
# phases 4-7: models end to end
# ---------------------------------------------------------------------------

def run_counted(make):
    """Build the engine, zero every launch counter, run the search,
    read the counters."""
    from jaxmc_torch.kernels import ops
    eng = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    r = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ops.LAUNCHES)
    return eng, r, wall, counts, torch.cuda.max_memory_allocated()


def phase_main(tag, seen_mode):
    cfg = os.path.join(SPECS, "transfer_scaled.cfg")
    eng, r, wall, counts, peak = run_counted(
        lambda: _engine(cfg, seen_mode=seen_mode))
    got = (r.distinct, r.generated, r.diameter)
    log(f"[{tag}] transfer_scaled seen={r.seen_mode}: distinct "
        f"{r.distinct} generated {r.generated} diameter {r.diameter}; "
        f"wall {wall:.3f}s, {r.generated / wall:.0f} generated states/s; "
        f"peak {peak / 2**20:.1f} MiB; launches {counts}")
    if not r.ok or got != PINS:
        raise AssertionError(f"transfer_scaled {got} != {PINS}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return counts


def _summary(r):
    from jaxmc_torch.engine.explore import format_trace
    v = r.violation
    return (r.ok, r.generated, r.distinct, r.diameter,
            v and v.kind, v and v.name, v and format_trace(v))


def phase_verdicts():
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    cases = [("batchtoy_bad", "batchtoy.tla", "batchtoy_bad.cfg",
              ("invariant", 6, 6, 6)),
             ("pcal_intro_buggy", "pcal_intro_buggy.tla", None,
              ("assert", 9040, 6135, 6))]
    for tag, spec, cfg, want in cases:
        cfgp = os.path.join(SPECS, cfg) if cfg else None
        res = {}
        for dev in (DEVICE, "cpu"):
            m = load_model(os.path.join(SPECS, spec), cfgp)
            res[dev] = TorchExplorer(m, device=dev).run()
        a, b = _summary(res[DEVICE]), _summary(res["cpu"])
        r = res[DEVICE]
        log(f"[6 verdicts] {tag}: {r.violation.kind} {r.violation.name}, "
            f"generated {r.generated} distinct {r.distinct}, trace "
            f"{len(r.violation.trace)} states; cuda == cpu: {a == b}")
        if a != b:
            raise AssertionError(f"{tag}: cuda run differs from cpu run")
        if (r.violation.kind, r.generated, r.distinct,
                len(r.violation.trace)) != want:
            raise AssertionError(f"{tag}: {r.violation.kind} "
                                 f"{r.generated}/{r.distinct} != {want}")


def phase_real_size():
    """The 4-process model on the kernels and on the twins; returns
    the counts and the kernel run's launch counts."""
    cfg = CFG_4P
    out = {}
    for kind, twins in (("kernels", False), ("twins", True)):
        eng, r, wall, counts, peak = run_counted(
            lambda: _engine(cfg, store_trace=False, twins=twins,
                            progress_every=1e9))
        if kind == "kernels":
            from jaxmc_torch import obs
            widest = max(lv["frontier"] for lv in obs.current().levels)
            FC = 256
            while FC < widest:
                FC *= 2
            log(f"[7 real size] layout W={eng.W} PW={eng.PW} K={eng.K} "
                f"A={eng.A}; widest frontier {widest} -> FC {FC}, "
                f"candidate block C = A*FC = {eng.A * FC} rows of "
                f"{eng.W} lanes ({eng.A * FC * eng.W * 4 / 2**30:.2f} GiB)")
        log(f"[7 real size] {kind}: ok={r.ok} distinct {r.distinct} "
            f"generated {r.generated} diameter {r.diameter}; wall "
            f"{wall:.3f}s, {r.generated / wall:.0f} generated states/s; "
            f"peak {peak / 2**30:.2f} GiB; launches {counts}")
        if not r.ok:
            raise AssertionError("real-size run found a violation")
        out[kind] = (r.distinct, r.generated, r.diameter)
        if kind == "kernels":
            launches = counts
        if kind == "twins" and any(counts.values()):
            raise AssertionError("twin run launched kernels")
    if out["kernels"] != out["twins"]:
        raise AssertionError(f"kernels {out['kernels']} != twins "
                             f"{out['twins']}")
    log(f"[7 real size] kernel path == twin path: {out['kernels']}")
    return out["kernels"], launches


def main() -> int:
    t_start = time.time()
    name, count, smi = phase_device()
    phase_build()
    from jaxmc_torch import obs
    eng, got = capture_busiest_level(os.path.join(SPECS,
                                                 "transfer_scaled.cfg"), PINS)
    table = phase_kernels(eng, got)
    del eng, got
    counts = phase_main("4 main path", "auto")
    counts_fp = phase_main("5 fp128", "fingerprint")
    for row in table:
        base = row["name"].replace("_fp128", "")
        row["launches"] = (counts_fp if row["name"].endswith("_fp128")
                           else counts)[base]
    phase_verdicts()
    obs.reset()
    counts_4p, launches_4p = phase_real_size()
    eng, got = capture_busiest_level(CFG_4P, counts_4p)
    rows_4p = phase_kernels(eng, got, "7 kernels", "@4p")
    del eng, got
    for row in rows_4p:
        base = row["name"].replace("@4p", "").replace("_fp128", "")
        row["launches"] = launches_4p[base]
    # the 4-process run keys exactly, so K2's fp128 branch has no
    # launches there: its row is timed, not counted
    table += [r for r in rows_4p if "_fp128" not in r["name"]]
    log(f"[done] {time.time() - t_start:.1f}s")
    print(f"{smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
