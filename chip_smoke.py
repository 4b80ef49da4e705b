#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the seven
hand-written kernels and the native fingerprint store, holds each
kernel against its plain PyTorch twin at the shapes the engines give
it, times both, and checks models end to end through the port's entry
points: the level engine and the chunked host-seen engine.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure raises; the exit code is then not 0):
  1 device     card name, count, `nvidia-smi` name and power limit
  2 build      nvcc each kernel for sm_90a; print its ptxas line; g++
               the native host fingerprint store
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
  8 symmetry   symtoy_scaled with 4 processes, MaxTurns 60 (fixtures/
               symtoy_scaled_4p.cfg, 23 permutations) on kernels and
               twins, counts equal to the reference's; K5 canon_rows and
               K2's canonical branch against their twins and timed at the
               widest level; K5 on random rows of the symkinds layout
               (every container kind of the canonicaliser)
  9 view       viewtoy_scaled at N 512 (fixtures/viewtoy_scaled_big.cfg)
               on kernels and twins, counts equal to the formula's pins;
               K2's view branch against its twin and timed
 10 por        msgstoy with 4 processes, T 10 (fixtures/msgstoy_
               scaled.cfg) with --por on kernels and twins: counts and
               por.* counters equal to the reference's; K6 por_mask and
               the POR site of K3 against their twins and timed at the
               widest level; portoy (deadlock) and portoy_bad
               (invariant) with --por on the card equal to the CPU run
 11 host seen  transfer_scaled_4p with --host-seen at chunk 65,536 on
               kernels and twins: the pins of phase 7, K1, K2 and K7
               launched and neither K3 nor K4; wall, generated states/s,
               peak device memory, the host store's size; then K7
               against its twin, and timed, at the chunk with the most
               valid candidates (row "hstep_epilogue@4p")
 12 hs por     msgstoy_scaled with --por --host-seen at chunk 65,536 on
               kernels and twins: counts and por.* counters equal to the
               reference's host_seen run at that chunk
 13 hybrid     interparm_toy (a demoted arm), fixtures/guarddem (guard
               demotion after three relayouts, then a restart),
               fixtures/deepvar (adaptive relayout) and
               fixtures/allinterp (every arm interpreted) under
               --host-seen on the card equal to the CPU run: verdict,
               counts, trace and every log line
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
# the kernels a search without SYMMETRY, VIEW or --por launches
MAIN_KERNELS = ("unpack_rows", "keys_of", "seen_probe", "rank_merge")
DEVICE = "cuda"
FIXTURES = os.path.join(ROOT, "jaxmc_torch", "fixtures")
CFG_4P = os.path.join(FIXTURES, "transfer_scaled_4p.cfg")
# (distinct, generated, diameter) of the JAX reference on the CPU
# (`python -m jaxmc check SPEC --cfg CFG --backend cpu [--por]`, see
# PERF.md section 4); the VIEW counts also follow distinct = N*N*M/Q
# and generated = (2K+1)*distinct + 1
CFG_SYM = os.path.join(FIXTURES, "symtoy_scaled_4p.cfg")
PINS_SYM = (3018036, 21214789, 64)
CFG_VIEW = os.path.join(FIXTURES, "viewtoy_scaled_big.cfg")
PINS_VIEW = (4194304, 54525953, 172)
CFG_POR = os.path.join(FIXTURES, "msgstoy_scaled.cfg")
PINS_POR = (1048589, 7864334, 43)
POR_PINS = {"por.ample_states": 1048584, "por.full_states": 4,
            "por.device_masked_arms": 1048683}
# the host-seen phases' chunk; --chunk keeps its default of 2048
CHUNK_HS = 65536
# msgstoy_scaled --por under host_seen at CHUNK_HS (the reference's
# `python -m jaxmc check specs/msgstoy.tla --cfg CFG_POR --backend jax
# --platform cpu --host-seen --chunk 65536 --por --no-trace`): the
# ample probe reads the store chunk by chunk, so these differ from the
# level engine's
PINS_HS_POR = (3014742, 22038124, 43)
POR_PINS_HS = {"por.ample_states": 1807106, "por.full_states": 1207635,
               "por.device_masked_arms": 1642412}
# the kernels a host-seen search launches, and those it must not
HS_KERNELS = ("unpack_rows", "keys_of", "hstep_epilogue")
HS_ABSENT = ("seen_probe", "seen_probe_por", "rank_merge", "por_mask")


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
    from jaxmc_torch import native_store
    from jaxmc_torch.kernels import build
    t0 = time.time()
    lines = build.load_all()
    log(f"[2 build] {len(lines)} libraries in {time.time() - t0:.1f}s "
        f"({build.build_dir()})")
    for src, ls in lines.items():
        for ln in ls:
            log(f"[2 build] {src}.cu: {ln}")
    t0 = time.time()
    if not native_store.is_available():
        raise AssertionError(f"native store: {native_store.build_error()}")
    log(f"[2 build] native store {os.path.relpath(native_store._SO, ROOT)} "
        f"in {time.time() - t0:.1f}s")


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


def _row(tag, name, src, replaces, launches, err, ms, plain_ms, nbytes,
         nops, library_ms=None, note=""):
    bms, by = _bound(nbytes, nops)
    log(f"[{tag}] {name}: max_abs_err {err}, kernel {ms:.4f} ms, twin "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
        + (f", library {library_ms:.4f} ms" if library_ms is not None
           else "") + note)
    if err != 0:
        raise AssertionError(f"{name} differs from its twin")
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


def phase_kernels(eng, got, tag="3 kernels", suffix=""):
    """Each kernel against its twin on the captured inputs, bit-exact,
    and timed; one table row per kernel (named with `suffix`)."""
    from jaxmc_torch.kernels import ops
    pt, W, PW = eng.pt, eng.W, eng.PW
    rows_out = []

    def record(name, src, replaces, *args, **kw):
        # launches are filled in from the search's counts by main()
        rows_out.append(_row(tag, name + suffix, src, replaces, 0, *args,
                             **kw))

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
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
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


# ---------------------------------------------------------------------------
# phases 8-10: SYMMETRY, VIEW and --por
# ---------------------------------------------------------------------------

def capturing_engine(spec, cfg, **kw):
    """A TorchExplorer that keeps, for each of K5, K2 and K3+K6, the
    inputs of the level that gave it the most valid rows (clones only:
    no kernel launches and no counts of their own)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    got = {}

    def keep(name, n, *xs):
        if n > got.get(name + "_n", -1):
            got[name + "_n"] = n
            got[name] = tuple(x.clone() if isinstance(x, torch.Tensor)
                              else x for x in xs)

    class Capture(TorchExplorer):
        def _canon(self, rows, valid):
            keep("canon", int(valid.sum()), rows, valid)
            return super()._canon(rows, valid)

        def _keys_of(self, rows, valid):
            keep("keys", int(valid.sum()), rows, valid)
            return super()._keys_of(rows, valid)

        def _por_filter(self, seen, seen_count, ckeys, cvalid, FC):
            keep("por", int(cvalid.sum()), seen, seen_count, ckeys, cvalid,
                 FC)
            return super()._por_filter(seen, seen_count, ckeys, cvalid, FC)

    eng = Capture(load_model(os.path.join(SPECS, spec), cfg), device=DEVICE,
                  **kw)
    return eng, got


def phase_reduction(tag, spec, cfg, pins, need, **kw):
    """The model on the kernels (capturing the widest level's inputs)
    and on the twins: counts equal to `pins` on both, every kernel in
    `need` launched on the kernel run, none on the twin run.  Returns
    (engine, captured inputs, launch counts, por counters)."""
    from jaxmc_torch import obs
    from jaxmc_torch.kernels import ops
    out = {}
    for kind, twins in (("kernels", False), ("twins", True)):
        obs.reset()
        holder = {}

        def make(holder=holder, twins=twins):
            holder["eng"], holder["got"] = capturing_engine(
                spec, cfg, store_trace=False, progress_every=1e9,
                twins=twins, **kw)
            return holder["eng"]
        eng, r, wall, counts, peak = run_counted(make)
        tel = obs.current()
        por = {k: v for k, v in list(tel.counters.items())
               + list(tel.gauges.items()) if k.startswith("por.")}
        got3 = (r.distinct, r.generated, r.diameter)
        widest = max(lv["frontier"] for lv in tel.levels)
        log(f"[{tag}] {kind}: ok={r.ok} distinct {r.distinct} generated "
            f"{r.generated} diameter {r.diameter}; wall {wall:.3f}s, "
            f"{r.generated / wall:.0f} generated states/s; peak "
            f"{peak / 2**30:.2f} GiB; widest frontier {widest}; layout "
            f"W={eng.W} PW={eng.PW} K={eng.K} A={eng.A}; launches "
            f"{counts}" + (f"; {por}" if por else ""))
        if not r.ok or r.warnings:
            raise AssertionError(f"{tag}: {kind} run ok={r.ok}, warnings "
                                 f"{r.warnings}")
        if got3 != pins:
            raise AssertionError(f"{tag}: {kind} counts {got3} != {pins}")
        if twins and any(counts.values()):
            raise AssertionError(f"{tag}: twin run launched kernels")
        if not twins:
            missing = [k for k in need if counts[k] <= 0]
            if missing:
                raise AssertionError(f"{tag}: kernels not launched: "
                                     f"{missing}")
            out["kernels"] = (eng, holder["got"], counts, por)
        else:
            out["twins_por"] = por
    if out["kernels"][3] != out["twins_por"]:
        raise AssertionError(f"{tag}: por counters differ between "
                             f"kernels and twins")
    return out["kernels"]


def check_canon(eng, got, counts, tag="8 symmetry"):
    """K5 and K2's canonical branch against their twins at the level
    with the most valid rows; K5 again over the symkinds layout."""
    from jaxmc_torch.kernels import ops
    canon, pt, W, PW, K = eng.canon, eng.pt, eng.W, eng.PW, eng.K
    rows, valid = got["canon"]
    N, nv = rows.shape[0], int(valid.sum())
    k = ops.canon_rows(rows, valid, canon)
    t = ops.canon_rows_twin(rows, valid, canon)
    torch.cuda.synchronize()
    prog = canon.program
    o = [int(x) for x in prog[3:11]]
    # per valid row and permutation: the lane copy, each alternative and
    # condition of the program, the compare
    per_row = 2 * W * canon.n_perms + (o[3] - o[2]) // 4 + \
        (o[4] - o[3]) // 3
    out = [_row(tag, "canon_rows", "jaxmc_torch/kernels/csrc/canon.cu",
                "jaxmc/compile/symmetry2.py:272", counts["canon_rows"],
                _max_abs(k, t),
                cuda_time(lambda: ops.canon_rows(rows, valid, canon)),
                cuda_time(lambda: ops.canon_rows_twin(rows, valid, canon),
                          reps=3),
                # every row read and written, one validity byte each
                N + 2 * N * W * 4, nv * per_row,
                note=f" [N={N} valid={nv} W={W} perms={canon.n_perms} "
                     f"program {len(prog)} words]")]
    rows, valid = got["keys"]
    N, nv = rows.shape[0], int(valid.sum())
    crows = ops.canon_rows(rows, valid, canon)
    args = (rows, valid, pt, eng.fp_mode, eng.plan.identity)
    kw = dict(basis=crows, basis_packed=True)
    k = ops.keys_of(*args, **kw)
    t = ops.keys_of_twin(*args, **kw)
    torch.cuda.synchronize()
    out.append(_row(
        tag, "keys_of_canon", "jaxmc_torch/kernels/csrc/keys.cu",
        "jaxmc/backend/bfs.py:1621", counts["keys_of_canon"],
        _max_abs(list(k), list(t)),
        cuda_time(lambda: ops.keys_of(*args, **kw)),
        cuda_time(lambda: ops.keys_of_twin(*args, **kw), reps=3),
        # validity, the valid raw and canonical rows; keys and packed
        # rows of every row
        N + 2 * nv * W * 4 + N * (PW + K) * 4, 2 * nv * W * 6,
        note=f" [N={N} valid={nv} K={K}]"))
    # every container kind: random rows of the symkinds layout
    from jaxmc_torch.compile.kernel2 import build_layout2
    from jaxmc_torch.compile.symmetry2 import build_canon2
    from jaxmc_torch.compile.vspec import Bounds
    from jaxmc_torch.engine.simulate import sample_states
    from jaxmc_torch.session import load_model
    kinds = os.path.join(FIXTURES, "symkinds")
    m = load_model(kinds + ".tla", kinds + ".cfg")
    lay = build_layout2(m, list(sample_states(m)), Bounds())
    kc = build_canon2(m, lay)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    r = torch.randint(-2, 14, (200000, lay.width), generator=g,
                      device=DEVICE, dtype=torch.int32)
    r[torch.rand(r.shape, generator=g, device=DEVICE) < 0.05] = 2**31 - 1
    v = torch.rand(r.shape[0], generator=g, device=DEVICE) < 0.9
    err = _max_abs(ops.canon_rows(r, v, kc), ops.canon_rows_twin(r, v, kc))
    log(f"[{tag}] canon_rows on the symkinds layout (seq, growset, union, "
        f"pfcn, kvtable; W={lay.width}, {kc.n_perms} permutations), "
        f"200,000 random rows: max_abs_err {err}")
    if err != 0:
        raise AssertionError("canon_rows differs from its twin on the "
                             "symkinds layout")
    return out


def check_view(eng, got, counts, tag="9 view"):
    from jaxmc_torch.kernels import ops
    pt, W, PW, K = eng.pt, eng.W, eng.PW, eng.K
    rows, valid = got["keys"]
    N, nv = rows.shape[0], int(valid.sum())
    vb = eng.view_fn(rows).reshape(N, -1).to(torch.int32).contiguous()
    Vw = vb.shape[1]
    args = (rows, valid, pt, eng.fp_mode, eng.plan.identity)
    kw = dict(basis=vb, basis_packed=False)
    k = ops.keys_of(*args, **kw)
    t = ops.keys_of_twin(*args, **kw)
    torch.cuda.synchronize()
    return [_row(
        tag, "keys_of_view", "jaxmc_torch/kernels/csrc/keys.cu",
        "jaxmc/backend/bfs.py:1608", counts["keys_of_view"],
        _max_abs(list(k), list(t)),
        cuda_time(lambda: ops.keys_of(*args, **kw)),
        cuda_time(lambda: ops.keys_of_twin(*args, **kw), reps=3),
        N + nv * (W + Vw) * 4 + N * (PW + K) * 4, nv * (W * 6 + Vw),
        note=f" [N={N} valid={nv} view lanes {Vw} K={K}]")]


def _fold(keys):
    """Key data words (one or two) as one monotone int64, or None."""
    w = keys.shape[1] - 1
    if w == 1:
        return keys[:, 1].to(torch.int64).contiguous()
    if w == 2:
        return (keys[:, 1].to(torch.int64) * (1 << 32)
                + (keys[:, 2].to(torch.int64) + (1 << 31))).contiguous()
    return None


def check_por(eng, got, counts, tag="10 por"):
    from jaxmc_torch.kernels import ops
    seen, seen_count, ckeys, cvalid, FC = got["por"]
    plan = eng._por_memo
    ia, safe = plan["inst_arm_t"], plan["arm_safe_t"]
    A = eng.A
    C, K = ckeys.shape
    fk = ops.seen_probe(seen, seen_count, ckeys, site="por")
    ft = ops.seen_probe_twin(seen, seen_count, ckeys)
    torch.cuda.synchronize()
    lib_ms = None
    sf, qf = _fold(seen[:seen_count]), _fold(ckeys)
    if sf is not None:
        lb_lib = torch.searchsorted(sf, qf)
        if _max_abs(lb_lib[ckeys[:, 0] == 0], fk[1][ckeys[:, 0] == 0]):
            raise AssertionError("searchsorted yardstick disagrees")
        lib_ms = cuda_time(lambda: torch.searchsorted(sf, qf))
    probes = max(1, math.ceil(math.log2(max(seen_count, 1) + 1)))
    out = [_row(tag, "seen_probe_por", "jaxmc_torch/kernels/csrc/probe.cu",
                "jaxmc/backend/bfs.py:199", counts["seen_probe_por"],
                _max_abs(list(fk), list(ft)),
                cuda_time(lambda: ops.seen_probe(seen, seen_count, ckeys,
                                                 site="por")),
                cuda_time(lambda: ops.seen_probe_twin(seen, seen_count,
                                                      ckeys), reps=3),
                (seen_count + C) * (K - 1) * 4 + C * 5,
                C * probes * (K - 1) * 2, library_ms=lib_ms,
                note=f" [C={C} seen_count={seen_count} K={K}, unsorted]")]
    found = fk[0]
    k = ops.por_mask(found, cvalid, ia, safe, A, FC)
    t = ops.por_mask_twin(found, cvalid, ia, safe, A, FC)
    torch.cuda.synchronize()
    out.append(_row(
        tag, "por_mask", "jaxmc_torch/kernels/csrc/por.cu",
        "jaxmc/backend/bfs.py:216", counts["por_mask"],
        _max_abs(list(k), list(t)),
        cuda_time(lambda: ops.por_mask(found, cvalid, ia, safe, A, FC)),
        cuda_time(lambda: ops.por_mask_twin(found, cvalid, ia, safe, A,
                                            FC), reps=3),
        # found and cvalid read, keep written, the arm tables
        3 * C + 4 * A + safe.numel(), 6 * C,
        note=f" [A={A} FC={FC} arms={safe.numel()} valid="
             f"{int(cvalid.sum())} masked={int(k[3])}]"))
    return out


def phase_por_verdicts():
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    for cfg, kind in (("portoy.cfg", "deadlock"),
                      ("portoy_bad.cfg", "invariant")):
        res = {}
        for dev in (DEVICE, "cpu"):
            m = load_model(os.path.join(SPECS, "portoy.tla"),
                           os.path.join(SPECS, cfg))
            ops.reset_launches()
            res[dev] = TorchExplorer(m, device=dev, por=True).run()
            if dev == DEVICE and ops.LAUNCHES["por_mask"] <= 0:
                raise AssertionError(f"{cfg}: K6 not launched")
        a, b = _summary(res[DEVICE]), _summary(res["cpu"])
        r = res[DEVICE]
        log(f"[10 por] {cfg} --por: {r.violation.kind} "
            f"{r.violation.name}, generated {r.generated} distinct "
            f"{r.distinct}, trace {len(r.violation.trace)} states; "
            f"cuda == cpu: {a == b}")
        if a != b or r.violation.kind != kind:
            raise AssertionError(f"{cfg}: cuda run differs from cpu run "
                                 f"or verdict {r.violation.kind} != {kind}")


# ---------------------------------------------------------------------------
# phases 11-13: the chunked host-seen engine
# ---------------------------------------------------------------------------

def host_seen_engine(spec, cfg, capture=None, **kw):
    """A host-seen TorchExplorer; with `capture` (a dict) it keeps the
    K7 inputs of the chunk with the most valid candidates (this reads
    each chunk's count back, so only the twin run captures)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    class Capture(TorchExplorer):
        def _epilogue(self, en, aok, ov, fcount, keys, cand, pack_ovf,
                      inv_ok, explore):
            CH = en.shape[1]
            fv = torch.arange(CH, device=en.device) < fcount
            n = int((en & fv[None, :]).sum())
            if n > capture.get("n", -1):
                capture.update(n=n, args=tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in (en, aok, ov, fcount, keys, cand, pack_ovf,
                              inv_ok, explore)))
            return super()._epilogue(en, aok, ov, fcount, keys, cand,
                                     pack_ovf, inv_ok, explore)

    cls = Capture if capture is not None else TorchExplorer
    return cls(load_model(os.path.join(SPECS, spec), cfg), device=DEVICE,
               host_seen=True, chunk=CHUNK_HS, store_trace=False,
               progress_every=1e9, **kw)


def phase_host_seen(tag, spec, cfg, pins, por_pins=None, **kw):
    """The model under --host-seen at CHUNK_HS on the kernels and on
    the twins (capturing K7's inputs): counts equal to `pins` on both,
    HS_KERNELS launched and HS_ABSENT not on the kernel run, none on
    the twin run.  Returns (launch counts, captured K7 inputs)."""
    from jaxmc_torch import obs
    out, captured = {}, {}
    for kind, twins in (("kernels", False), ("twins", True)):
        obs.reset()
        eng, r, wall, counts, peak = run_counted(
            lambda twins=twins: host_seen_engine(
                spec, cfg, captured if twins else None, twins=twins, **kw))
        tel = obs.current()
        por = {k: v for k, v in list(tel.counters.items())
               + list(tel.gauges.items()) if k.startswith("por.")}
        got3 = (r.distinct, r.generated, r.diameter)
        widest = max(lv["frontier"] for lv in tel.levels)
        occ = eng._fp_occupancy
        log(f"[{tag}] {kind}: ok={r.ok} distinct {r.distinct} generated "
            f"{r.generated} diameter {r.diameter}; wall {wall:.3f}s, "
            f"{r.generated / wall:.0f} generated states/s; peak "
            f"{peak / 2**30:.2f} GiB; widest frontier {widest} "
            f"({-(-widest // CHUNK_HS)} chunks of {CHUNK_HS}); host store "
            f"{occ} fingerprints ({occ * 16 / 2**20:.1f} MiB); layout "
            f"W={eng.W} PW={eng.PW} K={eng.K} A={eng.A}; launches "
            f"{counts}" + (f"; {por}" if por else ""))
        if not r.ok or got3 != pins:
            raise AssertionError(f"{tag}: {kind} ok={r.ok} counts {got3} "
                                 f"!= {pins}")
        if por_pins is not None:
            got_pins = {k: por.get(k) for k in por_pins}
            if got_pins != por_pins:
                raise AssertionError(f"{tag}: {kind} por counters "
                                     f"{got_pins} != {por_pins}")
        if twins and any(counts.values()):
            raise AssertionError(f"{tag}: twin run launched kernels")
        if not twins:
            missing = [k for k in HS_KERNELS if counts[k] <= 0]
            extra = [k for k in HS_ABSENT if counts[k] > 0]
            if missing or extra:
                raise AssertionError(f"{tag}: kernels not launched "
                                     f"{missing}, launched {extra}")
            out["counts"] = counts
    return out["counts"], captured


def check_hstep(captured, launches, tag="11 host seen"):
    """K7 against its twin, bit for bit, on the captured chunk; timed
    beside its twin, its byte bound and torch.nonzero + index_select
    doing the same compaction."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    (en, aok, ov, fcount, keys, cand, povf, inv, exp) = captured["args"]
    args = (en, aok, ov, fcount, keys, cand, povf, OV_PACK, inv, exp)
    k = ops.hstep_epilogue(*args)
    t = ops.hstep_epilogue_twin(*args)
    torch.cuda.synchronize()
    nv = int(t["scalars"][0])
    names = ["idx", "fps", "rows", "inv_ok", "explore"]
    err = max(_max_abs(k["scalars"], t["scalars"]),
              _max_abs(k["dead"], t["dead"]),
              max(_max_abs(k[n][:nv], t[n][:nv]) for n in names))
    A, CH = en.shape
    C, PW = A * CH, cand.shape[1]
    fv = torch.arange(CH, device=en.device) < fcount

    def library():
        idx = torch.nonzero((en & fv[None, :]).reshape(-1)).flatten()
        return keys.index_select(0, idx), cand.index_select(0, idx)
    lib = library()
    if _max_abs(lib[1], k["rows"][:nv]) or \
            _max_abs(lib[0][:, 1:], k["fps"][:nv]):
        raise AssertionError("nonzero + index_select yardstick disagrees")
    preds = 2
    # the three launches' device time alone, from the profiler: the
    # event time above also holds the wrapper's host work when that is
    # the longer of the two
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.hstep_epilogue(*args)
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if "hstep_" in e.key and "kernel" in e.key) / 10
    return _row(
        tag, "hstep_epilogue@4p", "jaxmc_torch/kernels/csrc/hstep.cu",
        "jaxmc/backend/bfs.py:1938", launches["hstep_epilogue"], err,
        cuda_time(lambda: ops.hstep_epilogue(*args)),
        cuda_time(lambda: ops.hstep_epilogue_twin(*args), reps=3),
        # en, aok and ov of every candidate; the valid candidates' four
        # fingerprint words, row words and predicate bits read and
        # written compacted with their index; dead written
        C * 6 + nv * (16 + PW * 4 + preds) * 2 + nv * 4 + CH + 48,
        C * 8 + nv * (5 + PW + preds),
        library_ms=cuda_time(library),
        note=f" [A={A} CH={CH} fcount={fcount} valid={nv} PW={PW}; "
             f"3 launches, device time {dev_us / 1e3:.4f} ms]")


def phase_hybrid():
    """The hybrid fixtures under --host-seen on the card and on the
    CPU: verdict, counts, trace and every log line equal; K7 launched
    on the card."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    cases = [("interparm_toy", os.path.join(SPECS, "interparm_toy"), {},
              (True, 29, 19), "interp-demoted"),
             ("guarddem", os.path.join(FIXTURES, "guarddem"), {},
              (True, 17, 11), "hybrid: demotion abort"),
             ("deepvar", os.path.join(FIXTURES, "deepvar"),
              {"sample_cfg": (3, 2, 3)}, (True, 12, 11),
              "hybrid: adaptive relayout"),
             ("allinterp", os.path.join(FIXTURES, "allinterp"), {},
              (True, 6, 5), "EVERY action arm")]
    for tag, base, kw, want, line in cases:
        res = {}
        for dev in (DEVICE, "cpu"):
            lines = []
            ops.reset_launches()
            r = TorchExplorer(load_model(base + ".tla", base + ".cfg"),
                              device=dev, host_seen=True, log=lines.append,
                              progress_every=1e9, **kw).run()
            if dev == DEVICE and ops.LAUNCHES["hstep_epilogue"] <= 0:
                raise AssertionError(f"{tag}: K7 not launched")
            res[dev] = _summary(r) + (tuple(r.warnings), tuple(lines))
        r = res[DEVICE]
        n_line = sum(line in ln for ln in r[-1])
        log(f"[13 hybrid] {tag}: ok={r[0]} generated {r[1]} distinct "
            f"{r[2]}; {n_line} log line(s) with {line!r}; cuda == cpu: "
            f"{res[DEVICE] == res['cpu']}")
        if res[DEVICE] != res["cpu"] or r[:3] != want or not n_line:
            raise AssertionError(f"{tag}: cuda run differs from cpu run "
                                 f"or {r[:3]} != {want}")


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

    eng, got, counts, _ = phase_reduction(
        "8 symmetry", "symtoy_scaled.tla", CFG_SYM, PINS_SYM,
        ("unpack_rows", "canon_rows", "keys_of_canon", "seen_probe",
         "rank_merge"))
    table += check_canon(eng, got, counts)
    del eng, got
    eng, got, counts, _ = phase_reduction(
        "9 view", "viewtoy_scaled.tla", CFG_VIEW, PINS_VIEW,
        ("unpack_rows", "keys_of_view", "seen_probe", "rank_merge"))
    table += check_view(eng, got, counts)
    del eng, got
    eng, got, counts, por = phase_reduction(
        "10 por", "msgstoy.tla", CFG_POR, PINS_POR,
        ("unpack_rows", "keys_of", "seen_probe", "seen_probe_por",
         "por_mask", "rank_merge"), por=True)
    got_pins = {k: por.get(k) for k in POR_PINS}
    if got_pins != POR_PINS:
        raise AssertionError(f"por counters {got_pins} != {POR_PINS}")
    table += check_por(eng, got, counts)
    del eng, got
    phase_por_verdicts()

    counts, captured = phase_host_seen("11 host seen", "transfer_scaled.tla",
                                       CFG_4P, counts_4p)
    table.append(check_hstep(captured, counts))
    del captured
    phase_host_seen("12 hs por", "msgstoy.tla", CFG_POR, PINS_HS_POR,
                    POR_PINS_HS, por=True)
    phase_hybrid()
    log(f"[done] {time.time() - t_start:.1f}s")
    print(f"{smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
