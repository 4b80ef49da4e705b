#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the ten
hand-written kernels and the native fingerprint store, holds each
kernel against its plain PyTorch twin at the shapes the engines give
it, times both, and checks models end to end through the port's entry
points: the level engine, the chunked host-seen engine, the resident
engine, the out-of-core seen tiers, temporal and refinement PROPERTYs,
and cross-model batching.

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
 14 resident   transfer_scaled_4p with --resident at chunk 65,536 on
               kernels and twins: the pins of phase 7; K1, K2, K3, K4,
               K8 (both sites) and K9 launched and K7 not; wall,
               generated states/s, peak device memory, the growth lines;
               then K8 at both sites and K9 against their twins, and
               timed, at the chunk with the most valid candidates (rows
               "resident_compact@4p", "resident_compact_explore@4p",
               "resident_fold@4p")
 15 res reduce symtoy_scaled_4p (SYMMETRY) and msgstoy_scaled --por under
               --resident on the kernels: the level engine's pins and
               por.* counters; pcal_intro_buggy, batchtoy_bad and
               portoy_bad --por under --resident on the card equal to
               the CPU run, log lines included
 16 tiers      transfer_scaled_4p --resident --seen-cap 4194304 and
               ooc_scaled on the level engine (--seen-cap 512, a host
               budget of 1024 keys): the pins, with spills
 17 properties jaxmc_torch/fixtures/transfer_props.tla (EXTENDS
               transfer_scaled, loaded with -I specs) at MaxMoney 12
               with a refinement that holds (Monotone), one that fails
               (Frozen) and a temporal property that holds under weak
               fairness (AllDone, LiveSpec) and fails without it
               (Spec): each on the level engine and under --host-seen
               --chunk 65536, on the kernels, on the twins and on the
               CPU, in a pool of worker processes (the host checkers
               are single-threaded Python), but the level engine's
               runs on the kernels alone after the pool; card runs
               equal the CPU run; K8's edge site launched on the level
               engine; wall, edges streamed and the host checker's
               share; then K8's
               edge site against its twin and torch.nonzero at the
               level with the most edges (row
               "resident_compact_edges@props")
 18 batch      a cohort of three msgstoy members (Procs {p1..p4}, T 6,
               Cap 1, 2 and 3: fixtures/msgstoy_batch_cap*.cfg)
               through BatchCheckEngine at chunk 65,536 on the kernels
               and on the twins: each member equal to its solo
               --host-seen run on the card and to the formula's pins,
               max_width 3, K10 launched and K7 not; the cohort's wall
               against the solo walls, the dispatches, peak device
               memory; K10 against its twin and the library call at
               the busiest dispatch (row "batch_epilogue@msgstoy3");
               the batchtoy_{a,b,c,d,bad} cohort on the card equal to
               the CPU
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
# written between timed calls when a kernel's inputs would otherwise stay
# in the 50 MB L2 from one call to the next
L2_FLUSH_BYTES = 256 << 20

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
# the resident phases' chunk, and the kernels a resident search launches
CHUNK_RES = 65536
RES_KERNELS = ("unpack_rows", "keys_of", "seen_probe", "rank_merge",
               "resident_compact", "resident_compact_explore",
               "resident_fold")
# the CPU formula's starting caps (TorchExplorer._res_start_caps), given
# to the card and the CPU alike where their runs are compared line by
# line
RES_CAPS_CPU = {"SC": 1 << 15, "FCap": 2048, "AccCap": 1 << 15,
                "VC": 1 << 13}
# ooc_scaled (jaxmc/corpus.py pins: distinct, generated) and the
# out-of-core settings of the reference's acceptance run
OOC_PINS = (3072, 12289)
SEEN_CAP_4P = 4194304
# the 4-process model's initial states (|1..12|^4), the seen table's
# rows before the first resident level
N_INIT_4P = 12 ** 4
SPILL = os.path.join(ROOT, "jaxmc_torch", "kernels", "_build", "spill")
# phase 17: the PROPERTY fixtures, the verdict each must reach, and the
# worker pool that runs their kernels, twins and CPU runs side by side
PROPS = os.path.join(FIXTURES, "transfer_props.tla")
PROP_WANT = {"monotone": (True, None), "frozen": (False, "Frozen"),
             "live": (True, None), "nolive": (False, "AllDone")}
# the host checkers' rough cost order (longest first into the pool)
PROP_ORDER = ("live", "monotone", "nolive", "frozen")
PROP_WORKERS = 8
# phase 18: the msgstoy cohort and its pins (Cap+1)^(4+T) + (Cap+1)^(3+T)
CAPS_BATCH = (1, 2, 3)
CFG_BATCH = [os.path.join(FIXTURES, f"msgstoy_batch_cap{c}.cfg")
             for c in CAPS_BATCH]
PINS_BATCH = [(c + 1) ** 10 + (c + 1) ** 9 for c in CAPS_BATCH]


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

        def level_step(self, seen, seen_count, frontier_p, fcount):
            # the whole step's inputs at the widest level (B.1, B.7)
            if fcount > got.get("step_n", -1):
                got["step_n"] = fcount
                got["step"] = (seen.clone(), seen_count, frontier_p.clone(),
                               fcount)
            return super().level_step(seen, seen_count, frontier_p, fcount)

    model = load_model(os.path.join(SPECS, "transfer_scaled.tla"), cfg)
    eng = Capture(model, device=DEVICE, store_trace=False,
                  progress_every=1e9)
    r = eng.run()
    if (r.distinct, r.generated, r.diameter) != want:
        raise AssertionError(f"capture run counts {r.distinct}/"
                             f"{r.generated}/{r.diameter} != {want}")
    return eng, got


def _flusher():
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    return buf.zero_


def cuda_time(fn, reps=20, warm=3, flush=False):
    """Mean ms per call over `reps` calls, CUDA events, after warm-up;
    with `flush`, each call is timed on its own after L2_FLUSH_BYTES are
    written, so its inputs come from HBM."""
    for _ in range(warm):
        fn()
    if flush:
        clear = _flusher()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for a, b in evs:
            clear()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / reps
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


def phase_torch_bounds(eng, got, tag="7 bounds"):
    """The two device programs of the level path that are torch, not a
    hand kernel, timed at the widest level beside their byte bounds:
    the emitter (B.1: reads FC*W words, writes A*FC*(W+3) words) and
    the whole level step (B.7: reads the packed frontier and the live
    seen prefix, writes the merged table and the next frontier with its
    provenance).  Printed, not in the kernel table."""
    seen, seen_count, frontier_p, fcount = got["step"]
    FC, PW = frontier_p.shape
    A, W, K = eng.A, eng.W, eng.K
    SC = seen.shape[0]
    rows = eng._unpack(frontier_p)
    ms = cuda_time(lambda: eng._expand(rows), reps=3, warm=1)
    bms, by = _bound((FC * W + A * FC * (W + 3)) * 4, 0)
    log(f"[{tag}] emitter (B.1) at the widest level: {ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}) [A={A} FC={FC} W={W}]")
    out = eng.level_step(seen, seen_count, frontier_p, fcount)
    front = int(out["scalars"][7])
    ms = cuda_time(lambda: eng.level_step(seen, seen_count, frontier_p,
                                          fcount), reps=3, warm=1)
    bms, by = _bound((FC * PW + seen_count * K + SC * K
                      + front * (PW + 1)) * 4, 0)
    log(f"[{tag}] level step (B.7) at the widest level: {ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}) [FC={FC} fcount={fcount} seen_count="
        f"{seen_count} SC={SC} new={front}]")


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


# ---------------------------------------------------------------------------
# phases 14-16: the resident engine and the out-of-core tiers
# ---------------------------------------------------------------------------

def resident_engine(spec, cfg, capture=None, **kw):
    """A resident TorchExplorer at CHUNK_RES; with `capture` (a dict) it
    keeps the inputs of K8 (both sites) and K9 at the chunk and level
    with the most valid candidates (this reads counts back, so only the
    twin run captures)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    def keep(name, n, *xs):
        if n > capture.get(name + "_n", -1):
            capture[name + "_n"] = n
            capture[name] = tuple(x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in xs)

    class Capture(TorchExplorer):
        def _compact(self, mask, cap, flim=None, aok=None, ov=None,
                     site=""):
            out = super()._compact(mask, cap, flim, aok, ov, site)
            keep("k8_" + (site or "chunk"), int(out[1][0]), mask, cap,
                 flim, aok, ov)
            return out

        def _fold(self, lv, part, pack_ovf, por, keys_c, rows_c, base):
            keep("k9", int(part[0]) if int(lv["carry"][0]) == 0 else -1,
                 lv["carry"], lv["bad_row"], part, pack_ovf, por, keys_c,
                 rows_c, lv["acc_keys"], lv["acc_rows"], lv["frontier"],
                 base, lv["CH"])
            return super()._fold(lv, part, pack_ovf, por, keys_c, rows_c,
                                 base)

    cls = Capture if capture is not None else TorchExplorer
    kw.setdefault("chunk", CHUNK_RES)
    return cls(load_model(os.path.join(SPECS, spec), cfg), device=DEVICE,
               resident=True, store_trace=False, progress_every=1e9, **kw)


def phase_resident(tag, spec, cfg, pins, por_pins=None, twins=True,
                   need=RES_KERNELS, **kw):
    """The model under --resident at CHUNK_RES on the kernels (and, with
    twins=True, on the twins, capturing K8's and K9's inputs): counts
    equal to `pins`, every kernel of `need` launched and K7 not on the
    kernel run, none on the twin run.  Returns (launch counts, captured
    inputs, kernel-run summary)."""
    from jaxmc_torch import obs
    out, captured = {}, {}
    for kind, tw in (("kernels", False), ("twins", True)):
        if tw and not twins:
            continue
        obs.reset()
        lines = []
        eng, r, wall, counts, peak = run_counted(
            lambda tw=tw: resident_engine(spec, cfg,
                                          captured if tw else None,
                                          twins=tw, log=lines.append, **kw))
        tel = obs.current()
        por = {k: v for k, v in list(tel.counters.items())
               + list(tel.gauges.items()) if k.startswith("por.")}
        got3 = (r.distinct, r.generated, r.diameter)
        grows = [ln for ln in lines if ln.startswith("-- ")]
        log(f"[{tag}] {kind}: ok={r.ok} distinct {r.distinct} generated "
            f"{r.generated} diameter {r.diameter}; wall {wall:.3f}s, "
            f"{r.generated / wall:.0f} generated states/s; peak "
            f"{peak / 2**30:.2f} GiB; {len(tel.levels)} level runs "
            f"(redone ones included); layout W={eng.W} "
            f"PW={eng.PW} K={eng.K} A={eng.A}; launches {counts}"
            + (f"; {por}" if por else "") + (f"; tiers {r.tiers}"
                                             if r.tiers else ""))
        for ln in grows:
            log(f"[{tag}]   {ln}")
        if not r.ok or got3 != pins:
            raise AssertionError(f"{tag}: {kind} ok={r.ok} counts {got3} "
                                 f"!= {pins}")
        if por_pins is not None:
            got_pins = {k: por.get(k) for k in por_pins}
            if got_pins != por_pins:
                raise AssertionError(f"{tag}: {kind} por counters "
                                     f"{got_pins} != {por_pins}")
        if tw and any(counts.values()):
            raise AssertionError(f"{tag}: twin run launched kernels")
        if not tw:
            missing = [k for k in need if counts[k] <= 0]
            if missing or counts["hstep_epilogue"]:
                raise AssertionError(f"{tag}: kernels not launched "
                                     f"{missing}, or K7 launched")
            out["counts"] = counts
            out["result"] = (r, wall, peak, list(tel.levels), eng.K,
                             eng.PW)
    return out["counts"], captured, out["result"]


def device_ms(fn, key, reps=10, flush=False):
    """The device time of the kernels whose names hold `key`, per call
    of fn, from the profiler: the event times also hold the wrapper's
    host work when that is the longer of the two.  With `flush`,
    L2_FLUSH_BYTES are written before each call (the write's own kernel
    is not counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    clear = _flusher() if flush else (lambda: None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            clear()
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if key in e.key) / reps / 1e3


def check_resident(captured, launches, tag="14 resident"):
    """K8 at both sites and K9 against their twins, bit for bit, on the
    captured inputs; timed beside the twins, their byte bounds and, for
    K8, torch.nonzero doing the same capped compaction."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    rows = []
    for site in ("chunk", "explore"):
        mask, cap, flim, aok, ov = captured["k8_" + site]
        kw = {} if site == "chunk" else {"site": "explore"}
        k = ops.resident_compact(mask, cap, flim, aok, ov, **kw)
        t = ops.resident_compact_twin(mask, cap, flim, aok, ov)
        torch.cuda.synchronize()
        err = max(_max_abs(k[0], t[0]), _max_abs(k[1], t[1]))
        m2 = mask if mask.dim() == 2 else mask.reshape(1, -1)
        A, CH = m2.shape
        C, n = A * CH, int(t[1][0])
        fl = CH if flim is None else flim
        fv = torch.arange(CH, device=mask.device) < fl

        def library():
            idx = torch.nonzero((m2 & fv[None, :]).reshape(-1)).flatten()
            return idx[:cap], idx.numel()
        if _max_abs(library()[0], k[0][:min(n, cap)]):
            raise AssertionError("torch.nonzero yardstick disagrees")
        per = 6 if site == "chunk" else 1
        name = "resident_compact" + ("" if site == "chunk" else "_explore")
        dev_ms = device_ms(lambda: ops.resident_compact(mask, cap, flim,
                                                        aok, ov, **kw),
                           "compact_")
        rows.append(_row(
            tag, name + "@4p", "jaxmc_torch/kernels/csrc/resident.cu",
            "jaxmc/backend/bfs.py:2275", launches[name], err,
            cuda_time(lambda: ops.resident_compact(mask, cap, flim, aok, ov,
                                                   **kw)),
            cuda_time(lambda: ops.resident_compact_twin(mask, cap, flim, aok,
                                                        ov), reps=3),
            # en, aok and ov of every candidate (the mask alone at the
            # explore site) read once; cap indices written
            C * per + cap * 4 + 48, C * 8,
            library_ms=cuda_time(library),
            note=f" [{site} site: A={A} CH={CH} flim={fl} set={n} "
                 f"cap={cap}; 3 launches, device time {dev_ms:.4f} ms]"))
    (carry, bad_row, part, povf, por, keys_c, rows_c, acc_keys, acc_rows,
     frontier, base, CH) = captured["k9"]
    VC, K = keys_c.shape
    PW = rows_c.shape[1]
    out = {}
    for name, f in (("kernel", ops.resident_fold),
                    ("twin", ops.resident_fold_twin)):
        c, b, ak, ar = (x.clone() for x in (carry, bad_row, acc_keys,
                                            acc_rows))
        f(c, b, part, povf, por, keys_c, rows_c, ak, ar, frontier, base,
          CH, True, OV_PACK)
        torch.cuda.synchronize()
        out[name] = (c, b, ak, ar)
    err = max(_max_abs(a, b) for a, b in zip(out["kernel"], out["twin"]))
    c, b, ak, ar = (x.clone() for x in (carry, bad_row, acc_keys, acc_rows))

    def run(f):
        # each call starts from the captured carry (a 56-byte copy)
        c.copy_(carry)
        f(c, b, part, povf, por, keys_c, rows_c, ak, ar, frontier, base,
          CH, True, OV_PACK)
    rows.append(_row(
        tag, "resident_fold@4p", "jaxmc_torch/kernels/csrc/resident.cu",
        "jaxmc/backend/bfs.py:2275", launches["resident_fold"], err,
        cuda_time(lambda: run(ops.resident_fold)),
        cuda_time(lambda: run(ops.resident_fold_twin), reps=3),
        # the VC block's keys and rows read and written once
        2 * VC * (K + PW) * 4, VC * (K + PW),
        note=f" [VC={VC} K={K} PW={PW} vcnt={int(part[0])} "
             f"AccCap={acc_keys.shape[0]}; 2 launches, device time "
             f"{device_ms(lambda: run(ops.resident_fold), 'fold_'):.4f} ms "
             f"(the carry copy apart); library null: no PyTorch call "
             f"appends a block guarded by a device flag]"))
    return rows


def resident_bound(result, n_init, tag="14 bounds"):
    """The resident search's (B.10) byte bound, the sum of its committed
    levels' bounds as the level step's (B.7) is reckoned: each level's
    frontier rows and live seen prefix read, its merged seen table and
    new frontier written.  Printed beside the run's wall."""
    r, wall, _peak, levels, K, PW = result
    nbytes, seen_prev, n = 0, n_init, 0
    for lv in levels:
        if lv.get("status") in (6, 7, 8, 9, 10):   # ST_OVF_*: redone
            continue
        n += 1
        nbytes += (lv["frontier"] * PW + seen_prev * K + lv["seen"] * K
                   + lv["new"] * PW) * 4
        seen_prev = lv["seen"]
    bms, by = _bound(nbytes, 0)
    log(f"[{tag}] resident search (B.10): wall {wall:.3f}s, bound "
        f"{bms:.4f} ms ({by}; {nbytes / 2**20:.1f} MiB over {n} committed "
        f"levels of {len(levels)} level runs)")


def phase_resident_verdicts(tag="15 res reduce"):
    """pcal_intro_buggy, batchtoy_bad and portoy_bad --por under
    --resident on the card and on the CPU, from the same starting caps:
    verdict, counts, violation state, warnings and every log line."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    cases = [("pcal_intro_buggy", "pcal_intro_buggy.tla", None, {},
              ("assert", 10250, 6740)),
             ("batchtoy_bad", "batchtoy.tla", "batchtoy_bad.cfg", {},
              ("invariant", 6, 6)),
             ("portoy_bad", "portoy.tla", "portoy_bad.cfg", {"por": True},
              ("invariant", None, None))]
    for name, spec, cfg, kw, want in cases:
        res = {}
        for dev in (DEVICE, "cpu"):
            lines = []
            ops.reset_launches()
            m = load_model(os.path.join(SPECS, spec),
                           os.path.join(SPECS, cfg) if cfg else None)
            r = TorchExplorer(m, device=dev, resident=True,
                              res_caps=RES_CAPS_CPU, log=lines.append,
                              progress_every=1e9, **kw).run()
            if dev == DEVICE and ops.LAUNCHES["resident_fold"] <= 0:
                raise AssertionError(f"{name}: K9 not launched")
            res[dev] = _summary(r) + (tuple(r.warnings), tuple(lines))
        r = res[DEVICE]
        log(f"[{tag}] {name} --resident: {r[4]} {r[5]}, generated {r[1]} "
            f"distinct {r[2]}; cuda == cpu: {res[DEVICE] == res['cpu']}")
        if res[DEVICE] != res["cpu"] or r[4] != want[0] or (
                want[1] is not None and (r[1], r[2]) != want[1:]):
            raise AssertionError(f"{name}: cuda run differs from cpu run "
                                 f"or {r[4]} {r[1]}/{r[2]} != {want}")


def phase_tiers(pins_4p, tag="16 tiers"):
    """The out-of-core seen set on the card: transfer_scaled_4p under
    --resident with a device seen cap below its state count (to phase
    7's counts, `pins_4p`), and ooc_scaled on the level engine; both
    reach their pins, spilling."""
    import shutil
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    shutil.rmtree(SPILL, ignore_errors=True)
    try:
        counts, _, (r, wall, peak, *_rest) = phase_resident(
            tag, "transfer_scaled.tla", CFG_4P, pins_4p, twins=False,
            seen_cap=SEEN_CAP_4P, spill_dir=os.path.join(SPILL, "4p"))
        if not r.tiers or r.tiers["spills"] <= 0:
            raise AssertionError(f"{tag}: transfer_scaled_4p did not spill")
        lines = []
        eng, r, wall, counts, peak = run_counted(lambda: TorchExplorer(
            load_model(os.path.join(SPECS, "ooc_scaled.tla"),
                       os.path.join(SPECS, "ooc_scaled.cfg")),
            device=DEVICE, seen_cap=512, host_tier_keys=1024,
            log=lines.append, progress_every=1e9, store_trace=False,
            spill_dir=os.path.join(SPILL, "ooc")))
        log(f"[{tag}] ooc_scaled (level engine, seen cap 512, host budget "
            f"1024 keys): distinct {r.distinct} generated {r.generated}; "
            f"wall {wall:.3f}s; tiers {r.tiers}; launches {counts}")
        if not r.ok or (r.distinct, r.generated) != OOC_PINS or \
                not r.tiers or r.tiers["spills"] <= 0 or \
                r.tiers["disk_keys"] <= 0:
            raise AssertionError(f"{tag}: ooc_scaled {r.distinct}/"
                                 f"{r.generated} tiers {r.tiers}")
    finally:
        shutil.rmtree(SPILL, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 17: temporal and refinement PROPERTYs
# ---------------------------------------------------------------------------

def _props_job(prop, host_seen, variant):
    """One phase-17 run, in a worker process: transfer_props with the
    `prop` cfg on the level engine or under --host-seen at CHUNK_HS, on
    the kernels, the twins or the CPU.  Every launch counter is set to
    0 just before the search and read just after.  Returns the result's
    summary, the wall, the host checker's time (the stepwise refinement
    checks and the liveness check) and the edges it was given."""
    torch.set_num_threads(1)
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.engine.explore import format_trace
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    checker = {"s": 0.0, "edges": 0}

    class Timed(TorchExplorer):
        def _refine_edges(self, frontier_rows, rows, idx, FC):
            t = time.time()
            try:
                return super()._refine_edges(frontier_rows, rows, idx, FC)
            finally:
                checker["s"] += time.time() - t
                checker["edges"] += len(idx)

        def _check_live(self, graph, warnings):
            t = time.time()
            try:
                return super()._check_live(graph, warnings)
            finally:
                checker["s"] += time.time() - t
                checker["edges"] += len(graph.edges)

    dev = "cpu" if variant == "cpu" else DEVICE
    model = load_model(PROPS, os.path.join(FIXTURES,
                                           f"transfer_props_{prop}.cfg"),
                       False, [SPECS])
    eng = Timed(model, device=dev, host_seen=host_seen, chunk=CHUNK_HS,
                twins=variant == "twins", progress_every=1e9)
    if dev != "cpu":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    r = eng.run()
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ops.LAUNCHES)
    v = r.violation
    return dict(summary=(r.ok, r.generated, r.distinct, r.diameter,
                         tuple(r.warnings), v and v.kind, v and v.name,
                         v and v.message, v and format_trace(v)),
                wall=wall, checker_s=checker["s"], edges=checker["edges"],
                launches=counts)


def phase_props(tag="17 properties"):
    """The PROPERTY runs in a pool of worker processes (spawned; each
    starts its own CUDA context; they share the card and the host's
    cores), then each cfg's level-engine run on the kernels alone in
    this process, so that its wall and its host checker's share are
    the run's own; then K8's edge site timed here."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    alone = [(p, False, "kernels") for p in PROP_ORDER]
    jobs = [(p, hs, v) for p in PROP_ORDER for hs in (False, True)
            for v in ("kernels", "twins", "cpu") if (p, hs, v) not in alone]
    t0 = time.time()
    ex = ProcessPoolExecutor(max_workers=PROP_WORKERS,
                             mp_context=mp.get_context("spawn"))
    try:
        futs = {j: ex.submit(_props_job, *j) for j in jobs}
        res = {j: f.result() for j, f in futs.items()}
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    log(f"[{tag}] {len(jobs)} runs in {time.time() - t0:.1f}s "
        f"({PROP_WORKERS} worker processes)")
    t0 = time.time()
    threads = torch.get_num_threads()
    try:
        for j in alone:
            res[j] = _props_job(*j)
    finally:
        torch.set_num_threads(threads)
    log(f"[{tag}] {len(alone)} runs alone in {time.time() - t0:.1f}s")
    edge_launches = 0
    for p in PROP_ORDER:
        for hs in (False, True):
            eng = "host-seen" if hs else "level"
            cpu = res[(p, hs, "cpu")]
            ok, name = PROP_WANT[p]
            s = cpu["summary"]
            if s[0] is not ok or s[6] != name or \
                    (name and s[5] != "property"):
                raise AssertionError(f"{tag}: {p} {eng} cpu verdict "
                                     f"{s[0]} {s[5]} {s[6]}")
            for variant in ("kernels", "twins"):
                r = res[(p, hs, variant)]
                lc = r["launches"]
                how = "alone" if (p, hs, variant) in alone else "pool"
                log(f"[{tag}] {p} {eng} {variant} ({how}): "
                    f"ok={r['summary'][0]} "
                    f"{r['summary'][5] or ''} {r['summary'][6] or ''} "
                    f"generated {r['summary'][1]} distinct "
                    f"{r['summary'][2]} diameter {r['summary'][3]}; wall "
                    f"{r['wall']:.3f}s, edges streamed {r['edges']}, host "
                    f"checker {r['checker_s']:.3f}s "
                    f"({100 * r['checker_s'] / max(r['wall'], 1e-9):.1f}% "
                    f"of the wall); card == cpu: "
                    f"{r['summary'] == cpu['summary']}"
                    + ("" if variant == "twins" else f"; launches {lc}"))
                if r["summary"] != cpu["summary"]:
                    raise AssertionError(f"{tag}: {p} {eng} {variant} "
                                         f"differs from the cpu run")
                if variant == "twins" and any(lc.values()):
                    raise AssertionError(f"{tag}: twin run launched "
                                         f"kernels")
                if variant == "kernels":
                    need = "hstep_epilogue" if hs else \
                        "resident_compact_edges"
                    if lc[need] <= 0:
                        raise AssertionError(f"{tag}: {p} {eng}: {need} "
                                             f"not launched")
                    if not hs:
                        edge_launches += lc["resident_compact_edges"]
            log(f"[{tag}] {p} {eng} cpu (pool): wall {cpu['wall']:.3f}s, host "
                f"checker {cpu['checker_s']:.3f}s")
    return check_edges(edge_launches, tag)


def check_edges(launches, tag):
    """K8 at the `edges` site against its twin and torch.nonzero, bit
    for bit and timed, on the level with the most edges of transfer_
    props (a capture run of the level engine on the kernels; its
    liveness check is skipped: the run only captures)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    got = {}

    class Capture(TorchExplorer):
        def _compact(self, mask, cap, flim=None, aok=None, ov=None,
                     site=""):
            out = super()._compact(mask, cap, flim, aok, ov, site)
            n = int(out[1][0])
            if site == "edges" and n > got.get("n", -1):
                got.update(n=n, mask=mask.clone(), cap=cap)
            return out

        def _check_live(self, graph, warnings):
            return None

    Capture(load_model(PROPS, os.path.join(FIXTURES,
                                           "transfer_props_nolive.cfg"),
                       False, [SPECS]), device=DEVICE, store_trace=False,
            progress_every=1e9).run()
    mask, cap, n = got["mask"], got["cap"], got["n"]
    C = mask.shape[0]
    k = ops.resident_compact(mask, cap, site="edges")
    t = ops.resident_compact_twin(mask, cap)
    torch.cuda.synchronize()
    err = max(_max_abs(k[0], t[0]), _max_abs(k[1], t[1]))

    def library():
        return torch.nonzero(mask).flatten()
    if _max_abs(library(), k[0][:n]):
        raise AssertionError("torch.nonzero yardstick disagrees")
    dev_ms = device_ms(lambda: ops.resident_compact(mask, cap,
                                                    site="edges"),
                       "compact_")
    # the level step reads idx[:n] only; the kernel also writes the C - n
    # unset entries of the stable partition, which nothing reads
    return _row(
        tag, "resident_compact_edges@props",
        "jaxmc_torch/kernels/csrc/resident.cu",
        "jaxmc/backend/bfs.py:1925", launches, err,
        cuda_time(lambda: ops.resident_compact(mask, cap, site="edges")),
        cuda_time(lambda: ops.resident_compact_twin(mask, cap), reps=3),
        # the mask read once; the n kept indices and the scalars written
        C + n * 4 + 48, C * 8, library_ms=cuda_time(library),
        note=f" [C={C} edges={n}; 3 launches, device time "
             f"{dev_ms:.4f} ms; launches summed over the four level-"
             f"engine kernel runs]")


# ---------------------------------------------------------------------------
# phase 18: cross-model batching
# ---------------------------------------------------------------------------

def _cohort(cfgs, spec, twins, device=DEVICE, keep=False):
    """One BatchCheckEngine cohort at CHUNK_HS: build, then run with
    every launch counter set to 0 just before and read just after.
    Returns (engine, members, build wall, run wall, launches, peak)."""
    from jaxmc_torch.backend.batch import BatchCheckEngine
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import SessionConfig
    t0 = time.time()
    be = BatchCheckEngine([SessionConfig(spec=spec, cfg=c, host_seen=True,
                                         chunk=CHUNK_HS, device=device)
                           for c in cfgs], twins=twins).build()
    build = time.time() - t0
    if keep:
        # keep the stacked chunk of the dispatch with the most valid
        # candidates (the dispatcher reads the offsets right after)
        donor = be.dispatcher.donor
        step = donor._hstep_batch

        def keep_busiest(frontier_p, fc, cvecs):
            out = step(frontier_p, fc, cvecs)
            n = int(out["offsets"][-1])
            if n > be.busiest[0]:
                be.busiest = (n, (frontier_p, list(fc)))
            return out
        be.busiest = (-1, None)
        donor._hstep_batch = keep_busiest
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    members = be.run()
    if device != "cpu":
        torch.cuda.synchronize()
    run = time.time() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    for m in members:
        if m.error is not None:
            raise AssertionError(f"batch member {m.model.module.name} "
                                 f"failed: {m.error!r}")
    return be, members, build, run, counts, peak


def phase_batch(tag="18 batch"):
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model
    spec = os.path.join(SPECS, "msgstoy.tla")
    res = {}
    for kind, twins in (("kernels", False), ("twins", True)):
        be, members, build, run, counts, peak = _cohort(
            CFG_BATCH, spec, twins, keep=not twins)
        disp = be.dispatcher
        res[kind] = [_summary(m.result) + (tuple(m.result.warnings),)
                     for m in members]
        log(f"[{tag}] msgstoy cohort {kind}: build {build:.3f}s + run "
            f"{run:.3f}s; {disp.dispatches} dispatches, max_width "
            f"{disp.max_width}; peak {peak / 2**30:.2f} GiB; lifted "
            f"{list(be.lift_names)}; distinct "
            f"{[m.result.distinct for m in members]} generated "
            f"{[m.result.generated for m in members]}; launches {counts}")
        if disp.max_width != len(CFG_BATCH):
            raise AssertionError(f"{tag}: max_width {disp.max_width}")
        if [m.result.distinct for m in members] != PINS_BATCH or \
                not all(m.result.ok for m in members):
            raise AssertionError(f"{tag}: distinct != {PINS_BATCH}")
        if twins and any(counts.values()):
            raise AssertionError(f"{tag}: twin cohort launched kernels")
        if not twins:
            if counts["batch_epilogue"] <= 0 or counts["hstep_epilogue"]:
                raise AssertionError(f"{tag}: K10 not launched or K7 "
                                     f"launched: {counts}")
            launches, donor, cohort_wall = counts, be, build + run
    if res["kernels"] != res["twins"]:
        raise AssertionError(f"{tag}: kernels cohort != twins cohort")
    solo_wall = 0.0
    for c, want in zip(CFG_BATCH, res["kernels"]):
        t0 = time.time()
        r = TorchExplorer(load_model(spec, c), device=DEVICE,
                          host_seen=True, chunk=CHUNK_HS,
                          progress_every=1e9).run()
        torch.cuda.synchronize()
        w = time.time() - t0
        solo_wall += w
        got = _summary(r) + (tuple(r.warnings),)
        log(f"[{tag}] solo {os.path.basename(c)}: {w:.3f}s (build and "
            f"run), distinct {r.distinct}; == cohort member: {got == want}")
        if got != want:
            raise AssertionError(f"{tag}: {c} solo != cohort member")
    log(f"[{tag}] cohort wall {cohort_wall:.3f}s against the sum of the "
        f"solo walls {solo_wall:.3f}s (ratio "
        f"{solo_wall / max(cohort_wall, 1e-9):.2f}x, not gated)")
    row = check_batch_epilogue(donor, launches["batch_epilogue"], tag)
    # batchtoy: a violation in one member, card against CPU
    bt = os.path.join(SPECS, "batchtoy.tla")
    cfgs = [os.path.join(SPECS, f"batchtoy_{v}.cfg")
            for v in ("a", "b", "c", "d", "bad")]
    out = {}
    for dev in (DEVICE, "cpu"):
        be, members, _b, _r, counts, _p = _cohort(cfgs, bt, False, dev)
        out[dev] = [_summary(m.result) + (tuple(m.result.warnings),)
                    for m in members]
        if dev == DEVICE and counts["batch_epilogue"] <= 0:
            raise AssertionError(f"{tag}: batchtoy cohort without K10")
    bad = out[DEVICE][-1]
    log(f"[{tag}] batchtoy cohort: bad member {bad[4]} {bad[5]}, trace "
        f"{bad[6].count('State ') if bad[6] else 0} states; cuda == cpu: "
        f"{out[DEVICE] == out['cpu']}")
    if out[DEVICE] != out["cpu"] or bad[4] != "invariant":
        raise AssertionError(f"{tag}: batchtoy cohort differs")
    return row


def check_batch_epilogue(be, launches, tag):
    """K10 against its twin and against torch.nonzero + index_select, bit
    for bit and timed, at the dispatch with the most valid candidates
    (its inputs rebuilt from the kept stacked chunk)."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    disp = be.dispatcher
    donor = be.members[0].engine
    _n, (frontier_p, fc) = be.busiest
    en, aok, ov, keys, cand, povf, inv, exp = donor._hstep_cands(
        frontier_p, fc, disp._cvecs)
    fct = torch.as_tensor(fc, dtype=torch.int32, device=en.device)
    args = (en, aok, ov, fct, keys, cand, povf, OV_PACK, inv, exp)
    k = ops.batch_epilogue(*args)
    t = ops.batch_epilogue_twin(*args)
    torch.cuda.synchronize()
    nv = int(t["offsets"][-1])
    names = ("idx", "fps", "rows", "inv_ok", "explore")
    err = max(_max_abs(k["scalars"], t["scalars"]),
              _max_abs(k["dead"], t["dead"]),
              _max_abs(k["offsets"], t["offsets"]),
              max(_max_abs(k[n][:nv], t[n][:nv]) for n in names))
    B, A, CH = en.shape
    C, PW = A * CH, cand.shape[1]
    fv = torch.arange(CH, device=en.device)[None, :] < fct[:, None]

    def library():
        idx = torch.nonzero((en & fv[:, None, :]).reshape(-1)).flatten()
        return (keys.index_select(0, idx), cand.index_select(0, idx),
                inv.index_select(0, idx), exp.index_select(0, idx))
    lib = library()
    if _max_abs(lib[1], k["rows"][:nv]) or \
            _max_abs(lib[0][:, 1:], k["fps"][:nv]):
        raise AssertionError("nonzero + index_select yardstick disagrees")
    # the inputs (about 55 MB) outgrow the 50 MB L2 only just, so every
    # time of this row is taken with L2 written over before each call;
    # the warm device time is printed beside it
    dev_ms = device_ms(lambda: ops.batch_epilogue(*args), "batch_",
                       flush=True)
    warm_ms = device_ms(lambda: ops.batch_epilogue(*args), "batch_")
    live = sum(fc)          # the frontier slots below each member's count
    return _row(
        tag, "batch_epilogue@msgstoy3", "jaxmc_torch/kernels/csrc/batch.cu",
        "jaxmc/backend/batch.py:99", launches, err,
        cuda_time(lambda: ops.batch_epilogue(*args), flush=True),
        cuda_time(lambda: ops.batch_epilogue_twin(*args), reps=3,
                  flush=True),
        # en, aok and ov of the live slots' candidates and their dead
        # flags; the valid candidates' four fingerprint words, row words
        # and two predicate bits read and written compacted with their
        # index; the scalars and the offsets written; the counts and
        # flags of the members read
        live * A * 6 + live + nv * (16 + PW * 4 + 2) * 2 + nv * 4
        + B * 53 + (B + 1) * 8,
        live * A * 8 + nv * (7 + PW),
        library_ms=cuda_time(library, flush=True),
        note=f" [B={B} A={A} CH={CH} fcount={fc} valid={nv} PW={PW}; "
             f"3 launches; L2 flushed before each call; device time "
             f"{dev_ms:.4f} ms, warm {warm_ms:.4f} ms]")


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
    phase_torch_bounds(eng, got)
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

    counts, captured, res_result = phase_resident(
        "14 resident", "transfer_scaled.tla", CFG_4P, counts_4p)
    resident_bound(res_result, N_INIT_4P)
    table += check_resident(captured, counts)
    del captured
    no_keys = tuple(k for k in RES_KERNELS if k != "keys_of")
    phase_resident("15 res reduce", "symtoy_scaled.tla", CFG_SYM, PINS_SYM,
                   twins=False, need=no_keys + ("canon_rows",
                                                "keys_of_canon"))
    phase_resident("15 res reduce", "msgstoy.tla", CFG_POR, PINS_POR,
                   POR_PINS, twins=False, por=True,
                   need=RES_KERNELS + ("seen_probe_por", "por_mask"))
    phase_resident_verdicts()
    phase_tiers(counts_4p)
    table.append(phase_props())
    table.append(phase_batch())
    log(f"[done] {time.time() - t_start:.1f}s")
    print(f"{smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
