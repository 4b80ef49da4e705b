#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the fifteen
hand-written kernels (K1-K14, K18), the generated transition kernels
of every engine (K15-K17: CUDA C++ that compile/cgen.py writes per
model) and the native fingerprint store, holds each kernel against its
plain PyTorch twin at the shapes the engines give it, times both, and
checks models end to end through the port's entry points: the level
engine, the chunked host-seen engine, the resident
engine, the out-of-core seen tiers, temporal and refinement PROPERTYs,
cross-model batching, checkpoints, resume and drain, the full-sort
level step, the telemetry artifacts, the profiler and the backend
oracle, the sharded mesh engine with its multi-process runner, the
session stages and the CLI's other subcommands, the corpus sweep, and
the mesh scaling bench with its phase probe.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases (any failure raises; the exit code is then not 0):
  1 device     card name, count, `nvidia-smi` name and power limit
  2 build      nvcc each kernel for sm_90a; print its ptxas line; g++
               the native host fingerprint store; the generated sources
               of transfer_scaled and its 4-process model (one nvcc per
               engine): units, bytes, nvcc wall, ptxas lines
  3 kernels    capture the widest level's inputs of transfer_scaled on
               the card; each kernel against its twin, bit-exact; times;
               K15 gen_expand against the emitter over the widest
               level's frontier block; K18 sort_keys on the widest
               merge's candidate keys and on their fp128 keys (rows
               "sort_keys", "sort_keys_fp128") and its front_order site
               on the widest next-frontier order (row "front_order"),
               beside the torch.sort chain and torch.sort(key4)
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
               model's widest level (rows named "...@4p", K15 and K18
               among them)
  8 symmetry   symtoy_scaled with 4 processes, MaxTurns 60 (fixtures/
               symtoy_scaled_4p.cfg, 23 permutations) on kernels and
               twins, counts equal to the reference's; K5 canon_rows and
               K2's canonical branch against their twins and timed at the
               widest level; K5 on random rows of the symkinds layout
               (every container kind of the canonicaliser; W 138 takes
               blocks of 32 rows) and again with blocks of 3 rows (a
               smaller shared memory budget); K15 against the emitter
               at the widest frontier (row "gen_expand@sym"); K18 on
               the widest merge's keys (row "sort_keys@sym")
  9 view       viewtoy_scaled at N 512 (fixtures/viewtoy_scaled_big.cfg)
               on kernels and twins, counts equal to the formula's pins;
               K2's view branch against its twin and timed; K16 (the
               invariant) and K17 (the VIEW) against the emitter on the
               largest blocks they were given (rows "gen_pred@view",
               "gen_value@view"); K18 on the widest merge's keys (row
               "sort_keys@view")
 10 por        msgstoy with 4 processes, T 10 (fixtures/msgstoy_
               scaled.cfg) with --por on kernels and twins: counts and
               por.* counters equal to the reference's; K6 por_mask and
               the POR site of K3 against their twins and timed at the
               widest level; K15 against the emitter at the widest
               frontier (row "gen_expand@por"); portoy (deadlock) and
               portoy_bad (invariant) with --por on the card equal to
               the CPU run
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
               runs on the kernels, the live cfg's excepted, alone
               after the pool; card runs equal the CPU run; K8's edge site launched on the level
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
               K15 against the emitter at the cohort's largest call
               (a member table whose members share tiles; row
               "gen_expand@cohort"); the batchtoy_{a,b,c,d,bad} cohort
               on the card equal to the CPU
 19 durability transfer_scaled with a checkpoint at every level, killed
               by JAXMC_FAULTS=run_kill:level=5 in a CLI subprocess, then
               resumed on the card and, from its `.host` snapshot, in
               ParallelExplorer: the pins; the snapshot's wall per
               state.  The 4-process model with --no-trace on the level
               and resident engines, transfer_scaled (3 processes) on
               the host-seen engine (chunk 65,536): truncated at half
               its distinct states and resumed, and a CLI subprocess
               drained by SIGTERM (exit 143, the resume hint) and
               resumed, each to its pins; the resident
               engine's completed checkpoint replayed with no kernel
               launch; each engine's checkpoint write wall and file size
 20 full sort  the 4-process model with JAXMC_LEVEL_RANKMERGE=0 on the
               kernels (K11 and K18 launched, K4 not) and on the twins:
               phase 7's counts, wall, peak memory; at its widest level
               K18 on the seen table and candidates (60,817,408 rows,
               row "sort_keys@fullsort") and K11
               against its twin, bit-exact, timed by events and device
               time with L2 written over before each call, beside its
               byte bound and torch.nonzero + index_select, and the
               whole full-sort step against the rank step (row
               "fullsort_dedup@4p")
 21 obs        `python -m jaxmc_torch.backend.oracle --smoke` (verdict
               gpu); transfer_scaled through the CLI with --backend auto
               --metrics-out --trace --profile: the pins, the oracle's
               gpu verdict, the artifact and every trace line valid
               (obs/schema.py), bfs.level_step dispatched once a level,
               the HBM model at most the allocator's peak (ratio
               printed), the card's name and power limit in the env
               block; the same run without --profile: equal counts,
               stdout and trace; the 4-process model profiled: each
               site's dispatches, wall and share of the search wall, the
               dominant site, model against measured memory; `obs report`
               and `obs top`; --profile=xla's torch.profiler trace; K12
               oracle_probe launched twice and K18 36 times in each gpu
               probe process (the counts the probe reports, from --smoke
               and from the profiled auto run, whose counts are the
               rows'); K18 on the probe's keys (row "sort_keys@oracle")
               and K12 held
               against its twin, bit-exact, timed with L2 written over
               before each call beside its bound and searchsorted +
               index_copy_ + two sums (row "oracle_probe")
 22 mesh       the mesh engine (MeshExplorer) with D = 4 shards on the
               card: transfer_scaled_4p on the a2a exchange and the rank
               merge to phase 7's pins, every mesh kernel launched (K1-K4,
               K8 at the mesh_block, mesh_vc and mesh_front sites, K13
               mesh_route, K14 mesh_scalars); wall, generated states/s,
               peak memory, mesh.a2a_max_bucket and mesh.shard_balance;
               then at its widest level K13 against its twin, bit-exact,
               in the receive layout and as the send layout plus its
               transposed copy, beside its byte bound and a stable
               torch.sort + index_copy_ + transpose (row
               "mesh_route@4p"), and K14 against its twin beside sum /
               amax / amin (row "mesh_scalars@4p"); the same model on
               the gather exchange (row "mesh_route_gather@4p", beside
               torch.where) and at D = 2 with JAXMC_MESH_RANKMERGE=0 (K11
               per shard); msgstoy_scaled --por at D = 4 to the level
               engine's pins and por.* counters, and msgstoy at T 5 with
               --por on the card equal to the CPU; pcal_intro_buggy at
               D = 2, card equal to CPU with its trace; the mesh_skew
               fault on transfer_scaled (every state on shard 0, a second
               run sized into the spill window: spills, exact counts); a
               truncation checkpoint and resume of the 4-process model at
               D = 4; the multi-process runner (backend/multihost.py) at
               world size 1 on NCCL to transfer_scaled's pins
 23 session    the 4-process model through CheckSession's stages on the
               card (parse, analyze, compile, explore, and explore again
               on the built engine: no nvcc build, equal counts and
               launches), through the CLI with --analyze warn
               --metrics-out (the stage spans in the artifact), `info`,
               `simulate`, and an --analyze strict refusal on linttoy
               that builds and launches nothing
 24 sweep      `python -m jaxmc_torch sweep --backend jax` in this process
               (JAXMC_SWEEP_INPROC=1) on the card: every non-slow
               repo-local corpus case passes with the manifest's pins and
               mode pins, each with compiled instances launching K15;
               the cases that need the reference corpus skip with its
               reason where it is absent
 25 meshbench  `python -m jaxmc_torch.meshbench bench` on the 4-process
               model at D = 1, 2, 4 shards on the card (a child process
               each): the timed run's gates (no nvcc build in the window,
               host_syncs <= levels) and counts equal to phase 7's, then
               the phase probe (B.12d): the expand, exchange, rank merge
               and full-sort merge walls over four levels, beside K13's
               and the merges' launches; the jaxmc.multichip/1 artifact
               goes to chiprun_out/meshbench_4p.json
Every kernel run of every phase launches K15 (gen_expand) and no twin
run does: the generated kernels are held against the emitter end to
end, on every engine.  Before the last lines, one "[gen]" line per
generated source built in this process: nvcc wall, registers, spills.
The last three lines are the `nvidia-smi` name and power limit, the
kernel table as JSON and {"ok": true, "device": {...}}.

Each kernel's bound is its compulsory traffic over the card's memory
rate, or its integer operations over the INT32 rate, whichever is
larger: each input the function needs read once, each output written
once, counted from this run's data (K2 reads only the valid rows, K3
and K4 only the live prefix of the seen table).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
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
MAIN_KERNELS = ("unpack_rows", "keys_of", "sort_keys", "seen_probe",
                "rank_merge", "front_order", "gen_expand", "gen_pred")
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
HS_KERNELS = ("unpack_rows", "keys_of", "hstep_epilogue", "gen_expand")
HS_ABSENT = ("seen_probe", "seen_probe_por", "rank_merge", "por_mask",
             "sort_keys", "front_order")
# the resident phases' chunk, and the kernels a resident search launches
CHUNK_RES = 65536
RES_KERNELS = ("unpack_rows", "keys_of", "sort_keys", "seen_probe",
               "rank_merge", "resident_compact", "resident_compact_explore",
               "resident_fold", "gen_expand")
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
# phase 19: each engine's keywords and CLI flags at the phases' chunks,
# and the gitignored directory its checkpoints go to (removed after)
ENGINE_KW = {"level": {}, "host_seen": dict(host_seen=True, chunk=CHUNK_HS),
             "resident": dict(resident=True, chunk=CHUNK_RES)}
ENGINE_FLAGS = {"level": [],
                "host_seen": ["--host-seen", "--chunk", str(CHUNK_HS)],
                "resident": ["--resident", "--chunk", str(CHUNK_RES)]}
DURABLE = os.path.join(ROOT, "jaxmc_torch", "kernels", "_build", "durable")
# phase 21: the artifacts and traces of its CLI runs (removed after)
OBS_DIR = os.path.join(ROOT, "jaxmc_torch", "kernels", "_build", "obs")
# phase 22: the shards of the mesh runs, the kernels a mesh search on the
# a2a exchange and the rank merge launches, and the gitignored directory
# of its checkpoint and cfg (removed after)
MESH_D = 4
MESH_KERNELS = ("unpack_rows", "keys_of", "sort_keys", "seen_probe",
                "rank_merge", "resident_compact_mesh_block",
                "resident_compact_mesh_vc",
                "resident_compact_mesh_front", "mesh_route", "mesh_scalars",
                "gen_expand")
MESH_DIR = os.path.join(ROOT, "jaxmc_torch", "kernels", "_build", "mesh")


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


# K15-K17: the generated transition kernels (compile/cgen.py writes one
# CUDA C++ source per engine; nvcc builds it when the engine is built)
GEN_SRC = "jaxmc_torch/compile/cgen.py"
GEN_REPLACES = {"gen_expand": "jaxmc/compile/kernel2.py:2464",
                "gen_pred": "jaxmc/compile/kernel2.py:2792",
                "gen_value": "jaxmc/compile/kernel2.py:2762"}


def _gen_note(gm) -> str:
    nv = gm.info.get("nvcc_s")
    return (f"{len(gm.units)} units, {len(gm.source)} bytes, nvcc "
            + (f"{nv:.2f}s" if nv is not None else "already built"))


def phase_build_gen():
    """The generated sources of transfer_scaled and its 4-process model,
    each built by one nvcc when its engine is built: wall, size and the
    ptxas lines (registers, stack, spills) of the three kernels."""
    for cfg in (os.path.join(SPECS, "transfer_scaled.cfg"), CFG_4P):
        t0 = time.time()
        eng = _engine(cfg, store_trace=False, progress_every=1e9)
        gm = eng._gen
        log(f"[2 build] generated {os.path.basename(cfg)} (A={eng.A} "
            f"W={eng.W}): {_gen_note(gm)}; engine build "
            f"{time.time() - t0:.2f}s "
            f"({os.path.relpath(gm.info['dir'], ROOT)})")
        for ln in gm.info["ptxas"]:
            log(f"[2 build]   {ln}")


def gen_summary():
    """Every generated source this process built or loaded: nvcc wall
    and the registers and spill bytes of its kernels."""
    from jaxmc_torch.kernels import build
    for dig, info in sorted(build.GEN_INFO.items()):
        regs = [int(x) for ln in info["ptxas"]
                for x in re.findall(r"Used (\d+) registers", ln)]
        spills = [int(x) for ln in info["ptxas"]
                  for x in re.findall(r"(\d+) bytes spill stores", ln)]
        nv = info["nvcc_s"]
        log(f"[gen] {dig}: nvcc "
            + (f"{nv:.2f}s" if nv is not None else "already built")
            + f", registers {regs}, spill stores {spills} bytes")


# The bound of K15-K17 is their bytes: the operations of a unit's graph
# are no floor, since nvcc folds much of them (K16's range test over a
# constant 512-member interval runs in a fraction of its graph's count)
def check_gen_expand(eng, rows, launches, tag, name="gen_expand"):
    """K15 against its twin (the emitter loop of _expand) on `rows`."""
    return check_gen_call(eng._gen, rows, eng._gen_units(rows.device),
                          eng._gen_cvals(), launches, tag, name)


@contextlib.contextmanager
def keeping_largest(box):
    """While on, the K15 and K5 calls the engines make keep their inputs
    (clones) in `box`, the largest call of each: A * N for K15 ("gen":
    gm, rows, units, cv), valid rows for K5 ("canon": rows, valid,
    canon).  The calls themselves run as before."""
    from jaxmc_torch.kernels import ops
    gen, canon = ops.gen_expand, ops.canon_rows

    def gen2(gm, rows, units, cvals=None):
        n = units.shape[0] * rows.shape[0]
        if n > box.get("gen_n", -1):
            box["gen_n"] = n
            box["gen"] = dict(gm=gm, rows=rows.clone(), units=units.clone(),
                              cv=None if cvals is None else cvals.clone())
        return gen(gm, rows, units, cvals)

    def canon2(rows, valid, c):
        n = int(valid.sum())
        if n > box.get("canon_n", -1):
            box["canon_n"] = n
            box["canon"] = dict(rows=rows.clone(), valid=valid.clone(),
                                canon=c)
        return canon(rows, valid, c)
    ops.gen_expand, ops.canon_rows = gen2, canon2
    try:
        yield box
    finally:
        ops.gen_expand, ops.canon_rows = gen, canon


def check_gen_call(gm, rows, units, cv, launches, tag, name):
    """K15 against its twin on one call's inputs, bit-exact, timed with
    L2 written over before each call, beside its bound: the rows read
    once, en/aok/ov/succ of every instance written once."""
    from jaxmc_torch.compile import cgen
    from jaxmc_torch.kernels import ops
    k = ops.gen_expand(gm, rows, units, cv)
    t = ops.gen_expand_twin(gm, rows, units, cv)
    torch.cuda.synchronize()
    N, W, A = rows.shape[0], gm.W, units.shape[0]
    T = gm.meta["tile"]
    return _row(tag, name, GEN_SRC, GEN_REPLACES["gen_expand"], launches,
                _max_abs(list(k), list(t)),
                cuda_time(lambda: ops.gen_expand(gm, rows, units, cv),
                          flush=True),
                cuda_time(lambda: ops.gen_expand_twin(gm, rows, units, cv),
                          reps=3, warm=1),
                N * W * 4 + A * N * (2 + 4 + W * 4), 0,
                note=f" [N={N} A={A} W={W}; tile {T} rows, "
                     f"{ops.gen_groups(A, -(-N // T)) if T else A} "
                     f"instances a block, {cgen.tile_bytes(W, T)} bytes of "
                     f"shared memory; {_gen_note(gm)}]")


def check_gen_pred_value(eng, got, counts, tag, suffix):
    """K16 (the first invariant) and K17 (the VIEW) against their twins
    on the largest blocks the run gave them, bit-exact and timed."""
    from jaxmc_torch.kernels import ops
    gm = eng._gen
    cv = eng._gen_cvals()
    rows_out = []
    W = eng.W
    rows = got["pred"][0]
    N = rows.shape[0]
    k = ops.gen_pred(gm, 0, rows, cv)
    t = ops.gen_pred_twin(gm, 0, rows, cv)
    torch.cuda.synchronize()
    rows_out.append(_row(
        tag, "gen_pred" + suffix, GEN_SRC, GEN_REPLACES["gen_pred"],
        counts["gen_pred"], _max_abs(k, t),
        cuda_time(lambda: ops.gen_pred(gm, 0, rows, cv), flush=True),
        cuda_time(lambda: ops.gen_pred_twin(gm, 0, rows, cv), reps=3,
                  warm=1),
        N * W * 4 + N, 0,
        note=f" [N={N} W={W}; {gm.preds[0].label}]"))
    rows = got["value"][0]
    N = rows.shape[0]
    k = ops.gen_value(gm, rows, cv)
    t = ops.gen_value_twin(gm, rows, cv)
    torch.cuda.synchronize()
    rows_out.append(_row(
        tag, "gen_value" + suffix, GEN_SRC, GEN_REPLACES["gen_value"],
        counts["gen_value"], _max_abs(k, t),
        cuda_time(lambda: ops.gen_value(gm, rows, cv), flush=True),
        cuda_time(lambda: ops.gen_value_twin(gm, rows, cv), reps=3,
                  warm=1),
        N * W * 4 + N * gm.VW * 4, 0,
        note=f" [N={N} W={W} VW={gm.VW}]"))
    return rows_out


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

        def _front_order(self, explore, prov, FC):
            # the widest block, and in it the most explored rows
            n = (explore.numel(), int(explore.sum()))
            if n > got.get("front_n", (-1, -1)):
                got["front_n"] = n
                got["front"] = (explore.clone(), prov.clone(), FC)
            return super()._front_order(explore, prov, FC)

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
        dev_ms = device_ms(lambda: ops.keys_of(rows, valid, pt, fp, False),
                           "keys_of_kernel")
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
               note=f" [N={N} valid={nv} K={K}; 1 launch, "
                    f"{_device_note(dev_ms)}]")

    # K3 seen_probe (on the sorted candidate keys, as rank_merge calls it)
    seen, seen_count, keys = got["merge"]
    N, K = keys.shape
    SC = seen.shape[0]
    skeys, sidx = ops.sort_keys(keys)
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
    # the launch's device time alone (the event time also holds the
    # wrapper's host work when that is the longer)
    dev_ms = device_ms(lambda: ops.seen_probe(seen, seen_count, skeys),
                       "seen_probe")
    record("seen_probe", "jaxmc_torch/kernels/csrc/probe.cu",
           "jaxmc/backend/bfs.py:142", _max_abs(list(k), list(t)),
           cuda_time(lambda: ops.seen_probe(seen, seen_count, skeys)),
           cuda_time(lambda: ops.seen_probe_twin(seen, seen_count, skeys),
                     reps=3),
           # the K-1 data words of the live seen rows and of the
           # queries; found and lb written
           (seen_count + N) * (K - 1) * 4 + N * 5,
           N * probes * (K - 1) * 2, library_ms=lib_ms,
           note=f" [N={N} seen_count={seen_count} SC={SC} K={K}; 1 launch, "
                f"{_device_note(dev_ms)}]")

    # K4 merge_sorted on the sorted keys and their probe; the whole
    # rank_merge (K18 + K3 + K4) is timed beside it for reference
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
    dev_ms = device_ms(lambda: ops.merge_sorted(seen, seen_count, skeys,
                                                sidx, found, lb), "merge_")
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
                f"new={new}; 2 launches, {_device_note(dev_ms)}; "
                f"whole rank_merge (K18 + K3 + K4) {whole_ms:.4f} ms]")

    # K18 on the merge's candidate keys, and (at transfer_scaled) on the
    # fp128 keys of the same candidate block; its front_order site
    rows_out.append(check_sort(keys, 0, tag, "sort_keys" + suffix))
    if not suffix:
        rows, valid = got["keys"]
        kf = ops.keys_of(rows, valid, pt, True, False)[0]
        rows_out.append(check_sort(kf, 0, tag, "sort_keys_fp128"))
        del kf
    explore, prov, FC = got["front"]
    rows_out.append(check_front_order(explore, prov, eng.A, FC, 0, tag,
                                      "front_order" + suffix))

    # K15 gen_expand over the widest level's frontier block (B.1)
    _seen, _sc, frontier_p, _fc = got["step"]
    rows_out.append(check_gen_expand(eng, eng._unpack(frontier_p), 0, tag,
                                     "gen_expand" + suffix))
    return rows_out


def _peak_of(fn):
    """The call's allocation above what was live before it, in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def check_sort(keys, launches, tag, name):
    """K18 on `keys` twice in a row, each call bit for bit against its
    twin; timed by events (L2 written over before each call) and device
    time, beside its byte bound (each key word read once, the sorted
    words and indices written once), the twin and the torch.sort chain
    that the port ran before K18 (lsd_sort and one gather); each call's
    memory above the live tensors."""
    from jaxmc_torch.kernels import ops
    N, K = keys.shape
    want = ops.sort_keys_twin(keys)
    ks = [ops.sort_keys(keys) for _ in range(2)]
    torch.cuda.synchronize()
    err = max(_max_abs(list(k), list(want)) for k in ks)
    del ks, want

    def chain():
        perm = ops.lsd_sort(keys)
        return keys[perm].contiguous(), perm.to(torch.int32)
    if _max_abs(list(chain()), list(ops.sort_keys(keys))):
        raise AssertionError(f"{name}: the torch.sort chain disagrees")
    # K18's tail key: the last row's
    tail = int((keys == keys[-1]).all(dim=1).sum()) if N else 0
    big = N * K > 1 << 26
    dev_ms = device_ms(lambda: ops.sort_keys(keys), "sort_", flush=True)
    peak, peak_chain = _peak_of(lambda: ops.sort_keys(keys)), \
        _peak_of(chain)
    return _row(
        tag, name, "jaxmc_torch/kernels/csrc/sort.cu",
        "jaxmc/backend/bfs.py:178", launches, err,
        cuda_time(lambda: ops.sort_keys(keys), reps=5 if big else 20,
                  flush=True),
        cuda_time(lambda: ops.sort_keys_twin(keys), reps=2, warm=1,
                  flush=True),
        N * (2 * K + 1) * 4, 0,
        library_ms=cuda_time(chain, reps=3 if big else 10, warm=1,
                             flush=True),
        note=f" [N={N} K={K} tail rows {tail}; {4 * K + 2} launches a "
             f"call, bit-equal to the twin twice in a row; L2 flushed "
             f"before each call; {_device_note(dev_ms)}; memory a call "
             f"{peak / 2**20:.1f} MiB, the chain's {peak_chain / 2**20:.1f} "
             f"MiB; library: the torch.sort chain]")


def check_front_order(explore, prov, A, FC, launches, tag, name):
    """K18's front_order site on the level step's explore flags and
    provenance, twice in a row against its twin, timed beside its byte
    bound (the flags and provenance read, the order written), the twin
    and torch.sort(key4, stable=True) on a key built outside the timed
    calls."""
    from jaxmc_torch.kernels import ops
    C = explore.shape[0]
    want = ops.front_order_twin(explore, prov, A, FC)
    ks = [ops.front_order(explore, prov, A, FC) for _ in range(2)]
    torch.cuda.synchronize()
    err = max(_max_abs(k, want) for k in ks)
    fmaj = (prov % FC) * max(A, 1) + torch.div(prov, FC,
                                               rounding_mode="floor")
    key4 = (~explore).to(torch.int64) * (1 << 40) + fmaj

    def library():
        return torch.sort(key4, stable=True).indices
    if _max_abs(library(), want):
        raise AssertionError(f"{name}: torch.sort(key4) disagrees")
    b = max(C - 1, 0).bit_length()
    dev_ms = device_ms(lambda: ops.front_order(explore, prov, A, FC),
                       "sort_", flush=True)
    return _row(
        tag, name, "jaxmc_torch/kernels/csrc/sort.cu",
        "jaxmc/backend/bfs.py:1879", launches, err,
        cuda_time(lambda: ops.front_order(explore, prov, A, FC),
                  flush=True),
        cuda_time(lambda: ops.front_order_twin(explore, prov, A, FC),
                  reps=3, flush=True),
        C * 13, 0, library_ms=cuda_time(library, flush=True),
        note=f" [C={C} A={A} FC={FC} explored {int(explore.sum())}, "
             f"provenance > 0 {int((prov != 0).sum())}; {b // 8 + 3} "
             f"launches a call "
             f"(b = {b}); L2 flushed before each call; "
             f"{_device_note(dev_ms)}; library: torch.sort(key4)]")


def phase_torch_bounds(eng, got, tag="7 bounds"):
    """The whole level step (B.7: reads the packed frontier and the live
    seen prefix, writes the merged table and the next frontier with its
    provenance) timed at the widest level beside its byte bound; its
    expand is K15 since B.1 has its kernel.  Printed, not in the kernel
    table."""
    seen, seen_count, frontier_p, fcount = got["step"]
    FC, PW = frontier_p.shape
    K = eng.K
    SC = seen.shape[0]
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
    from jaxmc_torch import obs
    cfg = CFG_4P
    out = {}
    for kind, twins in (("kernels", False), ("twins", True)):
        # a recording telemetry, whose level records give the widest
        # frontier (the process-wide default records nothing)
        tel = obs.reset()
        eng, r, wall, counts, peak = run_counted(
            lambda: _engine(cfg, store_trace=False, twins=twins,
                            progress_every=1e9))
        if kind == "kernels":
            widest = max(lv["frontier"] for lv in tel.levels)
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
        if kind == "kernels" and (counts["gen_expand"] <= 0
                                  or counts["gen_pred"] <= 0):
            raise AssertionError(f"kernel run without K15/K16: {counts}")
    if out["kernels"] != out["twins"]:
        raise AssertionError(f"kernels {out['kernels']} != twins "
                             f"{out['twins']}")
    log(f"[7 real size] kernel path == twin path: {out['kernels']}")
    return out["kernels"], launches


# ---------------------------------------------------------------------------
# phases 8-10: SYMMETRY, VIEW and --por
# ---------------------------------------------------------------------------

def capturing_engine(spec, cfg, **kw):
    """A TorchExplorer that keeps, for each of K5, K2, K3+K6 and K18, the
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

        def _rank_merge(self, seen, seen_count, keys):
            keep("merge", int((keys[:, 0] == 0).sum()), keys)
            return super()._rank_merge(seen, seen_count, keys)

        def _expand(self, frontier):
            keep("expand", frontier.shape[0], frontier)
            return super()._expand(frontier)

    eng = Capture(load_model(os.path.join(SPECS, spec), cfg), device=DEVICE,
                  **kw)
    # the largest blocks the first invariant and the VIEW are given
    if eng.inv_fns:
        nm0, f0 = eng.inv_fns[0]

        def pred(rows, f0=f0):
            keep("pred", rows.shape[0], rows)
            return f0(rows)
        eng.inv_fns = [(nm0, pred)] + list(eng.inv_fns[1:])
    if eng.view_fn is not None:
        v0 = eng.view_fn

        def view(rows):
            keep("value", rows.shape[0], rows)
            return v0(rows)
        eng.view_fn = view
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
    T = ops.canon_geometry(prog)[0]
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
                     f"program {len(prog)} words; blocks of {T} rows]")]
    rows, valid = got["keys"]
    N, nv = rows.shape[0], int(valid.sum())
    crows = ops.canon_rows(rows, valid, canon)
    args = (rows, valid, pt, eng.fp_mode, eng.plan.identity)
    kw = dict(basis=crows, basis_packed=True)
    k = ops.keys_of(*args, **kw)
    t = ops.keys_of_twin(*args, **kw)
    torch.cuda.synchronize()
    dev_ms = device_ms(lambda: ops.keys_of(*args, **kw), "keys_of_kernel")
    out.append(_row(
        tag, "keys_of_canon", "jaxmc_torch/kernels/csrc/keys.cu",
        "jaxmc/backend/bfs.py:1621", counts["keys_of_canon"],
        _max_abs(list(k), list(t)),
        cuda_time(lambda: ops.keys_of(*args, **kw)),
        cuda_time(lambda: ops.keys_of_twin(*args, **kw), reps=3),
        # validity, the valid raw and canonical rows; keys and packed
        # rows of every row
        N + 2 * nv * W * 4 + N * (PW + K) * 4, 2 * nv * W * 6,
        note=f" [N={N} valid={nv} K={K}; 1 launch, "
             f"{_device_note(dev_ms)}]"))
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
    want = ops.canon_rows_twin(r, v, kc)
    keep = ops.CANON_SMEM
    for budget in (keep, 8192):
        ops.CANON_SMEM = budget
        try:
            T, staged, smem = ops.canon_geometry(kc.program)
            err = _max_abs(ops.canon_rows(r, v, kc), want)
        finally:
            ops.CANON_SMEM = keep
        log(f"[{tag}] canon_rows on the symkinds layout (seq, growset, "
            f"union, pfcn, kvtable; W={lay.width}, {kc.n_perms} "
            f"permutations), 200,000 random rows, blocks of {T} rows, "
            f"program {'staged' if staged else 'in device memory'}, "
            f"{smem} bytes of shared memory: max_abs_err {err}")
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
    dev_ms = device_ms(lambda: ops.keys_of(*args, **kw), "keys_of_kernel")
    return [_row(
        tag, "keys_of_view", "jaxmc_torch/kernels/csrc/keys.cu",
        "jaxmc/backend/bfs.py:1608", counts["keys_of_view"],
        _max_abs(list(k), list(t)),
        cuda_time(lambda: ops.keys_of(*args, **kw)),
        cuda_time(lambda: ops.keys_of_twin(*args, **kw), reps=3),
        N + nv * (W + Vw) * 4 + N * (PW + K) * 4, nv * (W * 6 + Vw),
        note=f" [N={N} valid={nv} view lanes {Vw} K={K}; 1 launch, "
             f"{_device_note(dev_ms)}]")]


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
    dev_ms = device_ms(lambda: ops.seen_probe(seen, seen_count, ckeys,
                                              site="por"), "seen_probe")
    out = [_row(tag, "seen_probe_por", "jaxmc_torch/kernels/csrc/probe.cu",
                "jaxmc/backend/bfs.py:199", counts["seen_probe_por"],
                _max_abs(list(fk), list(ft)),
                cuda_time(lambda: ops.seen_probe(seen, seen_count, ckeys,
                                                 site="por")),
                cuda_time(lambda: ops.seen_probe_twin(seen, seen_count,
                                                      ckeys), reps=3),
                (seen_count + C) * (K - 1) * 4 + C * 5,
                C * probes * (K - 1) * 2, library_ms=lib_ms,
                note=f" [C={C} seen_count={seen_count} K={K}, unsorted; "
                     f"1 launch, {_device_note(dev_ms)}]")]
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
    """A host-seen TorchExplorer that counts its chunk steps
    (`chunk_steps`); with `capture` (a dict) it keeps the K7 inputs of
    the chunk with the most valid candidates (this reads each chunk's
    count back, so only the twin run captures)."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    class Counting(TorchExplorer):
        chunk_steps = 0

        def _hstep(self, frontier_p, fcount):
            self.chunk_steps += 1
            return super()._hstep(frontier_p, fcount)

        def _epilogue(self, en, aok, ov, fcount, keys, cand, pack_ovf,
                      inv_ok, explore):
            if capture is not None:
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

    return Counting(load_model(os.path.join(SPECS, spec), cfg),
                    device=DEVICE, host_seen=True, chunk=CHUNK_HS,
                    store_trace=False, progress_every=1e9, **kw)


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
            # K7 is one launch a chunk step
            if counts["hstep_epilogue"] != eng.chunk_steps:
                raise AssertionError(
                    f"{tag}: hstep_epilogue launched "
                    f"{counts['hstep_epilogue']} times in "
                    f"{eng.chunk_steps} chunk steps")
            log(f"[{tag}] hstep_epilogue: {counts['hstep_epilogue']} "
                f"launches, one a chunk step")
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
    # the launch's device time alone, from the profiler: the event time
    # also holds the wrapper's host work when that is the longer of the
    # two
    dev_ms = device_ms(lambda: ops.hstep_epilogue(*args), "hstep_kernel")
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
             f"1 launch, {_device_note(dev_ms)}]")


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
    keeps the inputs of K8 (both sites), K9 and K18 at the chunk and
    level with the most valid candidates (this reads counts back, so
    only the twin run captures)."""
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

        def _sort_keys(self, keys):
            keep("sort", int((keys[:, 0] == 0).sum()), keys)
            return super()._sort_keys(keys)

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


def k8_twice(call, twin):
    """K8 called twice in a row against its twin: the largest difference
    over the whole idx[:cap] and the six scalars of either call; the two
    calls must also agree with each other bit for bit."""
    outs = [call() for _ in range(2)]
    torch.cuda.synchronize()
    if _max_abs(outs[0], outs[1]):
        raise AssertionError("resident_compact: two calls on the same "
                             "inputs differ")
    return max(_max_abs(o[0], twin[0]) + _max_abs(o[1], twin[1])
               for o in outs)


def check_resident(captured, launches, tag="14 resident"):
    """K8 at both sites, K9 and K18 against their twins, bit for bit, on
    the captured inputs; timed beside the twins, their byte bounds and,
    for K8, torch.nonzero doing the same capped compaction (K18: the
    torch.sort chain)."""
    from jaxmc_torch.compile.kernel2 import OV_PACK
    from jaxmc_torch.kernels import ops
    rows = []
    for site in ("chunk", "explore"):
        mask, cap, flim, aok, ov = captured["k8_" + site]
        kw = {} if site == "chunk" else {"site": "explore"}
        t = ops.resident_compact_twin(mask, cap, flim, aok, ov)
        err = k8_twice(lambda: ops.resident_compact(mask, cap, flim, aok, ov,
                                                    **kw), t)
        k = ops.resident_compact(mask, cap, flim, aok, ov, **kw)
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
                           "res_compact")
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
                 f"cap={cap}; 2 launches a call (pass, unset tail), "
                 f"device time {dev_ms:.4f} ms; idx[:cap] and the scalars "
                 f"equal the twin's in two calls in a row]"))
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
    rows.append(check_sort(captured["sort"][0], launches["sort_keys"], tag,
                           "sort_keys@res"))
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
    cores), then the level-engine run on the kernels of each cfg but
    the live one alone in this process, so that its wall and its host
    checker's share are the run's own (the live cfg's, 40-50 s alone,
    runs in the pool to keep the script inside its time); then K8's
    edge site timed here."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    alone = [(p, False, "kernels") for p in PROP_ORDER if p != "live"]
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
    t = ops.resident_compact_twin(mask, cap)
    err = k8_twice(lambda: ops.resident_compact(mask, cap, site="edges"), t)
    k = ops.resident_compact(mask, cap, site="edges")

    def library():
        return torch.nonzero(mask).flatten()
    if _max_abs(library(), k[0][:n]):
        raise AssertionError("torch.nonzero yardstick disagrees")
    dev_ms = device_ms(lambda: ops.resident_compact(mask, cap,
                                                    site="edges"),
                       "res_compact")
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
        note=f" [C={C} edges={n}; 2 launches a call (pass, unset tail), "
             f"device time {dev_ms:.4f} ms; launches summed over the four "
             f"level-engine kernel runs; idx[:cap] and the scalars equal "
             f"the twin's in two calls in a row]")


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
    box = {}
    for kind, twins in (("kernels", False), ("twins", True)):
        with keeping_largest(box if not twins else {}):
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
            if counts["batch_epilogue"] <= 0 or counts["hstep_epilogue"] \
                    or counts["gen_expand"] <= 0:
                raise AssertionError(f"{tag}: K10 or K15 not launched or "
                                     f"K7 launched: {counts}")
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
    g = box["gen"]
    if g["cv"] is None or g["cv"].shape[0] < 2:
        raise AssertionError(f"{tag}: the cohort's largest K15 call bound "
                             f"no member table")
    gen_row = check_gen_call(g["gm"], g["rows"], g["units"], g["cv"],
                             launches["gen_expand"], tag,
                             "gen_expand@cohort")
    log(f"[{tag}] gen_expand@cohort: {g['cv'].shape[0]} members' "
        f"constants over {g['rows'].shape[0]} rows")
    # batchtoy: a violation in one member, card against CPU
    bt = os.path.join(SPECS, "batchtoy.tla")
    cfgs = [os.path.join(SPECS, f"batchtoy_{v}.cfg")
            for v in ("a", "b", "c", "d", "bad")]
    out = {}
    for dev in (DEVICE, "cpu"):
        be, members, _b, _r, counts, _p = _cohort(cfgs, bt, False, dev)
        out[dev] = [_summary(m.result) + (tuple(m.result.warnings),)
                    for m in members]
        if dev == DEVICE and (counts["batch_epilogue"] <= 0
                              or counts["gen_expand"] <= 0):
            raise AssertionError(f"{tag}: batchtoy cohort without K10 "
                                 f"or K15")
    bad = out[DEVICE][-1]
    log(f"[{tag}] batchtoy cohort: bad member {bad[4]} {bad[5]}, trace "
        f"{bad[6].count('State ') if bad[6] else 0} states; cuda == cpu: "
        f"{out[DEVICE] == out['cpu']}")
    if out[DEVICE] != out["cpu"] or bad[4] != "invariant":
        raise AssertionError(f"{tag}: batchtoy cohort differs")
    return [row, gen_row]


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


# ---------------------------------------------------------------------------
# phase 19: checkpoints, resume and drain
# ---------------------------------------------------------------------------

def durable_engine(spec, cfg, engine, stats, **kw):
    """A TorchExplorer on `engine` ("level", "host_seen" or "resident",
    at the phases' chunks) that records each checkpoint's write wall
    and file size, and each `.host` snapshot's wall and states, in
    `stats`."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.session import load_model

    class Timed(TorchExplorer):
        def _write_ck(self, mode, **state):
            t0 = time.time()
            super()._write_ck(mode, **state)
            stats.setdefault("ck", []).append(
                (time.time() - t0, os.path.getsize(self.checkpoint_path)))

        def _write_host_snapshot(self, trace_levels, frontier_maps, graph,
                                 depth, generated):
            t0 = time.time()
            super()._write_host_snapshot(trace_levels, frontier_maps, graph,
                                         depth, generated)
            n = sum(len(m) for m in frontier_maps) if frontier_maps else 0
            stats.setdefault("snap", []).append((time.time() - t0, n))

    kw = dict(ENGINE_KW[engine], **kw)
    kw.setdefault("progress_every", 1e9)
    return Timed(load_model(os.path.join(SPECS, spec), cfg), device=DEVICE,
                 **kw)


def _cli(args, env=None, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "jaxmc_torch", "check"] + args, cwd=ROOT,
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, **kw)


def _ck_note(stats):
    cks = stats.get("ck", [])
    if not cks:
        return "no checkpoint written"
    walls = [w for w, _ in cks]
    return (f"{len(cks)} checkpoint writes, wall max {max(walls):.3f}s "
            f"mean {sum(walls) / len(walls):.3f}s, last file "
            f"{cks[-1][1] / 2**20:.1f} MiB (largest "
            f"{max(s for _, s in cks) / 2**20:.1f} MiB)")


def phase_durability(pins_4p, tag="19 durability"):
    """transfer_scaled traced and killed by run_kill at level 5, resumed
    on the card and, from its `.host` snapshot, in ParallelExplorer; then
    the 4-process model (--no-trace) on each engine: a truncation at
    half its distinct states resumed, a SIGTERM drain of a CLI
    subprocess (exit 143) resumed, and on the resident engine a
    completed checkpoint replayed with no kernel launch.  The host-seen
    engine's legs run the 3-process model (cut in depth for time)."""
    import signal
    from jaxmc_torch import drain
    from jaxmc_torch.engine.ckpt import load_checkpoint
    from jaxmc_torch.engine.parallel import ParallelExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    if os.path.exists(DURABLE):
        shutil.rmtree(DURABLE)
    os.makedirs(DURABLE)
    try:
        # transfer_scaled, traced, a checkpoint at every level boundary,
        # SIGKILLed entering level 5
        ck = os.path.join(DURABLE, "ts.ck")
        fdir = os.path.join(DURABLE, "faults")
        os.makedirs(fdir)
        t0 = time.time()
        p = _cli([os.path.join(SPECS, "transfer_scaled.tla"), "--checkpoint",
                  ck, "--checkpoint-every", "0", "--quiet"],
                 env={"JAXMC_FAULTS": "run_kill:level=5",
                      "JAXMC_FAULTS_STATE": fdir})
        out, err = p.communicate(timeout=600)
        depth = load_checkpoint(ck, kind="device")[1]["depth"]
        log(f"[{tag}] transfer_scaled run_kill:level=5: exit "
            f"{p.returncode} after {time.time() - t0:.1f}s; last "
            f"checkpoint at depth {depth}; {os.path.getsize(ck)} bytes, "
            f".host {os.path.getsize(ck + '.host')} bytes")
        if p.returncode != -signal.SIGKILL or depth != 5:
            raise AssertionError(f"{tag}: run_kill gave exit "
                                 f"{p.returncode}, depth {depth}: {err}")
        t0 = time.time()
        r = durable_engine("transfer_scaled.tla", None, "level", {},
                           resume_from=ck).run()
        torch.cuda.synchronize()
        log(f"[{tag}] resumed on the card: distinct {r.distinct} generated "
            f"{r.generated} diameter {r.diameter} in "
            f"{time.time() - t0:.3f}s")
        if (r.distinct, r.generated, r.diameter) != PINS or not r.ok:
            raise AssertionError(f"{tag}: card resume != {PINS}")
        # one `.host` snapshot, timed: a drain at level 7 writes the
        # checkpoint and the snapshot once
        stats = {}

        def drain_at_7(line):
            if line.startswith("Progress(7)"):
                drain.request("phase 19")
        try:
            r = durable_engine("transfer_scaled.tla", None, "level", stats,
                               checkpoint_path=ck + ".7", progress_every=0.0,
                               log=drain_at_7).run()
        finally:
            drain.clear()
        (w, n), = stats["snap"]
        log(f"[{tag}] transfer_scaled drained at level 7 "
            f"(drained={r.drained}): {_ck_note(stats)}; host snapshot of "
            f"{n} states in {w:.3f}s, {w / n * 1e6:.1f} us a state")
        if not r.drained:
            raise AssertionError(f"{tag}: the level-7 drain did not stop "
                                 f"the run")
        t0 = time.time()
        r = ParallelExplorer(load_model(os.path.join(
            SPECS, "transfer_scaled.tla")), workers=PROP_WORKERS,
            resume_from=ck + ".host").run()
        log(f"[{tag}] .host snapshot resumed in ParallelExplorer "
            f"({PROP_WORKERS} workers): distinct {r.distinct} generated "
            f"{r.generated} diameter {r.diameter} in "
            f"{time.time() - t0:.3f}s")
        if (r.distinct, r.generated, r.diameter) != PINS or not r.ok:
            raise AssertionError(f"{tag}: host snapshot resume != {PINS}")

        for engine in ("level", "host_seen", "resident"):
            # the host-seen leg runs the 3-process model: the native
            # store's single-threaded insert made its four 4-process
            # runs about 50 s of this phase (cut in depth to keep the
            # script inside 600 s with phase 21)
            cfg, pins = (None, PINS) if engine == "host_seen" \
                else (CFG_4P, pins_4p)
            model = "3" if cfg is None else "4"
            half = pins[0] // 2
            ck = os.path.join(DURABLE, f"{engine}.ck")
            stats = {}
            t0 = time.time()
            r1 = durable_engine(
                "transfer_scaled.tla", cfg, engine, stats,
                store_trace=False, max_states=half, checkpoint_path=ck,
                checkpoint_every=0.0).run()
            torch.cuda.synchronize()
            w1 = time.time() - t0
            fin = ck + ".final"
            t0 = time.time()
            r2 = durable_engine(
                "transfer_scaled.tla", cfg, engine, {},
                store_trace=False, resume_from=ck, checkpoint_path=fin,
                final_checkpoint=True).run()
            torch.cuda.synchronize()
            w2 = time.time() - t0
            got = (r2.distinct, r2.generated, r2.diameter)
            log(f"[{tag}] {model} processes {engine}: truncated at "
                f"{r1.distinct} distinct in {w1:.3f}s ({_ck_note(stats)}); "
                f"resumed to {got} in {w2:.3f}s")
            if not r1.truncated or got != pins or not r2.ok:
                raise AssertionError(f"{tag}: {engine} resume {got} != "
                                     f"{pins}")
            # SIGTERM a CLI run at a level boundary: exit 143, resume hint
            ck2 = os.path.join(DURABLE, f"{engine}.drain.ck")
            t0 = time.time()
            p = _cli([os.path.join(SPECS, "transfer_scaled.tla")]
                     + (["--cfg", cfg] if cfg else [])
                     + ["--no-trace", "--checkpoint", ck2,
                        "--progress-every", "0"] + ENGINE_FLAGS[engine])
            try:
                for line in p.stdout:
                    if line.startswith("Progress(3)"):
                        p.send_signal(signal.SIGTERM)
                        break
                out, err = p.communicate(timeout=600)
            finally:
                if p.poll() is None:
                    p.kill()
            hint = f"resume with --resume {ck2}"
            log(f"[{tag}] {model} processes {engine}: SIGTERM at "
                f"Progress(3): "
                f"exit {p.returncode} after {time.time() - t0:.1f}s; "
                f"{err.strip().splitlines()[-1] if err.strip() else ''}")
            if p.returncode != 143 or hint not in err:
                raise AssertionError(f"{tag}: {engine} drain exit "
                                     f"{p.returncode}: {err}")
            stats = {}
            r3 = durable_engine("transfer_scaled.tla", cfg, engine,
                                stats, store_trace=False,
                                resume_from=ck2).run()
            got = (r3.distinct, r3.generated, r3.diameter)
            log(f"[{tag}] {model} processes {engine}: drained run resumed "
                f"to {got}")
            if got != pins or not r3.ok:
                raise AssertionError(f"{tag}: {engine} drain resume {got}")
            if engine == "resident":
                eng = durable_engine("transfer_scaled.tla", CFG_4P, engine,
                                     {}, store_trace=False,
                                     resume_from=fin)
                torch.cuda.synchronize()
                ops.reset_launches()
                r4 = eng.run()
                torch.cuda.synchronize()
                n = sum(ops.LAUNCHES.values())
                log(f"[{tag}] 4 processes resident: completed checkpoint "
                    f"replayed to {(r4.distinct, r4.generated, r4.diameter)}"
                    f" with {n} kernel launches")
                if n or (r4.distinct, r4.generated, r4.diameter) != pins_4p:
                    raise AssertionError(f"{tag}: completed resident "
                                         f"replay launched {n} kernels")
    finally:
        shutil.rmtree(DURABLE, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 20: the full-sort level step (JAXMC_LEVEL_RANKMERGE=0)
# ---------------------------------------------------------------------------

def phase_full_sort(pins_4p, tag="20 full sort"):
    """The 4-process model with JAXMC_LEVEL_RANKMERGE=0 on the kernels
    (K11 and K18 launched, K4 not) and on the twins, counts equal to
    phase 7's; then, at its widest level, K18 on the seen table and the
    candidates and K11 on its output, each against its twin, timed with
    L2 written over before each call, beside its byte bound and the
    library sequence, and the whole full-sort step against the rank
    step.  Returns K11's and K18's table rows."""
    from jaxmc_torch.backend.bfs import TorchExplorer
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.session import load_model
    got = {}

    class Capture(TorchExplorer):
        def level_step(self, seen, seen_count, frontier_p, fcount):
            if fcount > got.get("step_n", -1):
                got["step_n"] = fcount
                got["step"] = (seen.clone(), seen_count, frontier_p.clone(),
                               fcount)
            return super().level_step(seen, seen_count, frontier_p, fcount)

    os.environ["JAXMC_LEVEL_RANKMERGE"] = "0"
    try:
        res = {}
        for kind, twins in (("kernels", False), ("twins", True)):
            cls = TorchExplorer if twins else Capture
            eng, r, wall, counts, peak = run_counted(
                lambda cls=cls, twins=twins: cls(
                    load_model(os.path.join(SPECS, "transfer_scaled.tla"),
                               CFG_4P), device=DEVICE, store_trace=False,
                    twins=twins, progress_every=1e9))
            res[kind] = (r.ok, r.distinct, r.generated, r.diameter)
            log(f"[{tag}] {kind}: ok={r.ok} distinct {r.distinct} "
                f"generated {r.generated} diameter {r.diameter}; wall "
                f"{wall:.3f}s, {r.generated / wall:.0f} generated states/s; "
                f"peak {peak / 2**30:.2f} GiB; launches {counts}")
            if (r.distinct, r.generated, r.diameter) != pins_4p or not r.ok:
                raise AssertionError(f"{tag}: {kind} counts != {pins_4p}")
            if twins and any(counts.values()):
                raise AssertionError(f"{tag}: twin run launched kernels")
            if not twins:
                if min(counts[k] for k in ("fullsort_dedup", "gen_expand",
                                           "sort_keys", "front_order")) \
                        <= 0 or counts["rank_merge"]:
                    raise AssertionError(f"{tag}: K11, K15 or K18 not "
                                         f"launched or K4 launched: "
                                         f"{counts}")
                launches, keng = counts["fullsort_dedup"], eng
                sort_launches = counts["sort_keys"]
        # the widest level: the step's merge inputs rebuilt as _full_sort
        # builds them
        seen, seen_count, frontier_p, fcount = got["step"]
        out = keng.level_step(seen, seen_count, frontier_p, fcount)
        step_full = cuda_time(lambda: keng.level_step(
            seen, seen_count, frontier_p, fcount), reps=3, warm=1)
        os.environ["JAXMC_LEVEL_RANKMERGE"] = "1"
        out_r = keng.level_step(seen, seen_count, frontier_p, fcount)
        step_rank = cuda_time(lambda: keng.level_step(
            seen, seen_count, frontier_p, fcount), reps=3, warm=1)
        if _max_abs(out["scalars"], out_r["scalars"]):
            raise AssertionError(f"{tag}: full-sort step scalars differ "
                                 f"from the rank step's")
        del out, out_r
        frontier = keng._unpack(frontier_p)
        en, aok, ov, succ = keng._expand(frontier)
        FC = frontier_p.shape[0]
        valid = (en & (torch.arange(FC, device=en.device) <
                       fcount)[None, :]).reshape(-1)
        C = valid.shape[0]
        cand_u = torch.where(valid[:, None], succ.reshape(C, keng.W),
                             torch.full_like(succ.reshape(C, keng.W),
                                             2**31 - 1))
        keys, _cand, _ovf = keng._keys_of(cand_u, valid)
        del en, aok, ov, succ, cand_u, _cand
        SC, K = seen.shape
        allk = torch.cat([seen, keys])
        allk[seen_count:SC, 0] = 2**31 - 1
        sort_row = check_sort(allk, sort_launches, tag, "sort_keys@fullsort")
        skeys, perm = ops.sort_keys(allk)
        sflag = (perm >= SC).to(torch.int32)
        del allk, keys
        N = SC + C
        args = (skeys, sflag, perm, SC, C)
        t = ops.fullsort_dedup_twin(*args)
        n_new, n_keep = int(t[2][0]), int(t[2][1])

        def prefixes(o):
            return o[2], o[0][:n_new], o[1][:n_keep]
        # twice in a row: each call equal to the twin and to the other
        ks = [ops.fullsort_dedup(*args) for _ in range(2)]
        torch.cuda.synchronize()
        if _max_abs(prefixes(ks[0]), prefixes(ks[1])):
            raise AssertionError("fullsort_dedup: two calls on the same "
                                 "inputs differ")
        err = max(_max_abs(prefixes(k), prefixes(t)) for k in ks)
        k = ks[1]
        # the library sequence: torch.nonzero of both masks, two
        # index_select (the masks, a few elementwise ops, are made
        # outside the timed calls)
        rvalid = skeys[:, 0] == 0
        neq = torch.ones(N, dtype=torch.bool, device=skeys.device)
        neq[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
        new = (sflag != 0) & rvalid & neq
        keep = ((sflag == 0) & rvalid) | new

        def library():
            inew = torch.nonzero(new).flatten()
            ikeep = torch.nonzero(keep).flatten()
            return (perm.index_select(0, inew) - SC,
                    skeys.index_select(0, ikeep))
        lib = library()
        if _max_abs(lib[0], k[0][:n_new]) or \
                _max_abs(lib[1], k[1][:n_keep]):
            raise AssertionError("nonzero + index_select yardstick "
                                 "disagrees")
        dev_ms = device_ms(lambda: ops.fullsort_dedup(*args),
                           "fullsort_pass", flush=True)
        peak = torch.cuda.max_memory_allocated()
        row = _row(
            tag, "fullsort_dedup@4p", "jaxmc_torch/kernels/csrc/fullsort.cu",
            "jaxmc/backend/bfs.py:1820", launches, err,
            cuda_time(lambda: ops.fullsort_dedup(*args), reps=5,
                      flush=True),
            cuda_time(lambda: ops.fullsort_dedup_twin(*args), reps=2,
                      warm=1, flush=True),
            # every sorted key row and flag read once; perm read and the
            # index written for the new rows; the kept rows written; the
            # counts written
            N * (K + 1) * 4 + n_new * 8 + n_keep * K * 4 + 16,
            N * (2 * K + 4),
            library_ms=cuda_time(library, reps=5, flush=True),
            note=f" [N={N} SC={SC} C={C} K={K} seen_count={seen_count} "
                 f"new={n_new} kept={n_keep}; 1 launch a call, the "
                 f"prefixes and counts equal the twin's in two calls in a "
                 f"row; L2 flushed "
                 f"before each call; device time {dev_ms:.4f} ms; whole "
                 f"step full sort {step_full:.2f} ms, rank "
                 f"{step_rank:.2f} ms; peak {peak / 2**30:.2f} GiB]")
        return [row, sort_row]
    finally:
        os.environ.pop("JAXMC_LEVEL_RANKMERGE", None)


# ---------------------------------------------------------------------------
# phase 21: device observability, the backend layer and K12
# ---------------------------------------------------------------------------

def _obs_events(path):
    """A trace's events without times, walls, process identity or the
    watchdog's beats, the log lines' seconds masked: what profiling
    must not change."""
    import re
    skip = {"t", "t0", "wall_s", "mono", "pid", "argv", "psid",
            "parent_span", "tid", "env", "meta", "rss_bytes"}
    out = []
    with open(path) as fh:
        for ln in fh:
            e = json.loads(ln)
            if e["ev"] in ("heartbeat", "stall"):
                continue
            e = {k: v for k, v in e.items() if k not in skip}
            if "msg" in e:
                e["msg"] = re.sub(r"[0-9.]+s\)$", "<t>)", e["msg"])
                e["msg"] = re.sub(r"ETA [0-9.]+[smh]", "ETA <t>", e["msg"])
            out.append(e)
    return out


def _obs_runs(runs, tag):
    """CLI subprocesses with JAXMC_LEDGER=off, run side by side:
    {name: args} -> {name: (stdout lines, wall)}.  Each must exit 0."""
    t0 = time.time()
    procs = {k: _cli(a, env={"JAXMC_LEDGER": "off"})
             for k, a in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"{tag} {k}: exit {p.returncode}\n"
                                     f"{so[-2000:]}\n{se[-2000:]}")
            out[k] = (so.splitlines(), time.time() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def phase_obs(smi, tag="21 obs"):
    """The observability layer and the backend layer through the CLI:
    a transfer_scaled run under --backend auto with --metrics-out,
    --trace and --profile (the pins, the oracle's gpu verdict, the
    artifact and every trace line valid, bfs.level_step dispatched once
    a level, the HBM model under the allocator's peak, the card in the
    env block), the same run without --profile (same counts and trace),
    the 4-process model profiled (the per-site table), `report` and
    `top`, --profile=xla's trace directory, the oracle's --smoke, and
    K18 and K12 on the probe's keys against their twins: bit-exact,
    timed with L2 written over before each call, beside their bounds
    and library sequences.  Returns K12's and K18's table rows."""
    import io
    from jaxmc_torch.backend import oracle
    from jaxmc_torch.kernels import ops
    from jaxmc_torch.obs.prof import attribution
    from jaxmc_torch.obs.report import main as obs_main
    from jaxmc_torch.obs.schema import validate_summary, validate_trace_event
    t_phase = time.time()
    d = OBS_DIR
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        # the oracle on its own: the gpu probe live and chosen in time
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m",
                            "jaxmc_torch.backend.oracle", "--smoke"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120, env=dict(os.environ,
                                                 JAXMC_LEDGER="off"))
        for ln in p.stdout.splitlines():
            log(f"[{tag}] {ln}")
        if p.returncode != 0 or "ORACLE verdict gpu" not in p.stdout:
            raise AssertionError(f"{tag}: oracle --smoke exit "
                                 f"{p.returncode}: {p.stderr[-1000:]}")
        # K12's and K18's launches, as the gpu probe's own process
        # counted them: two probe calls, 4 * 4 + 2 K18 launches each
        smoke_launches = [
            tuple(int(x) for x in m.groups()) for m in (
                re.search(r" launches=(\d+) sort_launches=(\d+)", ln)
                for ln in p.stdout.splitlines()
                if ln.startswith("ORACLE gpu live")) if m]
        if smoke_launches != [(2, 36)]:
            raise AssertionError(f"{tag}: the --smoke gpu probe launched "
                                 f"(K12, K18) {smoke_launches} times, not "
                                 f"[(2, 36)]")
        log(f"[{tag}] oracle --smoke {time.time() - t0:.1f}s")

        # the profiled run alone, so its site walls share the card with
        # nothing; then the plain and --profile=xla runs side by side
        # (their counts and traces do not depend on the walls)
        spec = os.path.join(SPECS, "transfer_scaled.tla")
        mx = os.path.join(d, "xla.json")
        auto = {kind: [spec, "--backend", "auto", "--metrics-out",
                       os.path.join(d, f"{kind}.json"), "--trace",
                       os.path.join(d, f"{kind}.jsonl")] + extra
                for kind, extra in (("profiled", ["--profile"]),
                                    ("plain", []))}
        cli = _obs_runs({"profiled": auto["profiled"]}, tag)
        cli |= _obs_runs({"plain": auto["plain"],
                          "xla": [os.path.join(SPECS, "constoy.tla"),
                                  "--backend", "gpu", "--profile=xla",
                                  "--metrics-out", mx]}, tag)
        runs = {}
        for kind in ("profiled", "plain"):
            m, t = os.path.join(d, f"{kind}.json"), \
                os.path.join(d, f"{kind}.jsonl")
            out, wall = cli[kind]
            with open(m) as fh:
                summ = json.load(fh)
            runs[kind] = (out, summ, _obs_events(t))
            res = summ["result"]
            got = (res["distinct"], res["generated"], res["diameter"])
            choice = summ["gauges"].get("backend.oracle_choice")
            log(f"[{tag}] {kind}: {got}, oracle {choice} "
                f"({summ['gauges'].get('backend.oracle_wall_s')}s), "
                f"{wall:.1f}s; {out[0]}")
            if got != PINS or not res["ok"]:
                raise AssertionError(f"{tag}: {kind} counts {got} != {PINS}")
            if choice != "gpu" or not out[0].startswith(
                    "-- backend oracle: gpu"):
                raise AssertionError(f"{tag}: {kind} oracle verdict "
                                     f"{choice}, not gpu")
            validate_summary(summ, check_run=True)
            with open(t) as fh:
                for ln in fh:
                    validate_trace_event(json.loads(ln))
        out, summ, evs = runs["profiled"]
        prof = summ["prof"]
        disp = prof["sites"]["bfs.level_step"]["dispatches"]
        if prof["mode"] != "wall" or disp != len(summ["levels"]):
            raise AssertionError(f"{tag}: bfs.level_step {disp} "
                                 f"dispatches, {len(summ['levels'])} levels")
        hbm = prof["hbm"]
        if hbm["peak_bytes"] > hbm["measured_peak_bytes"]:
            raise AssertionError(f"{tag}: HBM model {hbm} above the "
                                 f"measured peak")
        env = summ["env"]
        name, limit = (x.strip() for x in smi.rsplit(",", 1))
        if (env.get("gpu_name"), env.get("gpu_power_limit"),
                env.get("platform")) != (name, limit, "gpu"):
            raise AssertionError(f"{tag}: env block {env} does not name "
                                 f"the card ({smi})")
        log(f"[{tag}] profiled: {disp} level steps for "
            f"{len(summ['levels'])} levels; HBM model peak "
            f"{hbm['peak_bytes']} B, measured {hbm['measured_peak_bytes']} "
            f"B, ratio {hbm['peak_bytes'] / hbm['measured_peak_bytes']:.4f}"
            f"; env {env.get('gpu_name')}, {env.get('gpu_power_limit')}")
        p_out, p_summ, p_evs = runs["plain"]
        strip = [ln for ln in out if "states/sec" not in ln
                 and not ln.startswith("-- backend oracle")]
        if strip != [ln for ln in p_out if "states/sec" not in ln
                     and not ln.startswith("-- backend oracle")] \
                or evs != p_evs or [
                    {k: v for k, v in r.items() if k != "wall_s"}
                    for r in summ["levels"]] != [
                    {k: v for k, v in r.items() if k != "wall_s"}
                    for r in p_summ["levels"]]:
            raise AssertionError(f"{tag}: profile on and off differ")
        log(f"[{tag}] profile off: the same counts, {len(evs)} trace "
            f"events equal, stdout equal")
        for cmd in ("report", "top"):
            buf = io.StringIO()
            rc = obs_main([cmd, os.path.join(d, "profiled.json")], out=buf)
            if rc != 0:
                raise AssertionError(f"{tag}: obs {cmd} exit {rc}")
            for ln in buf.getvalue().splitlines()[:24]:
                log(f"[{tag}] {cmd}| {ln}")

        # the 4-process model profiled: the per-site attribution
        m4 = os.path.join(d, "4p.json")
        out, wall = _obs_runs({"4p": [spec, "--cfg", CFG_4P, "--profile",
                                      "--metrics-out", m4]}, tag)["4p"]
        with open(m4) as fh:
            s4 = json.load(fh)
        att = attribution(s4)
        search = att["search_wall_s"]
        for n, st in sorted(s4["prof"]["sites"].items(),
                            key=lambda kv: -kv[1].get("wall_s", 0)):
            log(f"[{tag}] 4p site {n}: {st['dispatches']} dispatches, "
                f"wall {st.get('wall_s', 0):.4f}s, "
                f"{100 * st.get('wall_s', 0) / search:.1f}% of the search "
                f"wall {search:.4f}s, arg {st.get('arg_bytes', 0)} B, res "
                f"{st.get('res_bytes', 0)} B, builds {st['recompiles']}")
        dom = max(s4["prof"]["sites"].items(),
                  key=lambda kv: kv[1].get("wall_s", 0))
        h4 = s4["prof"]["hbm"]
        log(f"[{tag}] 4p: {s4['result']['distinct']} / "
            f"{s4['result']['generated']} / {s4['result']['diameter']}, "
            f"{wall:.1f}s; dominant site {dom[0]}; attributed "
            f"{att['share']}; phases "
            + ", ".join(f"{ph['name']} {ph['wall_s']:.3f}s"
                        for ph in s4["phases"])
            + f"; HBM model peak {h4['peak_bytes']} B against measured "
            f"{h4['measured_peak_bytes']} B "
            f"({h4['peak_bytes'] / h4['measured_peak_bytes']:.4f}); "
            f"buffers {h4['buffers']}")
        if h4["peak_bytes"] > h4["measured_peak_bytes"]:
            raise AssertionError(f"{tag}: 4p HBM model above measured")

        # --profile=xla: a torch.profiler chrome trace
        with open(mx) as fh:
            xdir = json.load(fh)["prof"].get("xla_trace_dir")
        files = os.listdir(xdir) if xdir and os.path.isdir(xdir) else []
        size = sum(os.path.getsize(os.path.join(xdir, f)) for f in files)
        log(f"[{tag}] --profile=xla: {xdir} holds {files}, {size} B")
        if not size:
            raise AssertionError(f"{tag}: --profile=xla left no trace")

        # K12's launches on the main path: the gpu probe process of the
        # profiled `--backend auto` run counted them
        gpu = runs["profiled"][1]["gauges"]["backend.oracle_probe"]["gpu"]
        launches, sort_launches = gpu.get("launches"), \
            gpu.get("sort_launches")
        log(f"[{tag}] K12 and K18 launches in the --backend auto run's gpu "
            f"probe: {launches}, {sort_launches}; in the --smoke run's: "
            f"{smoke_launches[0]}")
        if (launches, sort_launches) != (2, 36):
            raise AssertionError(f"{tag}: the auto run's probe launched "
                                 f"(K12, K18) ({launches}, {sort_launches}) "
                                 f"times, not (2, 36)")
        # K18 and K12 against their twins, in this process, on the
        # probe's keys
        keys = oracle.probe_keys(DEVICE)
        sort_row = check_sort(keys, sort_launches, tag, "sort_keys@oracle")
        sk, perm = ops.sort_keys(keys)
        args = (sk, perm, keys)
        k = ops.oracle_probe(*args)
        tw = ops.oracle_probe_twin(*args)
        torch.cuda.synchronize()
        err = _max_abs(k, tw)
        N = keys.shape[0]
        perm64 = perm.to(torch.int64)
        col, key = sk[:, 0].contiguous(), keys[:, 0].contiguous()

        def library():
            lo = torch.searchsorted(col, key).to(torch.int32)
            out = torch.zeros_like(sk).index_copy_(0, perm64, sk)
            return out, lo, out.sum(dtype=torch.int64) + lo.sum(
                dtype=torch.int64)
        lib = library()
        if _max_abs(lib[0], k[0]) or _max_abs(lib[1], k[1]) or \
                int(ops._i32(lib[2])) != int(k[2]):
            raise AssertionError(f"{tag}: searchsorted + index_copy_ "
                                 f"yardstick disagrees with K12")
        dev_ms = device_ms(lambda: ops.oracle_probe(*args), "oracle_probe",
                           flush=True)
        row = _row(
            tag, "oracle_probe", "jaxmc_torch/kernels/csrc/oracle.cu",
            "jaxmc/backend/oracle.py:72", launches, err,
            cuda_time(lambda: ops.oracle_probe(*args), flush=True),
            cuda_time(lambda: ops.oracle_probe_twin(*args), reps=5,
                      flush=True),
            # each row's 4 sorted words, its perm entry and keys[i, 0]
            # read; its 4 words at out[perm] and lo written
            N * 44,
            # 14 search steps of about 7 integer operations and the
            # 5-word checksum, per row
            N * (14 * 7 + 5),
            library_ms=cuda_time(library, flush=True),
            note=f" [N={N}; 1 launch; L2 flushed before each call; device "
                 f"time {dev_ms:.4f} ms; phase {time.time() - t_phase:.1f}s]")
        return [row, sort_row]
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 22: the sharded mesh engine, K13 and K14
# ---------------------------------------------------------------------------

def _device_note(ms):
    """A device time for a note; the profiler gives no kernel events
    after many sessions in one process, and then it is not measured."""
    return f"device time {ms:.4f} ms" if ms else \
        "device time not measured (no kernel events from the profiler)"


def mesh_engine(spec, cfg, shards, capture=None, device=DEVICE, **kw):
    """A MeshExplorer with `shards` shards on `device`; with `capture`,
    the inputs of the level with the widest frontier are kept there
    (the arguments of _level_core, a rolled-back attempt included)."""
    from jaxmc_torch.backend.mesh import MeshExplorer
    from jaxmc_torch.session import load_model

    class Capture(MeshExplorer):
        def _level_core(self, xchg, seen, scounts, frontier, fcounts, SC,
                        FC, VC, por, need_edges):
            n = sum(fcounts)
            if n > capture.get("n", -1):
                capture.update(n=n, args=(xchg, list(seen), list(scounts),
                                          list(frontier), list(fcounts), SC,
                                          FC, VC, por, need_edges))
            return super()._level_core(xchg, seen, scounts, frontier,
                                       fcounts, SC, FC, VC, por, need_edges)

    cls = Capture if capture is not None else MeshExplorer
    kw.setdefault("progress_every", 1e9)
    return cls(load_model(os.path.join(SPECS, spec), cfg), shards=shards,
               device=device, **kw)


def _mesh_blocks(eng, args):
    """The stacked candidate block of a captured level, as _level_core
    builds it: ([D, C, K] keys, [D, C, PW] rows, [D, C] validity)."""
    _x, _seen, _sc, frontier, fcounts, _SC, FC, _VC, _por, _e = args
    D, C = eng.D, eng.A * FC
    ckeys = torch.empty((D, C, eng.K), dtype=torch.int32, device=DEVICE)
    cand = torch.empty((D, C, eng.PW), dtype=torch.int32, device=DEVICE)
    cvalid = torch.empty((D, C), dtype=torch.bool, device=DEVICE)
    for m in range(D):
        b = eng._block(frontier[m], fcounts[m])
        ckeys[m], cand[m], cvalid[m] = b["ckeys"], b["cand"], b["cvalid"]
    return ckeys, cand, cvalid


def check_mesh_route(eng, got, launches, tag):
    """K13 (a2a) at the widest level of the a2a run: against its twin,
    bit-exact; the send layout plus its transposed copy against the
    receive layout; the library sequence (a stable torch.sort by owner,
    index_copy_ into the send layout, the transpose)."""
    from jaxmc_torch.kernels import ops
    ckeys, cand, cvalid = _mesh_blocks(eng, got["args"])
    D, C, K = ckeys.shape
    PW = cand.shape[2]
    FC = got["args"][6]
    R, B, SB = eng._route_shape(C, FC)
    args = (ckeys, cand, cvalid, D, B, SB)
    k = ops.mesh_route(*args)
    t = ops.mesh_route_twin(*args)
    torch.cuda.synchronize()
    err = _max_abs(k, t)
    Pw = K + PW + 1

    def to_recv(x):
        # the all_to_all's exchange of a send layout [S, R, w] on one card
        w = x.shape[2]
        main = x[:, :D * B].reshape(D, D, B, w).transpose(0, 1)
        spill = x[:, D * B:].reshape(D, D, SB, w).transpose(0, 1)
        return torch.cat([main.reshape(D, D * B, w),
                          spill.reshape(D, D * SB, w)], dim=1)

    def send_then_transpose():
        ok, oc, osrc, _st = ops.mesh_route(*args, send=True)
        return (to_recv(ok), to_recv(oc), to_recv(osrc[:, :, None])[:, :, 0])

    st = send_then_transpose()
    err = max(err, _max_abs(st, k[:3]))
    ar = torch.arange(C, device=DEVICE)
    rows_all = torch.cat([ckeys, cand, (torch.arange(D, device=DEVICE)[:, None]
                                        * C + ar)[:, :, None].to(torch.int32)],
                         dim=2).reshape(D * C, Pw)

    def library():
        dest = torch.where(cvalid, (ckeys[:, :, 1].to(torch.int64)
                                    & 0xFFFFFFFF) % D, D)
        sdest, perm = torch.sort(dest, dim=1, stable=True)
        counts = torch.zeros((D, D + 1), dtype=torch.int64, device=DEVICE)
        counts.scatter_add_(1, dest, torch.ones_like(dest))
        excl = torch.cumsum(counts, 1) - counts
        pos = ar[None, :] - excl.gather(1, sdest)
        src = torch.arange(D, device=DEVICE)[:, None] * R
        slot = src + torch.where(pos < B, sdest * B + pos,
                                 D * B + sdest * SB + pos - B)
        keep = (sdest < D) & (pos < B + SB)
        out = torch.full((D * R, Pw), 2**31 - 1, dtype=torch.int32,
                         device=DEVICE)
        out[:, 0] = 1
        flat = (torch.arange(D, device=DEVICE)[:, None] * C + perm)[keep]
        out.index_copy_(0, slot[keep], rows_all.index_select(0, flat))
        return to_recv(out.reshape(D, R, Pw))

    lib = library()
    if _max_abs((lib[:, :, :K], lib[:, :, K:K + PW], lib[:, :, K + PW]),
                k[:3]):
        raise AssertionError("sort + index_copy_ yardstick disagrees")
    send_ms = cuda_time(send_then_transpose, reps=5, flush=True)
    dev_ms = device_ms(lambda: ops.mesh_route(*args), "route_", flush=True)
    nvalid = int(cvalid.sum())
    return _row(
        tag, "mesh_route@4p", "jaxmc_torch/kernels/csrc/mesh.cu",
        "jaxmc/backend/mesh.py:481", launches, err,
        cuda_time(lambda: ops.mesh_route(*args), reps=5, flush=True),
        cuda_time(lambda: ops.mesh_route_twin(*args), reps=2, warm=1,
                  flush=True),
        # keys, rows and validity of every candidate read once; every
        # exchanged slot written once
        D * C * (4 * (K + PW) + 1) + D * R * Pw * 4,
        # per candidate: the owner, D destination compares in each of the
        # count and scatter passes, the slot arithmetic
        D * C * (2 * D + 12),
        library_ms=cuda_time(library, reps=5, flush=True),
        note=f" [D={D} C={C} valid={nvalid} B={B} SB={SB} R={R} K={K} "
             f"PW={PW}; 4 launches, written in the receive layout; the "
             f"send layout plus its transposed copy {send_ms:.4f} ms; "
             f"{_device_note(dev_ms)}; L2 flushed before each call]")


def check_mesh_gather(eng, got, launches, tag):
    """K13 (gather) at the widest level of the gather run."""
    from jaxmc_torch.kernels import ops
    ckeys, _cand, _cv = _mesh_blocks(eng, got["args"])
    D, C, K = ckeys.shape
    allk = ckeys.reshape(D * C, K)
    N = D * C
    args = (allk, D, 0, D, False)
    k = ops.mesh_route_gather(*args)
    t = ops.mesh_route_gather_twin(*args)
    torch.cuda.synchronize()
    err = _max_abs(k, t)
    inv = torch.full((K,), 2**31 - 1, dtype=torch.int32, device=DEVICE)
    inv[0] = 1
    shard = torch.arange(D, device=DEVICE)[:, None, None]

    def library():
        v = allk[:, 0] == 0
        owner = (allk[:, 1].to(torch.int64) & 0xFFFFFFFF) % D
        mine = (v & (owner[None, :] == shard[:, :, 0]))[:, :, None]
        return torch.where(mine, allk[None], inv), v

    if _max_abs(library(), k):
        raise AssertionError("torch.where yardstick disagrees")
    dev_ms = device_ms(lambda: ops.mesh_route_gather(*args), "gather",
                       flush=True)
    return _row(
        tag, "mesh_route_gather@4p", "jaxmc_torch/kernels/csrc/mesh.cu",
        "jaxmc/backend/mesh.py:453", launches, err,
        cuda_time(lambda: ops.mesh_route_gather(*args), reps=5, flush=True),
        cuda_time(lambda: ops.mesh_route_gather_twin(*args), reps=2,
                  warm=1, flush=True),
        # the gathered keys read once, each shard's masked keys and the
        # edge validity written once
        N * K * 4 + D * N * K * 4 + N, D * N * (K + 4),
        library_ms=cuda_time(library, reps=5, flush=True),
        note=f" [D={D} N={N} K={K}; 1 launch; {_device_note(dev_ms)}; "
             f"L2 flushed before each call]")


def check_mesh_merge(eng, got, tag):
    """B.12b, one shard's merge at the a2a run's widest level (K8 at
    mesh_vc and mesh_front, K18, K3, K4, the CONSTRAINTs), on
    the kernels against the same merge on the twins: equal outputs,
    both timed, beside the merge's byte bound."""
    from jaxmc_torch.kernels import ops
    _x, seen, scounts, _f, _fc, SC, FC, VC, _p, _e = got["args"]
    ckeys, cand, cvalid = _mesh_blocks(eng, got["args"])
    D, C, K = ckeys.shape
    R, B, SB = eng._route_shape(C, FC)
    gk, gc, gs, _st = ops.mesh_route(ckeys, cand, cvalid, D, B, SB)
    del ckeys, cand, cvalid

    def merge(twins):
        eng.twins = twins
        try:
            out = eng._merge(seen[0], scounts[0], gk[0], gc[0], gs[0], SC,
                             R, VC)
        finally:
            eng.twins = False
        return [out[k] for k in ("seen2", "seen_count2", "front_rows",
                                 "front_src", "front_count", "v_need")]

    k, t = merge(False), merge(True)
    torch.cuda.synchronize()
    err = _max_abs(k, t)
    n_new = int(k[1]) - scounts[0]
    nvalid = int((gk[0][:, 0] == 0).sum())
    N = VC if VC < R else R
    bms, by = _bound(R * (K + eng.PW + 1) * 4 + scounts[0] * K * 4
                     + int(k[1]) * K * 4 + N * (eng.PW + 1) * 4, 0)
    ms = cuda_time(lambda: merge(False), reps=3, warm=1, flush=True)
    tms = cuda_time(lambda: merge(True), reps=2, warm=1, flush=True)
    log(f"[{tag}] per-shard merge (B.12b, shard 0): max_abs_err {err}, "
        f"kernels {ms:.4f} ms, twins {tms:.4f} ms, bound {bms:.4f} ms "
        f"({by}) [R={R} valid={nvalid} VC={VC} SC={SC} seen "
        f"{scounts[0]} new {n_new}]")
    if err:
        raise AssertionError(f"{tag}: the merge on the kernels differs "
                             f"from the twins")


def check_mesh_scalars(eng, got, launches, tag):
    """K14 on the partials of the a2a run's widest level."""
    from jaxmc_torch.kernels import ops
    args = got["args"]
    part = eng._level_core(*args)["part"]
    FC, SC = args[6], args[5]
    k = ops.mesh_scalars(part, FC, SC, 0)
    t = ops.mesh_scalars_twin(part, FC, SC, 0)
    torch.cuda.synchronize()
    err = _max_abs(k, t)
    D, NP = part.shape

    def library():
        return part.sum(0), part.amax(0), part.amin(0)

    dev_ms = device_ms(lambda: ops.mesh_scalars(part, FC, SC, 0), "scalars")
    NS, NA = len(ops.MESH_REDUCE), len(ops.MESH_AUX)
    return _row(
        tag, "mesh_scalars@4p", "jaxmc_torch/kernels/csrc/mesh.cu",
        "jaxmc/backend/mesh.py:1055", launches, err,
        cuda_time(lambda: ops.mesh_scalars(part, FC, SC, 0), reps=20),
        cuda_time(lambda: ops.mesh_scalars_twin(part, FC, SC, 0), reps=5),
        D * NP * 4 + (NS + D * (NA + NP)) * 4, D * NS * 2,
        library_ms=cuda_time(library, reps=20),
        note=f" [D={D} partials {NP} per shard; 1 launch, replaces about "
             f"twenty reductions and reads; {_device_note(dev_ms)}]")


def _mesh_run(tag, what, make, want, need=(), absent=()):
    """Run a mesh search with the launch counters reset just before it;
    the counts must be `want` and the `need` kernels must have run."""
    from jaxmc_torch import obs
    tel = obs.reset()
    eng, r, wall, counts, peak = run_counted(make)
    got = (r.distinct, r.generated, r.diameter)
    g = tel.gauges
    log(f"[{tag}] {what}: ok={r.ok} distinct {r.distinct} generated "
        f"{r.generated} diameter {r.diameter}; wall {wall:.3f}s, "
        f"{r.generated / wall:.0f} generated states/s; peak "
        f"{peak / 2**30:.2f} GiB; mesh.a2a_max_bucket "
        f"{g.get('mesh.a2a_max_bucket')} mesh.shard_balance "
        f"{g.get('mesh.shard_balance')} mesh.a2a_spill "
        f"{g.get('mesh.a2a_spill')} gamma {g.get('mesh.a2a_gamma')}; "
        f"host_syncs {tel.counters.get('mesh.host_syncs')} over "
        f"{len(tel.levels)} level records; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if want is not None and (got != want or not r.ok):
        raise AssertionError(f"{tag} {what}: {got} != {want}")
    missing = [k for k in need if counts[k] <= 0]
    if missing or any(counts[k] for k in absent):
        raise AssertionError(f"{tag} {what}: kernels not launched "
                             f"{missing} or launched {absent}: {counts}")
    return eng, r, counts, tel


def phase_mesh(pins_4p, tag="22 mesh"):
    """The sharded mesh engine with D shards on the card.  Returns the
    K13 (both modes) and K14 table rows."""
    from jaxmc_torch import faults, obs
    from jaxmc_torch.backend.multihost import launch
    rows = []
    D = MESH_D
    # the 4-process model, a2a exchange, rank merge: K13 and K14 on the
    # main path, then both held and timed at its widest level
    got = {}
    eng, _r, counts, _tel = _mesh_run(
        tag, f"transfer_scaled_4p D={D} a2a rank",
        lambda: mesh_engine("transfer_scaled.tla", CFG_4P, D, got,
                            exchange="a2a"),
        pins_4p, need=MESH_KERNELS, absent=("mesh_route_gather",))
    rows.append(check_mesh_route(eng, got, counts["mesh_route"], tag))
    check_mesh_merge(eng, got, tag)
    rows.append(check_mesh_scalars(eng, got, counts["mesh_scalars"], tag))
    del eng, got
    got = {}
    eng, _r, counts, _tel = _mesh_run(
        tag, f"transfer_scaled_4p D={D} gather rank",
        lambda: mesh_engine("transfer_scaled.tla", CFG_4P, D, got,
                            exchange="gather"),
        pins_4p, need=("mesh_route_gather", "mesh_scalars"),
        absent=("mesh_route",))
    rows.append(check_mesh_gather(eng, got, counts["mesh_route_gather"],
                                  tag))
    del eng, got
    os.environ["JAXMC_MESH_RANKMERGE"] = "0"
    try:
        _mesh_run(tag, "transfer_scaled_4p D=2 a2a fullsort",
                  lambda: mesh_engine("transfer_scaled.tla", CFG_4P, 2,
                                      store_trace=False),
                  pins_4p, need=("fullsort_dedup", "mesh_route",
                                 "mesh_scalars"),
                  absent=("rank_merge",))
    finally:
        os.environ.pop("JAXMC_MESH_RANKMERGE", None)
    # --por: the level engine's pins (mesh POR probes the same pre-level
    # seen set), and the card equal to the port's CPU run at D shards on
    # msgstoy with T 5
    _eng, _r, _c, tel = _mesh_run(
        tag, f"msgstoy_scaled --por D={D}",
        lambda: mesh_engine("msgstoy.tla", CFG_POR, D, por=True,
                            store_trace=False),
        PINS_POR, need=("seen_probe_por", "por_mask", "mesh_route"))
    por = dict(tel.counters, **tel.gauges)
    got_por = {k: por.get(k) for k in POR_PINS}
    if got_por != POR_PINS:
        raise AssertionError(f"{tag}: por counters {got_por} != {POR_PINS}")
    os.makedirs(MESH_DIR, exist_ok=True)
    small = os.path.join(MESH_DIR, "msgstoy_t5.cfg")
    with open(CFG_POR) as fh:
        text = fh.read().replace("T = 10", "T = 5")
    with open(small, "w") as fh:
        fh.write(text)
    res = {}
    for dev in (DEVICE, "cpu"):
        tel = obs.reset()
        r = mesh_engine("msgstoy.tla", small, D, device=dev, por=True).run()
        res[dev] = (_summary(r), {k: tel.counters.get(k, tel.gauges.get(k))
                                  for k in POR_PINS})
    log(f"[{tag}] msgstoy T=5 --por D={D}: {res[DEVICE][0][1:4]} "
        f"{res[DEVICE][1]}; cuda == cpu: {res[DEVICE] == res['cpu']}")
    if res[DEVICE] != res["cpu"]:
        raise AssertionError(f"{tag}: msgstoy --por card != cpu")
    # a violation and its trace: card == CPU
    res = {dev: _summary(mesh_engine("pcal_intro_buggy.tla", None, 2,
                                     device=dev).run())
           for dev in (DEVICE, "cpu")}
    log(f"[{tag}] pcal_intro_buggy D=2: {res[DEVICE][4]} generated "
        f"{res[DEVICE][1]} distinct {res[DEVICE][2]}, trace "
        f"{res[DEVICE][6].count('State ')} states; cuda == cpu: "
        f"{res[DEVICE] == res['cpu']}")
    if res[DEVICE] != res["cpu"] or res[DEVICE][1:3] != (9040, 6135):
        raise AssertionError(f"{tag}: pcal_intro_buggy card != cpu")
    # the mesh_skew fault: every state on shard 0.  A first run measures
    # the widest destination bucket, a second pins FC and sizes gamma so
    # that bucket lands in the spill window
    cfg_ts = os.path.join(SPECS, "transfer_scaled.cfg")
    os.environ["JAXMC_FAULTS"] = "mesh_skew"
    try:
        faults.reset_for_tests()
        _e, _r, _c, tel = _mesh_run(
            tag, f"transfer_scaled mesh_skew D={D}",
            lambda: mesh_engine("transfer_scaled.tla", cfg_ts, D,
                                store_trace=False), PINS)
        lv = [(x["max_bucket"], x["fc"]) for x in tel.levels
              if x.get("max_bucket")]
        fcmax, mb = max(f for _, f in lv), max(b for b, _ in lv)
        faults.reset_for_tests()

        def skewed():
            e = mesh_engine("transfer_scaled.tla", cfg_ts, D,
                            store_trace=False,
                            mesh_caps={"SC": 1 << 18, "FC": fcmax,
                                       "TRL": 16, "GAM16": 1})
            e._a2a_gamma = (mb - 1) * D / (e.A * fcmax)
            return e
        _e, _r, _c, tel = _mesh_run(tag, f"transfer_scaled mesh_skew D={D}"
                                    f" in the spill window", skewed, PINS)
        if not tel.gauges.get("mesh.a2a_spill"):
            raise AssertionError(f"{tag}: the skewed run spilled nothing")
    finally:
        os.environ.pop("JAXMC_FAULTS", None)
        faults.reset_for_tests()
    # truncate at half the distinct states with a checkpoint, resume
    ck = os.path.join(MESH_DIR, "mesh4p.ck")
    try:
        r1 = mesh_engine("transfer_scaled.tla", CFG_4P, D, store_trace=False,
                         max_states=pins_4p[0] // 2,
                         checkpoint_path=ck).run()
        size = os.path.getsize(ck)
        _e, r2, _c, _t = _mesh_run(
            tag, f"transfer_scaled_4p D={D} resumed",
            lambda: mesh_engine("transfer_scaled.tla", CFG_4P, D,
                                store_trace=False, resume_from=ck),
            pins_4p, need=("mesh_route", "mesh_scalars"))
        log(f"[{tag}] truncated at {r1.distinct} distinct "
            f"({size / 2**20:.1f} MiB checkpoint), resumed to "
            f"{r2.distinct} / {r2.generated}")
        if not r1.truncated:
            raise AssertionError(f"{tag}: the truncated run was not")
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    # the multi-process runner, one rank on NCCL
    t0 = time.time()
    out = launch(1, ["--spec", os.path.join(SPECS, "transfer_scaled.tla"),
                     "--fc", "65536", "--sc", str(1 << 18)], timeout=300)
    want = f"MULTIHOST p0: {PINS[1]} generated / {PINS[0]} distinct"
    log(f"[{tag}] multihost world 1 (nccl): {out[0].strip()} in "
        f"{time.time() - t0:.1f}s")
    if out[0].strip().splitlines()[-1] != want:
        raise AssertionError(f"{tag}: multihost {out[0]!r} != {want!r}")
    return rows


# ---------------------------------------------------------------------------
# phases 23-25: the session stages and the CLI, the corpus sweep, the mesh
# scaling bench with its phase probe
# ---------------------------------------------------------------------------

# the artifacts of phases 23-25 (removed after, but the bench's artifact,
# which goes to the gitignored chiprun_out/)
STAGES_DIR = os.path.join(ROOT, "jaxmc_torch", "kernels", "_build", "stages")
BENCH_OUT = os.path.join(ROOT, "chiprun_out", "meshbench_4p.json")
# the stage spans of a device check's artifact, in order, under --analyze
# (the lint runs before the load)
STAGE_SPANS = ("analyze", "load", "device_init", "engine_build", "search")


def _main_captured(main, argv, env=None):
    """An entry point's main(argv) in this process: (exit code, stdout
    lines, stderr)."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, out.getvalue().splitlines(), err.getvalue()


def phase_session(pins_4p, tag="23 session"):
    """The 4-process model through CheckSession's stages on the card
    (parse, analyze, compile, explore, then explore again on the built
    engine: no nvcc build, equal counts), the same model through the
    CLI with --analyze warn --metrics-out (the stage spans in the
    artifact, the reference's schema), `info` and `simulate`, and an
    --analyze strict refusal that builds and launches nothing."""
    from jaxmc_torch import cli, obs
    from jaxmc_torch.kernels import build, ops
    from jaxmc_torch.obs.schema import validate_summary
    from jaxmc_torch.session import CheckSession, SessionConfig
    spec = os.path.join(SPECS, "transfer_scaled.tla")
    os.makedirs(STAGES_DIR, exist_ok=True)
    try:
        sess = CheckSession(SessionConfig(
            spec=spec, cfg=CFG_4P, backend="torch", analyze="warn",
            no_trace=True, progress_every=1e9), tel=obs.Telemetry())
        t0 = time.time()
        kind = sess.parse()
        diags = sess.analyze()
        t1 = time.time()
        sess.compile()
        t2 = time.time()
        walls, launches = [], []
        for _ in range(2):
            b0 = build.BUILDS
            torch.cuda.synchronize()
            ops.reset_launches()
            t3 = time.time()
            r = sess.explore()
            torch.cuda.synchronize()
            walls.append(time.time() - t3)
            launches.append({k: v for k, v in ops.LAUNCHES.items() if v})
            got = (r.distinct, r.generated, r.diameter)
            if got != pins_4p or not r.ok:
                raise AssertionError(f"{tag}: explore {got} != {pins_4p}")
            if launches[-1].get("gen_expand", 0) <= 0:
                raise AssertionError(f"{tag}: K15 not launched")
        if build.BUILDS != b0:
            raise AssertionError(f"{tag}: the warm re-run built again")
        d = sess.describe()
        log(f"[{tag}] stages on {sess.engine.device}: parse ({kind}) + "
            f"analyze ({len(diags)} diagnostics) {t1 - t0:.2f}s, compile "
            f"{t2 - t1:.2f}s (layout {d['layout_sig'][:12]}), explore "
            f"{walls[0]:.3f}s, re-explore {walls[1]:.3f}s on the built "
            f"engine; {pins_4p}; describe {d}; launches {launches[0]}")
        if (d["stage"], d["explore_count"]) != ("explore", 2) or \
                launches[0] != launches[1]:
            raise AssertionError(f"{tag}: describe {d}, launches "
                                 f"{launches}")
        del sess
        # the CLI over the same stages
        art = os.path.join(STAGES_DIR, "m.json")
        rc, out, err = _main_captured(cli.main, [
            "check", spec, "--cfg", CFG_4P, "--no-trace", "--quiet",
            "--analyze", "warn", "--metrics-out", art])
        with open(art) as fh:
            summ = json.load(fh)
        validate_summary(summ, check_run=True)
        spans = [p["name"] for p in summ["phases"]
                 if p["name"] in STAGE_SPANS]
        res = summ["result"]
        log(f"[{tag}] cli check --analyze warn --metrics-out: exit {rc}, "
            f"{out[-1] if out else ''}; spans {spans}; result "
            f"{res['distinct']}/{res['generated']}/{res['diameter']}")
        if rc != 0 or spans != list(STAGE_SPANS) or \
                (res["distinct"], res["generated"], res["diameter"]) \
                != pins_4p or summ["env"]["platform"] != \
                ("gpu" if DEVICE == "cuda" else "cpu"):
            raise AssertionError(f"{tag}: cli check {rc} {spans} {res}\n"
                                 f"{err[-2000:]}")
        rc, out, _ = _main_captured(cli.main, ["info", spec, "--cfg",
                                               CFG_4P])
        log(f"[{tag}] info: exit {rc}; " + " | ".join(
            ln.strip() for ln in out if not ln.startswith("    ")))
        if rc != 0 or not any(ln.startswith("  batch:") for ln in out) \
                or not any("independence:" in ln for ln in out):
            raise AssertionError(f"{tag}: info {rc} {out}")
        rc, out, _ = _main_captured(cli.main, [
            "simulate", os.path.join(SPECS, "pcal_intro_buggy.tla"),
            "--seed", "0"])
        rc2, out2, _ = _main_captured(cli.main, [
            "simulate", spec, "--cfg", CFG_4P, "--seed", "0"])
        log(f"[{tag}] simulate: pcal_intro_buggy exit {rc} ({out[0]}); "
            f"the 4-process model exit {rc2} ({out2[-1]})")
        if rc != 1 or "Assertion failed" not in out[0] or rc2 != 0:
            raise AssertionError(f"{tag}: simulate {rc} {rc2}")
        b0 = build.BUILDS
        ops.reset_launches()
        rc, out, err = _main_captured(cli.main, [
            "check", os.path.join(SPECS, "linttoy.tla"), "--analyze",
            "strict"])
        refused = err.strip().splitlines()[-1]
        log(f"[{tag}] --analyze strict on linttoy: exit {rc}, "
            f"{err.count('analyze: ')} diagnostics, {refused}")
        if rc != 2 or "--analyze=strict refused the run" not in refused \
                or build.BUILDS != b0 or any(ops.LAUNCHES.values()):
            raise AssertionError(f"{tag}: strict refusal {rc} {err}")
    finally:
        shutil.rmtree(STAGES_DIR, ignore_errors=True)


def phase_sweep(tag="24 sweep"):
    """`python -m jaxmc_torch sweep --backend jax` in this process
    (JAXMC_SWEEP_INPROC=1) on the card: every non-slow repo-local case
    passes, every case that needs the absent reference corpus skips
    with its reason, and every case with compiled instances launches
    K15 (the engines are built with twins=False, so no twin runs)."""
    from jaxmc_torch import cli, corpus
    from jaxmc_torch.kernels import ops
    per_case = {}
    real = corpus.run_case

    def counted(case, backend="interp", device=None):
        ops.reset_launches()
        out = real(case, backend, device)
        per_case[case.cfg or case.spec] = (
            out[0], out[3], ops.LAUNCHES["gen_expand"],
            ops.LAUNCHES["hstep_epilogue"])
        return out

    os.makedirs(STAGES_DIR, exist_ok=True)
    art = os.path.join(STAGES_DIR, "sweep.json")
    corpus.run_case = counted
    try:
        t0 = time.time()
        rc, out, err = _main_captured(
            cli.main, ["sweep", "--backend", "jax", "--metrics-out", art],
            env={"JAXMC_SWEEP_INPROC": "1"})
        wall = time.time() - t0
        with open(art) as fh:
            summ = json.load(fh)
    finally:
        corpus.run_case = real
        shutil.rmtree(STAGES_DIR, ignore_errors=True)
    for ln in out:
        if not ln.startswith("[SKIP]"):
            log(f"[{tag}] {ln}")
    log(f"[{tag}] {sum(ln.startswith('[SKIP]') for ln in out)} SKIP lines; "
        f"wall {wall:.1f}s; K15 launches per case "
        f"{ {k: v[2] for k, v in per_case.items() if v[0] == 'pass'} }")
    bad = []
    for rec in summ["cases"]:
        c = next(c for c in corpus.CASES if (c.cfg or c.spec) ==
                 rec["case"])
        st, mode, k15, _k7 = per_case[rec["case"]]
        if c.needs_reference() and not corpus.have_reference():
            ok = st == "skip" and rec["detail"] == \
                corpus.reference_missing()
        else:
            ok = st == "pass" and (mode == "interp-arms" or k15 > 0)
        if not ok:
            bad.append((rec["case"], st, mode, k15, rec["detail"]))
    if rc != 0 or bad or summ["tallies"]["fail"]:
        raise AssertionError(f"{tag}: exit {rc}, {bad}\n{err[-2000:]}")


def _probe_bounds(sh, levels):
    """Byte bounds (ms) of the probe's phases over `levels` levels at the
    shapes they ran at (mesh.probe_shapes: the run's capacities, whatever
    the probed levels' occupancy): expand reads the packed frontier and
    writes every candidate's key, row and validity; the exchange reads
    those and writes the received blocks (a2a: key, row and source; the
    gather's masked keys and validity); a merge reads the received block
    and the seen shard and writes the merged shard and the new frontier
    with its sources (both strategies compute the same function)."""
    D, FC, SC, C, R = sh["D"], sh["FC"], sh["SC"], sh["C"], sh["R"]
    K, PW = sh["K"], sh["PW"]
    blk = D * C * ((K + PW) * 4 + 1)
    out_x = D * R * (K + PW + 1) * 4 if sh["exchange"] == "a2a" \
        else D * R * K * 4 + R
    merge = D * (R * (K + PW + 1) * 4 + 2 * SC * K * 4 + FC * (PW + 1) * 4)
    return {ph: _bound(nb * levels, 0)[0]
            for ph, nb in (("expand", D * FC * PW * 4 + blk),
                           ("exchange", blk + out_x), ("merge", merge))}


def phase_meshbench(pins_4p, tag="25 meshbench"):
    """`python -m jaxmc_torch.meshbench bench` on the 4-process model at
    D = 1, 2, 4 shards on the card, each point in a child process: a
    warm-up run, the timed run (no nvcc build in its window, host_syncs
    <= levels), then the phase probe (B.12d: expand, exchange, rank and
    full-sort merges as separately timed calls).  Every point's counts
    equal the level engine's in this script.  The jaxmc.multichip/1
    artifact goes to chiprun_out/.  On one card the exchange is K13
    alone (no collective)."""
    from jaxmc_torch import meshbench
    out_dir = os.path.join(STAGES_DIR, "meshbench")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.dirname(BENCH_OUT), exist_ok=True)
    try:
        t0 = time.time()
        rc, out, err = _main_captured(meshbench.main, [
            "bench", "--devices", "1,2,4", "--rung",
            "specs/transfer_scaled.tla=" + os.path.relpath(CFG_4P, ROOT),
            "--out-dir", out_dir, "--out", BENCH_OUT, "--timeout", "300"])
        wall = time.time() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for ln in out:
        log(f"[{tag}] {ln}")
    if rc != 0:
        raise AssertionError(f"{tag}: meshbench bench exit {rc}\n"
                             f"{err[-3000:]}")
    with open(BENCH_OUT) as fh:
        art = json.load(fh)
    (rung,) = art["rungs"]
    for pt in rung["curve"]:
        got = (pt["distinct"], pt["generated"], pt["diameter"])
        pw, pl = pt["phase_walls"], pt["phase_launches"]
        bd = _probe_bounds(pt["phase_shapes"], pw["levels"])
        log(f"[{tag}] D={pt['devices']} probe shapes {pt['phase_shapes']}; "
            f"byte bounds over its {pw['levels']} levels: expand "
            f"{bd['expand']:.4f} ms, exchange {bd['exchange']:.4f} ms, "
            f"each merge {bd['merge']:.4f} ms (3.35 TB/s)")
        log(f"[{tag}] D={pt['devices']} {pt['exchange']}: {got}, wall "
            f"{pt['wall_s']}s ({pt['states_per_sec']:,.0f} st/s), "
            f"recompiles {pt['window_recompiles']}, host_syncs "
            f"{pt['host_syncs']}/{pt['levels']} levels; probe over "
            f"{pw['levels']} levels: expand {pw['expand_s']}s, exchange "
            f"{pw['exchange_s']}s (K13 launches "
            f"{pl['mesh_route'] + pl['mesh_route_gather']}), merge_rank "
            f"{pw['merge_rank_s']}s (K3 {pl['seen_probe']}, K4 "
            f"{pl['rank_merge']}, K8 mesh_vc "
            f"{pl['resident_compact_mesh_vc']}), merge_fullsort "
            f"{pw['merge_fullsort_s']}s (K11 {pl['fullsort_dedup']}), "
            f"step {pw.get('step_s')}s over {pw.get('step_levels')} "
            f"levels, hot share {pw.get('hot_share')}")
        if got != pins_4p or pt["window_recompiles"] or \
                pt["host_syncs"] > pt["levels"] or pw["levels"] < 1 or \
                min(pl["gen_expand"], pl["seen_probe"], pl["rank_merge"],
                    pl["fullsort_dedup"],
                    pl["mesh_route"] + pl["mesh_route_gather"]) <= 0:
            raise AssertionError(f"{tag}: point {pt}")
    log(f"[{tag}] artifact {os.path.relpath(BENCH_OUT, ROOT)}; "
        f"{wall:.1f}s")


def main() -> int:
    t_start = time.time()

    def mark(n):
        # the script's elapsed time after phase n (the time budget)
        log(f"[time] through phase {n}: {time.time() - t_start:.1f}s")

    name, count, smi = phase_device()
    phase_build()
    phase_build_gen()
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
    mark(7)

    eng, got, counts, _ = phase_reduction(
        "8 symmetry", "symtoy_scaled.tla", CFG_SYM, PINS_SYM,
        ("unpack_rows", "canon_rows", "keys_of_canon", "sort_keys",
         "seen_probe", "rank_merge", "front_order", "gen_expand"))
    table += check_canon(eng, got, counts)
    table.append(check_sort(got["merge"][0], counts["sort_keys"],
                            "8 symmetry", "sort_keys@sym"))
    table.append(check_gen_expand(eng, got["expand"][0],
                                  counts["gen_expand"], "8 symmetry",
                                  "gen_expand@sym"))
    del eng, got
    eng, got, counts, _ = phase_reduction(
        "9 view", "viewtoy_scaled.tla", CFG_VIEW, PINS_VIEW,
        ("unpack_rows", "keys_of_view", "sort_keys", "seen_probe",
         "rank_merge", "front_order", "gen_expand", "gen_pred",
         "gen_value"))
    table += check_view(eng, got, counts)
    table.append(check_sort(got["merge"][0], counts["sort_keys"],
                            "9 view", "sort_keys@view"))
    table += check_gen_pred_value(eng, got, counts, "9 view", "@view")
    del eng, got
    eng, got, counts, por = phase_reduction(
        "10 por", "msgstoy.tla", CFG_POR, PINS_POR,
        ("unpack_rows", "keys_of", "sort_keys", "seen_probe",
         "seen_probe_por", "por_mask", "rank_merge", "front_order",
         "gen_expand"), por=True)
    got_pins = {k: por.get(k) for k in POR_PINS}
    if got_pins != POR_PINS:
        raise AssertionError(f"por counters {got_pins} != {POR_PINS}")
    table += check_por(eng, got, counts)
    table.append(check_gen_expand(eng, got["expand"][0],
                                  counts["gen_expand"], "10 por",
                                  "gen_expand@por"))
    del eng, got
    phase_por_verdicts()
    mark(10)

    counts, captured = phase_host_seen("11 host seen", "transfer_scaled.tla",
                                       CFG_4P, counts_4p)
    table.append(check_hstep(captured, counts))
    del captured
    phase_host_seen("12 hs por", "msgstoy.tla", CFG_POR, PINS_HS_POR,
                    POR_PINS_HS, por=True)
    phase_hybrid()
    mark(13)

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
    mark(16)
    table.append(phase_props())
    mark(17)
    table += phase_batch()
    mark(18)
    phase_durability(counts_4p)
    mark(19)
    table += phase_full_sort(counts_4p)
    mark(20)
    table += phase_obs(smi)
    mark(21)
    table += phase_mesh(counts_4p)
    mark(22)
    phase_session(counts_4p)
    phase_sweep()
    phase_meshbench(counts_4p)
    gen_summary()
    log(f"[done] {time.time() - t_start:.1f}s")
    print(f"{smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
