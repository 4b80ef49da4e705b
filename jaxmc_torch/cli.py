"""Command line of the port: `python -m jaxmc_torch check SPEC`.

    python -m jaxmc_torch check SPEC [--cfg F] [-I DIR ...]
        [--device cuda|cpu] [--seen auto|exact|fingerprint]
        [--max-states N] [--no-trace] [--no-deadlock] [--por]
        [--host-seen | --resident] [--chunk N]
        [--seen-cap ROWS [--seen-spill DIR]] [--sample BFS WALKS DEPTH]
        [--seq-cap N] [--grow-cap N] [--kv-cap N] [--quiet]
        [--progress-every S] [--checkpoint F [--checkpoint-every S]]
        [--resume F] [--backend interp [--workers N]]
        [--no-device-fallback]

Prints the same TLC-style progress and final lines as `jaxmc check
--backend jax`.  The search runs on the CUDA card unless --device cpu
is given.  --host-seen runs the chunked engine whose seen set is the
native host fingerprint store, the mode that also runs hybrid specs
(units the compiler rejects demote to the interpreter).  --resident
keeps the whole level loop on the device and reads one summary per
level (no traces).  --seen-cap caps the device seen table of the level
and resident engines: past it the table spills to host-RAM and disk
runs (JAXMC_TIER_HOST_KEYS bounds the host tier).  Temporal and
refinement PROPERTYs are checked on the level and host-seen engines.  A
cfg that names neither SPECIFICATION nor INIT runs TLC's
No-Behavior-Spec mode: the module's ASSUMEs are evaluated and nothing
is searched.

--checkpoint F writes a checkpoint (engine/ckpt.py's container) every
--checkpoint-every seconds at a level boundary, and beside it, on the
level and host-seen engines with traces, the interpreter-format host
snapshot F.host; --resume F continues a run from F with the same
engine flags.  SIGTERM drains the search: it stops at the next level
boundary, checkpoints when --checkpoint is given, prints the resume
hint and exits 143.  --backend interp runs the interpreter engines
instead of the device (engine/explore.py, or engine/parallel.py with
--workers N > 1), which resume a device run's F.host.  A terminal
device failure exits 2: the port never demotes a run to the CPU
(--no-device-fallback is accepted and is the only behaviour).

Exit codes: 0 no error found, 1 a violation, 2 a refused mode, an
uncompilable spec, a damaged or foreign checkpoint, a device failure or
any other error (one line on stderr, `error: <Type>: <message>`, as the
reference prints it), 143 drained.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List, Optional


def interp_engine(model, cfg, log):
    """The interpreter engine --backend interp runs, chosen as the
    reference's CheckSession.compile chooses (jaxmc/session.py:518-548):
    --por runs the serial Explorer, --workers N > 1 (None or 0: the
    default count) the ParallelExplorer, else the serial Explorer."""
    from .engine.explore import Explorer
    from .engine.parallel import ParallelExplorer, default_workers
    workers = default_workers() if not cfg.workers \
        else max(1, cfg.workers)
    kw = dict(log=log, max_states=cfg.max_states,
              progress_every=cfg.progress_every,
              checkpoint_path=cfg.checkpoint,
              checkpoint_every=cfg.checkpoint_every,
              resume_from=cfg.resume,
              final_checkpoint=cfg.final_checkpoint)
    if cfg.por:
        return Explorer(model, por=True, **kw)
    if workers > 1:
        return ParallelExplorer(model, workers=workers, **kw)
    return Explorer(model, **kw)


def cmd_check(args) -> int:
    from . import drain
    from .obs import Logger

    t0 = time.time()
    log = Logger(quiet=args.quiet)
    # SIGTERM asks for a drain: the engine checkpoints at its next level
    # boundary and returns a drained result (exit 143 below).  The
    # previous handler comes back when the command returns, so a caller
    # that runs `main` in its own process keeps its own
    prev = signal.getsignal(signal.SIGTERM)
    installed = drain.install()
    try:
        return _check(args, log, t0)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev)


def _check(args, log, t0) -> int:
    from . import drain, faults
    from .backend.bfs import TorchExplorer
    from .compile.vspec import Bounds, CompileError, ModeError
    from .engine.explore import format_trace
    from .session import CheckSession, SessionConfig

    interp = args.backend == "interp"
    try:
        if args.host_seen and args.resident:
            raise ModeError("resident and host_seen are mutually "
                            "exclusive: resident keeps the seen-set on "
                            "device, host_seen keeps it in the native "
                            "host store")
        cfg = SessionConfig.from_args(args)
        sess = CheckSession(cfg)
        if sess.parse() == "assumes":
            return sess.run_assumes()
        if interp:
            eng = interp_engine(sess.model, cfg, log)
        else:
            eng = TorchExplorer(sess.model, log=log,
                                max_states=args.max_states,
                                store_trace=not args.no_trace,
                                progress_every=args.progress_every,
                                bounds=Bounds(seq_cap=args.seq_cap,
                                              grow_cap=args.grow_cap,
                                              kv_cap=args.kv_cap),
                                sample_cfg=tuple(args.sample),
                                seen_mode=args.seen, device=args.device,
                                por=args.por, host_seen=args.host_seen,
                                resident=args.resident, chunk=args.chunk,
                                seen_cap=args.seen_cap,
                                spill_dir=args.seen_spill,
                                checkpoint_path=args.checkpoint,
                                checkpoint_every=args.checkpoint_every,
                                resume_from=args.resume)
        try:
            res = eng.run()
        except (faults.FaultInjected, RuntimeError, OSError, MemoryError,
                ConnectionError) as e:
            if interp:
                raise
            # a terminal device failure: no demotion to the CPU engine
            # (ROADMAP A.14), so the run ends here with one named line
            print(f"error: terminal device failure ({type(e).__name__}: "
                  f"{e}); the torch engine does not fall back to the "
                  f"CPU", file=sys.stderr)
            return 2
    except ModeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except CompileError as e:
        print(f"error: this spec is outside the torch backend's "
              f"compilable subset ({e}); re-run with jaxmc --backend "
              f"interp", file=sys.stderr)
        return 2
    wall = time.time() - t0
    backend = "interp" if interp else f"torch:{eng.device}"
    print(f"{res.generated} states generated, {res.distinct} distinct states "
          f"found ({res.generated / max(res.wall_s, 1e-9):.0f} states/sec, "
          f"backend={backend}, wall {wall:.2f}s)")
    for w in res.warnings:
        print(f"Warning: {w}")
    if res.ok:
        if res.drained:
            # checkpointed at a level boundary and resumable: never a 0,
            # the search did not complete
            print("Search DRAINED at a safe boundary - no error found "
                  "in the explored prefix.")
            print(f"jaxmc: drained ({drain.reason()})"
                  + (f"; resume with --resume {args.checkpoint}"
                     if args.checkpoint else "; no checkpoint was "
                     "configured"), file=sys.stderr)
            return drain.DRAIN_EXIT_CODE
        if res.truncated:
            print("Search TRUNCATED at state limit - no error found in the "
                  "explored prefix.")
        else:
            print("Model checking completed. No error has been found.")
        return 0
    print(format_trace(res.violation))
    return 1


def build_parser() -> argparse.ArgumentParser:
    from .compile.vspec import Bounds
    p = argparse.ArgumentParser(prog="python -m jaxmc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="model-check SPEC")
    c.add_argument("spec")
    c.add_argument("--cfg", default=None)
    c.add_argument("-I", "--include", action="append", default=[],
                   help="extra module search directories (MC shims "
                        "extending reference specs)")
    c.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA card)")
    c.add_argument("--seen", default="auto",
                   choices=("auto", "exact", "fingerprint"))
    c.add_argument("--max-states", type=int, default=None)
    c.add_argument("--no-trace", action="store_true")
    c.add_argument("--no-deadlock", action="store_true",
                   help="disable deadlock checking")
    c.add_argument("--por", action="store_true",
                   help="device partial-order reduction (persistent-set "
                        "filter in the level step)")
    c.add_argument("--host-seen", action="store_true",
                   help="chunked engine with the seen set in the native "
                        "host fingerprint store; runs hybrid specs")
    c.add_argument("--resident", action="store_true",
                   help="keep the whole search on the device: one summary "
                        "read per level; no traces, no PROPERTYs")
    c.add_argument("--chunk", type=int, default=2048,
                   help="frontier rows per device step (host-seen and "
                        "resident modes)")
    c.add_argument("--seen-cap", type=int, default=None, metavar="ROWS",
                   help="cap the device seen table (level and resident "
                        "engines); past it the sorted table spills to "
                        "host-RAM and then disk runs, counts unchanged "
                        "(env: JAXMC_SEEN_CAP)")
    c.add_argument("--seen-spill", default=None, metavar="DIR",
                   help="disk-tier directory for spilled seen-set runs "
                        "(env: JAXMC_SPILL_DIR; default a temp dir). "
                        "Host-RAM tier budget: JAXMC_TIER_HOST_KEYS keys")
    c.add_argument("--sample", type=int, nargs=3, default=[800, 40, 60],
                   metavar=("BFS", "WALKS", "DEPTH"),
                   help="layout-sampling effort (BFS-prefix states, random "
                        "walks, walk depth)")
    c.add_argument("--seq-cap", type=int, default=Bounds.seq_cap,
                   help="sequence-length capacity floor")
    c.add_argument("--grow-cap", type=int, default=Bounds.grow_cap,
                   help="growing-set capacity floor")
    c.add_argument("--kv-cap", type=int, default=Bounds.kv_cap,
                   help="message-table domain capacity floor")
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--progress-every", type=float, default=30.0)
    c.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="write periodic checkpoints to this file at level "
                        "boundaries (and FILE.host, the interpreter-format "
                        "snapshot, on the level and host-seen engines "
                        "with traces)")
    c.add_argument("--checkpoint-every", type=float, default=600.0,
                   metavar="S", help="seconds between checkpoints")
    c.add_argument("--resume", default=None, metavar="FILE",
                   help="resume a run from a checkpoint (the engine and "
                        "its flags must match the writing run's)")
    c.add_argument("--backend", default=None,
                   choices=("torch", "interp", "jax", "auto", "cpu", "gpu",
                            "tpu"),
                   help="interp runs the interpreter engines on the host "
                        "(--workers N); any other value, or none, runs "
                        "the device engine")
    c.add_argument("--workers", type=int, metavar="N", default=None,
                   help="interp backend: worker processes (default: "
                        "JAXMC_WORKERS, else min(cpu_count, 8); 1 = the "
                        "serial engine)")
    c.add_argument("--no-device-fallback", action="store_true",
                   help="exit on a terminal device failure (the port "
                        "never falls back to the CPU, so this is always "
                        "so)")
    c.set_defaults(fn=cmd_check)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from .engine.ckpt import CkptError
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except CkptError as e:
        # a missing, damaged or foreign checkpoint: one line, exit 2
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Exception as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        if os.environ.get("JAXMC_DEBUG"):
            raise
        return 2


if __name__ == "__main__":
    sys.exit(main())
