"""Command line of the port: `python -m jaxmc_torch check SPEC`.

    python -m jaxmc_torch check SPEC [--cfg F] [-I DIR ...]
        [--device cuda|cpu] [--seen auto|exact|fingerprint]
        [--max-states N] [--no-trace] [--no-deadlock] [--por]
        [--host-seen | --resident] [--chunk N]
        [--seen-cap ROWS [--seen-spill DIR]] [--sample BFS WALKS DEPTH]
        [--seq-cap N] [--grow-cap N] [--kv-cap N] [--quiet]
        [--progress-every S]

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
is searched.  Exit codes: 0 no error found, 1 a violation, 2 a refused
mode, an uncompilable spec or any other error (one line on stderr,
`error: <Type>: <message>`, as the reference prints it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional


# options of `jaxmc check` whose engines this slice does not port, and
# the ROADMAP item that ports each
UNPORTED = (("checkpoint", "--checkpoint (level checkpoints)", "A.15"),
            ("resume", "--resume (level checkpoints)", "A.15"))


def refuse_unported(args) -> None:
    """Refuse the options no ported engine runs, and --resident with
    --host-seen with the reference's text for the pair, before the
    model loads."""
    from .compile.vspec import ModeError
    if args.host_seen and args.resident:
        raise ModeError("resident and host_seen are mutually exclusive: "
                        "resident keeps the seen-set on device, host_seen "
                        "keeps it in the native host store")
    for attr, what, item in UNPORTED:
        if getattr(args, attr, None):
            raise ModeError(f"{what} is not ported to the torch engine "
                            f"yet (ROADMAP {item})")


def cmd_check(args) -> int:
    from .backend.bfs import TorchExplorer
    from .compile.vspec import Bounds, CompileError, ModeError
    from .engine.explore import format_trace
    from .obs import Logger
    from .session import CheckSession, SessionConfig

    t0 = time.time()
    log = Logger(quiet=args.quiet)
    try:
        refuse_unported(args)
        sess = CheckSession(SessionConfig.from_args(args))
        if sess.parse() == "assumes":
            return sess.run_assumes()
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
                            spill_dir=args.seen_spill)
        res = eng.run()
    except ModeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except CompileError as e:
        print(f"error: this spec is outside the torch backend's "
              f"compilable subset ({e}); re-run with jaxmc --backend "
              f"interp", file=sys.stderr)
        return 2
    wall = time.time() - t0
    print(f"{res.generated} states generated, {res.distinct} distinct states "
          f"found ({res.generated / max(res.wall_s, 1e-9):.0f} states/sec, "
          f"backend=torch:{eng.device}, wall {wall:.2f}s)")
    for w in res.warnings:
        print(f"Warning: {w}")
    if res.ok:
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
    # accepted so that a `jaxmc check` command line is refused by name
    c.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    c.add_argument("--resume", default=None, help=argparse.SUPPRESS)
    c.set_defaults(fn=cmd_check)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
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
