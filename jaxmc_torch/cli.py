"""Command line of the port: `python -m jaxmc_torch check SPEC`.

    python -m jaxmc_torch check SPEC [--cfg F] [--device cuda|cpu]
        [--seen auto|exact|fingerprint] [--max-states N] [--no-trace]
        [--no-deadlock] [--por]

Prints the same TLC-style progress and final lines as `jaxmc check
--backend jax`.  The search runs on the CUDA card unless --device cpu
is given.  Exit codes: 0 no error found, 1 a violation, 2 a refused
mode or an uncompilable spec.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


# options of `jaxmc check` whose engines this slice does not port, and
# the ROADMAP item that ports each
UNPORTED = (("host_seen", "--host-seen (chunked host-seen engine)", "A.8"),
            ("seen_cap", "--seen-cap (out-of-core tiers)", "A.9"),
            ("resident", "--resident (resident engine)", "A.10"),
            ("checkpoint", "--checkpoint (level checkpoints)", "A.15"),
            ("resume", "--resume (level checkpoints)", "A.15"))


def refuse_unported(args) -> None:
    from .compile.vspec import ModeError
    for attr, what, item in UNPORTED:
        if getattr(args, attr, None):
            raise ModeError(f"{what} is not ported to the torch engine "
                            f"yet (ROADMAP {item})")


def cmd_check(args) -> int:
    from .backend.bfs import TorchExplorer
    from .compile.vspec import CompileError, ModeError
    from .engine.explore import format_trace
    from .obs import Logger
    from .session import load_model

    t0 = time.time()
    log = Logger(quiet=False)
    try:
        refuse_unported(args)
        model = load_model(args.spec, args.cfg,
                           no_deadlock=args.no_deadlock)
        eng = TorchExplorer(model, log=log, max_states=args.max_states,
                            store_trace=not args.no_trace,
                            seen_mode=args.seen, device=args.device,
                            por=args.por)
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
    p = argparse.ArgumentParser(prog="python -m jaxmc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="model-check SPEC on the level engine")
    c.add_argument("spec")
    c.add_argument("--cfg", default=None)
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
    # accepted so that a `jaxmc check` command line is refused by name
    c.add_argument("--host-seen", action="store_true",
                   help=argparse.SUPPRESS)
    c.add_argument("--resident", action="store_true",
                   help=argparse.SUPPRESS)
    c.add_argument("--seen-cap", type=int, default=None,
                   help=argparse.SUPPRESS)
    c.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    c.add_argument("--resume", default=None, help=argparse.SUPPRESS)
    c.set_defaults(fn=cmd_check)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from .compile.vspec import CompileError
    from .sem.values import EvalError
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (EvalError, CompileError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
