"""Command line of the port: `python -m jaxmc_torch check|simulate|info|
sweep`.

    python -m jaxmc_torch check SPEC [--cfg F] [-I DIR ...]
        [--device cuda|cpu] [--seen auto|exact|fingerprint]
        [--max-states N] [--no-trace] [--no-deadlock] [--por]
        [--host-seen | --resident] [--chunk N]
        [--seen-cap ROWS [--seen-spill DIR]] [--sample BFS WALKS DEPTH]
        [--seq-cap N] [--grow-cap N] [--kv-cap N] [--quiet]
        [--progress-every S] [--checkpoint F [--checkpoint-every S]]
        [--resume F] [--backend interp [--workers N]]
        [--backend auto|cpu|gpu|tpu] [--no-device-fallback]
        [--metrics-out F] [--trace F] [--profile [wall|xla]]
        [--analyze off|warn|strict]
    python -m jaxmc_torch simulate SPEC [--cfg F] [--walks N] [--depth N]
        [--seed N] [--coverage] [--no-deadlock]
    python -m jaxmc_torch info SPEC [--cfg F]
    python -m jaxmc_torch sweep [--backend interp|jax] [--device cuda|cpu]
        [--slow] [--metrics-out F]

`check` runs through the session stages (session.py CheckSession:
parse, analyze, compile, explore) and prints the same TLC-style
progress and final lines as `jaxmc check --backend jax`.  The search
runs on the CUDA card unless --device cpu is given.  --host-seen runs
the chunked engine whose seen set is the native host fingerprint store,
the mode that also runs hybrid specs (units the compiler rejects demote
to the interpreter).  --resident
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

--backend cpu|gpu pins the device engine to that platform (gpu without
a CUDA device exits 2 naming --device cpu; tpu exits 2: the port has
none; a --backend that contradicts --device exits 2); --backend auto
runs the preflight oracle (backend/oracle.py) and prints its verdict,
the one route on which the port chooses the CPU by itself.
--metrics-out, --trace and --profile write the reference's telemetry
artifacts (obs/).  --analyze warn|strict lints the spec/cfg pair first
(analyze/lint.py; strict exits 2 on an error diagnostic).  `simulate`
checks invariants along random behaviors, `info` prints the module
summary and, with a cfg, the batch class, proven bounds and the arm
independence matrix, and `sweep` checks the corpus manifest
(corpus.py): all as the reference's subcommands print them.

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


def cmd_check(args) -> int:
    from . import drain, obs

    t0 = time.time()
    # telemetry is a PARALLEL channel: stdout stays byte-identical; a
    # NullTelemetry (every method a no-op) serves runs that asked for no
    # artifact, so the engines' instrumentation costs nothing
    want_tel = bool(args.metrics_out or args.trace or args.profile)
    tel = obs.Telemetry(
        trace_path=args.trace,
        meta={"command": "check", "backend": args.backend or "torch",
              "spec": args.spec, "cfg": args.cfg,
              "argv": list(sys.argv[1:]),
              "env": obs.environment_meta()}) if want_tel \
        else obs.NullTelemetry()
    if args.profile:
        # per-dispatch profiling (obs/prof.py): wall mode waits on each
        # site's device work and sums its bytes; a sync cannot change
        # values, so counts and traces stay bit-identical
        tel.prof.mode = args.profile
    log = obs.Logger(tel, quiet=args.quiet)
    # the watchdog names a wedged phase on stderr and in the trace while
    # it hangs; start() is a no-op on the NullTelemetry
    wd = obs.Watchdog(tel).start()
    # SIGTERM asks for a drain: the engine checkpoints at its next level
    # boundary and returns a drained result (exit 143 below).  The
    # previous handler comes back when the command returns, so a caller
    # that runs `main` in its own process keeps its own
    prev = signal.getsignal(signal.SIGTERM)
    installed = drain.install()
    capture = _start_xla_trace(args, tel) if args.profile == "xla" \
        else None
    try:
        with obs.use(tel):
            return _check(args, tel, log, t0)
    finally:
        if capture is not None:
            _stop_xla_trace(capture)
        wd.stop()
        tel.close()
        if installed:
            signal.signal(signal.SIGTERM, prev)


def _start_xla_trace(args, tel):
    """--profile=xla: capture the whole run with torch.profiler to a
    named directory (JAXMC_XLA_TRACE_DIR, else METRICS_OUT.xla, else a
    fresh temp dir), written as a chrome trace when the run ends.  A
    profiler that will not start degrades to wall-mode profiling with a
    warning, as the reference's does.  Returns (profiler, dir) or
    None."""
    tdir = os.environ.get("JAXMC_XLA_TRACE_DIR") or \
        (args.metrics_out + ".xla" if args.metrics_out else None)
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if tdir is None:
            import tempfile
            tdir = tempfile.mkdtemp(prefix="jaxmc-xla-")
        os.makedirs(tdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:  # noqa: BLE001 — profiling is best-effort
        print(f"warning: --profile=xla trace capture unavailable "
              f"({e}); continuing with wall-mode profiling",
              file=sys.stderr)
        return None
    tel.prof.xla_trace_dir = tdir
    print(f"-- profile: xla trace capture -> {tdir}", file=sys.stderr)
    return prof, tdir


def _stop_xla_trace(capture) -> None:
    prof, tdir = capture
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(tdir, "trace.json"))
    except Exception as e:  # noqa: BLE001 — never mask the run's exit
        print(f"warning: --profile=xla trace export failed ({e})",
              file=sys.stderr)


def _metrics_error(args, tel, error: str) -> None:
    if args.metrics_out:
        tel.write_metrics(args.metrics_out,
                          result={"ok": False, "distinct": 0,
                                  "generated": 0, "diameter": 0,
                                  "truncated": False, "error": error})


def _result_block(res) -> dict:
    """The metrics artifact's `result` block, the reference's fields."""
    result = {"ok": res.ok, "distinct": res.distinct,
              "generated": res.generated, "diameter": res.diameter,
              "truncated": bool(res.truncated),
              "wall_s": round(res.wall_s, 6),
              "warnings": list(res.warnings)}
    if res.drained:
        result["drained"] = True
    result["seen_mode"] = getattr(res, "seen_mode", "exact")
    if getattr(res, "collision_p", None) is not None:
        result["collision_p"] = res.collision_p
    if getattr(res, "trunc_reason", None):
        result["trunc_reason"] = res.trunc_reason
    if getattr(res, "tiers", None):
        result["tiers"] = res.tiers
    if res.violation is not None:
        result["violation"] = {"kind": res.violation.kind,
                               "name": res.violation.name}
    return result


def _check(args, tel, log, t0) -> int:
    from . import drain, faults
    from .compile.vspec import CompileError, ModeError
    from .engine.explore import format_trace
    from .session import AnalyzeError, CheckSession, SessionConfig

    if args.analyze not in ("off", "warn", "strict"):
        # argparse checks only typed values against its choices: a bad
        # JAXMC_ANALYZE default must fail loudly, not degrade a strict
        # gate to warn
        print(f"error: invalid --analyze/JAXMC_ANALYZE value "
              f"{args.analyze!r} (expected off, warn or strict)",
              file=sys.stderr)
        _metrics_error(args, tel, f"invalid analyze mode {args.analyze!r}")
        return 2
    interp = args.backend == "interp"
    try:
        if args.host_seen and args.resident:
            raise ModeError("resident and host_seen are mutually "
                            "exclusive: resident keeps the seen-set on "
                            "device, host_seen keeps it in the native "
                            "host store")
        sess = CheckSession(SessionConfig.from_args(args), tel=tel, log=log)
        if args.analyze != "off":
            # before parse, so a cfg defect that bind_model would refuse
            # still reports its whole diagnostic list
            try:
                for d in sess.analyze():
                    print(f"analyze: {d.render()}", file=sys.stderr)
            except AnalyzeError as ex:
                for d in ex.diagnostics:
                    print(f"analyze: {d.render()}", file=sys.stderr)
                print(f"error: --analyze=strict refused the run ({ex}); "
                      f"fix the spec/cfg or re-run with --analyze=warn",
                      file=sys.stderr)
                _metrics_error(args, tel, f"analyze strict: {ex}")
                return 2
        if sess.parse() == "assumes":
            rc = sess.run_assumes()
            if args.metrics_out:
                tel.write_metrics(args.metrics_out,
                                  result={"ok": rc == 0, "distinct": 0,
                                          "generated": 0, "diameter": 0,
                                          "truncated": False,
                                          "mode": "assumes"})
            return rc
        sess.compile()
        if interp:
            res = sess.explore()
        else:
            try:
                res = sess.explore()
            except (faults.FaultInjected, RuntimeError, OSError,
                    MemoryError, ConnectionError) as e:
                # a terminal device failure: no demotion to the CPU
                # engine, so the run ends here with one named line
                print(f"error: terminal device failure "
                      f"({type(e).__name__}: {e}); the torch engine does "
                      f"not fall back to the CPU", file=sys.stderr)
                _metrics_error(args, tel, f"terminal device failure: "
                                          f"{type(e).__name__}: {e}")
                return 2
    except ModeError as e:
        print(f"error: {e}", file=sys.stderr)
        _metrics_error(args, tel, str(e))
        return 2
    except CompileError as e:
        print(f"error: this spec is outside the torch backend's "
              f"compilable subset ({e}); re-run with jaxmc --backend "
              f"interp", file=sys.stderr)
        _metrics_error(args, tel, str(e))
        return 2
    wall = time.time() - t0
    backend = "interp" if interp else f"torch:{sess.engine.device}"
    print(f"{res.generated} states generated, {res.distinct} distinct states "
          f"found ({res.generated / max(res.wall_s, 1e-9):.0f} states/sec, "
          f"backend={backend}, wall {wall:.2f}s)")
    for w in res.warnings:
        print(f"Warning: {w}")
    if args.metrics_out:
        mst = getattr(sess.model, "_memo", None)
        if mst is not None:
            tel.gauge("memo.hits", mst.hits)
            tel.gauge("memo.misses", mst.misses)
        tel.write_metrics(args.metrics_out, result=_result_block(res))
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


def cmd_simulate(args) -> int:
    """TLC's -simulate mode: random behaviors, invariants checked along
    the way (engine/simulate.py)."""
    from .engine.explore import format_trace
    from .engine.simulate import random_walks
    from .session import load_model

    model = load_model(args.spec, args.cfg, no_deadlock=args.no_deadlock,
                       includes=args.include)
    v = random_walks(model, n_walks=args.walks, depth=args.depth,
                     seed=args.seed, check_invariants=True,
                     coverage_guided=args.coverage,
                     check_deadlock=model.check_deadlock)
    if v is None:
        print(f"{args.walks} behaviors of length <= {args.depth} simulated. "
              f"No error has been found.")
        return 0
    print(format_trace(v))
    return 1


def cmd_sweep(args) -> int:
    from .corpus import sweep
    return 1 if sweep(backend=args.backend, include_slow=args.slow,
                      metrics_out=args.metrics_out,
                      device=args.device) else 0


def cmd_info(args) -> int:
    """The module summary, and with a bindable cfg the batch line, the
    proven bounds, the arm independence matrix and its key classes."""
    from .front import tla_ast as A
    from .sem.modules import Loader

    ldr = Loader([os.path.dirname(os.path.abspath(args.spec))])
    mod = ldr.load_path(args.spec)
    print(f"module {mod.name}")
    print(f"  extends:   {', '.join(mod.ast.extends) or '-'}")
    print(f"  constants: {', '.join(n for n, _ in mod.constants) or '-'}")
    print(f"  variables: {', '.join(mod.variables) or '-'}")
    ops = [u.name for u in mod.ast.units if isinstance(u, A.OpDef)]
    print(f"  operators: {len(ops)}")
    cfgp = getattr(args, "cfg", None) or \
        os.path.splitext(args.spec)[0] + ".cfg"
    if not os.path.exists(cfgp):
        return 0
    # one model load and one bounds fixpoint serve the batch line and
    # the analysis below
    model = rep = None
    try:
        from .analyze.bounds import infer_state_bounds
        from .session import load_model
        model = load_model(args.spec, cfgp, False)
        rep = infer_state_bounds(model)
        model._bounds_report = rep
    except Exception:  # noqa: BLE001 — info never fails on an
        model = None   # analysis defect
    try:
        from .session import SessionConfig, batch_profile
        prof = batch_profile(SessionConfig(spec=args.spec, cfg=cfgp,
                                           backend="jax", host_seen=True),
                             model=model)
    except Exception:  # noqa: BLE001
        prof = None
    if prof is not None:
        est = prof.cost_estimate if prof.cost_estimate is not None else "?"
        print(f"  batch:     sig={prof.bsig} "
              f"lifted=[{', '.join(prof.lift) or '-'}] "
              f"est_states={est}")
    if model is None:
        print("  analyze:   unavailable (model does not bind)")
        return 0
    try:
        from .analyze.bounds import state_space_estimate
        from .analyze.independence import independence_report, por_refusal
        if rep is None:
            print("  bounds:    analysis bailed (no proofs)")
        else:
            ebs = rep.element_bounds()
            lanes = rep.lane_bounds()
            parts = []
            for v in model.vars:
                if v in lanes:
                    parts.append(f"{v}∈[{lanes[v][0]},{lanes[v][1]}]")
                elif v in ebs:
                    parts.append(f"{v}:{ebs[v]!r}")
            est = state_space_estimate(model, rep)
            print(f"  bounds:    "
                  f"{'converged' if rep.converged else 'TRUNCATED'}"
                  f" proven=[{', '.join(parts) or '-'}] "
                  f"predicted_states={est if est is not None else '?'}")
        irep = independence_report(model)
        refusal = por_refusal(model)
        print(f"  independence: {len(irep.labels)} arms, "
              f"{irep.commuting_pairs()} commuting pairs, "
              f"{len(irep.por_safe)} por-safe"
              + (f" (--por disabled: {refusal})" if refusal else ""))
        for row in irep.matrix_rows():
            print(f"    {row}")
        # why each arm is, or is not, element-commuting
        print("  key classes:")
        for row in irep.keyclass_rows():
            print(f"    {row}")
    except Exception as ex:  # noqa: BLE001 — info never fails
        if os.environ.get("JAXMC_DEBUG"):
            raise
        print(f"  analyze:   unavailable ({type(ex).__name__})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .backend import BACKEND_CHOICES
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
    c.add_argument("--analyze", choices=["off", "warn", "strict"],
                   default=os.environ.get("JAXMC_ANALYZE", "off"),
                   help="lint the spec/cfg pair before the build (stable "
                        "JMC codes: undefined or unused names, dead "
                        "actions, cfg mismatches, symmetry hazards): "
                        "warn prints the diagnostics on stderr and goes "
                        "on, strict exits 2 on any error diagnostic "
                        "(env: JAXMC_ANALYZE).  Demotion prediction and "
                        "bounds inference do not depend on it "
                        "(JAXMC_ANALYZE_PREDICT, JAXMC_ANALYZE_BOUNDS)")
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
                   choices=("torch",) + BACKEND_CHOICES,
                   help="interp runs the interpreter engines on the host "
                        "(--workers N); cpu|gpu run the device engine "
                        "pinned to that platform (tpu: refused, the port "
                        "has none); auto probes the platforms with the "
                        "preflight oracle and runs on the best live one "
                        "(verdict printed and stored as "
                        "backend.oracle_choice); torch, jax or none run "
                        "the device engine on --device")
    c.add_argument("--workers", type=int, metavar="N", default=None,
                   help="interp backend: worker processes (default: "
                        "JAXMC_WORKERS, else min(cpu_count, 8); 1 = the "
                        "serial engine)")
    c.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write an end-of-run JSON metrics artifact: "
                        "phase wall times, per-level BFS counts, "
                        "counters, gauges, the env fingerprint and the "
                        "result block (schema jaxmc.metrics/4, "
                        "obs/schema.py; render with python -m "
                        "jaxmc_torch.obs report|diff|top)")
    c.add_argument("--trace", default=None, metavar="FILE",
                   help="stream telemetry events as JSONL while the run "
                        "is live (span_open/span/level/log plus watchdog "
                        "heartbeat/stall beats)")
    c.add_argument("--profile", nargs="?", const="wall", default=None,
                   choices=("wall", "xla"),
                   help="per-dispatch device profiling (obs/prof.py): "
                        "synchronised wall, bytes and kernel builds per "
                        "named dispatch site plus the device-memory "
                        "model, stamped into --metrics-out as the prof{} "
                        "block (render with python -m jaxmc_torch.obs "
                        "top).  --profile=xla also captures a "
                        "torch.profiler chrome trace to "
                        "JAXMC_XLA_TRACE_DIR (default METRICS_OUT.xla/). "
                        "Profiling never changes counts or traces")
    c.add_argument("--no-device-fallback", action="store_true",
                   help="exit on a terminal device failure (the port "
                        "never falls back to the CPU, so this is always "
                        "so)")
    c.set_defaults(fn=cmd_check)

    m = sub.add_parser("simulate",
                       help="check invariants along random behaviors "
                            "(TLC -simulate)")
    m.add_argument("spec")
    m.add_argument("--cfg", default=None)
    m.add_argument("-I", "--include", action="append", default=[])
    m.add_argument("--walks", type=int, default=100)
    m.add_argument("--depth", type=int, default=100)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--coverage", action="store_true",
                   help="bias toward rarely-taken action families")
    m.add_argument("--no-deadlock", action="store_true",
                   help="disable deadlock reporting")
    m.set_defaults(fn=cmd_simulate)

    i = sub.add_parser("info", help="parse a spec and print a summary")
    i.add_argument("spec")
    i.add_argument("--cfg", default=None,
                   help="model config for the batch and analysis lines "
                        "(default: <spec>.cfg when present)")
    i.set_defaults(fn=cmd_info)

    s = sub.add_parser("sweep",
                       help="check the whole corpus with its expected "
                            "verdicts (the reference's `tlc *tla`)")
    s.add_argument("--backend", choices=("interp", "jax"),
                   default="interp",
                   help="interp: the interpreter; jax: the port's "
                        "device engine on --device")
    s.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where --backend jax runs (default: "
                        "JAXMC_SWEEP_PLATFORM, else the CUDA card)")
    s.add_argument("--slow", action="store_true",
                   help="include the multi-minute models")
    s.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write a per-case JSON artifact (status, wall "
                        "time, expansion mode)")
    s.set_defaults(fn=cmd_sweep)
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
