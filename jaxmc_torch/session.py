"""CheckSession: the check flow as explicit, resumable stages (the port
of jaxmc/session.py).

    parse    cfg + spec  ->  a bound Model (or TLC's No-Behavior-Spec
                             mode: a cfg with neither SPECIFICATION nor
                             INIT, driven by run_assumes)
    analyze  the pair    ->  lint diagnostics, gated by cfg.analyze
                             off/warn/strict: strict raises AnalyzeError
                             on error diagnostics before any build
    compile  Model       ->  a ready engine: the interpreter engines for
                             --backend interp, else device_init (the
                             --backend and --device selection) and
                             TorchExplorer, with its layout signature
    explore  engine      ->  CheckResult (re-runnable: a later run may
                             override resume_from, checkpoint_path and
                             final_checkpoint)

The `check` command is a thin layer over these stages; the serve
daemon, when ported, holds sessions warm through the same object.  Every
stage reports spans into the recorder the session was built with
(obs.current() unless one is passed).  Stage errors propagate as the
exceptions the CLI maps to its exit codes.  There is no device-to-CPU
demotion: a terminal device failure ends the run (the reference's
demote_to_cpu is not ported).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from . import obs
from .compile.vspec import Bounds, ModeError

_SENTINEL = object()  # "keep the configured value" for explore overrides


def read_text(path: str) -> str:
    """Read a cfg/spec file without leaking the handle."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        return fh.read()


def default_cfg_path(spec_path: str) -> Optional[str]:
    guess = os.path.splitext(spec_path)[0] + ".cfg"
    return guess if os.path.exists(guess) else None


def load_model(spec_path: str, cfg_path=None, no_deadlock: bool = False,
               includes=()):
    """Parse SPEC (and its cfg: `cfg_path`, else SPEC's sibling .cfg,
    else `SPECIFICATION Spec`) and bind it into a checkable Model."""
    from .front.cfg import parse_cfg, ModelConfig
    from .sem.modules import Loader, bind_model

    if cfg_path is None:
        cfg_path = default_cfg_path(spec_path)
    if cfg_path:
        cfg = parse_cfg(read_text(cfg_path))
    else:
        cfg = ModelConfig(specification="Spec")
    if no_deadlock:
        cfg.check_deadlock = False
    ldr = Loader([os.path.dirname(os.path.abspath(spec_path))] +
                 list(includes))
    mod = ldr.load_path(spec_path)
    return bind_model(mod, cfg)


class AnalyzeError(Exception):
    """--analyze=strict found error-severity diagnostics: the run must
    not proceed to compile and search.  Carries the whole diagnostic
    list, so a caller can render every finding."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        errs = [d for d in self.diagnostics if d.severity == "error"]
        super().__init__(
            f"{len(errs)} error diagnostic"
            f"{'s' if len(errs) != 1 else ''} "
            f"({'; '.join(d.code for d in errs[:6])})")


@dataclass
class SessionConfig:
    """What a check run is parameterized by: the fields of the
    reference's SessionConfig that the port's check command, batching
    and the job signatures read, with the reference's names and
    defaults, plus the port's `device` (None: the CUDA card)."""

    spec: str
    cfg: Optional[str] = None
    include: Tuple[str, ...] = ()
    backend: str = "interp"
    platform: Optional[str] = None
    max_states: Optional[int] = None
    workers: Optional[int] = None
    no_deadlock: bool = False
    no_device_fallback: bool = False
    progress_every: float = 30.0
    seq_cap: int = Bounds.seq_cap
    grow_cap: int = Bounds.grow_cap
    kv_cap: int = Bounds.kv_cap
    no_trace: bool = False
    host_seen: bool = False
    sample: Tuple[int, int, int] = (800, 40, 60)
    chunk: int = 2048
    resident: bool = False
    seen: str = "auto"
    seen_cap: Optional[int] = None
    seen_spill: Optional[str] = None
    checkpoint: Optional[str] = None
    checkpoint_every: float = 600.0
    resume: Optional[str] = None
    # the lint gate of the analyze stage: "off" (skip), "warn" (record
    # and continue) or "strict" (error diagnostics refuse the run)
    analyze: str = "off"
    por: bool = False
    # checkpoint COMPLETED runs too (a resume replays the verdict)
    final_checkpoint: bool = False
    device: Optional[str] = None

    @classmethod
    def from_args(cls, args) -> "SessionConfig":
        """Build from an argparse Namespace (the `check` subcommand's);
        fields the namespace lacks keep their defaults."""
        import dataclasses
        kw = {}
        for f in dataclasses.fields(cls):
            if hasattr(args, f.name):
                kw[f.name] = getattr(args, f.name)
        kw["include"] = tuple(getattr(args, "include", ()) or ())
        kw["sample"] = tuple(getattr(args, "sample", (800, 40, 60)))
        return cls(**kw)

    def job_signature_fields(self) -> Dict[str, Any]:
        """The option surface that makes two submissions 'the same job':
        anything that changes the search's result or its layout and
        kernels.  Checkpoint paths, telemetry and pacing are excluded."""
        return {
            "spec": self.spec, "cfg": self.cfg,
            "include": list(self.include), "backend": self.backend,
            "platform": self.platform, "max_states": self.max_states,
            "no_deadlock": self.no_deadlock,
            "seq_cap": self.seq_cap, "grow_cap": self.grow_cap,
            "kv_cap": self.kv_cap, "no_trace": self.no_trace,
            "host_seen": self.host_seen, "sample": list(self.sample),
            "chunk": self.chunk, "resident": self.resident,
            "seen": self.seen, "seen_cap": self.seen_cap,
            "por": self.por,
        }

    def batch_signature_fields(self) -> Dict[str, Any]:
        """job_signature_fields without the model identity: the option
        surface every member of a cross-model batch must share."""
        f = self.job_signature_fields()
        f.pop("spec", None)
        f.pop("cfg", None)
        return f


def _stable(v) -> str:
    """Deterministic rendering of a parsed cfg constant value (frozensets
    sorted)."""
    if isinstance(v, frozenset):
        return "{" + ",".join(sorted(_stable(x) for x in v)) + "}"
    return repr(v)


@dataclass
class BatchProfile:
    """Parse-time batch compatibility verdict for one submission: the
    layout-compat class key and the state-space estimate."""
    bsig: str
    lift: Tuple[str, ...]
    cost_estimate: Optional[int]


def batch_profile(cfg: SessionConfig,
                  model=None) -> Optional["BatchProfile"]:
    """Which layout-compat class this job belongs to.  Two submissions
    with equal `bsig` differ at most in liftable constant values — same
    module shape, same non-lifted constants, same cfg-declared
    predicates, same result-affecting options — so one batched device
    program (backend/batch.py) may serve both.  None for configurations
    the batcher does not cover (interp backend, resident, non-host_seen
    device modes, tiered seen sets, --por) or a model that fails to
    load."""
    import hashlib
    import json
    if cfg.backend == "interp" or cfg.resident or not cfg.host_seen \
            or cfg.seen_cap is not None or cfg.por:
        return None
    if model is None:
        try:
            model = load_model(cfg.spec, cfg.cfg, cfg.no_deadlock,
                               cfg.include)
        except Exception:  # noqa: BLE001 — an unloadable pair is simply
            # not batchable; the solo path reports the real error
            return None
    from .analyze.bounds import liftable_constants, state_space_estimate
    lift = liftable_constants(model)
    mc = model.cfg
    masked = {n: ("<lifted>" if n in lift else _stable(v))
              for n, v in sorted(mc.constants.items())}
    ident = {
        "module": model.module.name,
        "vars": list(model.vars),
        "spec_sha": hashlib.sha256(
            read_text(cfg.spec).encode()).hexdigest(),
        "cfg_shape": {
            "specification": mc.specification, "init": mc.init,
            "next": mc.next,
            "invariants": sorted(mc.invariants),
            "properties": sorted(mc.properties),
            "constraints": sorted(mc.constraints),
            "action_constraints": sorted(mc.action_constraints),
            "symmetry": mc.symmetry, "view": mc.view,
            "overrides": sorted(mc.overrides.items()),
            "scoped_overrides": sorted(
                (f"{k[0]}!{k[1]}", v)
                for k, v in mc.scoped_overrides.items()),
            "check_deadlock": mc.check_deadlock,
            "constants": masked,
        },
        "lift": list(lift),
        "options": cfg.batch_signature_fields(),
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    bsig = "b" + hashlib.sha256(blob).hexdigest()[:15]
    try:
        est = state_space_estimate(model)
    except Exception:  # noqa: BLE001 — estimation must never block
        est = None
    return BatchProfile(bsig=bsig, lift=lift, cost_estimate=est)


class CheckSession:
    """One check as stages over one model/engine pair.

    Stage order is enforced (compile needs parse's model, explore needs
    compile's engine) and each stage is idempotent, so a caller can go
    straight to any stage.  `explore` alone is re-runnable with per-run
    overrides: a warm session re-drives its engine with
    `resume_from=<a completed run's final checkpoint>` and the search
    replays the stored verdict without building anything again."""

    def __init__(self, cfg: SessionConfig, tel=None, log=None):
        self.cfg = cfg
        self.tel = tel if tel is not None else obs.current()
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.stage: Optional[str] = None  # the last completed stage
        self.kind: Optional[str] = None   # "model" | "assumes"
        self.model = None
        self.cfg_path: Optional[str] = None
        self.engine = None
        self.workers: Optional[int] = None
        self.layout_sig: Optional[str] = None
        self.result = None
        self.explore_count = 0
        self.diagnostics = None  # the analyze stage's lint findings

    # ---- stage: parse ----
    def parse(self) -> str:
        """Load cfg+spec.  Returns "model" (a bound Model in
        self.model) or "assumes" (a cfg with neither SPECIFICATION nor
        INIT: drive it with run_assumes())."""
        if self.stage is not None:
            return self.kind
        cfg = self.cfg
        cfgp = cfg.cfg or default_cfg_path(cfg.spec)
        self.cfg_path = cfgp
        if cfgp:
            from .front.cfg import parse_cfg
            c = parse_cfg(read_text(cfgp))
            if not c.specification and not c.init:
                self.kind = "assumes"
                self.stage = "parse"
                return self.kind
        with self.tel.span("load", spec=cfg.spec):
            self.model = load_model(cfg.spec, cfg.cfg, cfg.no_deadlock,
                                    cfg.include)
        # a search-progress estimator on the recorder: with an analyze
        # bound every progress line carries a fraction-explored and ETA
        obs.attach_estimator(self.tel, self.model)
        self.kind = "model"
        self.stage = "parse"
        return self.kind

    def run_assumes(self) -> int:
        """Evaluate the module's ASSUMEs as a calculator: prints the
        verdict lines and returns the exit code."""
        assert self.kind == "assumes", "run_assumes needs an assumes session"
        from .front.cfg import parse_cfg, ModelConfig
        from .sem.modules import Loader, bind_model_defs
        from .sem.eval import Ctx, eval_expr
        from .sem.values import fmt

        cfg = self.cfg
        mcfg = parse_cfg(read_text(self.cfg_path)) if self.cfg_path \
            else ModelConfig()
        ldr = Loader([os.path.dirname(os.path.abspath(cfg.spec))] +
                     list(cfg.include))
        mod = ldr.load_path(cfg.spec)
        defs = bind_model_defs(mod, mcfg)
        prints = []
        ctx = Ctx(defs, {}, None, None, (),
                  on_print=lambda v: prints.append(v))
        failed = 0
        for a in mod.assumes:
            v = eval_expr(a.expr, ctx)
            nm = a.name or "ASSUME"
            if v is not True:
                print(f"Assumption {nm} is violated (evaluated to "
                      f"{fmt(v)}).")
                failed += 1
        for v in prints:
            print(fmt(v) if not isinstance(v, str) else v)
        if failed:
            return 1
        print(f"{len(mod.assumes)} assumption"
              f"{'s' if len(mod.assumes) != 1 else ''} checked. "
              "No error has been found.")
        return 0

    # ---- stage: analyze ----
    def analyze(self):
        """Lint the spec/cfg pair and keep the diagnostics.  cfg.analyze
        "off" skips the stage, "warn" records, "strict" raises
        AnalyzeError when any error-severity diagnostic exists, and
        keeps raising it on every later call (compile re-enters here,
        so a caller cannot build past a refusal).  Runnable before
        parse: the linter loads the pair itself, so a cfg that
        bind_model refuses still gets its diagnostics.  An assumes-mode
        pair has nothing to analyze."""
        mode = (self.cfg.analyze or "off").lower()
        if self.diagnostics is not None:
            if mode == "strict":
                if any(d.severity == "error" for d in self.diagnostics):
                    raise AnalyzeError(self.diagnostics)
            return self.diagnostics
        if mode == "off":
            return []
        cfgp = self.cfg.cfg or default_cfg_path(self.cfg.spec)
        if cfgp:
            try:
                from .front.cfg import parse_cfg
                c = parse_cfg(read_text(cfgp))
                if not c.specification and not c.init:
                    return []  # assumes-mode: no model to lint
            except Exception:  # noqa: BLE001 — lint_pair reports it
                pass           # as JMC100
        from .analyze.lint import errors, lint_pair, max_severity
        with self.tel.span("analyze", mode=mode):
            diags = lint_pair(self.cfg.spec, cfgp, tuple(self.cfg.include))
        self.diagnostics = diags
        if diags:
            self.tel.counter("analyze.lint_diags", len(diags))
            self.tel.gauge("analyze.lint_max_severity", max_severity(diags))
            self.tel.gauge("analyze.lint_codes",
                           sorted({d.code for d in diags}))
        if self.stage == "parse":
            self.stage = "analyze"
        if mode == "strict" and errors(diags):
            raise AnalyzeError(diags)
        return diags

    # ---- stage: compile ----
    def compile(self) -> "CheckSession":
        """Build the engine.  --backend interp: the serial Explorer
        (--por, or one worker) or the ParallelExplorer (--workers N > 1;
        None or 0: the default count).  Otherwise device_init, then
        TorchExplorer on that device, and the layout signature.  Raises
        what engine construction raises (ModeError, CompileError,
        CkptError, a missing card); the caller owns the policy."""
        if self.stage in ("compile", "explore"):
            return self
        if self.stage is None:
            self.parse()
        if self.stage == "parse":
            self.analyze()  # a no-op when cfg.analyze == "off"
        assert self.kind == "model", "assumes sessions have no engine"
        cfg = self.cfg
        if cfg.backend == "interp":
            from .engine.explore import Explorer
            from .engine.parallel import ParallelExplorer, default_workers
            self.workers = default_workers() if not cfg.workers \
                else max(1, cfg.workers)
            kw = dict(log=self.log, max_states=cfg.max_states,
                      progress_every=cfg.progress_every,
                      checkpoint_path=cfg.checkpoint,
                      checkpoint_every=cfg.checkpoint_every,
                      resume_from=cfg.resume,
                      final_checkpoint=cfg.final_checkpoint)
            if cfg.por:
                # the ample choice reads the live seen set state by
                # state, which the fork pool's chunks cannot replay
                if self.workers > 1:
                    self.tel.gauge("parallel.fallback_reason", "por")
                self.workers = 1
                self.engine = Explorer(self.model, por=True, **kw)
            elif self.workers > 1:
                self.engine = ParallelExplorer(self.model,
                                               workers=self.workers, **kw)
            else:
                self.engine = Explorer(self.model, **kw)
        else:
            from .backend.bfs import TorchExplorer
            device = self.device_init()
            with self.tel.span("engine_build"):
                self.engine = TorchExplorer(
                    self.model, log=self.log, max_states=cfg.max_states,
                    store_trace=not cfg.no_trace,
                    progress_every=cfg.progress_every,
                    bounds=Bounds(seq_cap=cfg.seq_cap,
                                  grow_cap=cfg.grow_cap,
                                  kv_cap=cfg.kv_cap),
                    sample_cfg=tuple(cfg.sample), seen_mode=cfg.seen,
                    device=device, por=cfg.por,
                    host_seen=cfg.host_seen, resident=cfg.resident,
                    chunk=cfg.chunk, seen_cap=cfg.seen_cap,
                    spill_dir=cfg.seen_spill,
                    checkpoint_path=cfg.checkpoint,
                    checkpoint_every=cfg.checkpoint_every,
                    resume_from=cfg.resume,
                    final_checkpoint=cfg.final_checkpoint)
            self.layout_sig = self.engine._layout_sig()
        self.stage = "compile"
        return self

    # ---- stage: explore ----
    def explore(self, resume_from=_SENTINEL, checkpoint_path=_SENTINEL,
                final_checkpoint=_SENTINEL):
        """Run (or run again) the search.  The overrides are set on the
        engine, whose run() reads them afresh each call: a warm session
        answers a repeat submission with
        explore(resume_from=<its final checkpoint>).  Returns (and
        keeps) the CheckResult."""
        if self.stage in (None, "parse", "analyze"):
            self.compile()
        ex = self.engine
        if resume_from is not _SENTINEL:
            ex.resume_from = resume_from
        if checkpoint_path is not _SENTINEL:
            ex.checkpoint_path = checkpoint_path
        if final_checkpoint is not _SENTINEL:
            ex.final_checkpoint = final_checkpoint
        self.explore_count += 1
        span = dict(workers=self.workers) \
            if self.cfg.backend == "interp" else {}
        with self.tel.span("search", **span):
            self.result = ex.run()
        self.stage = "explore"
        return self.result

    # ---- introspection ----
    def describe(self) -> Dict[str, Any]:
        """The session's resumable identity (the serve status
        endpoint's)."""
        return {
            "stage": self.stage,
            "kind": self.kind,
            "backend": self.cfg.backend,
            "spec": self.cfg.spec,
            "module": self.model.module.name if self.model is not None
            else None,
            "layout_sig": self.layout_sig,
            "checkpoint": self.cfg.checkpoint,
            "explore_count": self.explore_count,
            "analyze_diags": len(self.diagnostics)
            if self.diagnostics is not None else None,
        }

    # ---- device selection (the reference's resolve_platform and
    # device_init, jaxmc/session.py:420-495) ----
    def resolve_platform(self) -> Optional[str]:
        """The platform --backend names: cpu|gpu outright; auto asks the
        preflight oracle (backend/oracle.py) and logs its verdict; tpu
        is refused (the port has none); torch, jax or none: None, the
        device --device names."""
        b = self.cfg.backend
        if b == "tpu":
            raise ModeError("--backend tpu: the torch port has no TPU "
                            "platform; use --backend gpu, cpu or auto")
        if b in ("cpu", "gpu"):
            return b
        if b == "auto":
            from .backend.oracle import preflight
            with self.tel.span("preflight_oracle"):
                v = preflight(tel=self.tel)
            if v["platform"] is None:
                errs = "; ".join(f"{p}: {pr.get('error')}"
                                 for p, pr in v["probes"].items())
                raise RuntimeError(
                    f"backend oracle found no live platform ({errs})")
            self.log(f"-- backend oracle: {v['platform']} "
                     f"({v['reason']}; {v['wall_s']}s)")
            return v["platform"]
        return None

    def device_init(self):
        """Resolve --backend and --device to the torch device the engine
        runs on, and initialise it inside the `device_init` span (a hung
        driver is attributed there).  The card is the default and
        --backend gpu never falls back: without CUDA either exits 2
        naming --device cpu; only --backend auto chooses the CPU by
        itself, and says so."""
        import torch
        from .backend.bfs import resolve_device
        cfg, tel = self.cfg, self.tel
        platform = self.resolve_platform()
        want = {"cpu": "cpu", "gpu": "cuda", None: None}[platform]
        if want is not None and cfg.device is not None \
                and cfg.device != want:
            raise ModeError(f"--backend {cfg.backend} runs on "
                            f"{platform}, which contradicts --device "
                            f"{cfg.device}")
        if platform == "gpu" and not torch.cuda.is_available():
            raise ModeError("--backend gpu needs a CUDA device and torch "
                            "sees none; run on the CPU with --device cpu")
        with tel.span("device_init", platform=platform or "default",
                      attempt=0):
            device = resolve_device(want or cfg.device)
            if device.type == "cuda":
                torch.cuda.init()
            tel.gauge("device.platform",
                      "gpu" if device.type == "cuda" else "cpu")
            tel.gauge("device.count", torch.cuda.device_count()
                      if device.type == "cuda" else 1)
            tel.set_meta(env=obs.environment_meta(device))
        return device
