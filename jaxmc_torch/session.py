"""Model loading, the run configuration and the ASSUME-only mode of the
port's entry points (the port of jaxmc/session.py: load_model,
SessionConfig with its signature fields, batch_profile, and the parse,
run_assumes and device-init parts of CheckSession).

`CheckSession` holds what the `check` command needs before an engine
exists: `parse` (a bound model, or TLC's No-Behavior-Spec mode when the
cfg names neither SPECIFICATION nor INIT), `run_assumes`, and
`device_init` (the --backend selection: a pinned platform, or the
preflight oracle's verdict under auto, resolved to a torch device).
The engine stages stay in cli.py.  Every stage reports spans into the
recorder the session was built with (obs.current() unless one is
passed).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from . import obs
from .compile.vspec import Bounds, ModeError


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
    checkpoint: Optional[str] = None
    checkpoint_every: float = 600.0
    resume: Optional[str] = None
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
    """The parse stage of a check, TLC's No-Behavior-Spec mode and the
    device selection."""

    def __init__(self, cfg: SessionConfig, tel=None, log=None):
        self.cfg = cfg
        self.tel = tel if tel is not None else obs.current()
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.kind: Optional[str] = None   # "model" | "assumes"
        self.model = None
        self.cfg_path: Optional[str] = None

    def parse(self) -> str:
        """Load cfg+spec.  Returns "model" (a bound Model in
        self.model) or "assumes" (a cfg with neither SPECIFICATION nor
        INIT: drive it with run_assumes())."""
        if self.kind is not None:
            return self.kind
        cfg = self.cfg
        cfgp = cfg.cfg or default_cfg_path(cfg.spec)
        self.cfg_path = cfgp
        if cfgp:
            from .front.cfg import parse_cfg
            c = parse_cfg(read_text(cfgp))
            if not c.specification and not c.init:
                self.kind = "assumes"
                return self.kind
        with self.tel.span("load", spec=cfg.spec):
            self.model = load_model(cfg.spec, cfg.cfg, cfg.no_deadlock,
                                    cfg.include)
        # a search-progress estimator on the recorder: with an analyze
        # bound every progress line carries a fraction-explored and ETA
        obs.attach_estimator(self.tel, self.model)
        self.kind = "model"
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
