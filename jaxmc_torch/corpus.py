r"""The corpus sweep: `python -m jaxmc_torch sweep`, the port of
jaxmc/corpus.py.  One manifest (CASES, equal to the reference's field by
field) pins every checkable spec+cfg of the tla-rust corpus and of this
repo with its expected verdict, counts, expansion mode and lint waivers;
`sweep` checks each case and reports pass / fail / skip tallies, as the
reference's `make check-corpus` (the corpus's `tlc *tla`) does.

Verdicts: "ok", "assumes" (an ASSUME-calculator module) or
"violation:<kind>" (invariant/property/assert/deadlock).  Every case
resolves to "pass", "fail" or "skip"; a skip is never a pass.  A case
pinned into the compile set (`jax="yes"`) that stops compiling FAILS,
and so does one whose expansion mode slides toward the interpreter
(compiled -> hybrid -> interp-arms) or whose derived pin loses a
predicted arm.  `--backend jax` runs the port's device engine
(TorchExplorer, host_seen when the native store builds) on the CUDA
card unless the caller names the CPU (`device="cpu"`, `sweep --device
cpu`, JAXMC_SWEEP_PLATFORM=cpu); each case runs in a fresh child
process under JAXMC_SWEEP_TIMEOUT seconds (default 900) unless
JAXMC_SWEEP_INPROC=1.  Cases that need the reference corpus (the
`tla-rust` checkout) read it only from JAXMC_REFERENCE: the port has no
default path outside its checkout.  Where that is unset, or names no
corpus, they skip with a named reason (reference_missing()).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tla-rust corpus, only where JAXMC_REFERENCE names it
REFERENCE: Optional[str] = os.environ.get("JAXMC_REFERENCE") or None
SS = "examples/SpecifyingSystems"


@dataclass
class Case:
    spec: str                      # path, relative to root
    root: str = "ref"              # "ref" (reference) | "repo"
    cfg: Optional[str] = None      # defaults to spec with .cfg
    expect: str = "ok"             # ok | assumes | violation:<kind>
    distinct: Optional[int] = None
    generated: Optional[int] = None
    no_deadlock: bool = False
    includes: Tuple[str, ...] = ()  # extra -I dirs, relative to root kind
    slow: bool = False             # excluded from the default sweep/pins
    # the pinned compile set: "yes" = must compile on the device engine
    # and match the same pins; "skip" = outside the compilable subset
    jax: str = "skip"
    # the pinned expansion mode: "compiled" | "hybrid" | "interp-arms".
    # A slide toward the interpreter fails the case; "interp-arms" pins
    # skip kernel construction (TorchExplorer pin_interp_arms).
    # JAXMC_MODE_PIN=0 lifts the pins for one sweep.
    mode: Optional[str] = None
    # interp-arms derived by the demotion predictor (analyze/verdicts.py)
    # instead of the measured pin: the sweep fails if it stops predicting
    # every arm (JAXMC_PIN_DERIVE=0 restores the measured pin)
    pin_derived: bool = False
    # lane-capacity floors the default sampler under-observes
    seq_cap: Optional[int] = None
    grow_cap: Optional[int] = None
    kv_cap: Optional[int] = None
    # steady resident capacities {SC, FCap, AccCap, VC} and per-shard
    # mesh capacities {SC, FC, TRL, GAM16, MSL} recorded for benches
    res_caps: Optional[dict] = None
    mesh_caps: Optional[dict] = None
    # lint surface: waived diagnostic codes; a lint_only fixture is never
    # checked and must produce exactly lint_expect
    lint_waive: Tuple[str, ...] = ()
    lint_only: bool = False
    lint_expect: Tuple[str, ...] = ()

    def spec_path(self) -> str:
        return os.path.join(_base(self.root), self.spec)

    def cfg_path(self) -> Optional[str]:
        if self.cfg == "":
            return None
        if self.cfg is not None:
            return os.path.join(_base(self.root), self.cfg)
        p = self.spec_path()[:-4] + ".cfg"
        return p if os.path.exists(p) else None

    def include_dirs(self) -> List[str]:
        out = []
        for inc in self.includes:
            if inc.startswith("repo:"):
                out.append(os.path.join(REPO, inc[5:]))
            else:
                out.append(os.path.join(_base("ref"), inc))
        return out

    def needs_reference(self) -> bool:
        """The spec lives in the reference corpus, or a repo shim pulls
        modules from it (MCraftMicro EXTENDS raft)."""
        return self.root == "ref" or any(
            not inc.startswith("repo:") for inc in self.includes)


def reference_missing() -> Optional[str]:
    """Why reference-rooted cases skip here, or None where the corpus
    is mounted."""
    if REFERENCE is None:
        return "reference corpus not mounted (JAXMC_REFERENCE unset)"
    if not os.path.isdir(os.path.join(REFERENCE, "examples")):
        return f"reference corpus not mounted at {REFERENCE}"
    return None


def have_reference() -> bool:
    return reference_missing() is None


def _base(root: str) -> str:
    if root != "ref":
        return REPO
    if REFERENCE is None:
        raise FileNotFoundError(reference_missing())
    return REFERENCE


# Every reference cfg (all 21) plus the repo's MC shims and fixtures.
# Counts are the TLC-semantics pins (CONSTRAINT-violating states are
# discarded, as in the golden testout2 run).
CASES: List[Case] = [
    Case("pcal_intro.tla", distinct=3800, generated=5850, jax="yes",
         mode="compiled"),
    Case("specs/pcal_intro_buggy.tla", root="repo", cfg="",
         expect="violation:assert", jax="yes", mode="compiled",
         lint_waive=("JMC301",)),
    Case("atomic_add.tla", cfg="", distinct=5, generated=7,
         no_deadlock=True, jax="yes", mode="compiled"),
    Case("examples/Paxos/MCConsensus.tla", distinct=4, generated=7,
         no_deadlock=True, jax="yes", mode="compiled"),
    Case("examples/Paxos/MCVoting.tla", distinct=77, generated=406,
         no_deadlock=True, jax="yes", mode="compiled"),
    Case("examples/Paxos/MCPaxos.tla", distinct=25, generated=82,
         jax="yes", mode="compiled"),
    Case(f"{SS}/SimpleMath/SimpleMath.tla", expect="assumes"),
    Case(f"{SS}/HourClock/HourClock.tla", distinct=12, generated=24,
         jax="yes", mode="compiled"),
    Case(f"{SS}/HourClock/HourClock2.tla", distinct=12, generated=24,
         jax="yes", mode="compiled"),
    Case(f"{SS}/AsynchronousInterface/AsynchInterface.tla",
         distinct=12, generated=30, jax="yes", mode="hybrid"),
    Case(f"{SS}/AsynchronousInterface/Channel.tla",
         distinct=12, generated=30, jax="yes", mode="compiled"),
    Case(f"{SS}/AsynchronousInterface/PrintValues.tla", expect="assumes"),
    Case(f"{SS}/FIFO/MCInnerFIFO.tla", distinct=3864, generated=9660,
         jax="yes", mode="compiled"),
    Case(f"{SS}/CachingMemory/MCInternalMemory.tla",
         distinct=4408, generated=21400, jax="yes", mode="hybrid"),
    Case(f"{SS}/CachingMemory/MCWriteThroughCache.tla",
         distinct=5196, generated=28170, jax="yes", mode="hybrid"),
    Case(f"{SS}/Liveness/LiveHourClock.tla", distinct=12, generated=24,
         jax="yes", mode="compiled"),
    Case(f"{SS}/Liveness/MCLiveInternalMemory.tla",
         distinct=4408, generated=21400, jax="yes", mode="hybrid"),
    Case(f"{SS}/Liveness/MCLiveWriteThroughCache.tla",
         distinct=5196, generated=28170, jax="yes", mode="hybrid"),
    Case(f"{SS}/RealTime/MCRealTimeHourClock.tla",
         expect="violation:property", distinct=216, generated=696,
         jax="yes", mode="interp-arms"),
    Case(f"{SS}/TLC/ABCorrectness.tla", distinct=20, generated=36,
         jax="yes", mode="compiled"),
    Case(f"{SS}/TLC/MCAlternatingBit.tla", distinct=240, generated=1392,
         jax="yes", mode="compiled"),
    Case(f"{SS}/AdvancedExamples/MCInnerSequential.tla",
         distinct=3528, generated=24368, jax="yes", seq_cap=8,
         mode="compiled"),
    # the golden TLC testout2 model; its recursive opOrder reaches every
    # arm, so the predictor's verdicts (pin_derived) skip every build
    Case(f"{SS}/AdvancedExamples/MCInnerSerial.tla",
         distinct=195, generated=6181, jax="yes", mode="interp-arms",
         pin_derived=True),
    Case(f"{SS}/AdvancedExamples/MCInnerSerial.tla",
         cfg=f"{SS}/AdvancedExamples/MCInnerSerial.cfg.alt",
         distinct=9, generated=47, jax="yes", mode="interp-arms",
         pin_derived=True),
    Case("specs/transfer_scaled.tla", root="repo",
         cfg="specs/transfer_scaled.cfg",
         distinct=153701, generated=311153, slow=True, jax="yes",
         mode="compiled",
         res_caps={"SC": 1 << 18, "FCap": 1 << 16, "AccCap": 1 << 17,
                   "VC": 1 << 13, "chunk": 2048},
         mesh_caps={"SC": 1 << 17, "FC": 1 << 13, "TRL": 32,
                    "GAM16": 32, "MSL": 32}),
    Case("specs/MCraftMicro.tla", root="repo",
         cfg="specs/MCraft_micro.cfg", includes=("examples",),
         distinct=694, generated=6185, jax="yes", mode="compiled",
         res_caps={"SC": 1 << 12, "FCap": 1 << 9, "AccCap": 1 << 12,
                   "VC": 1 << 11, "chunk": 256},
         mesh_caps={"SC": 1 << 12, "FC": 1 << 9, "TRL": 32,
                    "GAM16": 32, "MSL": 32}),
    Case("specs/MCraftMicro.tla", root="repo",
         cfg="specs/MCraft_3s_bench.cfg", includes=("examples",),
         distinct=76654, generated=1138651, slow=True, jax="yes",
         mode="compiled",
         res_caps={"SC": 1 << 18, "FCap": 1 << 16, "AccCap": 1 << 17,
                   "VC": 1 << 13},
         mesh_caps={"SC": 1 << 17, "FC": 1 << 14, "TRL": 64,
                    "GAM16": 32, "MSL": 64}),
    Case("specs/MCtextbookSI.tla", root="repo",
         cfg="specs/MCtextbookSI_small.cfg", includes=("examples",),
         distinct=569, generated=945, jax="yes", mode="interp-arms"),
    Case("specs/MCtextbookSI.tla", root="repo",
         cfg="specs/MCtextbookSI_skew.cfg", includes=("examples",),
         expect="violation:invariant", slow=True),
    Case("specs/MCserializableSI.tla", root="repo",
         cfg="specs/MCserializableSI_small.cfg", includes=("examples",),
         distinct=569, generated=945, jax="yes", mode="interp-arms"),
    Case("specs/MCtextbookSI.tla", root="repo",
         cfg="specs/MCtextbookSI_skew_fast.cfg", includes=("examples",),
         expect="violation:invariant", jax="yes", mode="interp-arms"),
    Case("specs/MCserializableSI.tla", root="repo",
         cfg="specs/MCserializableSI_env.cfg", includes=("examples",),
         slow=True),
    Case("specs/viewtoy.tla", root="repo", cfg="specs/viewtoy.cfg",
         distinct=5, generated=11, jax="yes", mode="compiled",
         res_caps={"SC": 256, "FCap": 64, "AccCap": 128, "VC": 64,
                   "chunk": 64}),
    Case("specs/constoy.tla", root="repo", cfg="specs/constoy.cfg",
         distinct=21, generated=43, jax="yes", mode="compiled",
         lint_waive=("JMC301",),
         res_caps={"SC": 256, "FCap": 64, "AccCap": 128, "VC": 64,
                   "chunk": 64}),
    Case("specs/batchtoy.tla", root="repo",
         cfg="specs/batchtoy_a.cfg",
         distinct=28, generated=29, jax="yes", mode="compiled"),
    Case("specs/batchtoy.tla", root="repo",
         cfg="specs/batchtoy_b.cfg",
         distinct=40, generated=41, jax="yes", mode="compiled"),
    Case("specs/batchtoy.tla", root="repo",
         cfg="specs/batchtoy_c.cfg",
         distinct=20, generated=21, jax="yes", mode="compiled"),
    Case("specs/batchtoy.tla", root="repo",
         cfg="specs/batchtoy_d.cfg",
         distinct=32, generated=33, jax="yes", mode="compiled"),
    Case("specs/batchtoy.tla", root="repo",
         cfg="specs/batchtoy_bad.cfg",
         expect="violation:invariant", jax="yes", mode="compiled"),
    Case("specs/viewtoy_scaled.tla", root="repo",
         cfg="specs/viewtoy_scaled.cfg",
         distinct=18432, generated=239617, jax="yes", mode="compiled",
         res_caps={"SC": 1 << 15, "FCap": 1 << 12, "AccCap": 1 << 15,
                   "VC": 1 << 13, "chunk": 1024},
         mesh_caps={"SC": 1 << 16, "FC": 1 << 11, "TRL": 32,
                    "GAM16": 32, "MSL": 32}),
    Case("specs/ooc_scaled.tla", root="repo",
         cfg="specs/ooc_scaled.cfg",
         distinct=3072, generated=12289, jax="yes", mode="compiled",
         lint_waive=("JMC301",),
         res_caps={"SC": 1 << 13, "FCap": 256, "AccCap": 1 << 10,
                   "VC": 512, "chunk": 256}),
    Case("specs/symtoy_scaled.tla", root="repo",
         cfg="specs/symtoy_scaled.cfg", no_deadlock=True,
         distinct=10725, generated=65365, jax="yes", mode="compiled",
         res_caps={"SC": 1 << 15, "FCap": 1 << 12, "AccCap": 1 << 14,
                   "VC": 1 << 13, "chunk": 1024},
         mesh_caps={"SC": 1 << 15, "FC": 1 << 11, "TRL": 32,
                    "GAM16": 32, "MSL": 32}),
    Case("specs/symtoy.tla", root="repo", cfg="specs/symtoy.cfg",
         no_deadlock=True, distinct=22, generated=33, jax="yes",
         mode="compiled",
         res_caps={"SC": 256, "FCap": 64, "AccCap": 128, "VC": 64,
                   "chunk": 64}),
    Case("specs/symid.tla", root="repo", cfg="specs/symid.cfg",
         distinct=4, generated=4, jax="yes", mode="compiled"),
    # an arm that demotes at build time with a named reason: hybrid
    Case("specs/interparm_toy.tla", root="repo",
         cfg="specs/interparm_toy.cfg", distinct=19, generated=29,
         jax="yes", mode="hybrid"),
    Case("specs/portoy.tla", root="repo", cfg="specs/portoy.cfg",
         expect="violation:deadlock", distinct=80, generated=185,
         jax="yes", mode="compiled", lint_waive=("JMC301",)),
    Case("specs/portoy.tla", root="repo", cfg="specs/portoy_ok.cfg",
         no_deadlock=True, distinct=150, generated=366,
         jax="yes", mode="compiled", lint_waive=("JMC301",)),
    # device engines report the level-batched violation: verdict only
    Case("specs/portoy.tla", root="repo", cfg="specs/portoy_bad.cfg",
         expect="violation:invariant", jax="yes", mode="compiled",
         lint_waive=("JMC301",)),
    Case("specs/msgstoy.tla", root="repo", cfg="specs/msgstoy.cfg",
         no_deadlock=True, distinct=324, generated=1108,
         jax="yes", mode="compiled"),
    # both arms are unsized dynamic \E shapes the predictor names with
    # ground.py's reason strings: the repo-local pin_derived case
    Case("specs/dyntoy.tla", root="repo", cfg="specs/dyntoy.cfg",
         distinct=8, generated=49, jax="yes", mode="interp-arms",
         pin_derived=True),
    # lint-only: deliberately unclean, never searched
    Case("specs/linttoy.tla", root="repo", cfg="specs/linttoy.cfg",
         lint_only=True,
         lint_expect=("JMC101", "JMC102", "JMC201", "JMC202",
                      "JMC203", "JMC301", "JMC302")),
]

_MODE_ORDER = {"compiled": 0, "hybrid": 1, "interp-arms": 2}


# mode-slide severity order: a case may only move LEFT (toward
# "compiled") without failing its pin
_MODE_ORDER = {"compiled": 0, "hybrid": 1, "interp-arms": 2}


def mode_pins_enabled() -> bool:
    """JAXMC_MODE_PIN=0 lifts every pin for one sweep: every kernel is
    built again and each arm's demotion reason is logged."""
    return os.environ.get("JAXMC_MODE_PIN", "1") != "0"


def case_for_cfg(cfg_basename: str) -> Optional[Case]:
    """Manifest lookup by cfg basename (meshbench uses it for a rung's
    pins, caps and reference dependency)."""
    for c in CASES:
        if c.root == "ref" and REFERENCE is None:
            continue  # no corpus to resolve its cfg in
        p = c.cfg_path()
        if p and os.path.basename(p) == cfg_basename:
            return c
    return None


def run_case(case: Case, backend: str = "interp", device=None):
    """Returns (status, detail, result|None, mode|None); status is
    'pass' | 'fail' | 'skip'; mode (device backend only) is the
    expansion mode — 'compiled' | 'hybrid' | 'interp-arms'.  `backend`
    "jax" is the port's device engine on `device` (None: the CUDA card).
    A skip arises for a case that needs the absent reference corpus, a
    lint-only fixture, and, on the device backend, a case outside the
    compile set (jax != "yes") or a hybrid case without the native
    store; a pinned case that stops compiling FAILS."""
    from .front.cfg import ModelConfig, parse_cfg
    from .sem.modules import Loader, bind_model
    from .engine.explore import Explorer

    if case.lint_only:
        return "skip", ("lint-only fixture (python -m jaxmc_torch.analyze "
                        "lint-corpus checks it); not a checkable "
                        "model"), None, None
    if case.needs_reference() and not have_reference():
        return "skip", reference_missing(), None, None
    spec = case.spec_path()
    cfgp = case.cfg_path()
    if cfgp:
        with open(cfgp) as fh:
            cfg = parse_cfg(fh.read())
    else:
        cfg = ModelConfig(specification="Spec")
    if case.no_deadlock:
        cfg.check_deadlock = False
    ldr = Loader([os.path.dirname(spec)] + case.include_dirs())
    mod = ldr.load_path(spec)

    if case.expect == "assumes":
        from .sem.eval import eval_expr, _bool, Ctx
        from .sem.modules import bind_model_defs
        defs = bind_model_defs(mod, cfg)
        ctx = Ctx(defs)
        n = 0
        for a in mod.assumes:
            if not _bool(eval_expr(a.expr, ctx), "ASSUME"):
                return "fail", "ASSUME violated", None, None
            n += 1
        return "pass", f"{n} assumptions checked", None, None

    model = bind_model(mod, cfg)
    note = ""
    mode = None
    if backend == "jax":
        from . import analyze as _analyze
        from . import native_store
        from .backend.bfs import TorchExplorer
        from .compile.vspec import Bounds, CompileError, ModeError
        b = Bounds()
        if case.seq_cap:
            b.seq_cap = case.seq_cap
        if case.grow_cap:
            b.grow_cap = case.grow_cap
        if case.kv_cap:
            b.kv_cap = case.kv_cap
        pin = case.mode if mode_pins_enabled() else None
        if pin is not None and pin not in _MODE_ORDER:
            # a typo'd pin must not silently disable enforcement
            return "fail", (f"manifest defect: unknown mode pin {pin!r} "
                            f"(expected one of "
                            f"{sorted(_MODE_ORDER)})"), None, None
        # a derived pin: the predictor, not the measured pin, skips the
        # futile builds, unless lifted (JAXMC_PIN_DERIVE=0) or prediction
        # is off
        derive = (case.pin_derived and pin == "interp-arms"
                  and os.environ.get("JAXMC_PIN_DERIVE", "1") != "0"
                  and _analyze.predict_enabled())
        try:
            # construction = grounding + kernel build + the forced one-row
            # evaluation (and nvcc of the generated source on the card)
            t_c0 = time.time()
            ex = TorchExplorer(model, store_trace=False, bounds=b,
                               host_seen=native_store.is_available(),
                               pin_interp_arms=(pin == "interp-arms"
                                                and not derive),
                               device=device)
            build_s = time.time() - t_c0
            # how much of the expansion runs compiled, and whether cfg
            # SYMMETRY is reduced on the device
            n_arms = len(ex.arms)
            n_fb = len(ex.fb_arms)
            if n_fb == 0:
                mode = "compiled"
            elif ex.A > 0:
                mode = "hybrid"
            else:
                mode = "interp-arms"  # device does hashing/dedup only
            # an identity group builds no canonicaliser by design
            # (sym=identity); only a genuine fallback claims divergence
            sym_note = ""
            if model.symmetry is not None:
                if ex.canon is not None:
                    sym_note = ", sym=device-reduced"
                elif ex._sym_fallback:
                    sym_note = (", sym=UNREDUCED-FALLBACK (counts "
                                "diverge from TLC's reduced ones)")
                else:
                    sym_note = (", sym=identity (every declared "
                                "permutation is the identity; counts "
                                "match TLC)")
            note = (f" [build {build_s:.1f}s, mode={mode}, "
                    f"A={ex.A} compiled instances, "
                    f"{n_arms - n_fb}/{n_arms} arms compiled, "
                    f"W={ex.W} lanes"
                    + (f", {n_fb} arms interp-demoted"
                       if ex.fb_arms else "")
                    + (f", {len(ex.fb_invs)} invs interp-demoted"
                       if ex.fb_invs else "") + sym_note
                    + (" [mode pinned]" if pin == "interp-arms" else "")
                    + "]")
            # each demoted arm named with its reason
            if ex.fb_arms and pin != "interp-arms":
                reasons = "; ".join(
                    f"{a.label or 'Next'}: {reason[:100]}"
                    for a, reason in ex.fb_arms[:8])
                more = len(ex.fb_arms) - 8
                note += (f" [demoted arms: {reasons}"
                         + (f"; +{more} more" if more > 0 else "") + "]")
            # the measured pin stays the contract behind a derived one
            if derive:
                if len(ex.arm_verdicts) < len(ex.arms):
                    return "fail", (
                        f"PREDICTOR REGRESSION: pin_derived case "
                        f"predicted only {len(ex.arm_verdicts)}/"
                        f"{len(ex.arms)} arm demotions — the measured "
                        f"interp-arms pin would have skipped every "
                        f"build (diagnose with JAXMC_PIN_DERIVE=0)"
                        f"{note}"), None, mode
                note += " [pin derived by predictor]"
            # a slide toward the interpreter fails before the search
            if pin is not None and mode != pin:
                if _MODE_ORDER.get(mode, 3) > _MODE_ORDER.get(pin, 3):
                    return "fail", (
                        f"REGRESSION: expansion mode slid from pinned "
                        f"'{pin}' to '{mode}'{note}"), None, mode
                note += (f" [mode improved vs pinned '{pin}' — update "
                         f"the manifest]")
            r = ex.run()
        except (CompileError, ModeError) as ex:
            if isinstance(ex, ModeError) and "hybrid" in str(ex) \
                    and not native_store.is_available():
                # a host capability gap: hybrid needs the native store
                return "skip", (f"hybrid needs the native store "
                                f"(unavailable on this host): "
                                f"{ex}"), None, None
            if case.jax == "yes":
                return "fail", (f"REGRESSION: pinned into the jax "
                                f"compile-set but no longer compiles "
                                f"({ex})"), None, None
            return "skip", f"outside jax subset: {ex}", None, None
        if case.jax != "yes":
            note += " [compiles despite jax='skip' — update the manifest]"
    else:
        r = Explorer(model).run()

    if case.expect == "ok":
        if not r.ok:
            return "fail", f"unexpected {r.violation.kind} violation " \
                           f"({r.violation.name})", r, mode
    else:
        kind = case.expect.split(":", 1)[1]
        if r.ok or r.violation.kind != kind:
            return "fail", f"expected a {kind} violation, got " \
                           f"{'ok' if r.ok else r.violation.kind}", r, mode
    if case.distinct is not None and r.distinct != case.distinct:
        return "fail", f"distinct {r.distinct} != pinned " \
                       f"{case.distinct}", r, mode
    if case.generated is not None and r.generated != case.generated:
        return "fail", f"generated {r.generated} != " \
                       f"pinned {case.generated}", r, mode
    return "pass", f"{r.generated} generated / {r.distinct} distinct " \
                   f"({case.expect}){note}", r, mode


def _run_case_isolated(idx: int, backend: str, timeout_s: float,
                       device: str):
    """One case in a fresh child process under a wall-clock timeout:
    one pathological build must not wedge the sweep.  The child imports
    only jaxmc_torch and runs on `device` (passed as
    JAXMC_SWEEP_PLATFORM).  A timeout FAILS a jax='yes' case and skips
    the others."""
    import json
    import subprocess
    import sys
    code = (
        "import json\n"
        "from jaxmc_torch.corpus import CASES, run_case\n"
        f"s, d, _, md = run_case(CASES[{idx}], backend={backend!r}, "
        f"device={device!r})\n"
        "print('JAXMC_CASE ' + json.dumps([s, d, md]))\n")
    case = CASES[idx]
    try:
        p = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=timeout_s, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=REPO,
                                    JAXMC_SWEEP_PLATFORM=device))
    except subprocess.TimeoutExpired:
        if case.jax == "yes":
            return "fail", (f"REGRESSION: pinned into the jax compile-set "
                            f"but timed out after {timeout_s:.0f}s"), None
        return "skip", f"timed out after {timeout_s:.0f}s (compile?)", None
    for line in (p.stdout or "").splitlines():
        if line.startswith("JAXMC_CASE "):
            s, d, md = json.loads(line[len("JAXMC_CASE "):])
            return s, d, md
    tail = (p.stderr or "").strip().splitlines()[-1:] or ["no output"]
    return "fail", f"CRASH rc={p.returncode}: {tail[0][:160]}", None


def sweep(backend: str = "interp", include_slow: bool = False,
          log=print, isolate: Optional[bool] = None,
          metrics_out: Optional[str] = None, device=None) -> int:
    """Check the whole corpus; returns the number of failures.  Logs
    pass/violation/skip/fail tallies (a sweep where every model skips is
    visibly not a clean sweep).  With metrics_out (or
    JAXMC_SWEEP_METRICS_OUT) the per-case record (status, wall time,
    expansion mode) lands in a jaxmc.sweep-metrics/1 artifact."""
    if isolate is None:
        isolate = backend == "jax" and \
            os.environ.get("JAXMC_SWEEP_INPROC") != "1"
    if metrics_out is None:
        metrics_out = os.environ.get("JAXMC_SWEEP_METRICS_OUT") or None
    # the device backend's device: the caller's, else
    # JAXMC_SWEEP_PLATFORM, else the card
    device = device or os.environ.get("JAXMC_SWEEP_PLATFORM") or "cuda"
    timeout_s = float(os.environ.get("JAXMC_SWEEP_TIMEOUT", "900"))
    tallies = {"pass": 0, "fail": 0, "skip": 0}
    modes = {"compiled": 0, "hybrid": 0, "interp-arms": 0}
    expected_violations = 0
    case_records = []
    t0 = time.time()
    n = 0
    for i, case in enumerate(CASES):
        if case.slow and not include_slow:
            continue
        if case.lint_only:
            continue  # lint-corpus owns these fixtures
        n += 1
        name = case.cfg or case.spec
        t1 = time.time()
        mode = None
        try:
            if isolate:
                status, detail, mode = _run_case_isolated(
                    i, backend, timeout_s, device)
            else:
                status, detail, _, mode = run_case(case, backend, device)
        except Exception as ex:  # a crash is a failure, not an abort
            status, detail = "fail", f"CRASH {type(ex).__name__}: {ex}"
        tag = {"pass": "ok  ", "fail": "FAIL", "skip": "SKIP"}[status]
        log(f"[{tag}] {name:62s} {detail} "
            f"({time.time() - t1:.1f}s)")
        tallies[status] += 1
        if status == "pass" and case.expect.startswith("violation"):
            expected_violations += 1
        if mode in modes:
            modes[mode] += 1
        case_records.append({"case": name, "status": status,
                             "expect": case.expect, "mode": mode,
                             "wall_s": round(time.time() - t1, 3),
                             "detail": detail})
    # the device the isolated children were pinned to
    plat_note = ""
    if isolate:
        plat_note = f", platform={device} [JAXMC_SWEEP_PLATFORM]"
    if backend == "jax" and not mode_pins_enabled():
        plat_note += ", MODE PINS LIFTED [JAXMC_MODE_PIN=0]"
    mode_note = ""
    if backend == "jax" and sum(modes.values()):
        mode_note = (f"; expansion modes: {modes['compiled']} "
                     f"fully-compiled / {modes['hybrid']} hybrid / "
                     f"{modes['interp-arms']} all-interp-arms")
    log(f"{n} corpus models: {tallies['pass']} pass "
        f"({expected_violations} expected-violation), "
        f"{tallies['skip']} SKIP (outside jax subset), "
        f"{tallies['fail']} FAIL "
        f"({time.time() - t0:.1f}s, backend={backend}{plat_note})"
        f"{mode_note}")
    if metrics_out:
        from . import obs
        art = {"schema": "jaxmc.sweep-metrics/1", "backend": backend,
               "isolated": bool(isolate),
               "platform": device if isolate else None,
               "wall_s": round(time.time() - t0, 3),
               "tallies": dict(tallies, total=n,
                               expected_violations=expected_violations),
               "modes": modes, "cases": case_records}
        obs.write_json_atomic(metrics_out, art)
        log(f"sweep metrics written to {metrics_out}")
    return tallies["fail"]
