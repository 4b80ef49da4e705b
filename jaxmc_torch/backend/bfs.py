r"""The level, host-seen and resident engines on the card: TorchExplorer.

The port of jaxmc/backend/bfs.py's level mode (TpuExplorer.run without
resident or host_seen), of its host_seen mode and of its resident mode,
with the out-of-core seen tiers.  In the level mode
the frontier and the seen table live on the device; each BFS level is
one step:

  1. unpack the frontier                   K1 unpack_rows  (CUDA)
  2. expand every (state x grounded action) compile/kernel2.py emitter
  3. pack the successors, compute keys     K2 keys_of      (CUDA)
     (cfg SYMMETRY: over the orbit minima  K5 canon_rows   (CUDA);
      cfg VIEW: over the view's lanes      the emitter)
  4. with --por: probe the keys against    K3 seen_probe   (CUDA)
     the pre-level seen table and mask
     every non-ample arm's candidates      K6 por_mask     (CUDA)
  5. stable-sort the candidate keys        K18 sort_keys   (CUDA)
  6. probe them against the sorted seen    K3 seen_probe   (CUDA)
  7. rank-merge the new keys into the table K4 rank_merge  (CUDA)
  8. apply the CONSTRAINTs                 the emitter
  9. order the next frontier by provenance K18 front_order (CUDA)
  10. check the invariants                 the emitter

Two dedup modes, as the reference: exact (keys are the key basis) and
fp128 (keys are four 32-bit mixes of it) when the key width passes
FP_THRESHOLD or seen_mode="fingerprint".  The key basis is the packed
row, the packed orbit minimum (SYMMETRY) or the view lanes (VIEW, over
the orbit minimum when both are declared); the stored rows stay the
raw states, so traces decode them unchanged.  Capacities are
power-of-two buckets that grow on demand.  Parent provenance streams to
the host per level for counterexample traces (store_trace=False skips
it).  The step reads its verdict scalars in one small tensor: one host
synchronisation per level.

host_seen=True runs the chunked engine (_run_host_seen): the seen set
is the native host fingerprint store (jaxmc_torch/native_store.py), the
frontier stays on the host, and each chunk of `chunk` rows is one step
(_hstep): K1, the emitter, K2 (fp128), the predicates, then K7
hstep_epilogue (CUDA), which reduces the verdict scalars and compacts
the valid candidates in candidate order so that the host reads only
those.  The host inserts their fingerprints into the store and keeps
the new rows.  This is the mode that runs hybrid specs: arms,
invariants and constraints the compiler rejects are evaluated by the
interpreter (_fb_expand_level and the host predicate loops), and a
guard demotion that fires mid-search relayouts or demotes its arm and
restarts (run / _run_hybrid).

resident=True runs the resident engine (_run_resident): the seen
table, the frontier and a level's candidate accumulator stay on the
device.  Per level the host enqueues ceil(fcount / chunk) chunk bodies
(_res_chunk: K1, the emitter, K8 resident_compact — the verdict
partials and the first VC valid candidates — the VC gather, K2, the
POR branch, K9 resident_fold, which appends the block and folds the
status only while the device status is ST_CONTINUE) and the level end
(_res_level: the rank merge of the accumulator, the CONSTRAINTs, K8
over the explore mask, the invariants), then reads one summary vector.
On an ST_OVF_* status it keeps the pre-level tensors, grows the named
capacity and redoes the level.  No traces: a violation names the state
it reached.

seen_cap (the level and resident engines) caps the device seen table:
past it the sorted table spills to host-RAM and disk runs
(backend/tiers.py) and each level's new rows are probed against them
before they are counted or explored.

Every engine checkpoints at level boundaries (checkpoint_path,
checkpoint_every, resume_from, final_checkpoint; the file is
engine/ckpt.py's container, and the level and host-seen engines also
write the interpreter-format `<checkpoint>.host` snapshot) and polls
drain.py's request there.  JAXMC_LEVEL_RANKMERGE=0 replaces steps 5-7
with the full sort: one stable sort of seen table and candidates, then
K11 fullsort_dedup (CUDA).

Modes this port does not run raise ModeError with the ROADMAP item
that ports them.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..analyze import (bounds_enabled, infer_state_bounds,
                       predict_arm_demotions, predict_enabled)
from ..compile.ground import ground_arm, split_arms
from ..compile.kernel2 import (KernelCtx, OV_DEMOTED, OV_PACK,
                               build_layout2, compile_action2,
                               compile_predicate2, compile_value2)
from ..compile.vspec import Bounds, CompileError, ModeError
from ..engine.explore import CheckResult, Violation
from ..engine.simulate import sample_states
from ..kernels import ops
from ..kernels.ops import (ST_ASSERT, ST_CONTINUE, ST_DEADLOCK, ST_DONE,
                           ST_INV, ST_OVF_ACC, ST_OVF_FRONT, ST_OVF_LANES,
                           ST_OVF_SEEN, ST_OVF_VC, ST_TRUNC)
from ..sem.enumerate import enumerate_init
from ..sem.modules import Model

SENTINEL = np.int32(2**31 - 1)
FP_THRESHOLD = 48  # key lanes; beyond this, dedup on 128-bit fingerprints

SYMMETRY_WARNING = (
    "cfg SYMMETRY NOT applied on the jax backend: counts are "
    "unreduced and will exceed the interp/TLC reduced counts")


def filter_init_states(model, layout, init_rows):
    """Apply TLC's CONSTRAINT-discard semantics to encoded init rows:
    returns (explored_indices, (invariant_name, state) | None). Violating
    inits are fingerprinted by the caller but never counted distinct,
    invariant-checked, or explored; invariants run on kept inits only
    (host-side interpreter — init sets are small)."""
    from ..sem.modules import satisfies_constraints
    from ..sem.eval import eval_expr, _bool
    explored = []
    for i, row in enumerate(init_rows):
        st = layout.decode(row)
        if not satisfies_constraints(model, st):
            continue
        ctx = model.ctx(state=st)
        for nm, ex in model.invariants:
            if not _bool(eval_expr(ex, ctx), f"invariant {nm}"):
                return explored, (nm, st)
        explored.append(i)
    return explored, None


_POR_UNSET = object()
_NO_REPORT = object()


def _pow2_at_least(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _por_mask_np(found, cvalid, inst_arm, arm_safe, A, FC):
    """The persistent-set mask of bfs._por_mask in numpy, for the
    host_seen engine's host-side filter against the native store
    (bfs._por_mask_np).  Returns (keep [A*FC], n_ample, n_expanded)."""
    n_arms = arm_safe.shape[0]
    cv = cvalid.reshape(A, FC)
    bad = (found & cvalid).reshape(A, FC)
    one_hot = (np.arange(n_arms)[:, None] == inst_arm[None, :])
    en_cnt = one_hot.astype(np.int64) @ cv.astype(np.int64)
    bad_cnt = one_hot.astype(np.int64) @ bad.astype(np.int64)
    elig = arm_safe[:, None] & (en_cnt > 0) & (bad_cnt == 0)
    has = np.any(elig, axis=0)
    chosen = np.argmax(elig, axis=0)
    keep_inst = (~has)[None, :] | (inst_arm[:, None] == chosen[None, :])
    keep = keep_inst.reshape(A * FC) & cvalid
    slot_en = np.any(cv, axis=0)
    n_ample = int(np.sum(has & slot_en))
    n_expanded = int(np.sum(slot_en))
    return keep, n_ample, n_expanded


def _site(name: str):
    """Register the decorated engine step as the named dispatch site of
    the profiler (obs/prof.py), under the reference's site name."""
    return lambda fn: obs.prof_wrap(name, fn)


def resolve_device(device) -> torch.device:
    """`None` means the card.  Without CUDA that is an error that names
    the explicit CPU choice — the engine never falls back by itself."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchExplorer runs on the CUDA card by default and no CUDA "
            "device is available; pass device=\"cpu\" to run on the CPU")
    return dev


class _LiveGraph:
    """Host-side behavior-graph accumulator (bfs._LiveGraph).

    Mirrors the interp engine's bookkeeping (engine/explore.py): kept
    states get dense ids in discovery order; edges record every
    (parent, kept-successor) step including re-visits of already-seen
    states; parents/labels form the BFS tree for trace reconstruction.
    Constraint-discarded successors never enter the graph — the same
    mask that keeps them off the frontier keeps them out here."""

    def __init__(self, labels_flat: List[str], collect_edges: bool):
        self.labels_flat = labels_flat
        self.collect_edges = collect_edges
        self.rows: List[np.ndarray] = []
        self.sid_by_key: Dict[bytes, int] = {}
        self.parents: List[Optional[int]] = []
        self.labels: List[str] = []
        self.edges: List[Tuple[int, int]] = []

    def add_inits(self, init_rows, explored_idx) -> np.ndarray:
        sids = []
        for i in explored_idx:
            row = np.array(init_rows[i], copy=True)
            sid = len(self.rows)
            self.rows.append(row)
            self.sid_by_key[row.tobytes()] = sid
            self.parents.append(None)
            self.labels.append("Initial predicate")
            sids.append(sid)
        return np.asarray(sids, dtype=np.int64)

    def add_level(self, new_rows, new_prov, par_div: int,
                  frontier_sids: np.ndarray) -> np.ndarray:
        """Register this level's kept rows; prov = action*par_div + f."""
        sids = []
        for i in range(len(new_rows)):
            row = np.array(new_rows[i], copy=True)
            sid = len(self.rows)
            self.rows.append(row)
            self.sid_by_key[row.tobytes()] = sid
            p = int(new_prov[i])
            a, f = p // par_div, p % par_div
            self.parents.append(int(frontier_sids[f]))
            self.labels.append(self.labels_flat[a])
            sids.append(sid)
        return np.asarray(sids, dtype=np.int64)

    def add_edges(self, rows: np.ndarray, parent_f: np.ndarray,
                  frontier_sids: np.ndarray) -> None:
        """Record edges (frontier_sids[parent_f[i]] -> sid of rows[i]) for
        kept candidates; call after add_level so same-level successors
        resolve.  A target resolves by its packed row's bytes."""
        if not self.collect_edges:
            return
        for i in range(len(rows)):
            t = self.sid_by_key.get(rows[i].tobytes())
            if t is None:
                continue  # fp-collision shadow; counts already report it
            self.edges.append(
                (int(frontier_sids[int(parent_f[i])]), t))


class TorchExplorer:
    """Level-synchronous BFS over the device-resident seen table, or
    (host_seen=True) over the native host fingerprint store in chunks,
    or (resident=True) with the whole level loop on the device."""

    def __init__(self, model: Model, log: Callable[[str], None] = None,
                 max_states: Optional[int] = None, store_trace: bool = True,
                 progress_every: float = 30.0,
                 bounds: Optional[Bounds] = None,
                 sample_cfg: Tuple[int, int, int] = (800, 40, 60),
                 seen_mode: str = "auto", device=None,
                 twins: bool = False, por: bool = False,
                 host_seen: bool = False, chunk: int = 2048,
                 extra_samples: Optional[List[Dict[str, Any]]] = None,
                 relayouts_left: int = 3,
                 seen_cap: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 host_tier_keys: Optional[int] = None,
                 resident: bool = False,
                 res_caps: Optional[Dict[str, int]] = None,
                 lift_consts: Optional[Tuple[str, ...]] = None,
                 donor: Optional["TorchExplorer"] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: float = 600.0,
                 resume_from: Optional[str] = None,
                 final_checkpoint: bool = False,
                 pin_interp_arms: bool = False):
        # cross-model batching: `lift_consts` compiles the named
        # CONSTANTs as per-row inputs of the emitter instead of baked
        # scalars, so one engine serves every model that differs only in
        # those values; `donor` clones a FOLLOWER engine that reuses the
        # donor's layout and compiled units while keeping its own model,
        # init states and seen store (backend/batch.py)
        self._hstep_override: Optional[Callable] = None
        # checkpoints (engine/ckpt.py's JMCKPT1 container) are written
        # between levels, so a resume always starts at a level boundary;
        # final_checkpoint also checkpoints a COMPLETED run (an empty
        # frontier over the whole seen set), which a resume replays
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.resume_from = resume_from
        self.final_checkpoint = bool(final_checkpoint)
        # device POR: the plan (instance -> arm map, por-safe arms) is
        # resolved once by _por_plan(), which names the refusal when the
        # reduction cannot run
        self.por = bool(por)
        self.por_reason: Optional[str] = None
        self._por_memo: Any = _POR_UNSET
        self._por_stats = {"ample": 0, "expanded": 0, "masked": 0}
        if donor is not None:
            self._clone_from_donor(donor, model, log=log,
                                   max_states=max_states,
                                   store_trace=store_trace,
                                   progress_every=progress_every)
            return
        self._lift_names: Tuple[str, ...] = tuple(lift_consts or ())
        if self._lift_names and not host_seen:
            raise ModeError(
                "lifted-constant (batchable) engines run in host_seen "
                "mode only — the level/resident/mesh steps do not "
                "thread constant lanes")
        # twins=True runs the kernels' plain PyTorch twins on the same
        # device: the parity oracle for the CUDA path (tests and
        # chip_smoke.py pass it; nothing else does)
        self.device = resolve_device(device)
        self.twins = bool(twins)
        # the generated kernels (K15-K17), built at the end for a card
        # engine without twins (_build_gen)
        self._gen = None
        self._gen_first: Dict[int, int] = {}
        self.model = model
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.max_states = max_states
        self.store_trace = store_trace
        self.progress_every = progress_every
        self.bounds = bounds or Bounds()
        self.sample_cfg = sample_cfg
        # host_seen: the chunked engine whose seen set is the native
        # host fingerprint store (jaxmc_torch/native_store.py); the only
        # mode that runs hybrid specs
        self.host_seen = bool(host_seen)
        self.chunk = chunk
        # resident: the whole level loop stays on the device and the host
        # reads one summary vector per level (_run_resident); res_caps
        # are the caller's starting capacities (SC, FCap, AccCap, VC)
        self.resident = bool(resident)
        self._res_caps_hint = dict(res_caps) if res_caps else None
        # ADAPTIVE RELAYOUT (hybrid, host_seen): when a compile-recovery
        # demotion fires because a value SHAPE was never observed by the
        # layout sampler, the engine re-samples from the abort-time
        # frontier, rebuilds the layout and kernels with the enriched
        # observation set, and restarts compiled — falling back to
        # whole-arm interpretation only after relayouts_left attempts.
        self.extra_samples = list(extra_samples or [])
        self.relayouts_left = relayouts_left
        self.seen_mode_req = seen_mode
        # the corpus manifest's interp-arms pin: every arm goes to the
        # interpreter and no arm is grounded or built
        self.pin_interp_arms = bool(pin_interp_arms)
        self._last_frontier_np: Optional[np.ndarray] = None
        self._refuse_modes(model, self.resident, self.host_seen)

        tel = obs.current()
        base_ctx = model.ctx()
        self.init_states = enumerate_init(model.init, base_ctx, model.vars)
        bfs_n, walks, depth = sample_cfg
        with tel.span("layout_sample", bfs_states=bfs_n, walks=walks,
                      walk_depth=depth):
            sampled = sample_states(model, bfs_states=bfs_n,
                                    n_walks=walks, walk_depth=depth)
        sampled = list(sampled) + self.extra_samples
        # static bounds inference: proven intervals size the packed
        # lanes exactly as the reference's default does, so the lane
        # plan (and every key) is bit-identical to it
        static_bounds = None
        if bounds_enabled():
            # cached on the model, as the reference does: a batch donor
            # finds the cohort's merged bounds there (backend/batch.py)
            rep = getattr(model, "_bounds_report", _NO_REPORT)
            if rep is _NO_REPORT:
                with tel.span("analyze_bounds"):
                    rep = infer_state_bounds(model)
                try:
                    model._bounds_report = rep
                except AttributeError:
                    pass
            if rep is not None:
                ebf = getattr(rep, "element_bounds", None)
                static_bounds = ebf() if callable(ebf) else rep.lane_bounds()
                tel.gauge("analyze.bounds_converged", bool(rep.converged))
        with tel.span("layout_build", samples=len(sampled)):
            self.layout = build_layout2(model, sampled, self.bounds,
                                        static_bounds=static_bounds)
        self.kc = KernelCtx(model, self.layout, self.bounds)
        # this model's lifted-constant values, in _lift_names order
        # (empty for ordinary engines — same code path)
        self._cvec = np.asarray([int(model.defs[n])
                                 for n in self._lift_names], np.int32)
        self.W = self.layout.width
        self.PW = self.layout.packed_width
        self.plan = self.layout.plan

        # every compiled unit runs once on a one-row zero block here, so
        # a lazy CompileError surfaces at build time, as the reference's
        # forced abstract trace (jax.eval_shape) makes it
        zero = torch.zeros((1, self.W), dtype=torch.int32,
                           device=self.device)
        self.arms = split_arms(model)
        self.actions = []
        self.compiled = []
        self._ca_arm: List[int] = []  # arm index per compiled action
        # hybrid execution: an arm whose grounding or kernel compilation
        # fails is demoted to exact interpreter enumeration over decoded
        # frontier states (host_seen mode only) instead of rejecting
        # the spec
        self.fb_arms: List[Tuple[Any, str]] = []  # (ActionArm, reason)
        if self.pin_interp_arms:
            self.fb_arms = [(arm, "pinned interp-arms (corpus "
                                  "manifest): kernel construction "
                                  "skipped") for arm in self.arms]
        # statically predicted demotions (analyze/verdicts.py): an arm
        # the compiler is certain to demote skips grounding and its
        # build; the verdict is the build-time reason string
        self.arm_verdicts: Dict[int, str] = {}
        if not self.pin_interp_arms and predict_enabled() and self.arms:
            with tel.span("analyze_arms", arms=len(self.arms)):
                self.arm_verdicts = predict_arm_demotions(model, self.arms)
            if self.arm_verdicts:
                tel.counter("analyze.predicted_demotions",
                            len(self.arm_verdicts))
                tel.gauge("analyze.arm_verdicts",
                          {(self.arms[i].label or "Next"): r
                           for i, r in sorted(self.arm_verdicts.items())})
        for ai, arm in enumerate(() if self.pin_interp_arms else self.arms):
            if ai in self.arm_verdicts:
                self.fb_arms.append((arm, self.arm_verdicts[ai]))
                continue
            try:
                with tel.span("compile_arm", arm=arm.label or "Next"):
                    gas = ground_arm(model, arm,
                                     dyn_slots=self.bounds.kv_cap)
                    cas = []
                    for ga in gas:
                        ca = compile_action2(self.kc, ga)
                        for s in (range(ca.n_slots) if ca.n_slots
                                  else [None]):
                            self._traced_with(ca.fn, zero, s)
                        cas.append(ca)
            except CompileError as e:
                self.fb_arms.append((arm, str(e)))
                continue
            except RecursionError:
                self.fb_arms.append(
                    (arm, "recursive operator expansion diverges at "
                          "compile time (RecursionError)"))
                continue
            self.actions.extend(gas)
            self.compiled.extend(cas)
            self._ca_arm.extend([ai] * len(cas))
        for _arm, _reason in self.fb_arms:
            self.log(f"-- arm {_arm.label or 'Next'}: interp-demoted "
                     f"({_reason})")
        # kernels that compiled only by DEMOTING a guard conjunct (False
        # + abort flag) under-approximate behind a runtime abort; when
        # one fires, the host_seen engine demotes those arms to the
        # interpreter and restarts the search (see run())
        self._demotable = sorted({self._ca_arm[i]
                                  for i, ca in enumerate(self.compiled)
                                  if ca.demoted_guards})
        self.labels_flat: List[str] = []
        for ca in self.compiled:
            self.labels_flat.extend([ca.label] * (ca.n_slots or 1))
        # cfg SYMMETRY: key on each row's orbit minimum (same partition,
        # hence same counts, as the reference); an encoding build_canon2
        # rejects runs unreduced with the SYMMETRY warning, as the
        # reference does.  An identity group builds no canonicaliser and
        # warns of nothing: there is no reduction to diverge from.
        self.canon = None
        self._sym_fallback: Optional[str] = None
        if model.symmetry is not None:
            from ..compile.symmetry2 import build_canon2
            try:
                self.canon = build_canon2(model, self.layout)
            except CompileError as e:
                self._sym_fallback = str(e)
        self.sym_identity = (model.symmetry is not None
                             and self.canon is None
                             and self._sym_fallback is None)

        # predicates likewise force-evaluated; uncompilable ones demote
        # to host-side interpreter evaluation over decoded rows (hybrid).
        # A BUDGET (JAXMC_PRED_TRACE_BUDGET seconds, default 15) on the
        # forced one-row evaluation also demotes predicates whose
        # programs explode, in host_seen mode only (the other modes
        # keep slow compiled predicates rather than refuse the spec)
        budget = float(os.environ.get("JAXMC_PRED_TRACE_BUDGET", "15"))

        def compile_preds(pairs, may_demote_on_budget):
            compiled, demoted = [], []
            for nm, ex in pairs:
                f = compile_predicate2(self.kc, ex)
                t_tr = time.time()
                try:
                    self._traced_with(f, zero)
                except CompileError as e:
                    demoted.append((nm, ex, str(e)))
                    continue
                except RecursionError:
                    demoted.append(
                        (nm, ex, "recursive operator expansion diverges "
                                 "at compile time (RecursionError)"))
                    continue
                t_tr = time.time() - t_tr
                if t_tr > budget and may_demote_on_budget:
                    demoted.append(
                        (nm, ex,
                         f"trace budget exceeded ({t_tr:.0f}s > "
                         f"{budget:.0f}s [JAXMC_PRED_TRACE_BUDGET]; the "
                         f"compiled program would dwarf the model)"))
                    continue
                compiled.append((nm, f))
            return compiled, demoted

        with tel.span("compile_predicates",
                      invariants=len(model.invariants),
                      constraints=len(model.constraints)):
            self.inv_fns, self.fb_invs = compile_preds(model.invariants,
                                                       self.host_seen)
            # constraints under temporal/refinement PROPERTYs keep slow
            # compiled programs: a demotion would make the run refused
            self.constraint_fns, self.fb_cons = compile_preds(
                model.constraints, self.host_seen and not model.properties)
        # cfg VIEW: key the dedup on the view's value lanes (TLC
        # fingerprints the view); the stored rows stay full states
        self.view_fn = None
        self.view_width = 0
        if getattr(model, "view", None) is not None:
            try:
                self.view_fn = compile_value2(self.kc, model.view)
                vz = self.view_fn(zero)
                self.view_width = int(np.prod(vz.shape[1:]))
            except RecursionError:
                raise CompileError(
                    "cfg VIEW expression recurses unboundedly at compile "
                    "time - use --backend interp")
            if self.view_width == 0:
                raise CompileError(
                    "cfg VIEW evaluates to zero lanes - use --backend "
                    "interp")
        # refinement PROPERTYs check stepwise on the host over the
        # streamed candidate edges; temporal obligations check over the
        # behavior graph after the search (engine/liveness.py), as the
        # interp engine does: same classifier, same checker
        from ..engine.liveness import collect_obligations
        from ..engine.refinement import build_refinement_checkers
        self.refiners, self.unrefined = build_refinement_checkers(model)
        self._ref_pair_cache: set = set()
        self.live_obligations, self.live_unsupported, self.collect_edges = \
            collect_obligations(model, self.refiners)
        self._need_edges = bool(self.refiners) or self.collect_edges
        self.hybrid = bool(self.fb_arms or self.fb_invs or self.fb_cons)
        if self.hybrid:
            reasons = "; ".join(
                [f"action arm {a.label or 'Next'}: {r}"
                 for a, r in self.fb_arms]
                + [f"invariant {nm}: {r}" for nm, _, r in self.fb_invs]
                + [f"constraint {nm}: {r}" for nm, _, r in self.fb_cons])
            if not self.host_seen:
                raise ModeError(
                    "spec needs hybrid execution (uncompilable units "
                    "demoted to the exact interpreter), which only the "
                    "host_seen device mode runs — pass host_seen=True; "
                    f"demoted units: {reasons}")
            if self.fb_cons and (self.collect_edges or self.refiners):
                raise CompileError(
                    "uncompilable CONSTRAINT together with temporal/"
                    "refinement PROPERTYs is not supported on the device "
                    f"backend — use --backend interp; units: {reasons}")
            if not self.compiled and self.fb_arms:
                self.log("hybrid: EVERY action arm fell back to the "
                         "interpreter — the device does hashing/dedup "
                         "only on this model")

        # device flat-instance count; fallback arm j takes provenance
        # index A + j so traces resolve labels through one table
        self.A = len(self.labels_flat)
        self.labels_flat = self.labels_flat + \
            [arm.label or "Next" for arm, _ in self.fb_arms]
        tel.gauge("expand.arms_total", len(self.arms))
        tel.gauge("expand.arms_compiled",
                  len(self.arms) - len(self.fb_arms))
        tel.gauge("expand.arms_interp", len(self.fb_arms))
        tel.gauge("expand.invariants_interp", len(self.fb_invs))
        tel.gauge("expand.constraints_interp", len(self.fb_cons))
        tel.gauge("expand.mode",
                  "compiled" if not self.fb_arms
                  else ("hybrid" if self.A else "interp-arms"))
        self.key_width = self.view_width if self.view_fn is not None \
            else self.PW
        self.fp_mode = self.key_width > FP_THRESHOLD
        if self.resident:
            # resident dedup keys are always 128-bit fingerprints: the
            # merge is built for a fixed 4-word key; no traces
            self.store_trace = False
            self.fp_mode = True
        if self.host_seen:
            from .. import native_store
            if not native_store.is_available():
                raise CompileError(f"host_seen requires the native store: "
                                   f"{native_store.build_error()}")
            # narrow layouts also hash fine; the host store is fp-based
            self.fp_mode = True
        if seen_mode not in ("auto", "exact", "fingerprint"):
            raise ModeError(f"unknown --seen mode {seen_mode!r} "
                            f"(expected auto, exact or fingerprint)")
        if seen_mode == "fingerprint":
            self.fp_mode = True
        elif seen_mode == "exact" and self.fp_mode:
            if self.host_seen or self.resident:
                raise ModeError(
                    "--seen exact is incompatible with the resident/"
                    "host_seen modes (their dedup machinery is "
                    "fingerprint-based) — use the level device mode")
            raise ModeError(
                f"--seen exact refused: the dedup key is "
                f"{self.key_width} lanes wide (> FP_THRESHOLD="
                f"{FP_THRESHOLD}); exact keys "
                f"at this width would dominate device memory — use "
                f"--seen fingerprint (collision probability is reported)")
        # dedup key lanes: an explicit validity lane FIRST (0=valid row,
        # 1=invalid), then the key basis or its 4-word fingerprint
        self.K = (4 if self.fp_mode else self.key_width) + 1
        # out-of-core seen set: a device seen cap (rows of the key table;
        # JAXMC_SEEN_CAP is the test knob) turns device growth into a
        # spill of the sorted device prefix to host-RAM and disk runs
        # (backend/tiers.py), probed before rows are counted or explored;
        # counts stay those of the uncapped run.  The host-seen engine's
        # store needs none (its run logs that the cap is ignored)
        env_cap = os.environ.get("JAXMC_SEEN_CAP")
        self.seen_cap = int(seen_cap if seen_cap is not None
                            else (env_cap if env_cap else 0)) or None
        if self.seen_cap is not None:
            self.seen_cap = _pow2_at_least(self.seen_cap, lo=64)
            tel.gauge("tier.device_cap", self.seen_cap)
        self.spill_dir = spill_dir or os.environ.get("JAXMC_SPILL_DIR")
        self.host_tier_keys = host_tier_keys
        self._tiers = None  # created at the first spill
        self.pt = self.plan.tensors(self.device)
        tel.gauge("expand.compiled_instances", self.A)
        tel.gauge("layout.width_lanes", self.W)
        tel.gauge("layout.packed_width_lanes", self.PW)
        tel.gauge("seen.mode", "fingerprint" if self.fp_mode else "exact")
        tel.gauge("dedup.mode",
                  ("fp128" if self.fp_mode else "exact")
                  + ("-view" if self.view_fn is not None
                     else ("-packed" if not self.plan.identity else "")))
        tel.gauge("backend.device", str(self.device))
        # the reference's device-layer gauges; its donation rule (on
        # for accelerators) is what the in-place updates give here
        platform = "gpu" if self.device.type == "cuda" else "cpu"
        tel.gauge("device.donation", platform != "cpu")
        tel.gauge("backend.platform", platform)
        tel.gauge("backend.profile_ns", platform)
        # B.1 on the card: every compiled unit (each instance slot by
        # slot, each invariant and constraint, the VIEW) as CUDA C++
        # generated from the emitter's capture and built once for this
        # engine (K15-K17); the emitter stays their twin and the CPU path
        if self.device.type == "cuda" and not self.twins:
            self._build_gen()

    def _build_gen(self) -> None:
        """Capture, generate and build this engine's units (one nvcc),
        then route _expand to K15 and the predicate and VIEW callables
        to K16 / K17.  A unit the generator cannot translate, or a
        failed build, raises naming the unit: nothing runs the emitter
        on the card instead."""
        from ..compile import cgen
        preds = list(self.inv_fns) + list(self.constraint_fns)
        if not (self.compiled or preds or self.view_fn is not None):
            return                  # every arm interpreted: no unit
        gm = cgen.build_module(self.kc, self.W, self.compiled, preds,
                               self.view_fn, self._lift_names)
        gm.load()
        self._gen = gm
        first, i = {}, 0
        for ca in self.compiled:
            first[id(ca)] = i
            i += ca.n_slots or 1
        self._gen_first = first
        self._gen_units_memo = None
        ninv = len(self.inv_fns)
        self.inv_fns = [(nm, self._gen_pred_fn(i))
                        for i, (nm, _f) in enumerate(self.inv_fns)]
        self.constraint_fns = [(nm, self._gen_pred_fn(ninv + i))
                               for i, (nm, _f) in
                               enumerate(self.constraint_fns)]
        if self.view_fn is not None:
            self.view_fn = self._gen_value_fn()

    def _gen_cvals(self) -> Optional[torch.Tensor]:
        """The lifted constants a generated kernel reads: the member
        table _set_const_lanes bound ([M, L]: one row per member), or
        this model's values when none is bound (the emitter then bakes
        the same values)."""
        if not self._lift_names:
            return None
        if self._gen.cv is None:
            return torch.as_tensor(self._cvec[None], device=self.device)
        return self._gen.cv

    def _gen_units(self, device) -> torch.Tensor:
        """K15's instance -> unit map for the current compiled list (a
        demotion drops arms from it; the module keeps every unit)."""
        key = tuple(id(ca) for ca in self.compiled)
        memo = getattr(self, "_gen_units_memo", None)
        if memo is None or memo[0] != key:
            ids = [self._gen_first[id(ca)] + s for ca in self.compiled
                   for s in range(ca.n_slots or 1)]
            memo = (key, torch.as_tensor(np.asarray(ids, np.int32),
                                         device=device))
            self._gen_units_memo = memo
        return memo[1]

    def _gen_pred_fn(self, which: int) -> Callable:
        gm = self._gen

        def f(rows):
            return ops.gen_pred(gm, which, rows, self._gen_cvals())
        return f

    def _gen_value_fn(self) -> Callable:
        gm = self._gen

        def f(rows):
            return ops.gen_value(gm, rows, self._gen_cvals())
        return f

    @staticmethod
    def _refuse_modes(model: Model, resident: bool, host_seen: bool) -> None:
        if resident and host_seen:
            raise ModeError(
                "resident and host_seen are mutually exclusive: "
                "resident keeps the seen-set on device, host_seen "
                "keeps it in the native host store")
        if resident and model.properties:
            from ..engine.liveness import collect_obligations
            from ..engine.refinement import build_refinement_checkers
            refiners, _ = build_refinement_checkers(model)
            if refiners:
                raise ModeError(
                    "resident mode cannot check refinement PROPERTYs "
                    "(stepwise host checking needs the edge stream) - "
                    "use the level/host_seen device modes")
            if collect_obligations(model, refiners)[0]:
                raise ModeError(
                    "resident mode cannot check temporal properties "
                    "(the behavior graph stays on device) - use the "
                    "level/host_seen device modes")
        if model.action_constraints:
            raise CompileError("action constraints not compiled yet - "
                               "use the interp backend")

    # ---- the kernels, or their twins on the same device ----

    def _unpack(self, packed: torch.Tensor) -> torch.Tensor:
        return self.plan.unpack_rows(packed, twin=self.twins)

    def _canon(self, rows: torch.Tensor, valid: torch.Tensor):
        f = ops.canon_rows_twin if self.twins else ops.canon_rows
        return f(rows, valid, self.canon)

    def _keys_of(self, rows: torch.Tensor, valid: torch.Tensor):
        """(keys [N, K], packed [N, PW], pack_ovf 0-d bool) for a block
        of UNPACKED rows (bfs._keys_of).  The key basis is the packed
        row; with cfg SYMMETRY the packed orbit minimum, whose range
        guard joins pack_ovf (OV_PACK, never a wrong count); with cfg
        VIEW the view's lanes, evaluated over the orbit minimum when
        SYMMETRY is declared too.  The packed rows are the raw states."""
        basis, basis_packed = None, False
        if self.canon is not None or self.view_fn is not None:
            crows = rows if self.canon is None else \
                self._canon(rows, valid)
            if self.view_fn is not None:
                basis = self.view_fn(crows).reshape(
                    rows.shape[0], -1).to(torch.int32).contiguous()
            else:
                basis, basis_packed = crows, True
        f = ops.keys_of_twin if self.twins else ops.keys_of
        return f(rows, valid, self.pt, self.fp_mode, self.plan.identity,
                 basis=basis, basis_packed=basis_packed)

    def _por_filter(self, seen, seen_count: int, ckeys, cvalid, FC: int):
        """The device persistent-set filter: K3 probes the candidate keys
        against the PRE-level seen table, K6 picks each slot's ample arm.
        Returns (keep [C] bool, n_ample, n_expanded, n_masked)."""
        plan = self._por_memo
        if self.twins:
            found, _ = ops.seen_probe_twin(seen, seen_count, ckeys)
            return ops.por_mask_twin(found, cvalid, plan["inst_arm_t"],
                                     plan["arm_safe_t"], self.A, FC)
        found, _ = ops.seen_probe(seen, seen_count, ckeys, site="por")
        return ops.por_mask(found, cvalid, plan["inst_arm_t"],
                            plan["arm_safe_t"], self.A, FC)

    def _sort_keys(self, keys):
        """(skeys, sidx int32): the stable K-word sort of key rows with
        their indices, K18 or its twin."""
        f = ops.sort_keys_twin if self.twins else ops.sort_keys
        return f(keys)

    def _merge_sorted(self, seen, seen_count: int, skeys, sidx):
        """bfs._rank_merge after its sort: K3 probes the sorted keys
        against the seen prefix and K4 merges the new ones (or their
        twins)."""
        if self.twins:
            found, lb = ops.seen_probe_twin(seen, seen_count, skeys)
            return ops.merge_sorted_twin(seen, seen_count, skeys, sidx,
                                         found, lb)
        found, lb = ops.seen_probe(seen, seen_count, skeys)
        return ops.merge_sorted(seen, seen_count, skeys, sidx, found, lb)

    def _rank_merge(self, seen, seen_count: int, keys):
        skeys, sidx = self._sort_keys(keys)
        return self._merge_sorted(seen, seen_count, skeys, sidx)

    def _front_order(self, explore, prov, FC: int):
        """The next frontier's order by provenance (bfs.py:1879-1883):
        K18's front_order site, or its twin."""
        f = ops.front_order_twin if self.twins else ops.front_order
        return f(explore, prov, self.A, FC)

    def _full_sort(self, seen, seen_count: int, keys):
        """The full-sort merge (bfs.py:1820-1851, JAXMC_LEVEL_RANKMERGE=0):
        a stable sort of the whole seen table and the candidate keys,
        then K11 flags the first candidate of each run of equal valid
        keys and compacts the new candidates' indices and the merged
        table.  The flag, the reference's last sort key, is the
        concatenation order itself (seen rows first), so the stable
        K-word sort gives its permutation.  The rows past the live
        prefix are marked invalid first: K11 leaves them unwritten (the
        reference carries its duplicate keys there into the next sort,
        where they are kept again and only inflate seen_count).
        Returns the dict _rank_merge returns."""
        SC, K = seen.shape
        C = keys.shape[0]
        allk = torch.cat([seen, keys])
        allk[seen_count:SC, 0] = int(SENTINEL)
        skeys, perm = self._sort_keys(allk)
        sflag = (perm >= SC).to(torch.int32)
        f = ops.fullsort_dedup_twin if self.twins else ops.fullsort_dedup
        new_cidx, seen2, counts = f(skeys, sflag, perm, SC, C)
        return dict(new_count=counts[0], nk_sidx=new_cidx, seen2=seen2,
                    seen_count2=counts[1])

    @_site("bfs.host_keys")
    def _host_keys(self, rows_np: np.ndarray):
        """(keys, packed, pack_ovf) over unpacked numpy rows — the init
        boundary path.  numpy in, numpy out."""
        if len(rows_np) == 0:
            return (np.zeros((0, self.K), np.int32),
                    np.zeros((0, self.PW), np.int32), False)
        rows = torch.as_tensor(np.ascontiguousarray(rows_np, np.int32),
                               device=self.device)
        valid = torch.ones(len(rows_np), dtype=torch.bool,
                           device=self.device)
        k, p, o = self._keys_of(rows, valid)
        return k.cpu().numpy(), p.cpu().numpy(), bool(o)

    def _expand(self, frontier: torch.Tensor):
        """(en, aok, ov [A, FC], succ [A, FC, W]): every compiled
        instance over the frontier block; slotted kernels give one
        instance row per slot, in slot order."""
        if self._gen is not None:
            return ops.gen_expand(self._gen, frontier,
                                  self._gen_units(frontier.device),
                                  self._gen_cvals())
        FC = frontier.shape[0]
        dev = frontier.device
        en = torch.empty((self.A, FC), dtype=torch.bool, device=dev)
        aok = torch.empty((self.A, FC), dtype=torch.bool, device=dev)
        ov = torch.empty((self.A, FC), dtype=torch.int32, device=dev)
        succ = torch.empty((self.A, FC, self.W), dtype=torch.int32,
                           device=dev)
        i = 0
        for ca in self.compiled:
            for s in (range(ca.n_slots) if ca.n_slots else [None]):
                out = ca.fn(frontier) if s is None else ca.fn(frontier, s)
                en[i], aok[i], ov[i], succ[i] = out
                i += 1
        return en, aok, ov, succ

    # ---- one BFS level ----

    @_site("bfs.level_step")
    def level_step(self, seen, seen_count: int, frontier_p, fcount: int):
        """One fused level over seen [SC, K] (sorted valid prefix of
        seen_count rows) and frontier_p [FC, PW] (fcount valid rows).
        Requires seen_count + A*FC <= SC.  Returns a dict of device
        tensors; `scalars` is one int64 vector read with one copy:
        [overflow, assert_any, assert_a, assert_f, dead_any, dead_f,
         gen, front_count, seen_count2, inv_any, inv_idx, inv_which],
        followed by [por_ample, por_expanded, por_masked] when the
        device POR filter runs, or by the edge count when the run
        streams edges (PROPERTYs; the two never meet: por_refusal turns
        POR off for a model with PROPERTYs).  With edges the dict also
        holds `edge_idx` (K8's stable partition of the kept candidates'
        indices a*FC+f) and `cand` (the packed candidate rows)."""
        A, W, K = self.A, self.W, self.K
        FC = frontier_p.shape[0]
        dev = frontier_p.device
        frontier = self._unpack(frontier_p)
        fvalid = torch.arange(FC, device=dev) < fcount
        en, aok, ov, succ = self._expand(frontier)
        valid = en & fvalid[None, :]
        assert_bad = (~aok) & fvalid[None, :]
        overflow = torch.where(fvalid[None, :], ov, 0)
        dead = fvalid & ~en.any(dim=0)
        gen = valid.sum()

        C = A * FC
        cand_u = succ.reshape(C, W)
        cvalid = valid.reshape(C)
        cand_u = torch.where(cvalid[:, None], cand_u,
                             torch.full_like(cand_u, int(SENTINEL)))
        ckeys, cand, pack_ovf = self._keys_of(cand_u, cvalid)
        del succ

        por_scalars = []
        if isinstance(self._por_memo, dict):
            # persistent-set filter: probe the PRE-level seen table (the
            # closure through this depth, so ample chains strictly
            # deepen: the BFS cycle proviso), then mask every non-ample
            # arm's candidates into invalid keys.  Deadlock and assert
            # verdicts above read the PRE-mask enabledness; gen counts
            # the reduced stream.
            keep, n_amp, n_exp, n_masked = self._por_filter(
                seen, seen_count, ckeys, cvalid, FC)
            inv_key = torch.full((1, K), int(SENTINEL), dtype=torch.int32,
                                 device=dev)
            inv_key[0, 0] = 1
            ckeys = torch.where(keep[:, None], ckeys, inv_key)
            cvalid = keep
            gen = keep.sum()
            por_scalars = [n_amp.to(torch.int64), n_exp.to(torch.int64),
                           n_masked.to(torch.int64)]

        # O(new): sort only the C candidate keys, dedup them against the
        # sorted seen prefix, scatter the new keys at their ranks.
        # nk_sidx is each new key's original candidate index in
        # key-sorted order (stable ties keep the first occurrence).
        # JAXMC_LEVEL_RANKMERGE=0 full-sorts seen and candidates instead
        # (the reference's parity oracle): the same outputs
        if os.environ.get("JAXMC_LEVEL_RANKMERGE", "").strip() == "0":
            rm = self._full_sort(seen, seen_count, ckeys)
        else:
            rm = self._rank_merge(seen, seen_count, ckeys)
        new_count = rm["new_count"]
        safe_cidx = rm["nk_sidx"].clamp(0, max(C - 1, 0)).to(torch.int64)
        new_rows = cand[safe_cidx]                      # packed
        new_rows_u = cand_u[safe_cidx]                  # lanes
        new_prov = safe_cidx                            # prov = c
        nvalid = torch.arange(C, device=dev) < new_count
        new_rows = torch.where(nvalid[:, None], new_rows,
                               torch.full_like(new_rows, int(SENTINEL)))

        # constraints FIRST: violating states are in seen2 (fingerprinted)
        # but never counted distinct, invariant-checked or explored
        explore = nvalid
        for _nm, f in self.constraint_fns:
            explore = explore & f(new_rows_u)
        explore_count = explore.sum()
        # the next frontier is ordered by PROVENANCE (frontier-slot
        # major, action minor), never by key order: the reference's
        # stable 2-key sort on (not explore, fmaj)
        perm4 = self._front_order(explore, new_prov, FC)
        front_rows = new_rows[perm4]
        front_rows_u = new_rows_u[perm4]
        front_prov = new_prov[perm4].to(torch.int32)
        # tiered runs stream each kept row's key, so the cold-tier probe
        # never recomputes keys
        front_keys = ckeys[safe_cidx][perm4] if self._tiers is not None \
            else None
        frontvalid = torch.arange(C, device=dev) < explore_count

        # invariants over the kept (explored) states only; the first
        # violated invariant in declaration order wins
        inv_any = torch.zeros((), dtype=torch.bool, device=dev)
        inv_idx = torch.zeros((), dtype=torch.int64, device=dev)
        inv_which = torch.full((), -1, dtype=torch.int64, device=dev)
        for wi, (_nm, f) in enumerate(self.inv_fns):
            bad = frontvalid & ~f(front_rows_u)
            any_ = bad.any()
            idx = torch.argmax(bad.to(torch.int32))
            first = any_ & ~inv_any
            inv_idx = torch.where(first, idx, inv_idx)
            inv_which = torch.where(first, torch.full_like(inv_which, wi),
                                    inv_which)
            inv_any = inv_any | any_

        # the edge stream (bfs.py:1925-1931) for refinement and the
        # liveness graph: cvalid and every CONSTRAINT over every
        # candidate, not only the new rows.  K8 compacts it on the card
        # (a stable partition: candidate order holds); the host reads
        # the count with the scalars, then only the kept rows
        edge_out: Dict[str, Any] = {}
        edge_scalars = []
        if self._need_edges:
            exp_all = cvalid
            for _nm, f in self.constraint_fns:
                exp_all = exp_all & f(cand_u)
            eidx, epart = self._compact(exp_all, C, site="edges")
            edge_out = dict(edge_idx=eidx, cand=cand)
            edge_scalars = [epart[0].to(torch.int64)]

        # kernel overflow codes outrank the pack guard
        base_ov = overflow.max() if overflow.numel() else \
            torch.zeros((), dtype=torch.int32, device=dev)
        ov_out = torch.where(base_ov != 0, base_ov,
                             torch.where(pack_ovf, OV_PACK, 0))
        ab_flat = torch.argmax(assert_bad.reshape(-1).to(torch.int32)) \
            if assert_bad.numel() else torch.zeros((), dtype=torch.int64,
                                                   device=dev)
        dead_f = torch.argmax(dead.to(torch.int32))
        scalars = torch.stack([
            ov_out.to(torch.int64), assert_bad.any().to(torch.int64),
            torch.div(ab_flat, FC, rounding_mode="floor").to(torch.int64),
            (ab_flat % FC).to(torch.int64), dead.any().to(torch.int64),
            dead_f.to(torch.int64), gen.to(torch.int64),
            explore_count.to(torch.int64),
            rm["seen_count2"].to(torch.int64), inv_any.to(torch.int64),
            inv_idx.to(torch.int64), inv_which.to(torch.int64)]
            + por_scalars + edge_scalars)
        return dict(scalars=scalars, seen=rm["seen2"],
                    front_rows=front_rows, front_prov=front_prov,
                    front_keys=front_keys, dead=dead,
                    assert_bad=assert_bad, **edge_out)

    # ---- the search ----

    def _prepare_init(self, t0, warnings):
        """Encode + dedup the init states, check invariants on the kept
        ones, log the TLC init line.  Returns (init_rows, explored_init,
        n_init, err).  The clean result is memoized: a restarted search
        (hybrid demotion) does not encode or log the initial states
        again."""
        cached = getattr(self, "_init_prep", None)
        if cached is not None:
            return cached + (None,)
        layout = self.layout
        raw = [np.asarray(layout.encode(st), np.int32)
               for st in self.init_states]
        if raw and self.canon is not None:
            # cfg SYMMETRY: dedup and count the init states by their
            # orbit minimum (the reference stores the minimum itself)
            t = torch.as_tensor(np.stack(raw), device=self.device)
            ones = torch.ones(len(raw), dtype=torch.bool,
                              device=self.device)
            raw = list(self._canon(t, ones).cpu().numpy())
        if raw and self.view_fn is not None:
            # cfg VIEW: init states sharing a view value count once;
            # the first state per key is kept
            t = torch.as_tensor(np.stack(raw), device=self.device)
            kb = self.view_fn(t).reshape(len(raw), -1).cpu().numpy()
            byview: Dict[bytes, np.ndarray] = {}
            for i, rr in enumerate(raw):
                byview.setdefault(
                    np.ascontiguousarray(kb[i], np.int32).tobytes(), rr)
            init_rows = np.stack(list(byview.values()))
        else:
            rows = {rr.tobytes(): rr for rr in raw}
            init_rows = np.stack(list(rows.values())) if rows else \
                np.zeros((0, self.W), np.int32)
        n_init = len(init_rows)
        explored_init, init_viol = filter_init_states(self.model, layout,
                                                      init_rows)
        if init_viol is not None:
            nm, st = init_viol
            return init_rows, explored_init, n_init, self._mk_result(
                False, len(explored_init) + 1, n_init, 0, t0, warnings,
                Violation("invariant", nm, [(st, "Initial predicate")]))
        rv = self._refine_init(init_rows, explored_init)
        if rv is not None:
            nm, st = rv
            return init_rows, explored_init, n_init, self._mk_result(
                False, len(explored_init), n_init, 0, t0, warnings,
                Violation("property", nm, [(st, "Initial predicate")],
                          f"initial state violates {nm}'s initial "
                          f"predicate"))
        distinct = len(explored_init)
        self.log(f"Finished computing initial states: {distinct} distinct "
                 f"state{'s' if distinct != 1 else ''} generated.")
        self._init_prep = (init_rows, explored_init, n_init)
        return init_rows, explored_init, n_init, None

    def _pack_ovf_msg(self) -> str:
        return ("a value escaped its bit-packed lane's profiled range "
                "(compile/pack.py profiles raw-int lanes from sampled "
                "states with a 3x margin): deepen --sample or rerun "
                "with JAXMC_PACK=0 (unpacked lanes) — counts stay exact "
                "either way")

    def _caps_note(self) -> str:
        parts: Dict[str, None] = {}

        def walk(spec, path):
            k = spec.kind
            if k in ("seq", "growset", "kvtable"):
                flag = {"seq": "--seq-cap", "growset": "--grow-cap",
                        "kvtable": "--kv-cap"}[k]
                parts.setdefault(f"{path}:{k}[cap {spec.cap}, {flag}]")
            for sub in (spec.elems or ()):
                walk(sub, path)
            for sub in (spec.elem, spec.val):
                if sub is not None:
                    walk(sub, path)
            for _fields, fspecs in (spec.variants or ()):
                for sub in fspecs:
                    walk(sub, path)

        for v in self.layout.vars:
            walk(self.layout.specs[v], v)
        return "; ".join(parts) if parts else "no bounded containers"

    def run(self) -> CheckResult:
        if self.resident:
            return self._run_resident()
        if self.host_seen:
            return self._run_hybrid()
        from .. import faults
        t0 = time.time()
        tel = obs.current()
        dev = self.device
        W, K, PW = self.W, self.K, self.PW
        warnings: List[str] = []
        warnings.extend(self._temporal_warnings())
        warnings.extend(self._symmetry_warnings())
        warnings.extend(self._por_warnings())
        if self.fp_mode:
            warnings.append(
                "wide state (W={}): dedup on 128-bit fingerprints; "
                "collision probability < n^2 * 2^-129".format(W))

        init_rows, explored_init, n_init, err = \
            self._prepare_init(t0, warnings)
        if err is not None:
            return err
        generated = n_init
        distinct = len(explored_init)

        init_keys, init_packed, init_povf = self._host_keys(init_rows)
        if init_povf:
            return self._mk_result(
                False, distinct, generated, 0, t0, warnings,
                Violation("error", "capacity overflow", [],
                          self._pack_ovf_msg()))
        graph = _LiveGraph(self.labels_flat, self.collect_edges) \
            if self.live_obligations else None
        frontier_sids = graph.add_inits(init_packed, explored_init) \
            if graph is not None else None

        FC = _pow2_at_least(max(n_init, 1))
        SC = _pow2_at_least(4 * max(n_init, 1))
        front_init = init_packed[explored_init] if n_init else init_packed
        fcount = len(front_init)
        frontier_np = np.full((FC, PW), SENTINEL, np.int32)
        frontier_np[:fcount] = front_init
        frontier = torch.as_tensor(frontier_np, device=dev)

        seen_np = np.full((SC, K), SENTINEL, np.int32)
        if n_init:
            order = np.lexsort(tuple(init_keys[:, i]
                                     for i in reversed(range(K))))
            seen_np[:n_init] = init_keys[order]
        seen = torch.as_tensor(seen_np, device=dev)
        seen_count = n_init

        trace_levels: List[Tuple[np.ndarray, Optional[np.ndarray], int]] = \
            [(np.asarray(init_packed), None, 0)]
        frontier_maps: List[np.ndarray] = [np.asarray(explored_init,
                                                      dtype=np.int64)]
        depth = 0
        if self.resume_from:
            ck = self._load_ck("level")
            (distinct, generated, depth, tl, fm, graph,
             fsids) = self._restore_ck_state(ck, graph)
            if self.store_trace:
                trace_levels, frontier_maps = tl, fm
            if graph is not None:
                frontier_sids = fsids
            cs, fr = ck["seen"], ck["frontier"]
            SC = _pow2_at_least(len(cs), SC)
            seen_np = np.full((SC, K), SENTINEL, np.int32)
            seen_np[:len(cs)] = cs
            seen = torch.as_tensor(seen_np, device=dev)
            seen_count = len(cs)
            FC = _pow2_at_least(max(len(fr), 1), FC)
            fr_np = np.full((FC, PW), SENTINEL, np.int32)
            fr_np[:len(fr)] = fr
            frontier = torch.as_tensor(fr_np, device=dev)
            fcount = len(fr)
            del seen_np, fr_np

        def level_ck(front_np):
            self._write_ck(
                "level", seen=seen[:seen_count].cpu().numpy(),
                frontier=front_np,
                **self._ck_state_kwargs(distinct, generated, depth,
                                        trace_levels, frontier_maps,
                                        graph, frontier_sids))

        self.log(f"Progress({depth}): {generated} states generated, "
                 f"{distinct} distinct states found, "
                 f"{fcount} states left on queue."
                 f"{obs.eta_suffix(distinct)}")
        last_progress = last_ck = time.time()
        while fcount > 0:
            # chaos sites: a crash, or a terminal device failure,
            # entering a level; then the drain poll
            faults.kill_self("run_kill", level=depth, engine="level")
            faults.inject("device_run_fail", level=depth)
            if self._drain_requested(warnings, "level"):
                if self.checkpoint_path:
                    level_ck(frontier[:fcount].cpu().numpy())
                    self._write_host_snapshot(trace_levels, frontier_maps,
                                              graph, depth, generated)
                return self._mk_result(True, distinct, generated, depth,
                                       t0, warnings, None,
                                       truncated=True, drained=True)
            lvl_t0 = time.time()
            C = self.A * FC
            if seen_count + C > SC:
                SC2 = _pow2_at_least(seen_count + C, SC)
                if self.seen_cap is not None and SC2 > self.seen_cap \
                        and seen_count > 0:
                    # device tier full: compact the sorted prefix out to
                    # the cold tiers and restart the device table empty
                    # instead of growing past the cap; kept rows are
                    # cold-probed after each step
                    with tel.span("tier.spill", keys=seen_count):
                        self._tier_spill_prefix(
                            seen[:seen_count].cpu().numpy(), seen_count)
                    seen = torch.full((SC, K), int(SENTINEL),
                                      dtype=torch.int32, device=dev)
                    seen_count = 0
                    SC2 = _pow2_at_least(C, SC)
                    if SC2 > max(SC, self.seen_cap):
                        # the level's candidate block alone exceeds the
                        # cap: the merge needs seen_count + C <= SC
                        self.log(f"-- tier: device cap "
                                 f"{self.seen_cap} < one level's "
                                 f"candidate block ({C}); growing "
                                 f"anyway (soft cap)")
                if SC2 > SC:
                    pad = torch.full((SC2 - SC, K), int(SENTINEL),
                                     dtype=torch.int32, device=dev)
                    seen = torch.cat([seen, pad])
                    SC = SC2
            obs.note_buffer("level.seen", SC * K * 4)
            obs.note_buffer("level.frontier", FC * PW * 4)
            out = self.level_step(seen, seen_count, frontier, fcount)
            vals = [int(x) for x in out["scalars"].cpu().tolist()]
            (ovc, a_any, a_a, a_f, d_any, d_f, gen, front_count,
             seen_count2, inv_any, inv_idx, inv_which) = vals[:12]

            if ovc:
                if ovc == OV_DEMOTED:
                    msg = ("a demoted compile-recovery fired (the kernel "
                           "under-approximates here): run the host_seen "
                           "mode, which demotes the arm to the "
                           "interpreter and restarts")
                elif ovc == OV_PACK:
                    msg = self._pack_ovf_msg()
                else:
                    msg = ("a container exceeded its lane capacity "
                           f"({self._caps_note()}); "
                           "counts would no longer be exact")
                return self._mk_result(
                    False, distinct, generated, depth, t0, warnings,
                    Violation("error", "capacity overflow", [], msg))
            if a_any:
                trace = self._trace_to(trace_levels, frontier_maps,
                                       depth, a_f)
                return self._mk_result(
                    False, distinct, generated, depth, t0, warnings,
                    Violation("assert", "Assert",
                              [x for x in trace if x[0] is not None],
                              f"assertion in {self.labels_flat[a_a]}"))
            if self.model.check_deadlock and d_any:
                trace = self._trace_to(trace_levels, frontier_maps,
                                       depth, d_f)
                return self._mk_result(
                    False, distinct, generated, depth, t0, warnings,
                    Violation("deadlock", "deadlock", trace))

            e_rows = e_idx = None
            if self._need_edges:
                # the level's kept candidate edges: the count came with
                # the scalars, the rows come compacted
                eidx = out["edge_idx"][:vals[12]].to(torch.int64)
                e_rows = out["cand"].index_select(0, eidx).cpu().numpy()
                e_idx = eidx.cpu().numpy()
            if self.refiners:
                # the frontier of THIS level (the step read it; the next
                # frontier is a new tensor)
                rviol = self._refine_edges(
                    frontier[:fcount].cpu().numpy(), e_rows, e_idx, FC)
                if rviol is not None:
                    a, f, sst, rc = rviol
                    trace = self._trace_to(trace_levels, frontier_maps,
                                           depth, f)
                    return self._mk_result(
                        False, distinct, generated, depth, t0, warnings,
                        self._refine_violation(rc, sst, a, trace))

            generated += gen
            if len(vals) > 12 and not self._need_edges:
                for name, v in zip(("ample", "expanded", "masked"),
                                   vals[12:]):
                    self._por_stats[name] += v
            # cold-tier membership filter: rows the device merge called
            # new may duplicate keys spilled to the host/disk tiers —
            # drop them (order-preserving) before they are counted,
            # traced or explored: exactly the rows the uncapped run's
            # merge would have dropped
            tier_keep = fr_host = fp_host = None
            if self._tiers is not None and self._tiers.active \
                    and front_count:
                fkeys = out["front_keys"][:front_count, 1:].cpu().numpy()
                dup = self._tiers.probe(fkeys)
                if dup.any():
                    tier_keep = ~dup
                    fr_host = np.ascontiguousarray(
                        out["front_rows"][:front_count].cpu().numpy()
                        [tier_keep])
                    fp_host = np.ascontiguousarray(
                        out["front_prov"][:front_count].cpu().numpy()
                        [tier_keep])
                self._tiers.publish_gauges(seen_count2)
            kept_count = len(fr_host) if fr_host is not None \
                else front_count
            distinct += kept_count
            seen = out["seen"]
            seen_count = seen_count2
            tel.level(depth, frontier=fcount, generated=gen,
                      new=kept_count, distinct=distinct, seen=seen_count,
                      wall_s=round(time.time() - lvl_t0, 6))
            self._fp_occupancy = seen_count

            if (self.store_trace or graph is not None) and fr_host is None:
                fr_host = out["front_rows"][:front_count].cpu().numpy()
                fp_host = out["front_prov"][:front_count].cpu().numpy()
            if graph is not None:
                new_sids = graph.add_level(fr_host, fp_host, FC,
                                           frontier_sids)
                if graph.collect_edges:
                    graph.add_edges(e_rows, e_idx % FC, frontier_sids)
                frontier_sids = new_sids
            if self.store_trace:
                # trace levels hold the kept states; every kept state is
                # explored, so the frontier map is the identity
                trace_levels.append((fr_host, fp_host, FC))
                frontier_maps.append(np.arange(kept_count, dtype=np.int64))
            if inv_any:
                if tier_keep is not None:
                    # a tier duplicate never violates (its state was
                    # checked when first admitted): re-index the
                    # violating row into the filtered level
                    inv_idx = int(np.sum(tier_keep[:inv_idx]))
                nm = self.inv_fns[inv_which][0]
                trace = self._trace_to(trace_levels, frontier_maps,
                                       depth + 1, inv_idx, from_new=True)
                return self._mk_result(
                    False, distinct, generated, depth + 1, t0, warnings,
                    Violation("invariant", nm, trace))
            depth += 1

            if self.max_states and distinct >= self.max_states:
                self.log("-- state limit reached, search truncated")
                return self._mk_result(
                    True, distinct, generated, depth, t0, warnings,
                    None, truncated=True,
                    trunc_reason=f"max_states: distinct {distinct} >= "
                                 f"limit {self.max_states}")

            if kept_count > FC:
                FC = _pow2_at_least(kept_count, FC)
            nf = torch.full((FC, PW), int(SENTINEL), dtype=torch.int32,
                            device=dev)
            if tier_keep is not None:
                nf[:kept_count] = torch.as_tensor(fr_host, device=dev)
            else:
                nf[:front_count] = out["front_rows"][:front_count]
            frontier = nf
            fcount = kept_count
            del out

            now = time.time()
            if self.checkpoint_path and \
                    now - last_ck >= self.checkpoint_every:
                last_ck = now
                level_ck(frontier[:fcount].cpu().numpy())
                self._write_host_snapshot(trace_levels, frontier_maps,
                                          graph, depth, generated)
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} states generated, "
                         f"{distinct} distinct states found, "
                         f"{fcount} states left on queue."
                         f"{obs.eta_suffix(distinct)}")

        if graph is not None:
            viol = self._check_live(graph, warnings)
            if viol is not None:
                return self._mk_result(False, distinct, generated,
                                       depth - 1, t0, warnings, viol)
        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct states "
                 f"found, 0 states left on queue.")
        self.log(f"The depth of the complete state graph search is "
                 f"{depth}.")
        if self.checkpoint_path and self.final_checkpoint:
            # a COMPLETED-run checkpoint: an empty frontier over the
            # whole seen table; resuming it replays the stored totals
            level_ck(np.zeros((0, PW), np.int32))
        return self._mk_result(True, distinct, generated, depth - 1, t0,
                               warnings)

    # ---- checkpoints, resume and drain (bfs.py:2740-2946, :4508-4525) --
    #
    # The level and host-seen engines checkpoint between levels, the
    # resident engine between level programs, so a checkpoint is always a
    # level boundary and a resumed run's totals equal the uninterrupted
    # run's.

    def _layout_sig(self) -> str:
        """Fingerprint of the lane encoding: a resume is sound only when
        the resuming process rebuilds the IDENTICAL layout and lane plan
        (both derive deterministically from the model and Bounds).  The
        same text as the reference's, so the two agree on one layout."""
        import hashlib
        lay = self.layout
        desc = repr((lay.vars, [lay.specs[v] for v in lay.vars],
                     [str(v) for v in lay.uni.values],
                     lay.plan.signature()))
        return hashlib.sha256(desc.encode()).hexdigest()

    def _write_ck(self, mode: str, **state) -> None:
        """Write the device checkpoint (engine/ckpt.py, kind "device");
        a failed periodic write logs and the search goes on."""
        from ..engine import ckpt as _ckpt
        payload = dict(mode=mode, module=self.model.module.name,
                       vars=list(self.model.vars),
                       layout_sig=self._layout_sig(), **state)
        if self._tiers is not None and self._tiers.active:
            # the whole tier hierarchy rides every checkpoint, so a
            # resume after a spill dedups against exactly the same set
            payload["tiers"] = self._tiers.dump()
        try:
            with obs.current().span("checkpoint.write", mode=mode):
                _ckpt.write_checkpoint(
                    self.checkpoint_path, "device",
                    {"module": self.model.module.name, "mode": mode},
                    payload)
        except _ckpt.CkptError as ex:
            obs.current().counter("checkpoint.write_failures")
            self.log(f"WARNING: checkpoint write failed ({ex}); the run "
                     f"continues on the previous checkpoint")
            return
        self.log(f"Checkpointing run to {self.checkpoint_path}")

    def _load_ck(self, mode: str) -> dict:
        """Load and validate resume_from for this engine: its module,
        variables, device mode and layout signature must be this run's.
        A tiered checkpoint restores the cold tiers first."""
        from ..engine.ckpt import CkptError, load_checkpoint
        _, ck = load_checkpoint(self.resume_from, kind="device")
        if ck.get("module") != self.model.module.name or \
                ck.get("vars") != list(self.model.vars):
            raise CkptError(
                f"cannot resume: checkpoint is for module "
                f"{ck.get('module')!r} with variables {ck.get('vars')}, "
                f"not {self.model.module.name!r}")
        if ck.get("mode") != mode:
            raise CkptError(
                f"cannot resume: checkpoint was written by the "
                f"{ck.get('mode')!r} device mode, this run uses {mode!r} "
                f"(re-run with the matching flags)")
        if ck.get("layout_sig") != self._layout_sig():
            raise CkptError(
                "cannot resume: the lane layout differs from the "
                "checkpoint's (different --seq-cap/--grow-cap/--kv-cap "
                "or a changed model?)")
        if ck.get("tiers") is not None:
            self._ensure_tiers().load(ck["tiers"])
        return ck

    def _restore_ck_state(self, ck, graph):
        """The level and host-seen resume: check that the checkpoint
        carries what this run needs (traces, the behavior graph), log
        the resume line and return (distinct, generated, depth,
        trace_levels, frontier_maps, graph, frontier_sids); the trace
        pair is None when store_trace is off."""
        if self.store_trace and ck.get("trace_levels") is None:
            raise ValueError(
                "cannot resume with traces: the checkpoint was written "
                "with --no-trace")
        frontier_sids = None
        if graph is not None:
            ckg = ck.get("graph")
            if ckg is None:
                raise ValueError(
                    "cannot resume with temporal properties: the "
                    "checkpoint has no behavior graph")
            if graph.collect_edges and not ckg.collect_edges:
                raise ValueError(
                    "cannot resume with this PROPERTY set: the "
                    "checkpoint's behavior graph has no edge log (it "
                    "was written for 'always'-form obligations only)")
            graph = ckg
            frontier_sids = ck["frontier_sids"]
        trace_levels = ck["trace_levels"] if self.store_trace else None
        frontier_maps = ck["frontier_maps"] if self.store_trace else None
        self.log(f"Resumed from {self.resume_from}: {ck['distinct']} "
                 f"distinct states, {len(ck['frontier'])} on queue.")
        return (ck["distinct"], ck["generated"], ck["depth"],
                trace_levels, frontier_maps, graph, frontier_sids)

    def _ck_state_kwargs(self, distinct, generated, depth, trace_levels,
                         frontier_maps, graph, frontier_sids):
        """The level and host-seen checkpoint payload's shared fields."""
        return dict(
            distinct=distinct, generated=generated, depth=depth,
            trace_levels=trace_levels if self.store_trace else None,
            frontier_maps=frontier_maps if self.store_trace else None,
            graph=graph, frontier_sids=frontier_sids)

    def _write_host_snapshot(self, trace_levels, frontier_maps, graph,
                             depth, generated) -> None:
        """An INTERP-format checkpoint (`<checkpoint>.host`) rebuilt from
        the host-side trace levels, which the interpreter engines
        (engine/explore.py, engine/parallel.py) resume from the last
        level barrier.  Every kept state is decoded and re-fingerprinted
        with the interpreter's state_fingerprint, so the resumed dedup
        set is exact; a constraint-discarded state the device never kept
        is re-generated and re-discarded on first contact, as the serial
        engine counts it.  Skipped with --no-trace, in resident mode (no
        host rows) and when cfg SYMMETRY ran unreduced on the device
        (the interpreter would reduce)."""
        if not self.store_trace or not self.checkpoint_path:
            return
        if self.model.symmetry is not None and self.canon is None \
                and not self.sym_identity:
            if not getattr(self, "_host_snap_skip_logged", False):
                self._host_snap_skip_logged = True
                self.log("-- no host snapshot: SYMMETRY ran unreduced on "
                         "the device (interp counts would differ)")
            return
        from ..engine import ckpt as _ckpt
        from ..engine.explore import make_canonicalizer, state_fingerprint
        model = self.model
        vars = model.vars
        canon = make_canonicalizer(model)
        view_expr = getattr(model, "view", None)
        states: List[Dict[str, Any]] = []
        parents: List[Optional[int]] = []
        labels: List[str] = []
        depth_of: List[int] = []
        seen: Dict[Any, int] = {}
        level_sids: List[List[int]] = []
        for lvl, (rows, prov, par_div) in enumerate(trace_levels):
            sids: List[int] = []
            for ridx in frontier_maps[lvl]:
                ridx = int(ridx)
                st = self.layout.decode_packed(np.asarray(rows[ridx]))
                sid = len(states)
                if prov is None:
                    parents.append(None)
                    labels.append("Initial predicate")
                else:
                    p = int(prov[ridx])
                    a, pf = p // par_div, p % par_div
                    parents.append(level_sids[lvl - 1][pf])
                    labels.append(self.labels_flat[a])
                states.append(st)
                depth_of.append(lvl)
                key = state_fingerprint(model, canon, view_expr, vars, st)
                # an fp128 collision may have merged two interp-distinct
                # states on the device: keep the first sid
                seen.setdefault(key, sid)
                sids.append(sid)
            level_sids.append(sids)
        collect_edges = graph is not None and graph.collect_edges
        payload = _ckpt.interp_payload(
            model, vars, states, parents, labels, depth_of,
            level_sids[-1] if level_sids else [], generated,
            max(depth - 1, 0), seen,
            graph.edges if collect_edges else None, collect_edges, [])
        snap = self.checkpoint_path + ".host"
        try:
            with obs.current().span("checkpoint.host_snapshot",
                                    states=len(states)):
                _ckpt.write_checkpoint(
                    snap, "interp",
                    {"module": model.module.name,
                     "engine": "device-snapshot"},
                    payload)
        except _ckpt.CkptError as ex:
            obs.current().counter("checkpoint.write_failures")
            self.log(f"WARNING: host snapshot write failed ({ex}); the "
                     f"run continues on the previous snapshot")
            return
        obs.current().counter("checkpoint.host_snapshots")
        self.log(f"Host snapshot (CPU-resumable) written to {snap}")

    def _drain_requested(self, warnings, engine: str) -> bool:
        """The cooperative drain poll at a level boundary: on a request
        (drain.py: SIGTERM, or a caller), log it, name it in the
        warnings and return True; the caller writes its own checkpoint
        and returns a drained result."""
        from .. import drain as _drain
        if not _drain.requested():
            return False
        why = _drain.reason()
        self.log(f"-- drain requested ({why}): stopping at a safe "
                 f"boundary")
        obs.current().event("drain", reason=why, engine=engine)
        warnings.append(
            f"run drained before completion ({why})"
            + (f"; resume with --resume {self.checkpoint_path}"
               if self.checkpoint_path else "; no checkpoint was "
               "configured — progress was discarded"))
        return True

    # ---- the resident engine ----

    def _compact(self, mask, cap: int, flim=None, aok=None, ov=None,
                 site: str = ""):
        f = ops.resident_compact_twin if self.twins else ops.resident_compact
        return f(mask, cap, flim, aok, ov, site)

    def _fold(self, lv: dict, part, pack_ovf, por, keys_c, rows_c,
              base: int) -> None:
        f = ops.resident_fold_twin if self.twins else ops.resident_fold
        f(lv["carry"], lv["bad_row"], part, pack_ovf, por, keys_c, rows_c,
          lv["acc_keys"], lv["acc_rows"], lv["frontier"], base, lv["CH"],
          self.model.check_deadlock, OV_PACK)

    def _res_por(self, lv: dict, keys_c, rows_c, vmask, cidx, cvalid):
        """The persistent-set filter of a resident chunk (bfs.py:2367-
        2394): K3 probes the compacted keys against the PRE-level seen
        table, the verdicts scatter back onto the dense [A*CH] grid, K6
        picks each slot's ample arm, and the non-ample candidates become
        the invalid key and SENTINEL rows.  Returns (keys_c, rows_c,
        deltas int64 [n_ample, n_expanded, n_masked])."""
        plan = self._por_memo
        dev = keys_c.device
        if self.twins:
            found_c, _ = ops.seen_probe_twin(lv["seen"], lv["seen_count"],
                                             keys_c)
        else:
            found_c, _ = ops.seen_probe(lv["seen"], lv["seen_count"],
                                        keys_c, site="por")
        ci = cidx.to(torch.int64)
        found_g = torch.zeros(cvalid.shape[0], dtype=torch.bool,
                              device=dev).scatter_(0, ci, found_c & vmask)
        mask_f = ops.por_mask_twin if self.twins else ops.por_mask
        keep_g, n_amp, n_exp, _ = mask_f(found_g, cvalid, plan["inst_arm_t"],
                                         plan["arm_safe_t"], self.A,
                                         lv["CH"])
        keep_c = keep_g.index_select(0, ci) & vmask
        n_masked = (vmask & ~keep_c).sum()
        # the invalid key [1, SENTINEL...], made without a host write
        inv_key = torch.cat([
            torch.ones((1, 1), dtype=torch.int32, device=dev),
            torch.full((1, self.K - 1), int(SENTINEL), dtype=torch.int32,
                       device=dev)], dim=1)
        keys_c = torch.where(keep_c[:, None], keys_c, inv_key)
        rows_c = torch.where(keep_c[:, None], rows_c,
                             torch.full((), int(SENTINEL), dtype=torch.int32,
                                        device=dev))
        return keys_c, rows_c, torch.stack(
            [n_amp.to(torch.int64), n_exp.to(torch.int64),
             n_masked.to(torch.int64)])

    def _res_chunk(self, lv: dict, base: int) -> None:
        """One chunk of CH frontier rows (bfs.py:2313-2427): K1, the
        emitter, K8 over the valid grid (the verdict partials and the
        first VC valid candidates), their gather (SENTINEL past vcnt),
        K2 over the VC block, the POR branch, then K9, which folds the
        chunk into the level's device carry only while its status is
        ST_CONTINUE.  Nothing is read back to the host."""
        A, W, CH, VC = self.A, self.W, lv["CH"], lv["VC"]
        dev = lv["frontier"].device
        chunk = self._unpack(lv["frontier"][base:base + CH])
        en, aok, ov, succ = self._expand(chunk)
        flim = min(lv["fcount"] - base, CH)
        cidx, part = self._compact(en, VC, flim, aok, ov)
        vmask = torch.arange(VC, device=dev) < part[0]
        rows_cu = succ.reshape(A * CH, W).index_select(
            0, cidx.to(torch.int64))
        del succ
        rows_cu = torch.where(vmask[:, None], rows_cu,
                              torch.full((), int(SENTINEL),
                                         dtype=torch.int32, device=dev))
        keys_c, rows_c, pack_ovf = self._keys_of(rows_cu, vmask)
        por = None
        if isinstance(self._por_memo, dict):
            fv = torch.arange(CH, device=dev) < flim
            cvalid = (en & fv[None, :]).reshape(A * CH)
            keys_c, rows_c, por = self._res_por(lv, keys_c, rows_c, vmask,
                                                cidx, cvalid)
        self._fold(lv, part, pack_ovf, por, keys_c, rows_c, base)

    @_site("bfs.resident_run")
    def _res_level(self, seen, seen_count: int, frontier, fcount: int,
                   caps: Dict[str, int], CH: int):
        """One resident level (bfs.py:2307-2516): ceil(fcount / CH) chunk
        bodies enqueued back to back, then the level end — the
        seen-capacity check, the rank merge of all AccCap accumulator
        rows, the new rows in key order, the CONSTRAINTs, K8 over the
        explore mask capped at FCap, the invariants over the new
        frontier.  Returns (summary int64 [9 + PW] on the device: stat,
        seen_count, fcount, gen, ovcode, which, the three POR deltas,
        then the bad row; seen2; the new frontier [FCap, PW])."""
        dev = self.device
        K, PW = self.K, self.PW
        SC, FCap, AccCap = seen.shape[0], frontier.shape[0], caps["AccCap"]
        sent = int(SENTINEL)
        # the unfilled accumulator rows hold the invalid key, as the
        # chunks' invalid rows do (the reference fills SENTINEL; either
        # sorts after every valid key and is never new): K18 takes the
        # rows equal to the last row out of its digit passes
        acc_keys = torch.full((AccCap, K), sent, dtype=torch.int32,
                              device=dev)
        acc_keys[:, 0].fill_(1)      # a fill launch: no host copy
        lv = dict(seen=seen, seen_count=seen_count, frontier=frontier,
                  fcount=fcount, CH=CH, VC=caps["VC"], acc_keys=acc_keys,
                  acc_rows=torch.full((AccCap, PW), sent, dtype=torch.int32,
                                      device=dev),
                  carry=torch.zeros(len(ops.CARRY), dtype=torch.int64,
                                    device=dev),
                  bad_row=torch.full((PW,), sent, dtype=torch.int32,
                                     device=dev))
        for base in range(0, fcount, CH):
            self._res_chunk(lv, base)
        carry = lv["carry"]
        # conservative seen-capacity check BEFORE the merge: every
        # accumulated candidate could be new
        stat = torch.where((carry[0] == ST_CONTINUE)
                           & (seen_count + carry[1] > SC), ST_OVF_SEEN,
                           carry[0])
        rm = self._rank_merge(seen, seen_count, lv["acc_keys"])
        nvalid = torch.arange(AccCap, device=dev) < rm["new_count"]
        new_rows = lv["acc_rows"].index_select(
            0, rm["nk_sidx"].clamp(0, AccCap - 1).to(torch.int64))
        new_rows = torch.where(nvalid[:, None], new_rows,
                               torch.full((), sent, dtype=torch.int32,
                                          device=dev))
        explore = nvalid
        if self.constraint_fns:
            new_rows_u = self._unpack(new_rows)
            for _nm, f in self.constraint_fns:
                explore = explore & f(new_rows_u)
        fidx, fpart = self._compact(explore, FCap, site="explore")
        explore_count = fpart[0]
        stat = torch.where((stat == ST_CONTINUE) & (explore_count > FCap),
                           ST_OVF_FRONT, stat)
        frontvalid = torch.arange(FCap, device=dev) < explore_count
        front_rows = new_rows.index_select(0, fidx.to(torch.int64))
        front_rows = torch.where(frontvalid[:, None], front_rows,
                                 torch.full((), sent, dtype=torch.int32,
                                            device=dev))
        # the first violated invariant in declaration order, its first
        # row of the new frontier (merge order)
        inv_any = torch.zeros((), dtype=torch.bool, device=dev)
        inv_idx = torch.zeros((), dtype=torch.int64, device=dev)
        which = torch.full((), -1, dtype=torch.int64, device=dev)
        if self.inv_fns:
            front_u = self._unpack(front_rows)
            for wi, (_nm, f) in enumerate(self.inv_fns):
                bad = frontvalid & ~f(front_u)
                any_ = bad.any()
                first = any_ & ~inv_any
                inv_idx = torch.where(first,
                                      torch.argmax(bad.to(torch.int32)),
                                      inv_idx)
                which = torch.where(first, wi, which)
                inv_any = inv_any | any_
        inv_row = front_rows.index_select(0, inv_idx.reshape(1))[0]
        bad_row = torch.where(inv_any & (stat == ST_CONTINUE), inv_row,
                              lv["bad_row"])
        stat = torch.where((stat == ST_CONTINUE) & inv_any, ST_INV, stat)
        summary = torch.cat([
            torch.stack([stat, rm["seen_count2"].to(torch.int64),
                         explore_count, carry[2], carry[3], which,
                         carry[4], carry[5], carry[6]]),
            bad_row.to(torch.int64)])
        return summary, rm["seen2"], front_rows

    def _res_read(self, summary) -> List[int]:
        """The one host read of a resident level."""
        return [int(x) for x in summary.cpu().tolist()]

    def _res_start_caps(self, n_init: int, CH: int) -> Dict[str, int]:
        """The resident capacities (bfs.py:2969-3016): the caller's
        res_caps rounded to powers of two, else the card's defaults or
        the CPU formula; then the seen cap and the floors and invariants
        no start may undercut."""
        if self._res_caps_hint:
            h = self._res_caps_hint
            caps = {"SC": _pow2_at_least(int(h.get("SC", 1)), lo=256),
                    "FCap": _pow2_at_least(int(h.get("FCap", 1)), lo=64),
                    "AccCap": _pow2_at_least(int(h.get("AccCap", 1)),
                                             lo=128),
                    "VC": _pow2_at_least(int(h.get("VC", 1)), lo=64)}
        elif self.device.type != "cpu":
            caps = {"SC": 1 << 20, "FCap": max(1 << 16, CH),
                    "AccCap": 1 << 17, "VC": 1 << 14}
        else:
            caps = {"SC": _pow2_at_least(max(4 * n_init, 1), lo=1 << 15),
                    "FCap": CH, "AccCap": 1 << 15, "VC": 1 << 13}
        if self.seen_cap is not None:
            caps["SC"] = min(caps["SC"], self.seen_cap)
        caps["SC"] = max(caps["SC"],
                         _pow2_at_least(max(4 * n_init, 1), lo=256))
        caps["FCap"] = max(caps["FCap"], _pow2_at_least(max(n_init, 1),
                                                        lo=CH))
        # VC never exceeds the dense grid A*CH; AccCap covers one VC block
        # past acc_n and the [:FCap] compaction of the accumulator
        caps["VC"] = min(caps["VC"], self.A * CH)
        caps["AccCap"] = max(caps["AccCap"], 2 * caps["VC"], caps["FCap"])
        return caps

    def _run_resident(self) -> CheckResult:
        """The resident search (bfs.py:2948-3404): one level at a time,
        each one device program enqueued by the host and read back as
        one summary vector.  The host holds the rollback: on an ST_OVF_*
        status it keeps the pre-level seen table and frontier, grows the
        named capacity x4 (or spills the seen table to the cold tiers)
        and redoes the level."""
        from .. import faults
        t0 = time.time()
        tel = obs.current()
        dev = self.device
        K, PW = self.K, self.PW
        warnings = ["resident mode: search runs device-side end to end; "
                    "no counterexample traces (rerun with the level/"
                    "host_seen device modes or the interp for a trace)",
                    "resident mode (W={}): dedup on 128-bit fingerprints; "
                    "collision probability < n^2 * 2^-129".format(self.W)]
        warnings.extend(self._temporal_warnings())
        warnings.extend(self._symmetry_warnings())
        warnings.extend(self._por_warnings())

        init_rows, explored_init, n_init, err = \
            self._prepare_init(t0, warnings)
        if err is not None:
            return err
        generated = n_init
        distinct = len(explored_init)

        CH = _pow2_at_least(self.chunk, lo=64)
        caps = self._res_start_caps(n_init, CH)

        def res_ck(front_np):
            # caps: the port's own growth state (it keeps no capacity
            # profiles), which a resume takes as its starting caps
            self._write_ck(
                "resident", caps=dict(caps),
                seen=seen[:seen_count].cpu().numpy(), frontier=front_np,
                distinct=distinct, generated=generated, depth=depth)

        depth = 0
        if self.resume_from:
            # the checkpoint holds the seen table and the frontier, so
            # the initial states are not keyed again
            ck = self._load_ck("resident")
            for kk in caps:
                caps[kk] = max(caps[kk], ck.get("caps", {}).get(kk, 0))
            # the writing run may have used another --chunk: VC never
            # exceeds A*CH, AccCap covers 2*VC and FCap
            caps["VC"] = min(caps["VC"], self.A * CH)
            caps["AccCap"] = max(caps["AccCap"], 2 * caps["VC"],
                                 caps["FCap"])
            cs, fr = ck["seen"], ck["frontier"]
            distinct = ck["distinct"]
            generated = ck["generated"]
            depth = ck["depth"]
            self.log(f"Resumed from {self.resume_from}: {distinct} "
                     f"distinct states, {len(fr)} on queue.")
            if len(fr) == 0:
                # a COMPLETED-run checkpoint (final_checkpoint): nothing
                # left to explore, so the stored verdict is replayed
                # with no kernel launch
                self.log("Model checking completed. No error has been "
                         "found.")
                self.log(f"{generated} states generated, {distinct} "
                         f"distinct states found, 0 states left on "
                         f"queue.")
                self.log(f"The depth of the complete state graph search "
                         f"is {depth}.")
                if self.checkpoint_path and self.final_checkpoint and \
                        self.checkpoint_path != self.resume_from:
                    self._write_ck(
                        "resident", caps=dict(caps), seen=cs,
                        frontier=np.zeros((0, PW), np.int32),
                        distinct=distinct, generated=generated,
                        depth=depth)
                return self._mk_result(True, distinct, generated,
                                       depth - 1, t0, warnings)
            front_rows, seen_rows = fr, cs
        else:
            init_keys, init_packed, init_povf = self._host_keys(init_rows)
            if init_povf:
                return self._mk_result(
                    False, distinct, generated, 0, t0, warnings,
                    Violation("error", "capacity overflow", [],
                              self._pack_ovf_msg()))
            front_rows = init_packed[explored_init]
            seen_rows = init_keys[np.lexsort(tuple(
                init_keys[:, i] for i in reversed(range(K))))] \
                if n_init else init_keys
        frontier_np = np.full((caps["FCap"], PW), SENTINEL, np.int32)
        frontier_np[:len(front_rows)] = front_rows
        frontier = torch.as_tensor(frontier_np, device=dev)
        fcount = len(front_rows)
        seen_np = np.full((caps["SC"], K), SENTINEL, np.int32)
        seen_np[:len(seen_rows)] = seen_rows
        seen = torch.as_tensor(seen_np, device=dev)
        seen_count = len(seen_rows)
        del frontier_np, seen_np, front_rows, seen_rows
        grow_flag = {ST_OVF_SEEN: "SC", ST_OVF_FRONT: "FCap",
                     ST_OVF_ACC: "AccCap", ST_OVF_VC: "VC"}
        self.log(f"Progress({depth}): {generated} states generated, "
                 f"{distinct} distinct states found, "
                 f"{fcount} states left on queue."
                 f"{obs.eta_suffix(distinct)}")
        last_progress = last_ck = time.time()
        while True:
            # chaos sites: crash / device failure entering a level; then
            # the drain poll
            faults.kill_self("run_kill", level=depth, engine="resident")
            faults.inject("device_run_fail", level=depth)
            if self._drain_requested(warnings, "resident"):
                if self.checkpoint_path:
                    res_ck(frontier[:fcount].cpu().numpy())
                return self._mk_result(True, distinct, generated, depth,
                                       t0, warnings, None,
                                       truncated=True, drained=True)
            obs.note_buffer("resident.seen", caps["SC"] * K * 4)
            obs.note_buffer("resident.frontier", caps["FCap"] * PW * 4)
            obs.note_buffer("resident.accumulator",
                            caps["AccCap"] * (K + PW) * 4)
            obs.note_buffer("resident.candidates",
                            caps["VC"] * (K + PW) * 4)
            t_lvl = time.time()
            fcount_in, gen_in, dist_in = fcount, generated, distinct
            summary, seen2, front2 = self._res_level(seen, seen_count,
                                                     frontier, fcount, caps,
                                                     CH)
            vals = self._res_read(summary)
            (lstat, seen_count2, fcount2, gen_l, ovcode, which, pora, porx,
             porm) = vals[:9]
            brow = np.asarray(vals[9:], dtype=np.int64).astype(np.int32)
            # an overflow rolls the whole level back: growable caps are
            # redone after growth, a lane overflow aborts with the last
            # completed level's exact counts
            ovf = lstat in grow_flag or lstat == ST_OVF_LANES
            if not ovf:
                seen, seen_count, frontier, fcount = \
                    seen2, seen_count2, front2, fcount2
                distinct += fcount2
                generated += gen_l
                self._por_stats["ample"] += pora
                self._por_stats["expanded"] += porx
                self._por_stats["masked"] += porm
            del summary, seen2, front2
            # deadlock and assert states belong to the CURRENT frontier
            # (depth d); an invariant violation lives in the new level
            if not (ovf or lstat in (ST_DEADLOCK, ST_ASSERT)):
                depth += 1
            if lstat != ST_CONTINUE:
                stat = lstat
            elif fcount == 0:
                stat = ST_DONE
            elif self.max_states and distinct >= self.max_states:
                stat = ST_TRUNC
            else:
                stat = ST_CONTINUE
            # cold-tier filter: after a spill the device table restarted
            # empty, so a committed level's frontier may hold rows whose
            # keys live in the host/disk runs — exactly the rows the
            # uncapped table would have deduped.  Drop them (order-
            # preserving) before counts, truncation or the next level
            # see them.  Rolled-back levels keep their frontier.
            if self._tiers is not None and self._tiers.active and \
                    fcount > 0 and stat not in grow_flag and \
                    stat not in (ST_OVF_LANES, ST_DONE):
                fr_np = frontier[:fcount].cpu().numpy()
                keep = self._tier_keep_mask(fr_np)
                n_dup = int((~keep).sum())
                if n_dup:
                    kept_rows = np.ascontiguousarray(fr_np[keep])
                    distinct -= n_dup
                    fcount = len(kept_rows)
                    fr_full = np.full((frontier.shape[0], PW), SENTINEL,
                                      np.int32)
                    fr_full[:fcount] = kept_rows
                    frontier = torch.as_tensor(fr_full, device=dev)
                if stat == ST_TRUNC and self.max_states and \
                        distinct < self.max_states:
                    stat = ST_CONTINUE  # phantom limit: dups un-counted
                if fcount == 0 and stat == ST_CONTINUE:
                    stat = ST_DONE  # the whole level was cold dups
                self._tiers.publish_gauges(seen_count)
            tel.level(depth, frontier=fcount_in,
                      generated=generated - gen_in,
                      new=distinct - dist_in, distinct=distinct,
                      seen=seen_count, status=stat,
                      wall_s=round(time.time() - t_lvl, 6))
            self._fp_occupancy = seen_count

            if stat in grow_flag:
                what = grow_flag[stat]
                old = caps[what]
                if what == "SC" and self.seen_cap is not None and \
                        old >= self.seen_cap and seen_count > 0:
                    # device tier full: compact the sorted prefix out to
                    # the cold tiers, restart the device table empty and
                    # redo the level (the rollback kept the pre-level
                    # state)
                    with tel.span("tier.spill", keys=seen_count):
                        self._tier_spill_prefix(
                            seen[:seen_count].cpu().numpy(), seen_count)
                    seen = torch.full((old, K), int(SENTINEL),
                                      dtype=torch.int32, device=dev)
                    seen_count = 0
                    self.log(f"-- tier: device seen cap "
                             f"{self.seen_cap} reached; spilled the "
                             f"device tier to "
                             f"host={self._tiers.host_keys}/"
                             f"disk={self._tiers.disk_keys} keys "
                             f"(level {depth} redone)")
                    continue
                caps[what] = old * 4
                if what == "VC":
                    caps[what] = min(caps[what], self.A * CH)
                if what == "SC" and self.seen_cap is not None:
                    if old < self.seen_cap:
                        # grow the device tier all the way TO the cap
                        # before spilling
                        caps[what] = min(caps[what], self.seen_cap)
                    else:
                        # at the cap with nothing left to spill: one
                        # level's new keys alone exceed it
                        self.log(f"-- tier: device cap "
                                 f"{self.seen_cap} < one level's new "
                                 f"keys; growing to {caps[what]} "
                                 f"anyway (soft cap)")
                if what == "SC":
                    seen = torch.cat([seen, torch.full(
                        (caps[what] - old, K), int(SENTINEL),
                        dtype=torch.int32, device=dev)])
                elif what == "FCap":
                    frontier = torch.cat([frontier, torch.full(
                        (caps[what] - old, PW), int(SENTINEL),
                        dtype=torch.int32, device=dev)])
                caps["AccCap"] = max(caps["AccCap"], 2 * caps["VC"],
                                     caps["FCap"])
                self.log(f"-- resident: growing {what} to {caps[what]} "
                         f"(level {depth} redone)")
            elif stat == ST_CONTINUE:
                now = time.time()
                if now - last_progress >= self.progress_every:
                    last_progress = now
                    self.log(f"Progress({depth}): {generated} states "
                             f"generated, {distinct} distinct states "
                             f"found, {fcount} states left on queue."
                             f"{obs.eta_suffix(distinct)}")
                if self.checkpoint_path and \
                        now - last_ck >= self.checkpoint_every:
                    last_ck = now
                    res_ck(frontier[:fcount].cpu().numpy())
            elif stat == ST_DONE:
                self.log("Model checking completed. No error has been "
                         "found.")
                self.log(f"{generated} states generated, {distinct} "
                         f"distinct states found, 0 states left on queue.")
                self.log(f"The depth of the complete state graph search "
                         f"is {depth}.")
                if self.checkpoint_path and self.final_checkpoint:
                    res_ck(np.zeros((0, PW), np.int32))
                return self._mk_result(True, distinct, generated,
                                       depth - 1, t0, warnings)
            elif stat == ST_TRUNC:
                self.log("-- state limit reached, search truncated")
                if self.checkpoint_path:
                    # a truncated resident run is resumable: truncation
                    # lands on a level boundary, so this is exactly the
                    # periodic checkpoint's state
                    res_ck(frontier[:fcount].cpu().numpy())
                return self._mk_result(
                    True, distinct, generated, depth, t0, warnings,
                    None, truncated=True,
                    trunc_reason=f"max_states: distinct {distinct} >= "
                                 f"limit {self.max_states}")
            elif stat == ST_OVF_LANES:
                if ovcode == OV_DEMOTED:
                    msg = ("a demoted compile-recovery fired (the "
                           "kernel under-approximates here): run the "
                           "host_seen mode, which demotes the arm to "
                           "the interpreter and restarts — raising "
                           "caps cannot help")
                elif ovcode == OV_PACK:
                    msg = self._pack_ovf_msg()
                else:
                    msg = ("a container exceeded its lane capacity "
                           f"({self._caps_note()})")
                return self._mk_result(
                    False, distinct, generated, depth, t0, warnings,
                    Violation("error", "capacity overflow", [], msg))
            else:
                st = self.layout.decode_packed(brow)
                note = "state reached by resident-mode search (no trace)"
                if stat == ST_INV:
                    nm = self.inv_fns[which][0] if 0 <= which < \
                        len(self.inv_fns) else "invariant"
                    v = Violation("invariant", nm, [(st, note)])
                elif stat == ST_DEADLOCK:
                    v = Violation("deadlock", "deadlock", [(st, note)])
                else:
                    v = Violation("assert", "Assert", [(st, note)],
                                  "assertion failed in an enabled action")
                return self._mk_result(False, distinct, generated, depth,
                                       t0, warnings, v)

    # ---- the out-of-core seen set: spill and cold-tier probes ----

    def _ensure_tiers(self):
        """The cold-tier store, created at the first spill (runs that
        never overflow pay nothing)."""
        if self._tiers is None:
            from .tiers import TieredSeen
            self._tiers = TieredSeen(
                self.K - 1, host_budget_keys=self.host_tier_keys,
                spill_dir=self.spill_dir, log=self.log)
        return self._tiers

    def _tier_spill_prefix(self, seen_np: np.ndarray, count: int) -> None:
        """Compact the device table's sorted valid prefix out as ONE
        immutable sorted run (the validity lane is stripped — cold runs
        hold data words only)."""
        if count <= 0:
            return
        t = self._ensure_tiers()
        t.spill(np.ascontiguousarray(seen_np[:count, 1:]))
        obs.current().counter("tier.spilled_keys", int(count))

    @_site("bfs.packed_keys")
    def _packed_keys(self, packed_np: np.ndarray) -> np.ndarray:
        """Dedup-key DATA words ([n, K-1], validity lane stripped) of a
        block of PACKED rows (K1, then K2): the cold-tier probe basis for
        frontier rows pulled back from the device."""
        n = len(packed_np)
        if n == 0:
            return np.zeros((0, self.K - 1), np.int32)
        packed = torch.as_tensor(np.ascontiguousarray(packed_np, np.int32),
                                 device=self.device)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        keys = self._keys_of(self._unpack(packed), valid)[0]
        return keys[:, 1:].cpu().numpy()

    def _tier_keep_mask(self, rows_np: np.ndarray) -> np.ndarray:
        """[n] bool keep-mask over packed rows: False where the row's
        dedup key already lives in a cold tier (it was admitted before
        the spill, so the uncapped run would never have re-frontiered
        it)."""
        if self._tiers is None or not self._tiers.active \
                or len(rows_np) == 0:
            return np.ones(len(rows_np), bool)
        return ~self._tiers.probe(self._packed_keys(rows_np))

    # ---- the chunked host-seen engine ----

    def _epilogue(self, en, aok, ov, fcount: int, keys, cand, pack_ovf,
                  inv_ok, explore) -> dict:
        f = ops.hstep_epilogue_twin if self.twins else ops.hstep_epilogue
        return f(en, aok, ov, fcount, keys, cand, pack_ovf, OV_PACK,
                 inv_ok, explore)

    def _set_const_lanes(self, cvecs, rows_each: int = 1) -> None:
        """Bind each lifted CONSTANT to a per-row int32 lane where the
        emitter resolves identifiers (kernel2 reads kc.const_lanes):
        cvecs [M, n_lift] (numpy or a tensor), each row's values
        repeated over `rows_each` rows; None clears them.  The
        counterpart of the reference's tracer install: one member's
        value repeated over its rows is what vmap over cvec computes.
        On a card engine the generated kernels take the [M, n_lift]
        table itself.  A no-op for engines without lifted constants."""
        if not self._lift_names:
            return
        if cvecs is None:
            self.kc.const_lanes = {}
            if self._gen is not None:
                self._gen.cv = None
            return
        from ..compile.lanes import BL
        cv = torch.as_tensor(cvecs, dtype=torch.int32,
                             device=self.device).reshape(
                                 -1, len(self._lift_names))
        if self._gen is not None:
            # K15-K17 read each row's member from the table itself
            # (row n takes member n // rows_each): no per-row lanes
            self._gen.cv = cv
            return
        if rows_each != 1:
            cv = cv.repeat_interleave(rows_each, dim=0)
        self.kc.const_lanes = {nm: BL(cv[:, i].contiguous())
                               for i, nm in enumerate(self._lift_names)}

    def _traced_with(self, fn, zero, slot=None):
        """fn's forced evaluation on the one-row zero block, with a lifted
        engine's constant lanes installed (bfs._traced_with), so a lifted
        name used where compilation needs a static value fails here, as
        the reference's traced build does."""
        self._set_const_lanes(self._cvec[None])
        try:
            return fn(zero) if slot is None else fn(zero, slot)
        finally:
            self._set_const_lanes(None)

    def _hstep_cands(self, frontier_p: torch.Tensor, fcounts: List[int],
                     cvecs: np.ndarray):
        """The host-seen chunk step up to its epilogue, for B members'
        chunks stacked in frontier_p [B*CH, PW] (bfs._hstep_core, and
        its vmap over a leading member axis for batching): unpack (K1),
        expand every compiled instance over all B*CH rows with each
        member's lifted constants (cvecs [B, n_lift] int32) as per-row
        lanes, then per member the keys (K2, fp128) and its
        pack-overflow flag, and the invariants and constraints over
        every candidate.  Returns en, aok, ov [B, A, CH], keys
        [B*A*CH, K], cand [B*A*CH, PW], pack_ovf [B] bool, inv_ok and
        explore [B*A*CH], candidates member-major (b, a, f)."""
        A, W, PW = self.A, self.W, self.PW
        B = len(fcounts)
        CH = frontier_p.shape[0] // B
        C = A * CH
        dev = frontier_p.device
        frontier = self._unpack(frontier_p)
        self._set_const_lanes(cvecs, CH)
        try:
            en, aok, ov, succ = self._expand(frontier)
        finally:
            self._set_const_lanes(None)
        if B == 1:
            # the solo step: no host-to-device copy of the count
            fvalid = (torch.arange(CH, device=dev) < fcounts[0])[None, :]
        else:
            fvalid = torch.arange(CH, device=dev)[None, :] < \
                torch.as_tensor(fcounts, device=dev)[:, None]

        def member_major(x):
            return x.reshape((A, B, CH) + x.shape[2:]).transpose(0, 1) \
                .contiguous()

        en, aok, ov = member_major(en), member_major(aok), member_major(ov)
        cvalid = (en & fvalid[:, None, :]).reshape(B * C)
        if C == 0:
            # hybrid with every arm demoted: the device only hashes
            keys = torch.zeros((0, self.K), dtype=torch.int32, device=dev)
            cand = torch.zeros((0, PW), dtype=torch.int32, device=dev)
            pack_ovf = torch.zeros((B,), dtype=torch.bool, device=dev)
            cand_u = torch.zeros((0, W), dtype=torch.int32, device=dev)
        else:
            cand_u = torch.where(cvalid[:, None],
                                 member_major(succ).reshape(B * C, W),
                                 torch.full((), int(SENTINEL),
                                            dtype=torch.int32,
                                            device=dev))
            parts = []
            for b in range(B):
                # one K2 per member: its pack-overflow flag is its own
                sl = slice(b * C, (b + 1) * C)
                self._set_const_lanes(cvecs[b:b + 1], C)
                try:
                    parts.append(self._keys_of(cand_u[sl], cvalid[sl]))
                finally:
                    self._set_const_lanes(None)
            if B == 1:
                keys, cand = parts[0][0], parts[0][1]
            else:
                keys = torch.cat([p[0] for p in parts])
                cand = torch.cat([p[1] for p in parts])
            pack_ovf = torch.stack([p[2].reshape(()) for p in parts])
        del succ
        inv_ok = torch.ones(B * C, dtype=torch.bool, device=dev)
        explore = torch.ones(B * C, dtype=torch.bool, device=dev)
        if C:
            self._set_const_lanes(cvecs, C)
            try:
                for _nm, f in self.inv_fns:
                    inv_ok = inv_ok & f(cand_u)
                for _nm, f in self.constraint_fns:
                    explore = explore & f(cand_u)
            finally:
                self._set_const_lanes(None)
        return en, aok, ov, keys, cand, pack_ovf, inv_ok, explore

    @_site("bfs.hstep")
    def _hstep(self, frontier_p: torch.Tensor, fcount: int) -> dict:
        """One chunk of the host-seen step (bfs._hstep_core, the fused
        path of _get_hstep) with this model's lifted-constant vector:
        K1, the emitter, K2 (fp128), the invariants and constraints over
        every candidate, then the epilogue (K7): verdict scalars and
        the compacted valid candidates.  Returns K7's dict of device
        tensors.  The reference splits the step into arm groups on
        XLA:CPU, whose single fused program compiles superlinearly in
        the instance count; eager torch compiles nothing, so the port
        always runs this fused step (same counts and traces)."""
        en, aok, ov, keys, cand, pack_ovf, inv_ok, explore = \
            self._hstep_cands(frontier_p, [fcount], self._cvec[None])
        return self._epilogue(en[0], aok[0], ov[0], fcount, keys, cand,
                              pack_ovf[0], inv_ok, explore)

    def _hstep_np(self, block: np.ndarray, fcount: int) -> dict:
        return self._hstep(torch.as_tensor(block, device=self.device),
                           fcount)

    def _hstep_batch(self, frontier_p: torch.Tensor, fcounts: List[int],
                     cvecs: np.ndarray) -> dict:
        """B members' chunk steps in one pass (the batch dispatcher's
        step, backend/batch.py): _hstep_cands over the stacked chunks,
        then K10, which computes each member's K7 result over its
        slice.  Returns K10's dict (ops.batch_epilogue)."""
        en, aok, ov, keys, cand, pack_ovf, inv_ok, explore = \
            self._hstep_cands(frontier_p, fcounts, cvecs)
        fc = torch.as_tensor(np.asarray(fcounts, np.int32),
                             device=frontier_p.device)
        f = ops.batch_epilogue_twin if self.twins else ops.batch_epilogue
        return f(en, aok, ov, fc, keys, cand, pack_ovf, OV_PACK, inv_ok,
                 explore)

    def _d2h(self, tensors, n: Optional[int] = None) -> List[np.ndarray]:
        """Host copies of `tensors` (of their first n rows when n is
        given): where the chunk loop waits for the chunk's step."""
        return [(t if n is None else t[:n]).cpu().numpy() for t in tensors]

    def _run_host_seen(self) -> CheckResult:
        from .. import faults, native_store
        from ..sem.eval import _bool, eval_expr
        t0 = time.time()
        tel = obs.current()
        model = self.model
        layout = self.layout
        warnings = ["seen-set resident in the native host fingerprint "
                    "store (host_seen); dedup on 128-bit fingerprints"]
        warnings.extend(self._temporal_warnings())
        warnings.extend(self._symmetry_warnings())
        warnings.extend(self._por_warnings())
        # POR: the ample check probes the native store BEFORE insert via
        # contains(); the store grows chunk by chunk, so this engine's
        # probe is (soundly) MORE conservative than the pre-level
        # snapshot the level engine uses, and its counts depend on the
        # chunk
        por_plan = self._por_plan() if self.por else None
        if self.seen_cap is not None:
            self.log("-- host_seen: --seen-cap/JAXMC_SEEN_CAP is "
                     "ignored here (the native fingerprint store is "
                     "host-resident; tier spill applies to the "
                     "device-table modes)")

        init_rows, explored_init, n_init, err = \
            self._prepare_init(t0, warnings)
        if err is not None:
            return err
        generated = n_init
        distinct = len(explored_init)

        store = native_store.FingerprintStore()
        init_keys, init_packed, init_povf = self._host_keys(init_rows)
        if init_povf:
            return self._mk_result(
                False, distinct, generated, 0, t0, warnings,
                Violation("error", "capacity overflow", [],
                          self._pack_ovf_msg()))
        store.insert(init_keys[:, 1:])  # drop the validity lane

        # the frontier lives host-side as a dense PACKED row matrix; each
        # level runs in fixed-size chunks so the [A, chunk, W] expansion
        # is memory-bounded
        CH = _pow2_at_least(self.chunk, lo=64)
        A, PW = self.A, self.PW
        frontier_np = np.ascontiguousarray(init_packed[explored_init])
        graph = _LiveGraph(self.labels_flat, self.collect_edges) \
            if self.live_obligations else None
        frontier_sids = graph.add_inits(init_packed, explored_init) \
            if graph is not None else None
        trace_levels = [(np.asarray(init_packed), None, 0)]
        frontier_maps = [np.asarray(explored_init, dtype=np.int64)]
        depth = 0
        if self.resume_from:
            # the store is refilled from the checkpoint before the first
            # chunk, so every later insert dedups against it
            ck = self._load_ck("host_seen")
            (distinct, generated, depth, tl, fm, graph,
             fsids) = self._restore_ck_state(ck, graph)
            if self.store_trace:
                trace_levels, frontier_maps = tl, fm
            if graph is not None:
                frontier_sids = fsids
            store.load(ck["store"])
            frontier_np = np.ascontiguousarray(ck["frontier"])

        def hs_ck(front_np):
            self._write_ck(
                "host_seen", store=store.dump(), frontier=front_np,
                **self._ck_state_kwargs(distinct, generated, depth,
                                        trace_levels, frontier_maps,
                                        graph, frontier_sids))

        self.log(f"Progress({depth}): {generated} generated, "
                 f"{distinct} distinct, {len(frontier_np)} on "
                 f"queue.{obs.eta_suffix(distinct)}")
        last_progress = last_ck = time.time()
        # cross-model batching: a batch member's chunk step goes through
        # the shared dispatcher (backend/batch.py) instead of its own —
        # same arguments, the same dict back
        hstep = self._hstep_override(CH) \
            if self._hstep_override is not None else self._hstep_np
        while len(frontier_np) > 0:
            # chaos sites: a crash, or a terminal device failure,
            # entering a level; then the drain poll
            faults.kill_self("run_kill", level=depth, engine="host_seen")
            faults.inject("device_run_fail", level=depth)
            if self._drain_requested(warnings, "host_seen"):
                if self.checkpoint_path:
                    hs_ck(frontier_np)
                    self._write_host_snapshot(trace_levels, frontier_maps,
                                              graph, depth, generated)
                return self._mk_result(True, distinct, generated, depth,
                                       t0, warnings, None,
                                       truncated=True, drained=True)
            L = len(frontier_np)
            lvl_t0 = time.time()
            lvl_gen0 = generated
            lvl_new_rows: List[np.ndarray] = []
            lvl_new_prov: List[np.ndarray] = []
            lvl_explore: List[np.ndarray] = []
            lvl_edges: List[Tuple[np.ndarray, np.ndarray]] = []
            lvl_dead = np.zeros(L, bool)  # deferred when fb arms exist
            inv_hit = None
            for base in range(0, L, CH):
                cn = min(CH, L - base)
                block = np.full((CH, PW), SENTINEL, np.int32)
                block[:cn] = frontier_np[base:base + cn]
                out = hstep(block, cn)
                (nv, ovc, ab_any, ab_flat, dead_any,
                 dead_f) = (int(x) for x in self._d2h([out["scalars"]])[0])
                if ovc:
                    self._last_ovf_code = ovc
                    self._last_frontier_np = frontier_np
                    if ovc == OV_DEMOTED:
                        msg = ("a demoted compile-recovery fired (the "
                               "kernel under-approximates here); the "
                               "hybrid engine demotes the arm and "
                               "restarts")
                    elif ovc == OV_PACK:
                        msg = self._pack_ovf_msg()
                    else:
                        msg = ("a container exceeded its lane capacity "
                               f"({self._caps_note()})")
                    return self._mk_result(
                        False, distinct, generated, depth, t0, warnings,
                        Violation("error", "capacity overflow", [], msg))
                if ab_any:
                    ai, f = divmod(ab_flat, CH)
                    trace = self._trace_to(trace_levels, frontier_maps,
                                           depth, base + f)
                    return self._mk_result(
                        False, distinct, generated, depth, t0, warnings,
                        Violation("assert", "Assert",
                                  [x for x in trace if x[0] is not None],
                                  f"assertion in {self.labels_flat[ai]}"))
                if model.check_deadlock and dead_any:
                    if self.fb_arms:
                        # a device-dead state may still have fallback-arm
                        # successors: defer the verdict to after the
                        # interpreter expansion of this level
                        lvl_dead[base:base + cn] = self._d2h(
                            [out["dead"]], cn)[0]
                    else:
                        trace = self._trace_to(trace_levels,
                                               frontier_maps, depth,
                                               base + dead_f)
                        return self._mk_result(
                            False, distinct, generated, depth, t0,
                            warnings,
                            Violation("deadlock", "deadlock", trace))

                names = ["idx", "fps", "rows", "inv_ok", "explore"]
                got = dict(zip(names, self._d2h([out[k] for k in names],
                                                nv)))
                del out
                idx = got["idx"].astype(np.int64)
                if por_plan is not None:
                    # rebuild found and cvalid over all A*CH candidates
                    # from the compacted index list
                    cvalid = np.zeros(A * CH, dtype=bool)
                    cvalid[idx] = True
                    found = np.zeros(A * CH, dtype=bool)
                    if nv:
                        found[idx] = store.contains(got["fps"])
                    keep, n_amp, n_exp = _por_mask_np(
                        found, cvalid, por_plan["inst_arm"],
                        por_plan["arm_safe"], A, CH)
                    self._por_stats["ample"] += int(n_amp)
                    self._por_stats["expanded"] += int(n_exp)
                    self._por_stats["masked"] += \
                        int(np.sum(cvalid & ~keep))
                    kk = keep[idx]
                    got = {k: v[kk] for k, v in got.items()}
                    idx = idx[kk]
                    generated += int(kk.sum())
                else:
                    generated += nv
                if self._need_edges:
                    # the chunk's kept candidate edges (bfs.py:3606-
                    # 3631): K7 compacted the valid candidates in
                    # candidate order with their explore bits
                    ek = got["explore"]
                    e_rows, e_idx = got["rows"][ek], idx[ek]
                    if self.refiners:
                        rviol = self._refine_edges(block, e_rows, e_idx,
                                                   CH)
                        if rviol is not None:
                            a, f, sst, rc = rviol
                            trace = self._trace_to(trace_levels,
                                                   frontier_maps,
                                                   depth, base + f)
                            return self._mk_result(
                                False, distinct, generated, depth, t0,
                                warnings,
                                self._refine_violation(rc, sst, a, trace))
                    if graph is not None and graph.collect_edges:
                        lvl_edges.append((e_rows, base + e_idx % CH))
                new_mask = store.insert(got["fps"])
                new_idx = idx[new_mask]
                if not len(new_idx):
                    continue
                rows_np = got["rows"][new_mask]
                # the predicates' verdicts count on NEW rows only (TLC
                # checks each state once)
                inv_okn = got["inv_ok"][new_mask]
                exploren = got["explore"][new_mask]
                if self.fb_cons:
                    # hybrid: uncompilable CONSTRAINTs evaluate on the
                    # host over decoded new rows (same discard semantics)
                    exploren = exploren.copy()
                    for k in range(len(rows_np)):
                        if not exploren[k]:
                            continue
                        cctx = model.ctx(
                            state=layout.decode_packed(rows_np[k]))
                        for cnm, cex, _r in self.fb_cons:
                            if not _bool(eval_expr(cex, cctx),
                                         f"constraint {cnm}"):
                                exploren[k] = False
                                break
                # discarded (constraint-violating) states are in the
                # store (fingerprinted) but never counted distinct,
                # checked, or explored — TLC semantics
                distinct += int(exploren.sum())
                # global provenance: action a, parent base+f within the
                # level's full frontier of length L (cand index a*CH + f)
                a_ids = new_idx // CH
                f_ids = new_idx % CH
                prov_global = a_ids * L + (base + f_ids)
                bad_mask = (~inv_okn) & exploren
                if inv_hit is None and bad_mask.any():
                    off = sum(len(r) for r in lvl_new_rows)
                    badpos = int(np.nonzero(bad_mask)[0][0])
                    inv_hit = off + badpos
                lvl_new_rows.append(rows_np)
                lvl_new_prov.append(prov_global.astype(np.int64))
                lvl_explore.append(exploren)
                if inv_hit is not None:
                    # the violation is in hand: skip the level's rest
                    break

            if self.fb_arms and inv_hit is None:
                # hybrid: interpreter-enumerate the fallback arms over
                # this level's frontier and splice the results into the
                # same level streams (rows/prov/explore)
                fb_enabled = np.zeros(L, bool)
                gen_inc, dist_inc, fbv = self._fb_expand_level(
                    frontier_np, L, store, lvl_new_rows, lvl_new_prov,
                    lvl_explore, lvl_edges, fb_enabled, trace_levels,
                    frontier_maps, depth, t0, warnings, distinct,
                    generated)
                if fbv is not None:
                    return fbv
                generated += gen_inc
                distinct += dist_inc
                if model.check_deadlock:
                    dead_final = lvl_dead & ~fb_enabled
                    if dead_final.any():
                        f = int(np.nonzero(dead_final)[0][0])
                        trace = self._trace_to(trace_levels,
                                               frontier_maps, depth, f)
                        return self._mk_result(
                            False, distinct, generated, depth, t0,
                            warnings,
                            Violation("deadlock", "deadlock", trace))

            new_rows_np = np.concatenate(lvl_new_rows) if lvl_new_rows \
                else np.zeros((0, PW), np.int32)
            new_prov_np = np.concatenate(lvl_new_prov) if lvl_new_prov \
                else np.zeros(0, np.int64)
            explore_mask = np.concatenate(lvl_explore) if lvl_explore \
                else np.zeros(0, bool)

            if inv_hit is None and self.fb_invs:
                # hybrid: uncompilable INVARIANTs evaluate on the host
                # over this level's kept (explored) new states
                for pos in np.nonzero(explore_mask)[0]:
                    ictx = model.ctx(state=layout.decode_packed(
                        new_rows_np[pos]))
                    bad = False
                    for inm, iex, _r in self.fb_invs:
                        if not _bool(eval_expr(iex, ictx),
                                     f"invariant {inm}"):
                            bad = True
                            break
                    if bad:
                        inv_hit = int(pos)
                        break

            if self.store_trace:
                trace_levels.append((new_rows_np, new_prov_np, L))
            if inv_hit is not None:
                st = layout.decode_packed(new_rows_np[inv_hit])
                ctx = model.ctx(state=st)
                nm = next((n for n, ex in model.invariants
                           if not _bool(eval_expr(ex, ctx), n)),
                          model.invariants[0][0] if model.invariants
                          else "invariant")
                trace = self._trace_to(trace_levels, frontier_maps,
                                       depth + 1, inv_hit,
                                       from_new=True) \
                    if self.store_trace else [(st, "?")]
                return self._mk_result(
                    False, distinct, generated, depth + 1, t0, warnings,
                    Violation("invariant", nm, trace))

            sel = np.nonzero(explore_mask)[0]
            if graph is not None:
                new_sids = graph.add_level(new_rows_np[sel],
                                           new_prov_np[sel], L,
                                           frontier_sids)
                for erows, eparents in lvl_edges:
                    graph.add_edges(erows, eparents, frontier_sids)
                frontier_sids = new_sids
            if self.store_trace:
                frontier_maps.append(sel.astype(np.int64))
            tel.level(depth, frontier=L, generated=generated - lvl_gen0,
                      new=len(sel), distinct=distinct, seen=len(store),
                      wall_s=round(time.time() - lvl_t0, 6))
            self._fp_occupancy = len(store)
            depth += 1
            if self.max_states and distinct >= self.max_states:
                self.log("-- state limit reached, search truncated")
                return self._mk_result(
                    True, distinct, generated, depth, t0, warnings,
                    None, truncated=True,
                    trunc_reason=f"max_states: distinct {distinct} >= "
                                 f"limit {self.max_states}")
            frontier_np = new_rows_np[sel]

            now = time.time()
            if self.checkpoint_path and \
                    now - last_ck >= self.checkpoint_every:
                last_ck = now
                hs_ck(frontier_np)
                self._write_host_snapshot(trace_levels, frontier_maps,
                                          graph, depth, generated)
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} generated, "
                         f"{distinct} distinct, {len(frontier_np)} on "
                         f"queue.{obs.eta_suffix(distinct)}")

        if graph is not None:
            viol = self._check_live(graph, warnings)
            if viol is not None:
                return self._mk_result(False, distinct, generated,
                                       depth - 1, t0, warnings, viol)
        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct "
                 f"states found, 0 states left on queue.")
        if self.checkpoint_path and self.final_checkpoint:
            # a COMPLETED-run checkpoint: an empty frontier over the
            # whole store; resuming it replays the stored totals
            hs_ck(np.zeros((0, self.PW), np.int32))
        return self._mk_result(True, distinct, generated, depth - 1, t0,
                               warnings)

    def _fb_expand_level(self, frontier_np, L, store, lvl_new_rows,
                         lvl_new_prov, lvl_explore, lvl_edges, fb_enabled,
                         trace_levels, frontier_maps, depth, t0, warnings,
                         distinct, generated):
        """Hybrid execution, action side: enumerate the fallback arms
        with the EXACT interpreter over this level's decoded frontier
        states, encode the successors, key them (K2), dedup them through
        the native store, and splice rows/provenance into the level
        streams so traces, refinement and the liveness behavior graph
        see one uniform level.  Fallback arm j uses provenance action
        index A + j.

        Returns (generated_inc, distinct_inc, violation CheckResult |
        None); mutates lvl_* and fb_enabled in place."""
        from ..sem.enumerate import enumerate_next
        from ..sem.eval import TLCAssertFailure, _bool, eval_expr
        from ..sem.modules import satisfies_constraints
        from ..sem.values import EvalError
        model = self.model
        layout = self.layout
        base_ctx = model.ctx()
        gen_inc = 0
        cand_rows: List[np.ndarray] = []
        cand_prov: List[int] = []

        def _mk(viol):
            return self._mk_result(False, distinct, generated + gen_inc,
                                   depth, t0, warnings, viol)

        decoded = [layout.decode_packed(frontier_np[f]) for f in range(L)]
        for j, (arm, _reason) in enumerate(self.fb_arms):
            ctx = base_ctx.with_bound(arm.bound)
            for f in range(L):
                pst = decoded[f]
                try:
                    succs = [st for st, _ in enumerate_next(
                        arm.expr, ctx, model.vars, pst)]
                except TLCAssertFailure as ex:
                    trace = self._trace_to(trace_levels, frontier_maps,
                                           depth, f)
                    return gen_inc, 0, _mk(Violation(
                        "assert", "Assert",
                        [x for x in trace if x[0] is not None],
                        str(ex.out)))
                if succs:
                    fb_enabled[f] = True
                gen_inc += len(succs)
                for sst in succs:
                    # constraint check FIRST: a discarded successor is
                    # never explored, counted, or checked, so it needs
                    # no encoding at all (its value shapes may be absent
                    # from the sampled layout); satisfaction is
                    # state-determined, so the drop is count-equivalent
                    # to fingerprint-and-discard
                    if not satisfies_constraints(model, sst):
                        continue
                    try:
                        row = np.asarray(layout.encode(sst), np.int32)
                    except (CompileError, EvalError) as ex:
                        # an OBSERVATION gap relayout can fix; the
                        # failing state rides along so recovery does not
                        # depend on the enrichment cap
                        self._last_ovf_code = OV_DEMOTED
                        self._relayout_hint = True
                        self._last_frontier_np = frontier_np
                        self._relayout_states = [sst]
                        return gen_inc, 0, _mk(Violation(
                            "error", "capacity overflow", [],
                            "a fallback successor exceeded its lane "
                            f"capacity ({ex}; {self._caps_note()}); "
                            "counts would no longer be exact"))
                    # EVERY invariant (compiled and demoted alike)
                    # checks host-side on fallback successors
                    ictx = model.ctx(state=sst)
                    for inm, iex in model.invariants:
                        if not _bool(eval_expr(iex, ictx),
                                     f"invariant {inm}"):
                            trace = self._trace_to(
                                trace_levels, frontier_maps, depth, f)
                            trace = [x for x in trace
                                     if x[0] is not None]
                            trace.append(
                                (sst, self.labels_flat[self.A + j]))
                            return gen_inc, 0, _mk(Violation(
                                "invariant", inm, trace))
                    for rc in self.refiners:
                        if not rc.check_edge(pst, sst):
                            trace = self._trace_to(
                                trace_levels, frontier_maps, depth, f)
                            return gen_inc, 0, _mk(
                                self._refine_violation(
                                    rc, sst, self.A + j, trace))
                    cand_rows.append(row)
                    cand_prov.append((self.A + j) * L + f)

        if not cand_rows:
            return gen_inc, 0, None
        rows_mat = np.stack(cand_rows)
        keys, packed_mat, povf = self._host_keys(rows_mat)
        if povf:
            # the same observation-gap class as an encode failure
            self._last_ovf_code = OV_DEMOTED
            self._relayout_hint = True
            self._last_frontier_np = frontier_np
            self._relayout_states = []
            return gen_inc, 0, _mk(Violation(
                "error", "capacity overflow", [],
                f"a fallback successor escaped its packed lane range "
                f"({self._pack_ovf_msg()})"))
        if self.collect_edges:
            # every explored successor edge (revisits included) feeds the
            # behavior graph, as the device candidate stream does
            lvl_edges.append(
                (packed_mat, np.asarray([p % L for p in cand_prov])))
        new_mask = store.insert(keys[:, 1:])
        new_idx = np.nonzero(new_mask)[0]
        dist_inc = len(new_idx)
        if len(new_idx):
            lvl_new_rows.append(packed_mat[new_idx])
            lvl_new_prov.append(np.asarray(
                [cand_prov[i] for i in new_idx], np.int64))
            lvl_explore.append(np.ones(len(new_idx), bool))
        return gen_inc, dist_inc, None

    def _relayout_and_restart(self) -> Optional[CheckResult]:
        """Adaptive relayout (hybrid): decode the abort-time frontier,
        interp-enumerate one exact level of its successors, and build a
        FRESH engine whose layout sampling includes those states; the
        restarted search then stays compiled.  Returns the fresh
        engine's result, or None when enrichment fails (the caller
        falls back to arm demotion)."""
        from ..sem.enumerate import enumerate_next
        from ..sem.eval import TLCAssertFailure
        from ..sem.values import EvalError
        model = self.model
        cap = 20000
        rows = self._last_frontier_np
        if len(rows) > cap:
            if self.relayouts_left <= 1 and len(rows) <= 10 * cap:
                # last attempt: pay for the FULL frontier (bounded at
                # 10x the per-attempt cap)
                self.log(f"hybrid: final relayout attempt — enriching "
                         f"from ALL {len(rows)} abort-frontier rows")
            else:
                # stride over the WHOLE frontier, with a per-attempt
                # offset so a repeated abort enriches from other rows
                stride = -(-len(rows) // cap)
                off = self.relayouts_left % stride
                self.log(f"hybrid: relayout enrichment strided (rows "
                         f"{off}::{stride} of {len(rows)} in the abort "
                         f"frontier)")
                rows = rows[off::stride]
        enrich: List[Dict[str, Any]] = list(self._relayout_states)
        base_ctx = model.ctx()
        enrich_cap = 400_000  # hard memory ceiling on successor dicts
        try:
            for row in rows:
                # frontier states are encodable already: only their
                # SUCCESSORS can carry unobserved shapes
                st = self.layout.decode_packed(np.asarray(row))
                for succ, _ in enumerate_next(model.next, base_ctx,
                                              model.vars, st):
                    enrich.append(succ)
                if len(enrich) >= enrich_cap:
                    self.log(f"hybrid: relayout enrichment truncated "
                             f"at {len(enrich)} successor states "
                             f"(memory ceiling)")
                    break
        except (EvalError, TLCAssertFailure):
            return None
        self.log(f"hybrid: adaptive relayout — re-sampling with "
                 f"{len(enrich)} abort-frontier states, rebuilding "
                 f"kernels, restarting compiled "
                 f"({self.relayouts_left - 1} attempts left)")
        obs.current().counter("expand.relayouts")
        obs.current().reset_levels("adaptive relayout restart")
        if self.checkpoint_path:
            # a checkpoint written under the enriched layout could not be
            # resumed (a resume re-derives the layout from plain
            # sampling, so the layout signature would differ): the
            # restarted run writes none, and it never resumes, since the
            # checkpoint it was started from was already consumed
            self.log("hybrid: relayout disables checkpointing for the "
                     "restarted run (the enriched layout would make "
                     "checkpoints unresumable)")
        try:
            ex2 = TorchExplorer(
                model, log=self.log, max_states=self.max_states,
                store_trace=self.store_trace,
                progress_every=self.progress_every, bounds=self.bounds,
                sample_cfg=self.sample_cfg, host_seen=True,
                chunk=self.chunk,
                extra_samples=self.extra_samples + enrich,
                relayouts_left=self.relayouts_left - 1,
                seen_mode=self.seen_mode_req, device=self.device,
                twins=self.twins, por=self.por, seen_cap=self.seen_cap)
        except (CompileError, ModeError):
            return None
        return ex2.run()

    def _demote_arms(self, arm_idxs) -> List[str]:
        """Hybrid runtime demotion: move the given arms' compiled
        kernels to the interpreter-fallback list.  Called when a demoted
        guard conjunct's abort flag fires; the caller restarts."""
        idxset = set(arm_idxs)
        reasons: Dict[int, List[str]] = {ai: [] for ai in idxset}
        labels: List[str] = []
        for i, ca in enumerate(self.compiled):
            ai = self._ca_arm[i]
            if ai in idxset:
                reasons[ai].extend(ca.demoted_guards)
                labels.append(ca.label)
        keep = [(ga, ca, ai) for ga, ca, ai in
                zip(self.actions, self.compiled, self._ca_arm)
                if ai not in idxset]
        self.actions = [g for g, _, _ in keep]
        self.compiled = [c for _, c, _ in keep]
        self._ca_arm = [a for _, _, a in keep]
        self.labels_flat = []
        for ca in self.compiled:
            self.labels_flat.extend([ca.label] * (ca.n_slots or 1))
        self.A = len(self.labels_flat)
        for ai in sorted(idxset):
            why = "; ".join(dict.fromkeys(reasons[ai])) or \
                "demoted guard conjunct"
            self.fb_arms.append((self.arms[ai], f"guard demoted: {why}"))
        self.labels_flat = self.labels_flat + \
            [arm.label or "Next" for arm, _ in self.fb_arms]
        self.hybrid = True
        self._demotable = []
        # the engine is hybrid now: a cached POR plan would mask arms
        # the interpreter expands out of the device's sight
        self._por_memo = _POR_UNSET
        obs.current().counter("expand.recovery_demotions", len(idxset))
        return labels

    def _run_hybrid(self) -> CheckResult:
        """run() in host_seen mode: the search, then on a compile-
        recovery abort (OV_DEMOTED, or OV_PACK) an adaptive relayout
        when an observation gap can explain it, else the demotion of
        the aborting arms to the interpreter and a restart."""
        self._last_ovf_code = 0
        self._relayout_hint = False
        self._relayout_states: List[Dict[str, Any]] = []
        r = self._run_host_seen()
        while not r.ok and r.violation is not None \
                and r.violation.kind == "error" \
                and self._last_ovf_code in (OV_DEMOTED, OV_PACK):
            # structural compiler limitations can never be fixed by
            # observation; a packed-lane overflow always can
            def _structural(why):
                return ("extensional" in why or
                        "unbounded CHOOSE" in why or
                        "Lambda" in why or "not supported" in why)
            fixable = (self._last_ovf_code == OV_PACK or
                       self._relayout_hint or any(
                           not _structural(why)
                           for ca in self.compiled
                           for why in ca.demoted_guards))
            if fixable and self.relayouts_left > 0 and \
                    self._last_frontier_np is not None and \
                    len(self._last_frontier_np):
                r2 = self._relayout_and_restart()
                if r2 is not None:
                    return r2
            if not self._demotable:
                break
            demoted = self._demote_arms(self._demotable)
            obs.current().reset_levels("hybrid demotion restart")
            self.log(f"hybrid: demotion abort — falling "
                     f"{demoted} back to the interpreter and "
                     f"restarting")
            self._last_ovf_code = 0
            self._relayout_hint = False
            self._relayout_states = []
            r = self._run_host_seen()
        return r

    # ---- temporal and refinement PROPERTYs (host side) ----

    def _temporal_warnings(self) -> List[str]:
        out = []
        if self.live_unsupported:
            out.append(
                "temporal properties NOT checked (unsupported form): "
                + ", ".join(self.live_unsupported))
        for rc in self.refiners:
            if rc.liveness_skipped:
                out.append(
                    f"property {rc.name}: refinement checked stepwise; "
                    f"its fairness conjuncts are NOT checked")
        return out

    def _check_live(self, graph, warnings) -> Optional[Violation]:
        """Run the temporal obligations over the accumulated behavior
        graph (end of a completed search)."""
        if not self.live_obligations:
            return None
        from ..engine.liveness import LivenessChecker
        states = [self.layout.decode_packed(r) for r in graph.rows]
        lc = LivenessChecker(self.model, states, graph.edges,
                             graph.parents, graph.labels)
        bad, live_warns = lc.check(self.live_obligations)
        warnings.extend(live_warns)
        if bad is None:
            return None
        pname, trace, msg = bad
        return Violation("property", pname, trace, msg)

    def _refine_init(self, init_rows, explored_init):
        """check_init on kept init states; (rc_name, state) | None."""
        if not self.refiners:
            return None
        for i in explored_init:
            st = self.layout.decode(init_rows[i])
            for rc in self.refiners:
                if not rc.check_init(st):
                    return rc.name, st
        return None

    def _refine_edges(self, frontier_rows, rows, idx, FC):
        """Stepwise refinement over a step's kept candidate edges, in
        candidate order: rows [n, PW] packed, idx [n] their candidate
        indices a*FC + f (bfs._refine_edges over cvalid & explore).
        Returns (action_idx, frontier_idx, succ_state, checker) or None.
        Duplicate (parent, succ) pairs are checked once per run."""
        if not self.refiners or not len(idx):
            return None
        parents: Dict[int, Any] = {}
        if len(self._ref_pair_cache) > (1 << 20):
            self._ref_pair_cache.clear()
        for i in range(len(idx)):
            c = int(idx[i])
            f = c % FC
            a = c // FC
            key = (frontier_rows[f].tobytes(), rows[i].tobytes())
            if key in self._ref_pair_cache:
                continue
            self._ref_pair_cache.add(key)
            pst = parents.get(f)
            if pst is None:
                pst = self.layout.decode_packed(frontier_rows[f])
                parents[f] = pst
            sst = self.layout.decode_packed(rows[i])
            for rc in self.refiners:
                if not rc.check_edge(pst, sst):
                    return a, f, sst, rc
        return None

    def _refine_msg(self, rc) -> str:
        msg = (f"step is not a [{rc.name}-Next]_v step of the refined "
               f"specification")
        if rc.last_error:
            msg += f"; while evaluating the property: {rc.last_error}"
        return msg

    def _refine_violation(self, rc, sst, a, trace):
        trace = [x for x in trace if x[0] is not None]
        trace.append((sst, self.labels_flat[a]))
        return Violation("property", rc.name, trace, self._refine_msg(rc))

    # ---- lifted constants and follower clones (cross-model batching) ----

    def batch_block_reason(self) -> Optional[str]:
        """None when this engine can serve as a cross-model batch donor
        or member; otherwise the blocker (the batch planner falls back
        to solo runs and reports it).  The reference's arm-split clause
        (JAXMC_FUSED_MAX_INSTANCES on XLA:CPU) has no counterpart: the
        port always runs the fused step."""
        if not self.host_seen:
            return "host_seen mode required"
        if self.hybrid:
            return ("hybrid execution (interp-demoted units): "
                    + "; ".join(
                        [f"arm {a.label or 'Next'}" for a, _ in
                         self.fb_arms]
                        + [f"invariant {nm}" for nm, _, _ in
                           self.fb_invs]
                        + [f"constraint {nm}" for nm, _, _ in
                           self.fb_cons]))
        if self.refiners:
            return "refinement PROPERTYs (stepwise host edge checks)"
        if self.live_obligations:
            return "temporal PROPERTYs (behavior graph)"
        if self._demotable:
            # a fired compile-recovery demotion restarts via
            # _demote_arms, which mutates the (donor-shared) compiled
            # arm set mid-cohort — refuse up front
            return ("compile-recovery demotions possible (arms "
                    + ", ".join(self.arms[i].label or "Next"
                                for i in self._demotable)
                    + "): a runtime demotion restart would mutate the "
                      "shared batch program")
        if self.seen_cap is not None:
            return "hierarchical seen-set spill (per-member tiers)"
        return None

    # what a follower shares with its donor: the layout and every
    # compiled unit (and the device they live on)
    _DONOR_SHARED = (
        "device", "twins", "bounds", "layout", "kc",
        "plan", "pt",
        "compiled", "actions", "arms", "_ca_arm", "fb_arms", "fb_invs",
        "fb_cons", "inv_fns", "constraint_fns", "canon", "_sym_fallback",
        "sym_identity", "view_fn", "view_width", "refiners", "unrefined",
        "live_obligations", "live_unsupported", "collect_edges",
        "_need_edges", "hybrid", "_demotable", "labels_flat",
        "arm_verdicts", "A", "W", "PW", "K", "fp_mode", "key_width",
        "chunk", "sample_cfg", "host_seen", "seen_mode_req", "_lift_names",
        "_gen", "_gen_first")

    def _clone_from_donor(self, donor: "TorchExplorer", model: Model,
                          log, max_states, store_trace,
                          progress_every) -> None:
        """Follower construction: reuse the donor's layout and compiled
        units wholesale — no sampling, no bounds fixpoint, no builds —
        binding only this member's model, init states and run control.
        The caller (backend/batch.py) has proven layout compatibility
        and that the donor is batchable."""
        reason = donor.batch_block_reason()
        if reason is not None:
            raise ModeError(f"donor engine is not batchable: {reason}")
        for attr in self._DONOR_SHARED:
            setattr(self, attr, getattr(donor, attr))
        self.model = model
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.max_states = max_states
        self.store_trace = store_trace
        self.progress_every = progress_every
        self.resident = False
        self.pin_interp_arms = False
        self._res_caps_hint = None
        self.extra_samples = []
        # a relayout restart rebuilds layout and units per member, which
        # would diverge from the shared batch program
        self.relayouts_left = 0
        self._last_frontier_np = None
        self._ref_pair_cache = set()
        self.seen_cap = None
        self.spill_dir = None
        self.host_tier_keys = None
        self._tiers = None
        self._cvec = np.asarray([int(model.defs[n])
                                 for n in self._lift_names], np.int32)
        self.init_states = enumerate_init(model.init, model.ctx(),
                                          model.vars)

    # ---- SYMMETRY and POR disclosure ----

    def _symmetry_warnings(self) -> List[str]:
        if self.model.symmetry is None or self.canon is not None \
                or self.sym_identity:
            # identity groups have no reduction to fall back FROM
            return []
        return [SYMMETRY_WARNING + (f" ({self._sym_fallback})"
                                    if self._sym_fallback else "")]

    def _por_plan(self) -> Optional[Dict[str, Any]]:
        """The device POR plan, or None with the named refusal in
        self.por_reason (the engine then runs unreduced and says why).

        plan = dict(inst_arm [A] int32 - split-arm index per flat kernel
        instance (slotted kernels contribute n_slots entries), arm_safe
        [n_arms] bool - arms the independence report proved commuting
        with all and property-invisible), and both as tensors on the
        device (the level step's K6 reads those; the host_seen engine
        masks on the host with _por_mask_np)."""
        if self._por_memo is not _POR_UNSET:
            return self._por_memo
        from ..analyze.independence import (indep_enabled,
                                            independence_report,
                                            por_refusal)
        plan = None
        reason = None
        if not self.por:
            reason = "POR not requested"
        elif not indep_enabled():
            reason = ("independence analysis disabled "
                      "(JAXMC_ANALYZE_INDEP=0)")
        elif self.hybrid:
            reason = ("hybrid execution: interp-demoted units expand "
                      "on the host where the device mask cannot reach "
                      "them")
        else:
            reason = por_refusal(self.model)
            if reason is None and (self.canon is not None
                                   or self.sym_identity):
                reason = "symmetry canonicalizer active"
            if reason is None:
                try:
                    irep = independence_report(self.model, self.arms)
                except Exception:
                    if os.environ.get("JAXMC_DEBUG"):
                        raise
                    irep = None
                if irep is None:
                    reason = "independence analysis failed"
                elif not irep.por_safe:
                    reason = ("no arm commutes with every other arm "
                              "invisibly")
                else:
                    if len(self.arms) > ops.POR_MAX_ARMS and \
                            not self.host_seen:
                        raise ModeError(
                            f"--por: {len(self.arms)} action arms, the "
                            f"device filter takes at most "
                            f"{ops.POR_MAX_ARMS}")
                    safe = np.zeros(len(self.arms), dtype=bool)
                    safe[list(irep.por_safe)] = True
                    inst = np.asarray(
                        [self._ca_arm[ci]
                         for ci, ca in enumerate(self.compiled)
                         for _ in range(max(1, ca.n_slots))], np.int32)
                    assert inst.shape[0] == self.A
                    plan = dict(inst_arm=inst, arm_safe=safe,
                                inst_arm_t=torch.as_tensor(
                                    inst, device=self.device),
                                arm_safe_t=torch.as_tensor(
                                    safe, device=self.device))
        self._por_memo = plan
        self.por_reason = reason
        tel = obs.current()
        if self.por:
            if plan is None:
                self.log(f"-- por requested but reduction disabled: "
                         f"{reason} (running unreduced)")
                tel.gauge("por.disabled_reason", reason)
                tel.gauge("por.enabled", False)
            else:
                n_safe = int(plan["arm_safe"].sum())
                self.log(f"-- por: {n_safe}/{len(self.arms)} arms "
                         f"eligible as singleton ample sets (device "
                         f"persistent-set filter in the fused step)")
                tel.gauge("por.enabled", True)
                tel.gauge("por.engine", "device")
        return plan

    def _por_warnings(self) -> List[str]:
        """The reference's refusal warning, word for word, when --por
        was requested but the reduction cannot run."""
        if not self.por:
            return []
        if self._por_plan() is None:
            return [f"--por requested but reduction disabled: "
                    f"{self.por_reason} (running unreduced)"]
        return []

    def _por_finish(self, ample: int, expanded: int, masked: int,
                    distinct: int) -> None:
        """The end-of-run POR counters (the reference's names)."""
        if not isinstance(self._por_memo, dict):
            return
        tel = obs.current()
        full = max(0, int(expanded) - int(ample))
        tel.counter("por.ample_states", int(ample))
        tel.counter("por.full_states", full)
        tel.gauge("por.ample_ratio",
                  round(int(ample) / int(expanded), 4)
                  if expanded else 0.0)
        tel.gauge("por.device_masked_arms", int(masked))
        tel.gauge("por.reduced_states", int(distinct))

    def _mk_result(self, ok, distinct, generated, diameter, t0, warnings,
                   violation=None, truncated=False, drained=False,
                   trunc_reason: Optional[str] = None) -> CheckResult:
        tel = obs.current()
        tel.high_water("device.mem_high_water_bytes",
                       obs.device_mem_high_water())
        occ = getattr(self, "_fp_occupancy", None)
        if occ is not None:
            tel.gauge("fingerprint.occupancy", occ)
        if truncated and self.live_obligations:
            warnings.append("temporal properties NOT checked: the "
                            "search was truncated (behavior graph "
                            "incomplete)")
        # the tier-hierarchy summary when the run spilled
        tiers_stats = None
        if self._tiers is not None and self._tiers.active:
            tiers_stats = self._tiers.stats()
            self._tiers.publish_gauges(occ or 0)
        self._por_finish(self._por_stats["ample"],
                         self._por_stats["expanded"],
                         self._por_stats["masked"], distinct)
        seen_mode = "fingerprint" if self.fp_mode else "exact"
        collision_p = None
        if self.fp_mode:
            # every admitted key: device occupancy and the cold tiers
            n = float((occ or 0) + (len(self._tiers)
                                    if self._tiers is not None else 0))
            collision_p = n * n * 2.0 ** -129
            tel.gauge("fingerprint.collision_p", collision_p)
        if truncated and trunc_reason is None:
            trunc_reason = "drain" if drained else "unattributed"
        if trunc_reason:
            tel.gauge("truncation.reason", trunc_reason)
        return CheckResult(ok=ok, distinct=distinct, generated=generated,
                           diameter=max(diameter, 0), violation=violation,
                           wall_s=time.time() - t0, truncated=truncated,
                           warnings=warnings, drained=drained,
                           trunc_reason=trunc_reason,
                           seen_mode=seen_mode, collision_p=collision_p,
                           tiers=tiers_stats)

    def _trace_to(self, trace_levels, frontier_maps, level: int, idx: int,
                  from_new: bool = False) -> List[Tuple[Dict, str]]:
        if not self.store_trace:
            return []
        out = []
        lvl = level
        cur = idx
        if not from_new and lvl < len(frontier_maps):
            cur = int(frontier_maps[lvl][cur])
        while lvl >= 0:
            rows, prov, par_FC = trace_levels[lvl]
            row = rows[cur]
            st = self.layout.decode_packed(row)
            if prov is None:
                out.append((st, "Initial predicate"))
                break
            p = int(prov[cur])
            a, f = p // par_FC, p % par_FC
            out.append((st, self.labels_flat[a]))
            lvl -= 1
            cur = int(frontier_maps[lvl][f]) if lvl < len(frontier_maps) \
                else f
        out.reverse()
        return out
