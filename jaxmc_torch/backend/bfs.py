r"""The level engine and the host-seen engine on the card: TorchExplorer.

The port of jaxmc/backend/bfs.py's level mode (TpuExplorer.run without
resident or host_seen) and of its host_seen mode.  In the level mode
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
  5. stable-sort the candidate keys        torch.sort (LSD passes)
  6. probe them against the sorted seen    K3 seen_probe   (CUDA)
  7. rank-merge the new keys into the table K4 rank_merge  (CUDA)
  8. apply the CONSTRAINTs, 9. order the next frontier by provenance,
  10. check the invariants                 torch + the emitter

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
from ..analyze import bounds_enabled, infer_state_bounds
from ..compile.ground import ground_arm, split_arms
from ..compile.kernel2 import (KernelCtx, OV_DEMOTED, OV_PACK,
                               build_layout2, compile_action2,
                               compile_predicate2, compile_value2)
from ..compile.vspec import Bounds, CompileError, ModeError
from ..engine.explore import CheckResult, Violation
from ..engine.simulate import sample_states
from ..kernels import ops
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


class TorchExplorer:
    """Level-synchronous BFS over the device-resident seen table, or
    (host_seen=True) over the native host fingerprint store in
    chunks."""

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
                 seen_cap: Optional[int] = None):
        # twins=True runs the kernels' plain PyTorch twins on the same
        # device: the parity oracle for the CUDA path (tests and
        # chip_smoke.py pass it; nothing else does)
        self.device = resolve_device(device)
        self.twins = bool(twins)
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
        # ADAPTIVE RELAYOUT (hybrid, host_seen): when a compile-recovery
        # demotion fires because a value SHAPE was never observed by the
        # layout sampler, the engine re-samples from the abort-time
        # frontier, rebuilds the layout and kernels with the enriched
        # observation set, and restarts compiled — falling back to
        # whole-arm interpretation only after relayouts_left attempts.
        self.extra_samples = list(extra_samples or [])
        self.relayouts_left = relayouts_left
        self.seen_mode_req = seen_mode
        self._last_frontier_np: Optional[np.ndarray] = None
        # device POR: the plan (instance -> arm map, por-safe arms) is
        # resolved once by _por_plan(), which names the refusal when the
        # reduction cannot run
        self.por = bool(por)
        self.por_reason: Optional[str] = None
        self._por_memo: Any = _POR_UNSET
        self._por_stats = {"ample": 0, "expanded": 0, "masked": 0}
        self._refuse_modes(model)

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
            with tel.span("analyze_bounds"):
                rep = infer_state_bounds(model)
            if rep is not None:
                ebf = getattr(rep, "element_bounds", None)
                static_bounds = ebf() if callable(ebf) else rep.lane_bounds()
                tel.gauge("analyze.bounds_converged", bool(rep.converged))
        with tel.span("layout_build", samples=len(sampled)):
            self.layout = build_layout2(model, sampled, self.bounds,
                                        static_bounds=static_bounds)
        self.kc = KernelCtx(model, self.layout, self.bounds)
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
        for ai, arm in enumerate(self.arms):
            try:
                with tel.span("compile_arm", arm=arm.label or "Next"):
                    gas = ground_arm(model, arm,
                                     dyn_slots=self.bounds.kv_cap)
                    cas = []
                    for ga in gas:
                        ca = compile_action2(self.kc, ga)
                        for s in (range(ca.n_slots) if ca.n_slots
                                  else [None]):
                            ca.fn(zero) if s is None else ca.fn(zero, s)
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
                    f(zero)
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
            self.constraint_fns, self.fb_cons = compile_preds(
                model.constraints, self.host_seen)
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
            if self.host_seen:
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
        # the out-of-core device tiers are not ported (ROADMAP A.9); the
        # host store needs none (the run logs that the cap is ignored)
        env_cap = os.environ.get("JAXMC_SEEN_CAP")
        self.seen_cap = int(seen_cap if seen_cap is not None
                            else (env_cap if env_cap else 0)) or None
        if seen_cap and not self.host_seen:
            raise ModeError("--seen-cap (out-of-core tiers) is not ported "
                            "to the torch engine yet (ROADMAP A.9)")
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

    @staticmethod
    def _refuse_modes(model: Model) -> None:
        if model.properties:
            raise ModeError("temporal and refinement PROPERTYs are not "
                            "ported to the torch level engine yet "
                            "(ROADMAP A.7)")
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

    def _rank_merge(self, seen, seen_count: int, keys):
        f = ops.rank_merge_twin if self.twins else ops.rank_merge
        return f(seen, seen_count, keys)

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

    def level_step(self, seen, seen_count: int, frontier_p, fcount: int):
        """One fused level over seen [SC, K] (sorted valid prefix of
        seen_count rows) and frontier_p [FC, PW] (fcount valid rows).
        Requires seen_count + A*FC <= SC.  Returns a dict of device
        tensors; `scalars` is one int64 vector read with one copy:
        [overflow, assert_any, assert_a, assert_f, dead_any, dead_f,
         gen, front_count, seen_count2, inv_any, inv_idx, inv_which],
        followed by [por_ample, por_expanded, por_masked] when the
        device POR filter runs."""
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
        # key-sorted order (stable ties keep the first occurrence)
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
        # stable 2-key sort on (not explore, fmaj) as one int64 key
        fmaj = (new_prov % FC) * max(A, 1) + torch.div(
            new_prov, FC, rounding_mode="floor")
        key4 = (~explore).to(torch.int64) * (1 << 40) + fmaj
        perm4 = torch.sort(key4, stable=True).indices
        front_rows = new_rows[perm4]
        front_rows_u = new_rows_u[perm4]
        front_prov = new_prov[perm4].to(torch.int32)
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
            + por_scalars)
        return dict(scalars=scalars, seen=rm["seen2"],
                    front_rows=front_rows, front_prov=front_prov,
                    dead=dead, assert_bad=assert_bad)

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
        if self.host_seen:
            return self._run_hybrid()
        t0 = time.time()
        tel = obs.current()
        dev = self.device
        W, K, PW = self.W, self.K, self.PW
        warnings: List[str] = []
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
        self.log(f"Progress({depth}): {generated} states generated, "
                 f"{distinct} distinct states found, "
                 f"{fcount} states left on queue.")
        last_progress = time.time()
        while fcount > 0:
            lvl_t0 = time.time()
            C = self.A * FC
            if seen_count + C > SC:
                SC2 = _pow2_at_least(seen_count + C, SC)
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

            generated += gen
            if len(vals) > 12:
                for name, v in zip(("ample", "expanded", "masked"),
                                   vals[12:]):
                    self._por_stats[name] += v
            distinct += front_count
            seen = out["seen"]
            seen_count = seen_count2
            tel.level(depth, frontier=fcount, generated=gen,
                      new=front_count, distinct=distinct, seen=seen_count,
                      wall_s=round(time.time() - lvl_t0, 6))
            self._fp_occupancy = seen_count

            if self.store_trace:
                # trace levels hold the kept states; every kept state is
                # explored, so the frontier map is the identity
                trace_levels.append(
                    (out["front_rows"][:front_count].cpu().numpy(),
                     out["front_prov"][:front_count].cpu().numpy(), FC))
                frontier_maps.append(np.arange(front_count, dtype=np.int64))
            if inv_any:
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

            if front_count > FC:
                FC = _pow2_at_least(front_count, FC)
            nf = torch.full((FC, PW), int(SENTINEL), dtype=torch.int32,
                            device=dev)
            nf[:front_count] = out["front_rows"][:front_count]
            frontier = nf
            fcount = front_count
            del out

            now = time.time()
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} states generated, "
                         f"{distinct} distinct states found, "
                         f"{fcount} states left on queue.")

        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct states "
                 f"found, 0 states left on queue.")
        self.log(f"The depth of the complete state graph search is "
                 f"{depth}.")
        return self._mk_result(True, distinct, generated, depth - 1, t0,
                               warnings)

    # ---- the chunked host-seen engine ----

    def _epilogue(self, en, aok, ov, fcount: int, keys, cand, pack_ovf,
                  inv_ok, explore) -> dict:
        f = ops.hstep_epilogue_twin if self.twins else ops.hstep_epilogue
        return f(en, aok, ov, fcount, keys, cand, pack_ovf, OV_PACK,
                 inv_ok, explore)

    def _hstep(self, frontier_p: torch.Tensor, fcount: int) -> dict:
        """One chunk of the host-seen step (bfs._hstep_core, the fused
        path of _get_hstep): unpack (K1), expand every compiled
        instance, keys (K2, fp128), the invariants and constraints over
        every candidate, then the epilogue (K7): verdict scalars and
        the compacted valid candidates.  Returns K7's dict of device
        tensors.  The reference splits the step into arm groups on
        XLA:CPU, whose single fused program compiles superlinearly in
        the instance count; eager torch compiles nothing, so the port
        always runs this fused step (same counts and traces)."""
        A, W, PW = self.A, self.W, self.PW
        CH = frontier_p.shape[0]
        dev = frontier_p.device
        frontier = self._unpack(frontier_p)
        en, aok, ov, succ = self._expand(frontier)
        C = A * CH
        fvalid = torch.arange(CH, device=dev) < fcount
        cvalid = (en & fvalid[None, :]).reshape(C)
        if C == 0:
            # hybrid with every arm demoted: the device only hashes
            keys = torch.zeros((0, self.K), dtype=torch.int32, device=dev)
            cand = torch.zeros((0, PW), dtype=torch.int32, device=dev)
            pack_ovf = torch.zeros((), dtype=torch.bool, device=dev)
            cand_u = torch.zeros((0, W), dtype=torch.int32, device=dev)
        else:
            cand_u = torch.where(cvalid[:, None], succ.reshape(C, W),
                                 torch.full((), int(SENTINEL),
                                            dtype=torch.int32,
                                            device=dev))
            keys, cand, pack_ovf = self._keys_of(cand_u, cvalid)
        del succ
        inv_ok = torch.ones(C, dtype=torch.bool, device=dev)
        explore = torch.ones(C, dtype=torch.bool, device=dev)
        for _nm, f in (self.inv_fns if C else ()):
            inv_ok = inv_ok & f(cand_u)
        for _nm, f in (self.constraint_fns if C else ()):
            explore = explore & f(cand_u)
        return self._epilogue(en, aok, ov, fcount, keys, cand, pack_ovf,
                              inv_ok, explore)

    def _d2h(self, tensors, n: Optional[int] = None) -> List[np.ndarray]:
        """Host copies of `tensors` (of their first n rows when n is
        given): where the chunk loop waits for the chunk's step."""
        return [(t if n is None else t[:n]).cpu().numpy() for t in tensors]

    def _run_host_seen(self) -> CheckResult:
        from .. import native_store
        from ..sem.eval import _bool, eval_expr
        t0 = time.time()
        tel = obs.current()
        model = self.model
        layout = self.layout
        warnings = ["seen-set resident in the native host fingerprint "
                    "store (host_seen); dedup on 128-bit fingerprints"]
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
        trace_levels = [(np.asarray(init_packed), None, 0)]
        frontier_maps = [np.asarray(explored_init, dtype=np.int64)]
        depth = 0
        self.log(f"Progress({depth}): {generated} generated, "
                 f"{distinct} distinct, {len(frontier_np)} on queue.")
        last_progress = time.time()
        while len(frontier_np) > 0:
            L = len(frontier_np)
            lvl_t0 = time.time()
            lvl_gen0 = generated
            lvl_new_rows: List[np.ndarray] = []
            lvl_new_prov: List[np.ndarray] = []
            lvl_explore: List[np.ndarray] = []
            lvl_dead = np.zeros(L, bool)  # deferred when fb arms exist
            inv_hit = None
            for base in range(0, L, CH):
                cn = min(CH, L - base)
                block = np.full((CH, PW), SENTINEL, np.int32)
                block[:cn] = frontier_np[base:base + cn]
                out = self._hstep(torch.as_tensor(block, device=self.device),
                                  cn)
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
                    lvl_explore, fb_enabled, trace_levels, frontier_maps,
                    depth, t0, warnings, distinct, generated)
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
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} generated, "
                         f"{distinct} distinct, {len(frontier_np)} on "
                         f"queue.")

        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct "
                 f"states found, 0 states left on queue.")
        return self._mk_result(True, distinct, generated, depth - 1, t0,
                               warnings)

    def _fb_expand_level(self, frontier_np, L, store, lvl_new_rows,
                         lvl_new_prov, lvl_explore, fb_enabled,
                         trace_levels, frontier_maps, depth, t0, warnings,
                         distinct, generated):
        """Hybrid execution, action side: enumerate the fallback arms
        with the EXACT interpreter over this level's decoded frontier
        states, encode the successors, key them (K2), dedup them through
        the native store, and splice rows/provenance into the level
        streams so traces see one uniform level.  Fallback arm j uses
        provenance action index A + j.

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
                   violation=None, truncated=False,
                   trunc_reason: Optional[str] = None) -> CheckResult:
        tel = obs.current()
        tel.high_water("device.mem_high_water_bytes",
                       obs.device_mem_high_water())
        occ = getattr(self, "_fp_occupancy", None)
        if occ is not None:
            tel.gauge("fingerprint.occupancy", occ)
        self._por_finish(self._por_stats["ample"],
                         self._por_stats["expanded"],
                         self._por_stats["masked"], distinct)
        seen_mode = "fingerprint" if self.fp_mode else "exact"
        collision_p = None
        if self.fp_mode:
            n = float(occ or 0)
            collision_p = n * n * 2.0 ** -129
            tel.gauge("fingerprint.collision_p", collision_p)
        if truncated and trunc_reason is None:
            trunc_reason = "unattributed"
        if trunc_reason:
            tel.gauge("truncation.reason", trunc_reason)
        return CheckResult(ok=ok, distinct=distinct, generated=generated,
                           diameter=max(diameter, 0), violation=violation,
                           wall_s=time.time() - t0, truncated=truncated,
                           warnings=warnings, trunc_reason=trunc_reason,
                           seen_mode=seen_mode, collision_p=collision_p)

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
