r"""The level engine on the card: TorchExplorer.

The port of jaxmc/backend/bfs.py's level mode (TpuExplorer.run without
resident or host_seen).  The frontier and the seen table live on the
device; each BFS level is one step:

  1. unpack the frontier                   K1 unpack_rows  (CUDA)
  2. expand every (state x grounded action) compile/kernel2.py emitter
  3. pack the successors, compute keys     K2 keys_of      (CUDA)
  4. stable-sort the candidate keys        torch.sort (LSD passes)
  5. probe them against the sorted seen    K3 seen_probe   (CUDA)
  6. rank-merge the new keys into the table K4 rank_merge  (CUDA)
  7. apply the CONSTRAINTs, 8. order the next frontier by provenance,
  9. check the invariants                  torch + the emitter

Two dedup modes, as the reference: exact (keys are the packed row) and
fp128 (keys are four 32-bit mixes of the packed row) when the packed
width passes FP_THRESHOLD or seen_mode="fingerprint".  Capacities are
power-of-two buckets that grow on demand.  Parent provenance streams to
the host per level for counterexample traces (store_trace=False skips
it).  The step reads its verdict scalars in one small tensor: one host
synchronisation per level.

Modes the level engine of this port does not run raise ModeError with
the ROADMAP item that ports them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..analyze import bounds_enabled, infer_state_bounds
from ..compile.ground import ground_arm, split_arms
from ..compile.kernel2 import (KernelCtx, OV_DEMOTED, OV_PACK,
                               build_layout2, compile_action2,
                               compile_predicate2)
from ..compile.vspec import Bounds, CompileError, ModeError
from ..engine.explore import CheckResult, Violation
from ..engine.simulate import sample_states
from ..kernels import ops
from ..sem.enumerate import enumerate_init
from ..sem.modules import Model

SENTINEL = np.int32(2**31 - 1)
FP_THRESHOLD = 48  # packed lanes; beyond this, dedup on 128-bit fingerprints


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


def _pow2_at_least(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


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
    """Level-synchronous BFS over the device-resident seen table."""

    def __init__(self, model: Model, log: Callable[[str], None] = None,
                 max_states: Optional[int] = None, store_trace: bool = True,
                 progress_every: float = 30.0,
                 bounds: Optional[Bounds] = None,
                 sample_cfg: Tuple[int, int, int] = (800, 40, 60),
                 seen_mode: str = "auto", device=None,
                 twins: bool = False):
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
        self._refuse_modes(model)

        tel = obs.current()
        base_ctx = model.ctx()
        self.init_states = enumerate_init(model.init, base_ctx, model.vars)
        bfs_n, walks, depth = sample_cfg
        with tel.span("layout_sample", bfs_states=bfs_n, walks=walks,
                      walk_depth=depth):
            sampled = sample_states(model, bfs_states=bfs_n,
                                    n_walks=walks, walk_depth=depth)
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
            self.layout = build_layout2(model, list(sampled), self.bounds,
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
        self.compiled = []
        fb_arms: List[Tuple[Any, str]] = []
        for arm in self.arms:
            try:
                with tel.span("compile_arm", arm=arm.label or "Next"):
                    cas = []
                    for ga in ground_arm(model, arm,
                                         dyn_slots=self.bounds.kv_cap):
                        ca = compile_action2(self.kc, ga)
                        for s in (range(ca.n_slots) if ca.n_slots
                                  else [None]):
                            ca.fn(zero) if s is None else ca.fn(zero, s)
                        cas.append(ca)
            except CompileError as e:
                fb_arms.append((arm, str(e)))
                continue
            except RecursionError:
                fb_arms.append(
                    (arm, "recursive operator expansion diverges at "
                          "compile time (RecursionError)"))
                continue
            self.compiled.extend(cas)
        self.labels_flat: List[str] = []
        for ca in self.compiled:
            self.labels_flat.extend([ca.label] * (ca.n_slots or 1))

        def compile_preds(pairs):
            compiled, demoted = [], []
            for nm, ex in pairs:
                f = compile_predicate2(self.kc, ex)
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
                compiled.append((nm, f))
            return compiled, demoted

        with tel.span("compile_predicates",
                      invariants=len(model.invariants),
                      constraints=len(model.constraints)):
            self.inv_fns, fb_invs = compile_preds(model.invariants)
            self.constraint_fns, fb_cons = compile_preds(model.constraints)
        if fb_arms or fb_invs or fb_cons:
            reasons = "; ".join(
                [f"action arm {a.label or 'Next'}: {r}" for a, r in fb_arms]
                + [f"invariant {nm}: {r}" for nm, _, r in fb_invs]
                + [f"constraint {nm}: {r}" for nm, _, r in fb_cons])
            raise ModeError(
                "spec needs hybrid execution (uncompilable units "
                "demoted to the exact interpreter), which only the "
                "host_seen device mode runs — pass host_seen=True; "
                f"demoted units: {reasons} (the port's host_seen mode "
                f"is ROADMAP A.8)")

        self.A = len(self.labels_flat)
        self.fp_mode = self.PW > FP_THRESHOLD
        if seen_mode not in ("auto", "exact", "fingerprint"):
            raise ModeError(f"unknown --seen mode {seen_mode!r} "
                            f"(expected auto, exact or fingerprint)")
        if seen_mode == "fingerprint":
            self.fp_mode = True
        elif seen_mode == "exact" and self.fp_mode:
            raise ModeError(
                f"--seen exact refused: the dedup key is {self.PW} "
                f"lanes wide (> FP_THRESHOLD={FP_THRESHOLD}); exact keys "
                f"at this width would dominate device memory — use "
                f"--seen fingerprint (collision probability is reported)")
        # dedup key lanes: an explicit validity lane FIRST (0=valid row,
        # 1=invalid), then the packed row or its 4-word fingerprint
        self.K = (4 if self.fp_mode else self.PW) + 1
        self.pt = self.plan.tensors(self.device)
        tel.gauge("expand.compiled_instances", self.A)
        tel.gauge("layout.width_lanes", self.W)
        tel.gauge("layout.packed_width_lanes", self.PW)
        tel.gauge("seen.mode", "fingerprint" if self.fp_mode else "exact")
        tel.gauge("backend.device", str(self.device))

    @staticmethod
    def _refuse_modes(model: Model) -> None:
        if model.symmetry is not None:
            raise ModeError("cfg SYMMETRY is not ported to the torch "
                            "level engine yet (ROADMAP A.5)")
        if getattr(model, "view", None) is not None:
            raise ModeError("cfg VIEW is not ported to the torch level "
                            "engine yet (ROADMAP A.5)")
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

    def _keys_of(self, rows: torch.Tensor, valid: torch.Tensor):
        """(keys [N, K], packed [N, PW], pack_ovf 0-d bool) for a block
        of UNPACKED rows (bfs._keys_of without SYMMETRY and VIEW)."""
        f = ops.keys_of_twin if self.twins else ops.keys_of
        return f(rows, valid, self.pt, self.fp_mode, self.plan.identity)

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
         gen, front_count, seen_count2, inv_any, inv_idx, inv_which]."""
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
            inv_idx.to(torch.int64), inv_which.to(torch.int64)])
        return dict(scalars=scalars, seen=rm["seen2"],
                    front_rows=front_rows, front_prov=front_prov,
                    dead=dead, assert_bad=assert_bad)

    # ---- the search ----

    def _prepare_init(self, t0, warnings):
        """Encode + dedup the init states, check invariants on the kept
        ones, log the TLC init line.  Returns (init_rows, explored_init,
        n_init, err)."""
        layout = self.layout
        rows: Dict[bytes, bool] = {}
        for st in self.init_states:
            rows[np.asarray(layout.encode(st), np.int32).tobytes()] = True
        init_rows = np.stack([np.frombuffer(kk, dtype=np.int32)
                              for kk in rows.keys()]) \
            if rows else np.zeros((0, self.W), np.int32)
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
        t0 = time.time()
        tel = obs.current()
        dev = self.device
        W, K, PW = self.W, self.K, self.PW
        warnings: List[str] = []
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
            (ovc, a_any, a_a, a_f, d_any, d_f, gen, front_count,
             seen_count2, inv_any, inv_idx, inv_which) = \
                [int(x) for x in out["scalars"].cpu().tolist()]

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

    def _mk_result(self, ok, distinct, generated, diameter, t0, warnings,
                   violation=None, truncated=False,
                   trunc_reason: Optional[str] = None) -> CheckResult:
        tel = obs.current()
        tel.high_water("device.mem_high_water_bytes",
                       obs.device_mem_high_water())
        occ = getattr(self, "_fp_occupancy", None)
        if occ is not None:
            tel.gauge("fingerprint.occupancy", occ)
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
