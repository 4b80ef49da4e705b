r"""Cross-model batching: one batched device step serves many
layout-compatible jobs (the port of jaxmc/backend/batch.py).

  compat   two models are batch-compatible when they differ only in
           LIFTABLE constant values (analyze/bounds.liftable_constants:
           ints used purely in value positions); everything that shapes
           the layout, the arm structure or the dedup key is equal.
  compile  ONE donor engine builds the layout (lane plan over the union
           of every member's sampled states; proven bounds interval-
           merged across members) and the compiled units, with the
           lifted constants as per-row emitter inputs (kernel2
           const_lanes).  Followers clone the donor
           (TorchExplorer(donor=...)): no sampling, no builds.
  dispatch every member runs the UNCHANGED host_seen loop — its own
           init states, native fingerprint store, trace bookkeeping and
           verdicts — but its chunk step routes through the shared
           BatchDispatcher, which waits until every ACTIVE member has a
           pending chunk and then runs one batched step over the
           [B*CH, PW] stacked frontier: K1, the emitter with each
           member's constants repeated over its rows (the counterpart of
           the reference's jit(vmap(_hstep_core))), K2 per member, and
           K10 batch_epilogue, which gives each member K7's result over
           its slice.
  ragged   a lane with no pending chunk (a member that finished) is
           idle: fcount 0 and SENTINEL rows.  Membership changes between
           supersteps.

Each member's host loop IS the solo engine's loop and K10's slice of a
member equals K7's result on it, so per-job counts, traces and verdicts
equal solo runs.  Each member checkpoints and resumes as a solo
host-seen run does (its own `checkpoint`, `checkpoint_every`, `resume`,
`final_checkpoint`); a member whose checkpoint cannot seed this
cohort's merged layout runs fresh (_validate_resumes).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..compile.vspec import Bounds, CompileError, ModeError
from ..engine.simulate import sample_states
from .bfs import SENTINEL, TorchExplorer, _pow2_at_least


class BatchIncompatible(Exception):
    """The cohort cannot share one program; the message names why.  The
    caller falls back to solo runs."""


@dataclass
class _MergedBounds:
    """Shim BoundsReport for the donor build: the interval-UNION of
    every member's converged proof, sound for all of them."""
    merged: Dict[str, Tuple[int, int]]
    merged_eb: Dict[str, Any] = field(default_factory=dict)
    converged: bool = True

    def lane_bounds(self) -> Dict[str, Tuple[int, int]]:
        return self.merged

    def element_bounds(self) -> Dict[str, Any]:
        # per-element trees where every member proved one, backed by the
        # lane interval for variables whose structured merge collapsed
        from ..analyze.bounds import EB
        out: Dict[str, Any] = dict(self.merged_eb)
        for v, iv in self.merged.items():
            if v not in out:
                out[v] = EB(all=iv)
        return out


class BatchDispatcher:
    """The superstep barrier: collects one pending chunk per ACTIVE
    member, runs ONE batched step, hands each member its slice.  The
    thread that completes the barrier launches (every other member is
    blocked waiting on its slice), so the members share one CUDA
    stream."""

    def __init__(self, donor: TorchExplorer, cvecs: np.ndarray, tel=None):
        self.CH = _pow2_at_least(donor.chunk, lo=64)
        self.B = len(cvecs)
        self.PW = donor.PW
        self.donor = donor
        self._cvecs = np.ascontiguousarray(cvecs, np.int32).reshape(
            self.B, -1)
        self.tel = tel
        self._cv = threading.Condition()
        self._active: set = set(range(self.B))
        self._pending: Dict[int, Tuple[np.ndarray, int]] = {}
        self._results: Dict[int, Any] = {}
        self.dispatches = 0
        self.max_width = 0
        self.widths: List[int] = []

    def reset(self) -> None:
        """Re-arm for another cohort run: all lanes active again,
        superstep state and per-run stats cleared."""
        with self._cv:
            self._active = set(range(self.B))
            self._pending.clear()
            self._results.clear()
            self.dispatches = 0
            self.max_width = 0
            self.widths = []

    # ---- member surface ------------------------------------------------
    def hstep_factory(self, slot: int):
        """The _hstep_override for member `slot`: a callable with the
        solo chunk step's signature whose device work goes through the
        shared batched step."""
        def factory(CH: int):
            if CH != self.CH:
                raise ModeError(
                    f"batch member chunk capacity {CH} != shared "
                    f"dispatcher capacity {self.CH}")

            def hstep(frontier_p, fcount):
                return self._step(slot, frontier_p, int(fcount))

            return hstep

        return factory

    def deregister(self, slot: int) -> None:
        """Membership change between supersteps: the member is done (or
        failed); the remaining members' barrier no longer waits for
        it."""
        with self._cv:
            self._active.discard(slot)
            self._pending.pop(slot, None)
            if self._active and set(self._pending) >= self._active:
                self._fire_locked()
            self._cv.notify_all()

    # ---- the superstep -------------------------------------------------
    def _step(self, slot: int, frontier_p, fcount: int) -> Dict[str, Any]:
        with self._cv:
            self._pending[slot] = (np.asarray(frontier_p, np.int32),
                                   fcount)
            if set(self._pending) >= self._active:
                self._fire_locked()
            while slot not in self._results:
                self._cv.wait(0.5)
            res = self._results.pop(slot)
            if isinstance(res, BaseException):
                # the shared dispatch failed: every waiter gets the error,
                # each member fails its own run and deregisters, so the
                # cohort never deadlocks on a lane that cannot re-fire
                raise RuntimeError(
                    f"batched dispatch failed: "
                    f"{type(res).__name__}: {res}") from res
            return res

    def _fire_locked(self) -> None:
        """One batched step over every pending member lane (the caller
        holds the condition).  A failure is every pending slot's
        result — see _step."""
        slots = sorted(self._pending)
        width = len(slots)
        fr = np.full((self.B, self.CH, self.PW), SENTINEL, np.int32)
        fc = [0] * self.B
        for s in slots:
            bf, c = self._pending[s]
            fr[s] = bf
            fc[s] = c
        self._pending.clear()
        try:
            dev = self.donor.device
            frontier_p = torch.as_tensor(
                fr.reshape(self.B * self.CH, self.PW), device=dev)
            out = self.donor._hstep_batch(frontier_p, fc, self._cvecs)
            offs = [int(x) for x in out["offsets"].cpu().tolist()]
        except Exception as ex:  # noqa: BLE001 — a device failure lands
            # on every waiting member
            for s in slots:
                self._results[s] = ex
            self._cv.notify_all()
            return
        for s in slots:
            lo, hi = offs[s], offs[s + 1]
            self._results[s] = dict(
                scalars=out["scalars"][s], dead=out["dead"][s],
                **{k: out[k][lo:hi] for k in ("idx", "fps", "rows",
                                              "inv_ok", "explore")})
        self.dispatches += 1
        self.max_width = max(self.max_width, width)
        self.widths.append(width)
        if self.tel is not None:
            self.tel.gauge("batch.width", width)
            self.tel.counter("batch.dispatches")
        self._cv.notify_all()


@dataclass
class BatchMember:
    """One job in the cohort: its model, engine, telemetry channel and
    (after run) result or error."""
    model: Any
    engine: Optional[TorchExplorer] = None
    tel: Any = None
    result: Any = None
    error: Optional[BaseException] = None
    tag: Optional[str] = None
    warnings: List[str] = field(default_factory=list)
    resumed: bool = False  # engine restored from its checkpoint


# engine-relevant option surface every member must share (per-model
# differences ride the lifted constant lanes, nothing else)
_SHARED_FIELDS = ("include", "no_deadlock", "max_states", "seq_cap",
                  "grow_cap", "kv_cap", "no_trace", "sample", "chunk")


class BatchCheckEngine:
    """B layout-compatible SessionConfigs -> one donor engine + B-1
    follower clones -> one batched dispatch sequence -> B solo-identical
    CheckResults.  The engines run on cfgs[0].device (None: the card);
    twins=True runs the kernels' plain twins (the parity oracle)."""

    def __init__(self, cfgs: List[Any], tels: Optional[List[Any]] = None,
                 tags: Optional[List[str]] = None, log=None, tel=None,
                 twins: bool = False):
        if len(cfgs) < 1:
            raise ValueError("empty batch")
        self.cfgs = cfgs
        self.tel = tel if tel is not None else obs.current()
        self.log = log if log is not None else obs.Logger(quiet=True)
        self.members: List[BatchMember] = []
        self.dispatcher: Optional[BatchDispatcher] = None
        self.lift_names: Tuple[str, ...] = ()
        self._tels = tels or [None] * len(cfgs)
        self._tags = tags or [None] * len(cfgs)
        self.twins = twins
        self.build_wall_s = 0.0

    # ---- compat proof + build -----------------------------------------
    def build(self) -> "BatchCheckEngine":
        from ..analyze.bounds import (infer_state_bounds,
                                      liftable_constants,
                                      merge_element_bounds,
                                      merge_lane_bounds)
        from ..session import load_model
        t0 = time.time()
        c0 = self.cfgs[0]
        for c in self.cfgs[1:]:
            for f in _SHARED_FIELDS + ("device",):
                if getattr(c, f) != getattr(c0, f):
                    raise BatchIncompatible(
                        f"member option {f!r} differs "
                        f"({getattr(c, f)!r} vs {getattr(c0, f)!r})")
        models = []
        for c, jt in zip(self.cfgs, self._tels):
            with (jt or self.tel).span("load", spec=c.spec):
                models.append(load_model(c.spec, c.cfg, c.no_deadlock,
                                         c.include))
        m0 = models[0]
        lift = liftable_constants(m0)
        for m in models[1:]:
            if m.module.name != m0.module.name:
                raise BatchIncompatible(
                    f"module {m.module.name!r} != {m0.module.name!r}")
            if tuple(m.vars) != tuple(m0.vars):
                raise BatchIncompatible("state variables differ")
            if liftable_constants(m) != lift:
                raise BatchIncompatible("liftable-constant sets differ")
            if set(m.cfg.constants) != set(m0.cfg.constants):
                raise BatchIncompatible("cfg CONSTANT names differ")
            for n in m.cfg.constants:
                if n not in lift and \
                        m.defs.get(n) != m0.defs.get(n):
                    raise BatchIncompatible(
                        f"non-liftable constant {n} differs "
                        f"({m.defs.get(n)!r} vs {m0.defs.get(n)!r}) — "
                        f"it shapes the layout, so the models are not "
                        f"layout-compatible")
        self.lift_names = lift
        self.members = [BatchMember(model=m, tel=t, tag=g)
                        for m, t, g in zip(models, self._tels,
                                           self._tags)]

        # ONE layout over the union of every member's sampled states,
        # with the proven bounds interval-merged so no member's values
        # can trip another's proof
        bfs_n, walks, depth = tuple(c0.sample)
        extra: List[Dict[str, Any]] = []
        reports = []
        with self.tel.span("batch_sample", members=len(models)):
            for m in models:
                reports.append(infer_state_bounds(m))
                if m is not m0:
                    extra.extend(sample_states(m, bfs_states=bfs_n,
                                               n_walks=walks,
                                               walk_depth=depth))
        merged = merge_lane_bounds(
            [r.lane_bounds() if r is not None and r.converged else None
             for r in reports])
        merged_eb = merge_element_bounds(
            [r.element_bounds() if r is not None and r.converged
             else None for r in reports])
        m0._bounds_report = _MergedBounds(merged=merged,
                                          merged_eb=merged_eb)

        bounds = Bounds(seq_cap=c0.seq_cap, grow_cap=c0.grow_cap,
                        kv_cap=c0.kv_cap)
        with self.tel.span("engine_build", batch=len(models)):
            try:
                donor = TorchExplorer(
                    m0, log=self.log, bounds=bounds,
                    store_trace=not c0.no_trace,
                    progress_every=c0.progress_every,
                    host_seen=True, chunk=c0.chunk,
                    sample_cfg=tuple(c0.sample),
                    extra_samples=extra,
                    max_states=c0.max_states,
                    relayouts_left=0, device=c0.device,
                    twins=self.twins, lift_consts=lift,
                    checkpoint_path=c0.checkpoint,
                    checkpoint_every=c0.checkpoint_every,
                    resume_from=c0.resume,
                    final_checkpoint=c0.final_checkpoint)
            except (CompileError, ModeError) as ex:
                raise BatchIncompatible(
                    f"lifted-constant compile failed: {ex}")
        reason = donor.batch_block_reason()
        if reason is not None:
            raise BatchIncompatible(f"donor engine not batchable: "
                                    f"{reason}")
        self.members[0].engine = donor
        for mem, c in zip(self.members[1:], self.cfgs[1:]):
            mem.engine = TorchExplorer(
                mem.model, donor=donor, log=self.log,
                max_states=c0.max_states,
                store_trace=not c0.no_trace,
                progress_every=c0.progress_every,
                checkpoint_path=c.checkpoint,
                checkpoint_every=c.checkpoint_every,
                resume_from=c.resume,
                final_checkpoint=c.final_checkpoint)
        self._validate_resumes()
        cvecs = np.stack([mem.engine._cvec for mem in self.members]) \
            if lift else np.zeros((len(self.members), 0), np.int32)
        self.dispatcher = BatchDispatcher(donor, cvecs, tel=self.tel)
        # the donor build above is the cohort's only engine build
        self.engine_builds = 1
        self.build_wall_s = time.time() - t0
        self.tel.gauge("batch.members", len(self.members))
        self.tel.gauge("batch.lifted_consts", list(lift))
        self.tel.gauge("batch.plan", donor.plan.batch_descriptor())
        return self

    def _validate_resumes(self) -> None:
        """The cohort's resume guard (reference batch.py:368-395): a
        member whose checkpoint cannot seed THIS cohort's merged layout
        (a solo checkpoint, another cohort's packing, a damaged file)
        runs fresh instead of failing, with one log line and the
        batch.resume_refused counter."""
        from ..engine.ckpt import CkptError, load_checkpoint
        for mem in self.members:
            eng = mem.engine
            path = getattr(eng, "resume_from", None)
            if not path:
                continue
            why = None
            try:
                _, ck = load_checkpoint(path, kind="device")
                if ck.get("module") != mem.model.module.name or \
                        ck.get("vars") != list(mem.model.vars):
                    why = "checkpoint is for a different model"
                elif ck.get("mode") != "host_seen":
                    why = (f"checkpoint was written by the "
                           f"{ck.get('mode')!r} device mode")
                elif ck.get("layout_sig") != eng._layout_sig():
                    why = ("lane layout differs from the checkpoint's "
                           "(solo or different-cohort checkpoint)")
            except (CkptError, OSError, ValueError) as ex:
                why = str(ex)
            if why is None:
                mem.resumed = True
                continue
            eng.resume_from = None
            self.tel.counter("batch.resume_refused")
            self.log(f"batch member {mem.tag or '?'}: refusing "
                     f"checkpoint {path} ({why}); running fresh")

    # ---- run -----------------------------------------------------------
    def run(self) -> List[BatchMember]:
        """Drive every member's UNCHANGED host_seen loop, one thread per
        member, device work through the shared dispatcher.  Returns the
        members with .result (or .error) filled."""
        assert self.dispatcher is not None, "build() first"
        disp = self.dispatcher
        disp.reset()
        for mem in self.members:
            mem.result = mem.error = None
        # serial init prep: small, and it keeps the member threads'
        # device work inside the dispatcher
        for mem in self.members:
            with obs.use_local(mem.tel) if mem.tel is not None \
                    else contextlib.nullcontext():
                mem.engine._prepare_init(time.time(), [])

        def drive(slot: int, mem: BatchMember) -> None:
            eng = mem.engine
            eng._hstep_override = disp.hstep_factory(slot)
            try:
                if mem.tel is not None:
                    with obs.use_local(mem.tel), \
                            mem.tel.span("search", batch_slot=slot):
                        mem.result = eng.run()
                else:
                    mem.result = eng.run()
            except BaseException as ex:  # noqa: BLE001 — the member's
                # failure is ITS verdict; the cohort keeps running
                mem.error = ex
            finally:
                disp.deregister(slot)

        threads = [threading.Thread(
            target=drive, args=(i, mem),
            name=f"jaxmc-torch-batch-m{i}", daemon=True)
            for i, mem in enumerate(self.members)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.tel.gauge("batch.occupancy", disp.max_width)
        self.tel.gauge("batch.dispatch_count", disp.dispatches)
        return self.members
