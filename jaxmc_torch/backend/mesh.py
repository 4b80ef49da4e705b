r"""The sharded mesh engine on the card: MeshExplorer.

The port of jaxmc/backend/mesh.py.  The reference shards its search over
the devices of a jax Mesh with shard_map; here the D shards are D slices
of tensors on the engine's one device (the card unless the caller asks
for the CPU), and the collectives become local operations:

  all_to_all   K13 mesh_route writes every candidate straight into its
               owner's receive block (a2a exchange)
  all_gather   a view of the stacked candidate block; K13 (gather mode)
               masks each shard's keys to the rows it owns
  psum / pmax  K14 mesh_scalars reduces the shards' partials into the
  / pmin       reference's replicated scalar vector, the localization
               vectors and the partials themselves: the one vector the
               host reads per level

Each shard owns the fingerprints whose key lane 1 is its index mod D
(_owner_from_keys on the host, K13 on the device: one formula), and
keeps them in a sorted seen shard.  A level, per shard in turn:

  1. unpack and expand the frontier shard     K1, the emitter
  2. its verdict partials                     K8 (site mesh_block)
  3. keys and packed rows                     K2
  4. with --por: every shard probes all D*C   K3 (POR site), K6
     keys against its pre-level seen shard,
     the verdicts summed, then the ample mask
  5. the exchange (all shards at once)        K13
  6. the rank merge: compact the valid        K8 (mesh_vc), K18, K3,
     exchanged rows to VC, sort, probe, merge K4
     (JAXMC_MESH_RANKMERGE=0: the full sort   K18, K11)
  7. the CONSTRAINTs, the explore compaction  K8 (mesh_front)
  8. the invariants over the new frontier
  9. the replicated scalar vector             K14

then the host reads K14's vector and commits the level or rolls it back
(a capacity overflow grows SC, FC, the trace ring TRL, gamma or VC and
redoes the level).  One level per dispatch: `mesh.host_syncs` counts
levels, as the reference's JAXMC_MESH_SUPERSTEP=1 does.  Traces,
named violations, deadlock and assert slots, checkpoints, resume,
drain and the cold seen tiers follow the reference.  Refinement and
temporal PROPERTYs run the host loop (_run_hostloop), as
JAXMC_MESH_RESIDENT=0 forces.

backend/multihost.py runs the same level with one shard per process
over torch.distributed (the _Dist exchange below).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults, obs
from ..compile.kernel2 import OV_DEMOTED, OV_PACK
from ..compile.vspec import CompileError, ModeError
from ..engine.explore import CheckResult, Violation
from ..kernels import ops
from ..sem.modules import Model
from .bfs import SENTINEL, TorchExplorer, _LiveGraph, _pow2_at_least, _site

_BIG = 2**31 - 1
_SENT = int(SENTINEL)

# the replicated scalar vector (mesh.py:121-142); K14 writes it in this
# layout (ops.MESH_REDUCE), then the localization vectors, then the
# shards' partials
_S_GEN = 0        # generated this level
_S_NEW = 1        # kept new (post-constraint) this level
_S_FRONT = 2      # next-frontier occupancy
_S_MAXF = 3       # max per-shard next-frontier occupancy
_S_MAXS = 4       # max per-shard seen occupancy
_S_SUMS = 5       # seen occupancy
_S_OVC = 6        # max kernel overflow code (OV_*; 0 = none)
_S_DEAD = 7       # shards holding a deadlocked row
_S_ASSERT = 8     # shards holding a failed Assert
_S_INVMIN = 9     # first violated invariant index (_BIG = none)
_S_FOVF = 10      # frontier outgrew FC (redo after growth)
_S_SOVF = 11      # a seen shard outgrew SC (redo after growth)
_S_TOVF = 12      # trace ring outgrew TRL (redo after growth)
_S_AOVF = 13      # a2a bucket AND spill overflowed (redo, gamma grows)
_S_SPILL = 14     # rows through the spill buckets
_S_MAXDEST = 15   # max per-destination bucket occupancy (a2a)
_S_VOVF = 16      # the valid-candidate block outgrew VC (redo)
_S_MAXV = 17      # max per-shard valid-candidate need (grows VC)
_S_PORA = 18      # POR singleton-ample states this level
_S_PORX = 19      # POR expanded states this level
_S_PORM = 20      # POR-masked candidate rows this level
_NS = 21
# the per-shard localization vector (mesh.py:145-152)
_A_INVW = 0
_A_INVSLOT = 1
_A_DEAD = 2
_A_DEADSLOT = 3
_A_ASSERT = 4
_A_ASRTA = 5
_A_ASRTF = 6
_NA = 7
_NP = len(ops.MESH_PARTIALS)
_P = {name: i for i, name in enumerate(ops.MESH_PARTIALS)}
assert len(ops.MESH_REDUCE) == _NS and len(ops.MESH_AUX) == _NA

_OVC_DEMOTED_MSG = ("a demoted compile-recovery fired (the kernel "
                    "under-approximates here): run the host_seen mode, "
                    "which demotes the arm to the interpreter and "
                    "restarts — raising caps cannot help")


def split_vector(vals: List[int], D: int):
    """K14's vector as (scal [NS], aux [D, NA], part [D, NP]) numpy."""
    v = np.asarray(vals, np.int64)
    scal = v[:_NS]
    aux = v[_NS:_NS + D * _NA].reshape(D, _NA)
    part = v[_NS + D * _NA:].reshape(D, _NP)
    return scal, aux, part


class _Local:
    """The exchange of D shards held on one device by one process: an
    all_to_all is K13's receive layout, an all_gather a view, and every
    shard's partials are already here."""

    def __init__(self, eng: "MeshExplorer"):
        self.eng = eng
        self.n = eng.D

    def route_a2a(self, ckeys, cand, cvalid, B: int, SB: int):
        e = self.eng
        f = ops.mesh_route_twin if e.twins else ops.mesh_route
        return f(ckeys, cand, cvalid, e.D, B, SB, e._skew)

    def route_gather(self, ckeys, cand):
        e = self.eng
        D, C, K = ckeys.shape
        f = ops.mesh_route_gather_twin if e.twins else ops.mesh_route_gather
        gk, evalid = f(ckeys.reshape(D * C, K), e.D, 0, D, e._skew)
        return gk, cand.reshape(D * C, -1), evalid

    def gather_partials(self, part):
        return part


class MeshExplorer(TorchExplorer):
    """BFS with the frontier and the seen set sharded over D owner-routed
    shards.  Shares TorchExplorer's compile pipeline (layout, emitter,
    keys, predicates); dedup is always on 128-bit fingerprints.  One
    level per dispatch: JAXMC_MESH_SUPERSTEP, the reference's levels per
    dispatch, changes nothing here."""

    def __init__(self, model: Model, shards: Optional[int] = None,
                 log: Callable[[str], None] = None,
                 max_states: Optional[int] = None,
                 progress_every: float = 30.0, store_trace: bool = True,
                 exchange: Optional[str] = None,
                 mesh_caps: Optional[Dict[str, int]] = None, **kw):
        super().__init__(model, log=log, max_states=max_states,
                         progress_every=progress_every,
                         store_trace=store_trace, **kw)
        # the caller's shard count, else every visible CUDA card (the
        # reference's jax.devices()), or 1 on the CPU
        if shards is None:
            shards = torch.cuda.device_count() \
                if self.device.type == "cuda" else 1
        self.D = int(shards)
        if self.D < 1:
            raise ValueError(f"shards must be >= 1, got {self.D}")
        # seen shards store fingerprint keys, so --seen exact cannot be
        # honoured: refuse it rather than fingerprint past the request
        if self.seen_mode_req == "exact":
            raise ModeError(
                "--seen exact is incompatible with the mesh engine "
                "(seen shards store 128-bit fingerprints) — use the "
                "single-device level mode or --backend interp")
        self.fp_mode = True
        self.K = 4 + 1
        # a2a is the default when there is more than one shard;
        # JAXMC_MESH_EXCHANGE overrides, an explicit argument outranks both
        self._exchange_src = "explicit"
        if exchange is None:
            env = os.environ.get("JAXMC_MESH_EXCHANGE", "").strip()
            if env:
                exchange, self._exchange_src = env, "JAXMC_MESH_EXCHANGE"
            else:
                exchange = "a2a" if self.D > 1 else "gather"
                self._exchange_src = "default"
        if exchange not in ("gather", "a2a"):
            raise ValueError(f"exchange must be 'gather' or 'a2a', "
                             f"got {exchange!r}")
        self.exchange = exchange
        # the shard-local merge: "rank" (default) or the full sort
        # (JAXMC_MESH_RANKMERGE=0); the same counts and traces
        self.merge = "fullsort" \
            if os.environ.get("JAXMC_MESH_RANKMERGE", "").strip() == "0" \
            else "rank"
        self._a2a_gamma = 2.0
        # the caller's starting capacities (SC, FC, TRL, GAM16 = gamma *
        # 16, VC), max-merged with the run's own; the port keeps no
        # capacity profiles
        self._mesh_caps_hint: Dict[str, int] = dict(mesh_caps or {})
        if self._mesh_caps_hint.get("GAM16"):
            self._a2a_gamma = max(self._a2a_gamma,
                                  self._mesh_caps_hint["GAM16"] / 16.0)
        # the skewed-hash fault: every state hashes to shard 0, on the
        # host init path and in K13 alike, which forces the spill
        # buckets and, once they overflow, the gamma rerun
        self._skew = faults.fire("mesh_skew", devices=self.D) is not None
        self._spill_rows = 0
        self._max_bucket = 0
        self._shard_balance: Optional[float] = None
        self._supersteps = 0
        # the capacities the last resident run ended at (SC, FC, VC):
        # probe_phase_walls times its phases at them; a run starts from
        # the caller's mesh_caps regardless
        self._run_caps: Dict[str, Optional[int]] = {}
        self._lvl_FC: List[int] = []
        self._levels: List[Tuple[np.ndarray, Optional[np.ndarray], int]] = []
        self._local = _Local(self)

    # ---- hierarchical seen set: per-shard tiering ----

    def _mesh_shard_cap(self) -> Optional[int]:
        """Per-shard device seen cap: the engine's (total) cap divided
        across the D owner-routed shards."""
        if self.seen_cap is None:
            return None
        return _pow2_at_least(max(self.seen_cap // self.D, 64), lo=64)

    def _empty_seen(self, SC: int) -> torch.Tensor:
        t = torch.full((SC, self.K), _SENT, dtype=torch.int32,
                       device=self.device)
        t[:, 0] = 1
        return t

    def _mesh_tier_spill(self, seen, scounts, SC: int):
        """Spill every shard's sorted valid prefix into the cold tiers as
        one run each (owner-routed keys partition the key space, so one
        store answers for every shard) and restart the shards empty.
        Returns the reset (seen, scounts)."""
        tel = obs.current()
        total = int(sum(scounts))
        with tel.span("tier.spill", keys=total, shards=self.D):
            t = self._ensure_tiers()
            for d in range(self.D):
                cnt = int(scounts[d])
                if cnt:
                    t.spill(np.ascontiguousarray(
                        seen[d][:cnt, 1:].cpu().numpy()))
            tel.counter("tier.spilled_keys", total)
        return [self._empty_seen(SC) for _ in range(self.D)], \
            [0] * self.D

    def _mesh_tier_filter(self, frontier, fcounts, tr_rows, tr_src,
                          depth: int, FC: int):
        """Post-commit cold-tier filter of one level: drop frontier rows
        whose keys live in the host/disk runs (per shard, order kept) and
        rewrite the level's trace-ring slot with the same compaction so
        the next level's parent indices keep resolving.  Returns
        (frontier, fcounts, n_dup)."""
        keeps = []
        n_dup = 0
        for d in range(self.D):
            c = fcounts[d]
            keep = self._tier_keep_mask(frontier[d][:c].cpu().numpy()) \
                if c else None
            keeps.append(keep)
            if keep is not None:
                n_dup += int((~keep).sum())
        if n_dup == 0:
            return frontier, fcounts, 0
        if self.store_trace:
            obs.current().counter("mesh.row_syncs")
        frontier, fcounts = list(frontier), list(fcounts)
        for d in range(self.D):
            c = fcounts[d]
            if not c:
                continue
            fr = frontier[d][:c].cpu().numpy()[keeps[d]]
            k = len(fr)
            nf = np.full((FC, self.PW), SENTINEL, np.int32)
            nf[:k] = fr
            frontier[d] = torch.as_tensor(nf, device=self.device)
            if self.store_trace:
                src = tr_src[d][depth - 1][:c].cpu().numpy()[keeps[d]]
                ns = np.full(FC, -1, np.int32)
                ns[:k] = src
                tr_rows[d][depth - 1] = frontier[d]
                tr_src[d][depth - 1] = torch.as_tensor(ns,
                                                       device=self.device)
            fcounts[d] = k
        return frontier, fcounts, n_dup

    # ---- the exchange ----

    def _a2a_bucket(self, C: int, FC: int) -> int:
        # R = D*B must cover the frontier capacity FC
        return max(1, math.ceil(C * self._a2a_gamma / self.D),
                   math.ceil(FC / self.D))

    def _a2a_spill_bucket(self, B: int) -> int:
        # small on purpose: it absorbs ordinary hash skew past B
        return max(1, B // 4)

    def _owner_from_keys(self, keys: np.ndarray) -> np.ndarray:
        """THE ownership formula (key lane 1 mod D) on the host; K13 and
        ops.mesh_owner_twin are its device twins.  The mesh_skew fault
        collapses it to shard 0 on both."""
        if self._skew:
            return np.zeros(len(keys), np.int64)
        return (keys[:, 1].astype(np.uint32) % np.uint32(self.D)) \
            .astype(np.int64)

    def _route_shape(self, C: int, FC: int) -> Tuple[int, int, int]:
        """(R, B, SB): the exchanged rows per shard and the a2a buckets
        (0 in gather mode)."""
        if self.exchange != "a2a":
            return self.D * C, 0, 0
        B = self._a2a_bucket(C, FC)
        SB = self._a2a_spill_bucket(B)
        return self.D * (B + SB), B, SB

    def _exchange_bytes(self, C: int, B: int, SB: int) -> int:
        """Whole-mesh bytes one level's exchange moves (from the static
        shapes): a2a moves D*(B+SB) payload rows of K+PW+1 words per
        shard; gather replicates C candidate and key rows to every
        shard."""
        D, K, PW = self.D, self.K, self.PW
        if self.exchange == "a2a":
            return D * D * (B + SB) * (K + PW + 1) * 4
        return D * D * C * (K + PW) * 4

    def _initial_vc(self, FC: int) -> Optional[int]:
        """The rank merge's starting valid-candidate capacity: the
        caller's VC hint, else 4*FC (at least 256), never below FC.
        JAXMC_MESH_VC pins it (growth still applies); JAXMC_MESH_VC=off
        disables the compaction."""
        env = os.environ.get("JAXMC_MESH_VC", "").strip().lower()
        if env == "off":
            return None
        if env:
            try:
                return max(FC, _pow2_at_least(int(env), lo=64))
            except ValueError:
                pass
        hint = int(self._mesh_caps_hint.get("VC", 0))
        if hint:
            return max(FC, _pow2_at_least(hint, lo=256))
        return max(FC, _pow2_at_least(4 * FC, lo=256))

    # ---- one level, every shard ----

    def _block(self, frontier_p: torch.Tensor, fcount: int) -> dict:
        """One shard's candidate block (bfs._candidate_block_fn): expand
        the frontier, K8's verdict partials over the enabled grid, keys
        and packed rows of the valid candidates."""
        FC = frontier_p.shape[0]
        A, W = self.A, self.W
        C = A * FC
        dev = frontier_p.device
        en, aok, ov, succ = self._expand(self._unpack(frontier_p))
        _, vp = self._compact(en, 0, fcount, aok, ov, site="mesh_block")
        fvalid = torch.arange(FC, device=dev) < fcount
        cvalid = (en & fvalid[None, :]).reshape(C)
        cand_u = torch.where(cvalid[:, None], succ.reshape(C, W), _SENT)
        del succ
        ckeys, cand, pack_ovf = self._keys_of(cand_u, cvalid)
        # kernel overflow codes outrank the pack guard
        ovc = torch.where(vp[1] != 0, vp[1],
                          torch.where(pack_ovf, OV_PACK, 0))
        z = torch.zeros((), dtype=torch.int64, device=dev)
        dead = vp[4] if self.model.check_deadlock else z
        return dict(ckeys=ckeys, cand=cand, cvalid=cvalid, gen=vp[0],
                    ovc=ovc, dead=dead, dead_slot=vp[5], assert_=vp[2],
                    asrt_a=torch.div(vp[3], FC, rounding_mode="floor"),
                    asrt_f=vp[3] % FC)

    def _mesh_por(self, seen, scounts, ckeys, cand, cvalid, FC: int):
        """Mesh POR before the exchange, against the pre-level seen
        shards: every shard probes all D*C candidate keys (K3's POR
        site), the found flags are summed over the shards (each key lives
        in one owner shard), then each shard's ample mask (K6); masked
        rows become the invalid key and never enter the exchange.
        Returns (ckeys, cand, cvalid, [(pora, porx, porm)] per shard)."""
        D, C, K = ckeys.shape
        plan = self._por_memo
        allk = ckeys.reshape(D * C, K)
        found = torch.zeros(D * C, dtype=torch.int32, device=ckeys.device)
        for d in range(D):
            if self.twins:
                fl, _ = ops.seen_probe_twin(seen[d], scounts[d], allk)
            else:
                fl, _ = ops.seen_probe(seen[d], scounts[d], allk, site="por")
            found += fl.to(torch.int32)
        found = (found > 0).reshape(D, C)
        mask_f = ops.por_mask_twin if self.twins else ops.por_mask
        inv_key = ops._invalid_key(K, ckeys.device)
        por = []
        for d in range(D):
            keep, n_amp, n_exp, n_masked = mask_f(
                found[d], cvalid[d], plan["inst_arm_t"], plan["arm_safe_t"],
                self.A, FC)
            ckeys[d] = torch.where(keep[:, None], ckeys[d], inv_key)
            cand[d] = torch.where(keep[:, None], cand[d], _SENT)
            cvalid[d] = keep
            por.append((n_amp, n_exp, n_masked))
        return ckeys, cand, cvalid, por

    def _finish(self, new_rows, new_src, nvalid, N: int) -> dict:
        """The merge epilogue (mesh._merge_finish_fn): the CONSTRAINTs
        over the new rows (violators stay fingerprinted but are not
        counted, checked or explored), then K8's stable compaction of
        the explored rows to the front (site mesh_front)."""
        need_u = bool(self.constraint_fns or self.inv_fns)
        new_u = self._unpack(new_rows) if need_u else None
        explore = nvalid
        for _nm, f in self.constraint_fns:
            explore = explore & f(new_u)
        idx, fp = self._compact(explore, N, site="mesh_front")
        front_count = fp[0]
        fv = torch.arange(N, device=new_rows.device) < front_count
        ik = idx.to(torch.int64)
        front_rows = torch.where(fv[:, None], new_rows[ik], _SENT)
        front_u = torch.where(fv[:, None], new_u[ik], _SENT) \
            if need_u else None
        front_src = torch.where(fv, new_src[ik], 0)
        return dict(front_rows=front_rows, front_u=front_u,
                    front_src=front_src, front_count=front_count)

    def _merge(self, seen_d, scount: int, gkeys, gcand, gsrc, SC: int,
               R: int, VC: Optional[int], merge: Optional[str] = None
               ) -> dict:
        """One shard's merge-dedup (mesh._merge_fn).  "rank": compact the
        valid exchanged rows to VC (K8 site mesh_vc, stable, so the
        candidate order holds), sort them, probe and rank-merge (K3, K4).
        "fullsort": one stable sort of the masked seen shard and the
        exchanged keys, then K11.  seen_count2 is the true need before
        any crop to SC, so growth is strategy-blind.  `merge` overrides
        the engine's strategy (the phase probe times both)."""
        dev = gkeys.device
        K = self.K
        inv_key = ops._invalid_key(K, dev)
        z = torch.zeros((), dtype=torch.int64, device=dev)
        if (merge or self.merge) == "fullsort":
            seen_m = seen_d.clone()
            seen_m[scount:] = inv_key
            allk = torch.cat([seen_m, gkeys])
            skeys, perm = self._sort_keys(allk)
            sflag = (perm >= SC).to(torch.int32)
            f = ops.fullsort_dedup_twin if self.twins else ops.fullsort_dedup
            new_cidx, seen2, counts = f(skeys, sflag, perm, SC, R)
            new_count, seen_count2 = counts[0], counts[1]
            seen2 = torch.where((torch.arange(SC, device=dev)
                                 < seen_count2)[:, None], seen2, inv_key)
            N, sidx, v_need = R, new_cidx, z
        else:
            N, v_need = R, z
            if VC is not None and VC < R:
                idx, vp = self._compact(gkeys[:, 0] == 0, VC,
                                        site="mesh_vc")
                v_need = vp[0]
                vm = torch.arange(VC, device=dev) < v_need
                ik = idx.to(torch.int64)
                gkeys = torch.where(vm[:, None], gkeys[ik], inv_key)
                gcand = torch.where(vm[:, None], gcand[ik], _SENT)
                gsrc = torch.where(vm, gsrc[ik], 0)
                N = VC
            rm = self._rank_merge(seen_d, scount, gkeys)
            new_count, seen2 = rm["new_count"], rm["seen2"]
            seen_count2, sidx = rm["seen_count2"], rm["nk_sidx"]
        nvalid = torch.arange(N, device=dev) < new_count
        safe = sidx.clamp(0, N - 1).to(torch.int64)
        new_rows = torch.where(nvalid[:, None], gcand[safe], _SENT)
        out = self._finish(new_rows, gsrc[safe], nvalid, N)
        out.update(seen2=seen2, seen_count2=seen_count2, v_need=v_need, N=N)
        return out

    def _inv_scan(self, front_u, front_count, N: int):
        """Named invariants: the FIRST cfg invariant any kept row
        violates, and its first violating slot."""
        dev = front_count.device
        frontvalid = torch.arange(N, device=dev) < front_count
        which = torch.full((), _BIG, dtype=torch.int64, device=dev)
        slot = torch.full((), -1, dtype=torch.int64, device=dev)
        for i, (_nm, f) in enumerate(self.inv_fns):
            bad = frontvalid & ~f(front_u)
            hit = bad.any() & (which == _BIG)
            which = torch.where(hit, i, which)
            slot = torch.where(hit, torch.argmax(bad.to(torch.int32)), slot)
        return which, slot

    def _expand_shards(self, frontier, fcounts, n: int, C: int):
        """The level's expansion: _block (K1, K15, K8 mesh_block, K2) on
        each of the n shards, stacked for the exchange.  Returns ckeys
        [n, C, K], cand [n, C, PW], cvalid [n, C] and each shard's
        remaining block dict."""
        dev = self.device
        ckeys = torch.empty((n, C, self.K), dtype=torch.int32, device=dev)
        cand = torch.empty((n, C, self.PW), dtype=torch.int32, device=dev)
        cvalid = torch.empty((n, C), dtype=torch.bool, device=dev)
        rows = []
        for m in range(n):
            b = self._block(frontier[m], fcounts[m])
            ckeys[m], cand[m], cvalid[m] = (b.pop("ckeys"), b.pop("cand"),
                                            b.pop("cvalid"))
            rows.append(b)
        return ckeys, cand, cvalid, rows

    def _exchange(self, xchg, ckeys, cand, cvalid, R: int, B: int, SB: int):
        """The level's owner-routed exchange over xchg (K13 for a2a, the
        all-gather otherwise).  Returns per-shard received keys, rows
        and sources, the gather's edge validity (None for a2a) and the
        [n, 3] route stats."""
        n, dev = xchg.n, self.device
        if self.exchange == "a2a":
            obs.note_buffer("mesh.a2a_buckets",
                            2 * self.D * R * (self.K + self.PW + 1) * 4)
            gk, gc, gs, stats = xchg.route_a2a(ckeys, cand, cvalid, B, SB)
            return gk, gc, gs, None, stats
        gk, gcand, evalid = xchg.route_gather(ckeys, cand)
        return (gk, [gcand] * n,
                [torch.arange(R, dtype=torch.int32, device=dev)] * n, evalid,
                torch.zeros((n, 3), dtype=torch.int32, device=dev))

    def _level_core(self, xchg, seen, scounts, frontier, fcounts, SC: int,
                    FC: int, VC: Optional[int], por: bool,
                    need_edges: bool) -> dict:
        """Everything a level computes before the verdict, for the
        xchg.n shards this process holds: expansion, POR, the exchange,
        the per-shard merges and invariant scans, and the partials of
        every shard (xchg.gather_partials).  Returns dict(part [D, NP]
        int32, shards [per-shard merge dicts], R, B, SB, edges)."""
        n = xchg.n
        C = self.A * FC
        R, B, SB = self._route_shape(C, FC)
        z = torch.zeros((), dtype=torch.int64, device=self.device)
        ckeys, cand, cvalid, rows = self._expand_shards(frontier, fcounts, n,
                                                        C)
        por_c = [(z, z, z)] * n
        if por:
            ckeys, cand, cvalid, por_c = self._mesh_por(seen, scounts, ckeys,
                                                        cand, cvalid, FC)
        gk, gc, gs, evalid, stats = self._exchange(xchg, ckeys, cand, cvalid,
                                                   R, B, SB)
        del ckeys, cvalid
        shards = []
        parts = []
        for m in range(n):
            mg = self._merge(seen[m], scounts[m], gk[m], gc[m], gs[m], SC, R,
                             VC)
            N = mg["N"]
            which, slot = self._inv_scan(mg.pop("front_u"), mg["front_count"],
                                         N)
            b = rows[m]
            pora, porx, porm = por_c[m]
            # v_need is 0 where no compaction ran
            v_ovf = (mg["v_need"] > VC) if VC is not None else z
            vals = (b["gen"] - porm, mg["front_count"], mg["seen_count2"],
                    stats[m, 0], stats[m, 2], mg["v_need"], b["ovc"],
                    b["dead"], b["dead_slot"], b["assert_"], b["asrt_a"],
                    b["asrt_f"], which, slot, pora, porx, porm, stats[m, 1],
                    v_ovf)
            parts.append(torch.stack([torch.as_tensor(v).to(torch.int64)
                                      for v in vals]))
            shards.append(mg)
        part = xchg.gather_partials(
            ops._i32(torch.stack(parts)).contiguous())
        edges = None
        if need_edges:
            edges = self._edge_stream(gk, gc, gs, evalid, n)
        return dict(part=part, shards=shards, R=R, B=B, SB=SB, edges=edges)

    def _edge_stream(self, gk, gc, gs, evalid, n: int):
        """Every exchanged candidate (revisits included), its explore mask
        and its global source index — the host's edge stream.  gather:
        one shared block (the reference's device-0 read, validity before
        the ownership mask); a2a: every shard's disjoint buckets."""

        def explore(valid, cand):
            u = self._unpack(cand)
            for _nm, f in self.constraint_fns:
                valid = valid & f(u)
            return valid

        if evalid is not None:
            return (gc[0].cpu().numpy(),
                    explore(evalid, gc[0]).cpu().numpy(),
                    gs[0].cpu().numpy())
        return (torch.cat([gc[m] for m in range(n)]).cpu().numpy(),
                torch.cat([explore(gk[m][:, 0] == 0, gc[m])
                           for m in range(n)]).cpu().numpy(),
                torch.cat([gs[m] for m in range(n)]).cpu().numpy())

    def _scalars(self, part, FC: int, SC: int, t_ovf: int):
        f = ops.mesh_scalars_twin if self.twins else ops.mesh_scalars
        return f(part, FC, SC, t_ovf)

    @_site("mesh.superstep")
    def _mesh_level(self, seen, scounts, frontier, fcounts, SC: int,
                    FC: int, TRL: int, VC: Optional[int], depth: int):
        """One resident level of every shard; returns (K14's vector on
        the device, the per-shard merge outputs, B, SB)."""
        core = self._level_core(self._local, seen, scounts, frontier,
                                fcounts, SC, FC, VC,
                                por=isinstance(self._por_memo, dict),
                                need_edges=False)
        t_ovf = int(self.store_trace and depth >= TRL)
        vec = self._scalars(core["part"], FC, SC, t_ovf)
        return vec, core["shards"], core["B"], core["SB"]

    @_site("mesh.level_step")
    def _mesh_step(self, xchg, seen, scounts, frontier, fcounts, SC: int,
                   FC: int, out_cap: Optional[int] = None,
                   need_edges: bool = False):
        """The legacy exchange step (mesh._get_mesh_step): no POR and no
        VC compaction.  out_cap=None drives the host loop (PROPERTYs);
        out_cap set is the multi-process variant, whose frontier stays a
        fixed [out_cap] shard and whose S_FOVF is measured against it.
        Returns (K14's vector, the per-shard outputs, R, B, SB, edges)."""
        core = self._level_core(xchg, seen, scounts, frontier, fcounts, SC,
                                FC, None, por=False, need_edges=need_edges)
        cap = out_cap if out_cap is not None else core["R"]
        vec = self._scalars(core["part"], cap, SC, 0)
        return (vec, core["shards"], core["R"], core["B"], core["SB"],
                core["edges"])

    # ---- host-side shard construction and traces ----

    def _init_shards(self, init_rows: np.ndarray, explored_idx, D: int,
                     SC: int, FC: int, keys=None, packed=None, owner=None):
        """Per-owner frontier fill and lexsorted seen keys with the
        validity-lane-1 empty-slot convention, shared by the run loops
        and the multi-process runner.  Returns numpy (seen [D, SC, K],
        frontier [D, FC, PW], fcount [D], seen_counts [D])."""
        K = self.K
        if keys is None:
            keys, packed, povf = self._host_keys(init_rows)
            if povf:
                raise CompileError(self._pack_ovf_msg())
            owner = self._owner_from_keys(keys)
        exp = np.zeros(len(init_rows), bool)
        exp[np.asarray(explored_idx, int)] = True
        frontier = np.full((D, FC, self.PW), SENTINEL, np.int32)
        seen = np.full((D, SC, K), SENTINEL, np.int32)
        seen[:, :, 0] = 1
        fcount = np.zeros((D,), np.int32)
        seen_counts = np.zeros((D,), np.int32)
        for d in range(D):
            p = packed[(owner == d) & exp]
            frontier[d, :len(p)] = p
            k = keys[owner == d]
            if len(k):
                order = np.lexsort(tuple(k[:, i]
                                         for i in reversed(range(K))))
                seen[d, :len(k)] = k[order]
            fcount[d] = len(p)
            seen_counts[d] = len(k)
        return seen, frontier, fcount, seen_counts

    # self._levels[L] = (rows [D, cap_L, PW], src [D, cap_L] | None, FC_L).
    # Level 0 is the initial frontier.  For L >= 1, slot i of shard d
    # holds global candidate index g = src[d][i]; with C_L = A * FC_L:
    # source shard g // C_L, action (g % C_L) // FC_L, parent slot
    # (g % C_L) % FC_L.

    def _mesh_trace_to(self, dev: int, slot: int, depth: int,
                       extra: Optional[Tuple[Dict, str]] = None):
        if not self.store_trace:
            return None
        out = []
        d, i = dev, slot
        for lvl in range(depth, -1, -1):
            rows, src, FC = self._levels[lvl]
            st = self.layout.decode_packed(np.asarray(rows[d][i]))
            if lvl == 0:
                out.append((st, "Initial predicate"))
            else:
                g = int(src[d][i])
                C = self.A * FC
                out.append((st, self.labels_flat[(g % C) // FC]))
                d, i = g // C, (g % C) % FC
        out.reverse()
        if extra is not None:
            out.append(extra)
        return out

    def _mesh_refine_edges(self, frontier_np, ecand, eexp, esrc, FC: int,
                           depth: int):
        """Stepwise refinement over this level's explored candidate
        edges, parents resolved through the global source index."""
        C = self.A * FC
        idxs = np.nonzero(eexp)[0]
        if not len(idxs):
            return None
        parents: Dict[Tuple[int, int], dict] = {}
        if len(self._ref_pair_cache) > (1 << 20):
            self._ref_pair_cache.clear()
        for c in idxs:
            g = int(esrc[c])
            d_src, cc = g // C, g % C
            a, f = cc // FC, cc % FC
            key = (frontier_np[d_src, f].tobytes(), ecand[c].tobytes())
            if key in self._ref_pair_cache:
                continue
            self._ref_pair_cache.add(key)
            pst = parents.get((d_src, f))
            if pst is None:
                pst = self.layout.decode_packed(frontier_np[d_src, f])
                parents[(d_src, f)] = pst
            sst = self.layout.decode_packed(ecand[c])
            for rc in self.refiners:
                if not rc.check_edge(pst, sst):
                    trace = self._mesh_trace_to(
                        d_src, f, depth, extra=(sst, self.labels_flat[a]))
                    return self._viol("property", rc.name, trace,
                                      self._refine_msg(rc))
        return None

    def _viol(self, kind, name, trace, msg=None):
        if trace is None:
            note = (f"{kind} found (mesh traces disabled by "
                    f"store_trace=False)")
            return Violation(kind, name, [], msg or note)
        return Violation(kind, name, trace, msg)

    def _ovc_violation(self, ovc: int) -> Violation:
        if ovc == OV_DEMOTED:
            msg = _OVC_DEMOTED_MSG
        elif ovc == OV_PACK:
            msg = self._pack_ovf_msg()
        else:
            msg = ("a container exceeded its lane capacity "
                   f"({self._caps_note()}); counts would no longer be "
                   "exact")
        return Violation("error", "capacity overflow", [], msg)

    # ---- checkpoint/resume (level boundaries) ----

    def _mesh_ck(self, seen, scounts, frontier, fcounts, FC, SC, depth,
                 generated, distinct):
        self._write_ck(
            "mesh", D=self.D, FC=FC, SC=SC, depth=depth,
            generated=generated, distinct=distinct,
            seen=np.stack([s.cpu().numpy() for s in seen]),
            seen_counts=np.asarray(scounts, np.int32),
            frontier=np.stack([f.cpu().numpy() for f in frontier]),
            fcount=np.asarray(fcounts, np.int32),
            levels=self._levels if self.store_trace else None)

    def _shards_on_device(self, arr: np.ndarray) -> List[torch.Tensor]:
        return [torch.as_tensor(np.ascontiguousarray(arr[d]),
                                device=self.device)
                for d in range(arr.shape[0])]

    def run(self) -> CheckResult:
        # the edge stream feeds refiners and non-[]P liveness; []P-only
        # obligations still need the behavior graph's states
        need_edges = bool(self.refiners) or self.collect_edges
        need_props = bool(self.refiners) or bool(self.live_obligations)
        self._spill_rows = 0
        self._max_bucket = 0
        self._shard_balance = None
        self._supersteps = 0
        resident = not (need_props or need_edges or
                        os.environ.get("JAXMC_MESH_RESIDENT", "1") == "0")
        self.log(f"-- mesh: {self.D} shard(s) on {self.device}, exchange="
                 f"{self.exchange} ({self._exchange_src}), "
                 f"gamma={self._a2a_gamma:g}, merge={self.merge}, "
                 f"loop={'resident' if resident else 'host'}"
                 + (" [mesh_skew fault armed]" if self._skew else ""))
        tel = obs.current()
        tel.gauge("mesh.exchange", self.exchange)
        tel.gauge("mesh.devices", self.D)
        tel.gauge("dedup.mode",
                  "fp128" + ("-view" if self.view_fn is not None
                             else ("-packed" if not self.plan.identity
                                   else "")))
        tel.gauge("seen.mode", "fingerprint")
        tel.gauge("mesh.merge", self.merge)
        if resident:
            return self._run_mesh_resident()
        if self.seen_cap is not None:
            self.log("-- mesh host loop: --seen-cap/JAXMC_SEEN_CAP is "
                     "ignored here (tier spill runs on the resident "
                     "mesh loop; refinement/temporal PROPERTYs force "
                     "the host loop)")
        return self._run_hostloop(need_edges, need_props)

    # ------------------------------------------------------------------
    # the resident loop: one level per dispatch
    # ------------------------------------------------------------------

    def _pad(self, t: torch.Tensor, dim: int, new: int, fill: int,
             lane1: bool = False) -> torch.Tensor:
        """Grow a shard tensor along `dim` with constant fill (the
        validity-lane-1 empty-slot convention for seen shards)."""
        shape = list(t.shape)
        shape[dim] = new - shape[dim]
        pad = torch.full(shape, fill, dtype=t.dtype, device=t.device)
        if lane1:
            pad[..., 0] = 1
        return torch.cat([t, pad], dim=dim)

    def _ring_levels(self, tr_rows, tr_src, upto: int) -> None:
        """Materialize self._levels[1..upto] from the device trace ring:
        the one row pull a violating or checkpointing run pays."""
        if not self.store_trace or upto <= 0:
            return
        obs.current().counter("mesh.row_syncs")
        rows_np = np.stack([t[:upto].cpu().numpy() for t in tr_rows])
        src_np = np.stack([t[:upto].cpu().numpy() for t in tr_src])
        del self._levels[1:]
        for lv in range(upto):
            # trim to the occupied prefix (src == -1 marks empty slots)
            occ = np.nonzero((src_np[:, lv] >= 0).any(axis=0))[0]
            keep = int(occ.max()) + 1 if len(occ) else 1
            self._levels.append((rows_np[:, lv, :keep].copy(),
                                 src_np[:, lv, :keep].copy(),
                                 self._lvl_FC[lv]))

    def _run_mesh_resident(self) -> CheckResult:
        t0 = time.time()
        tel = obs.current()
        model = self.model
        D, K, PW = self.D, self.K, self.PW
        dev = self.device
        warnings = ["mesh backend: dedup on 128-bit fingerprints; "
                    "collision probability < n^2 * 2^-129"]
        warnings.extend(self._temporal_warnings())
        warnings.extend(self._symmetry_warnings())
        warnings.extend(self._por_warnings())

        init_rows, explored_init, n_init, err = \
            self._prepare_init(t0, warnings)
        if err is not None:
            return err
        generated = n_init
        explored_mask = np.zeros(n_init, bool)
        explored_mask[explored_init] = True
        distinct = int(explored_mask.sum())
        self._levels = []
        self._lvl_FC = []
        hint = self._mesh_caps_hint

        if self.resume_from:
            ck = self._load_ck("mesh")
            if ck["D"] != D:
                raise ValueError(
                    f"cannot resume: checkpoint has {ck['D']} devices, "
                    f"mesh has {D}")
            FC = max(ck["FC"], _pow2_at_least(int(hint.get("FC", 1)),
                                              lo=64))
            SC = max(ck["SC"], _pow2_at_least(int(hint.get("SC", 1)),
                                              lo=256))
            depth = ck["depth"]
            generated = ck["generated"]
            distinct = ck["distinct"]
            seen_np = np.full((D, SC, K), SENTINEL, np.int32)
            seen_np[:, :, 0] = 1
            seen_np[:, :ck["SC"]] = ck["seen"]
            seen = self._shards_on_device(seen_np)
            scounts = [int(x) for x in ck["seen_counts"]]
            fr_np = np.full((D, FC, PW), SENTINEL, np.int32)
            fr_np[:, :ck["FC"]] = ck["frontier"]
            frontier = self._shards_on_device(fr_np)
            fcounts = [int(x) for x in ck["fcount"]]
            del seen_np, fr_np
            if ck.get("levels") is not None:
                self._levels = list(ck["levels"])
            elif self.store_trace:
                raise ValueError(
                    "cannot resume with traces: the checkpoint was "
                    "written with --no-trace")
            self._lvl_FC = [lv[2] for lv in self._levels[1:]]
            TRL = _pow2_at_least(
                max(depth + 1, int(hint.get("TRL", 1)), 16), lo=16)
            self.log(f"Resuming mesh run at depth {depth} "
                     f"({distinct} distinct states)")
        else:
            init_keys, init_packed, init_povf = self._host_keys(init_rows)
            if init_povf:
                raise CompileError(self._pack_ovf_msg())
            owner = self._owner_from_keys(init_keys)
            per_dev = [int(((owner == d) & explored_mask).sum())
                       for d in range(D)]
            FC = _pow2_at_least(max(max(per_dev, default=1), 1,
                                    int(hint.get("FC", 1))), lo=64)
            SC = _pow2_at_least(max(4 * FC, int(hint.get("SC", 1))),
                                lo=256)
            shard_cap = self._mesh_shard_cap()
            if shard_cap is not None:
                # bound each shard's hot tier from the start, floored so
                # every shard seats its init keys
                SC = min(SC, shard_cap)
                SC = max(SC, _pow2_at_least(
                    max(int(np.bincount(owner, minlength=D).max()), 1),
                    lo=64))
            TRL = _pow2_at_least(max(int(hint.get("TRL", 1)), 16), lo=16)
            seen_np, frontier_np, fcount_np, scount_np = self._init_shards(
                init_rows, np.nonzero(explored_mask)[0], D, SC, FC,
                keys=init_keys, packed=init_packed, owner=owner)
            if self.store_trace:
                self._levels.append((frontier_np.copy(), None, FC))
            seen = self._shards_on_device(seen_np)
            frontier = self._shards_on_device(frontier_np)
            fcounts = [int(x) for x in fcount_np]
            scounts = [int(x) for x in scount_np]
            depth = 0

        tr_rows = tr_src = None
        if self.store_trace:
            ring_np = np.full((D, TRL, FC, PW), SENTINEL, np.int32)
            src_np = np.full((D, TRL, FC), -1, np.int32)
            for lv, (rows, src, _fcl) in enumerate(self._levels[1:]):
                k = min(rows.shape[1], FC)
                ring_np[:, lv, :k] = rows[:, :k]
                src_np[:, lv, :k] = src[:, :k]
            tr_rows = self._shards_on_device(ring_np)
            tr_src = self._shards_on_device(src_np)
            del ring_np, src_np
            # the ring re-materializes the levels past 0 on demand
            del self._levels[1:]

        last_progress = last_ck = time.time()
        lvl_frontier = sum(fcounts)
        VC = self._initial_vc(FC)

        def ckpt():
            self._ring_levels(tr_rows, tr_src, depth)
            self._mesh_ck(seen, scounts, frontier, fcounts, FC, SC, depth,
                          generated, distinct)

        while lvl_frontier > 0:
            lvl_t0 = time.time()
            self._run_caps = {"SC": SC, "FC": FC, "VC": VC}
            # chaos sites: crash / device failure between dispatches
            faults.kill_self("run_kill", level=depth, engine="mesh")
            faults.inject("device_run_fail", level=depth, engine="mesh")
            if self._drain_requested(warnings, "mesh"):
                if self.checkpoint_path:
                    ckpt()
                return self._mk(True, distinct, generated, depth, t0,
                                warnings, truncated=True, drained=True)
            C = self.A * FC
            obs.note_buffer("mesh.seen_shards", D * SC * K * 4)
            obs.note_buffer("mesh.frontier", D * FC * PW * 4)
            if self.store_trace:
                obs.note_buffer("mesh.trace_ring",
                                D * TRL * FC * (PW + 1) * 4)
            vec, shards, B, SB = self._mesh_level(
                seen, scounts, frontier, fcounts, SC, FC, TRL, VC, depth)
            # THE one host read of the level
            scal, aux, part = split_vector(vec.cpu().tolist(), D)
            disp_wall = time.time() - lvl_t0
            tel.counter("mesh.host_syncs")
            tel.counter("mesh.exchange_bytes", self._exchange_bytes(C, B, SB))
            self._supersteps += 1
            lwall = round(disp_wall, 6)

            ovc = int(scal[_S_OVC])
            if ovc:
                return self._mk(False, distinct, generated, depth, t0,
                                warnings, self._ovc_violation(ovc))
            if scal[_S_FOVF] or scal[_S_SOVF] or scal[_S_TOVF] or \
                    scal[_S_AOVF] or scal[_S_VOVF]:
                # roll the level back (the pre-level tensors are kept),
                # grow every flagged capacity at once, redo the level
                del shards
                grew = []
                if scal[_S_AOVF]:
                    # straight to the observed per-peer need
                    need_g = int(scal[_S_MAXDEST]) * D / max(C, 1)
                    self._a2a_gamma = max(self._a2a_gamma * 2, need_g)
                    grew.append(f"gamma->{self._a2a_gamma:g}")
                if scal[_S_SOVF]:
                    SC2 = _pow2_at_least(int(scal[_S_MAXS]), lo=2 * SC)
                    shard_cap = self._mesh_shard_cap()
                    if shard_cap is not None and SC2 > shard_cap \
                            and sum(scounts) > 0:
                        # per-shard device tier full: spill every shard's
                        # prefix to the cold tiers and redo the level
                        # against empty shards
                        n_sp = sum(scounts)
                        seen, scounts = self._mesh_tier_spill(seen, scounts,
                                                              SC)
                        grew.append(
                            f"seen->tier-spill({n_sp} keys, "
                            f"host={self._tiers.host_keys} "
                            f"disk={self._tiers.disk_keys})")
                    else:
                        seen = [self._pad(s, 0, SC2, _SENT, lane1=True)
                                for s in seen]
                        SC = SC2
                        grew.append(f"SC->{SC}")
                if scal[_S_FOVF]:
                    FC2 = _pow2_at_least(int(scal[_S_MAXF]), lo=2 * FC)
                    frontier = [self._pad(f, 0, FC2, _SENT)
                                for f in frontier]
                    if self.store_trace:
                        tr_rows = [self._pad(t, 1, FC2, _SENT)
                                   for t in tr_rows]
                        tr_src = [self._pad(t, 1, FC2, -1) for t in tr_src]
                    FC = FC2
                    grew.append(f"FC->{FC}")
                if scal[_S_TOVF]:
                    TRL2 = _pow2_at_least(depth + 1, lo=2 * TRL)
                    tr_rows = [self._pad(t, 0, TRL2, _SENT) for t in tr_rows]
                    tr_src = [self._pad(t, 0, TRL2, -1) for t in tr_src]
                    TRL = TRL2
                    grew.append(f"TRL->{TRL}")
                if scal[_S_VOVF]:
                    VC = max(FC, _pow2_at_least(int(scal[_S_MAXV]),
                                                lo=2 * (VC or FC)))
                    grew.append(f"VC->{VC}")
                if scal[_S_FOVF] and VC is not None:
                    # the compacted block must cover the frontier crop
                    VC = max(VC, FC)
                self.log(f"-- mesh: growing {', '.join(grew)} "
                         f"(level {depth} redone)")
                tel.level(depth, frontier=lvl_frontier, generated=0,
                          new=0, distinct=distinct, devices=D,
                          redo=",".join(grew), fresh_compile=False,
                          wall_s=lwall)
                continue

            # committed level: adopt the merged shards, append the ring
            expanding_FC = FC
            seen = [mg["seen2"] for mg in shards]
            scounts = [int(x) for x in part[:, _P["seen"]]]
            fcounts = [int(x) for x in part[:, _P["front"]]]
            frontier = [mg["front_rows"][:FC] for mg in shards]
            if self.store_trace:
                slot = torch.arange(FC, device=dev)
                for d, mg in enumerate(shards):
                    tr_rows[d][depth] = frontier[d]
                    tr_src[d][depth] = torch.where(
                        slot < fcounts[d], mg["front_src"][:FC], -1)
                self._lvl_FC.append(expanding_FC)
            del shards
            self._spill_rows += int(scal[_S_SPILL])
            self._max_bucket = max(self._max_bucket, int(scal[_S_MAXDEST]))

            # deadlock/assert live in the CURRENT frontier (depth d):
            # totals exclude the partial level
            if model.check_deadlock and scal[_S_DEAD]:
                dv = int(np.argmax(aux[:, _A_DEAD]))
                ds = int(aux[dv, _A_DEADSLOT])
                self._ring_levels(tr_rows, tr_src, depth)
                trace = self._mesh_trace_to(dv, ds, depth)
                return self._mk(False, distinct, generated, depth, t0,
                                warnings,
                                self._viol("deadlock", "deadlock", trace))
            if scal[_S_ASSERT]:
                av = int(np.argmax(aux[:, _A_ASSERT]))
                aa = int(aux[av, _A_ASRTA])
                af = int(aux[av, _A_ASRTF])
                self._ring_levels(tr_rows, tr_src, depth)
                trace = self._mesh_trace_to(av, af, depth)
                return self._mk(
                    False, distinct, generated, depth, t0, warnings,
                    self._viol("assert", "Assert", trace,
                               f"assertion in {self.labels_flat[aa]}"))

            generated += int(scal[_S_GEN])
            distinct += int(scal[_S_NEW])
            self._por_stats["ample"] += int(scal[_S_PORA])
            self._por_stats["expanded"] += int(scal[_S_PORX])
            self._por_stats["masked"] += int(scal[_S_PORM])
            sum_seen = int(scal[_S_SUMS])
            max_seen = int(scal[_S_MAXS])
            self._fp_occupancy = sum_seen
            if sum_seen:
                self._shard_balance = max_seen / (sum_seen / D)
            tel.level(depth, frontier=lvl_frontier,
                      generated=int(scal[_S_GEN]), new=int(scal[_S_NEW]),
                      distinct=distinct, seen=sum_seen, devices=D, fc=FC,
                      spill=int(scal[_S_SPILL]),
                      max_bucket=int(scal[_S_MAXDEST]),
                      superstep=self._supersteps, fresh_compile=False,
                      wall_s=lwall)

            which = int(scal[_S_INVMIN])
            if which != _BIG:
                # invariant violations live in the NEW frontier: the
                # lowest violated invariant index wins, then the first
                # shard holding it
                nm = self.inv_fns[which][0]
                iv_dev = int(np.argmax(aux[:, _A_INVW] == which))
                iv_slot = int(aux[iv_dev, _A_INVSLOT])
                self._ring_levels(tr_rows, tr_src, depth + 1)
                trace = self._mesh_trace_to(iv_dev, iv_slot, depth + 1)
                return self._mk(False, distinct, generated, depth + 1, t0,
                                warnings, self._viol("invariant", nm, trace))
            depth += 1
            lvl_frontier = int(scal[_S_FRONT])
            if self._tiers is not None and self._tiers.active and \
                    lvl_frontier > 0:
                # the cold-tier filter: drop frontier rows whose keys were
                # spilled, and rewrite the ring slot to match
                frontier, fcounts, n_dup = self._mesh_tier_filter(
                    frontier, fcounts, tr_rows, tr_src, depth, FC)
                if n_dup:
                    distinct -= n_dup
                    lvl_frontier -= n_dup
                self._tiers.publish_gauges(sum_seen)

            if self.max_states and distinct >= self.max_states:
                # a truncation point IS a level boundary: leave a
                # checkpoint so the run can be resumed past the limit
                if self.checkpoint_path:
                    ckpt()
                self.log("-- state limit reached, search truncated")
                return self._mk(
                    True, distinct, generated, depth, t0, warnings,
                    truncated=True,
                    trunc_reason=f"max_states: distinct {distinct} "
                                 f">= limit {self.max_states}")

            now = time.time()
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} generated, "
                         f"{distinct} distinct, "
                         f"{lvl_frontier} on queue.")
            if self.checkpoint_path and \
                    now - last_ck >= self.checkpoint_every:
                last_ck = now
                ckpt()

        if self.checkpoint_path and self.final_checkpoint:
            # a COMPLETED-run checkpoint: an empty frontier over the
            # full seen set
            self._ring_levels(tr_rows, tr_src, depth)
            self._mesh_ck(seen, scounts,
                          [torch.zeros((FC, PW), dtype=torch.int32)] * D,
                          [0] * D, FC, SC, depth, generated, distinct)
        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct "
                 f"states found, 0 states left on queue.")
        return self._mk(True, distinct, generated, depth - 1, t0, warnings)

    # ------------------------------------------------------------------
    # the phase probe
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def probe_phase_walls(self, max_levels: int = 4
                          ) -> Optional[Dict[str, float]]:
        """Measured expand / exchange / merge wall breakdown
        (jaxmc/backend/mesh.py:2259).

        The level runs as one dispatch, so its phases are timed by a
        probe: each phase as a separate call at the run's capacities
        (the last run's SC, FC and VC, else the caller's mesh_caps),
        driven a few levels from the real initial shards, with
        torch.cuda.synchronize() before and after each call and one
        untimed warm-up pass of every phase first (it builds nothing on
        the card; it keeps first-touch allocation out of the walls):

          expand          K1, K15, K8 (mesh_block), K2 per shard
                          (_block)
          exchange        K13 over the stacked blocks; on one device
                          there is no collective: the a2a buckets are
                          written straight into each owner's receive
                          layout (_Local)
          merge_rank      per shard: K8 (mesh_vc), K18, K3, K4, the
                          CONSTRAINTs and K8 (mesh_front)
          merge_fullsort  per shard: K18 over seen + received keys
                          and K11, then the same epilogue

        Both merges run on the same inputs every level; the rank merge's
        output carries the probe to the next level.  It stops when the
        frontier empties, after max_levels, or when a level outgrows the
        probe's capacities.  Then the whole one-level step (the body of
        _mesh_level) is timed over the same levels, its first call
        untimed, as the denominator of the hot share.  Counts are never
        consumed.

        Gauges: mesh.phase_levels, mesh.phase_expand_s,
        mesh.phase_exchange_s, mesh.phase_merge_rank_s,
        mesh.phase_merge_fullsort_s, mesh.phase_merge_s (the engine's
        strategy), and with a timed step mesh.phase_step_s and
        mesh.phase_hot_share; mesh.probe_shapes (D, FC, SC, C, R, VC, K,
        PW: the capacities the phases ran at); one `mesh.phase_walls`
        event per probed
        level; profiler sites mesh.probe_expand, mesh.probe_route,
        mesh.probe_merge_rank and mesh.probe_merge_fullsort."""
        tel = obs.current()
        init_rows, explored_init, n_init, err = \
            self._prepare_init(time.time(), [])
        if err is not None:
            return None
        D, K, PW = self.D, self.K, self.PW
        caps = self._run_caps
        hint = self._mesh_caps_hint
        explored_mask = np.zeros(n_init, bool)
        explored_mask[explored_init] = True
        FC = _pow2_at_least(max(int(hint.get("FC", 1)),
                                int(caps.get("FC") or 1),
                                int(explored_mask.sum()), 1), lo=64)
        SC = _pow2_at_least(max(4 * FC, int(hint.get("SC", 1)),
                                int(caps.get("SC") or 1)), lo=256)
        seen_np, frontier_np, fcount_np, scount_np = self._init_shards(
            init_rows, np.nonzero(explored_mask)[0], D, SC, FC)
        C = self.A * FC
        R, B, SB = self._route_shape(C, FC)
        VCp = self._initial_vc(FC)
        if VCp is not None and caps.get("VC"):
            VCp = max(VCp, int(caps["VC"]))
        # the shapes every phase runs at, for byte bounds
        tel.gauge("mesh.probe_shapes", {"D": D, "FC": FC, "SC": SC, "C": C,
                                        "R": R, "VC": VCp, "K": K,
                                        "PW": PW,
                                        "exchange": self.exchange})

        # the level's own expansion and exchange (_level_core's helpers)
        def expand(frontier, fcounts):
            return self._expand_shards(frontier, fcounts, D, C)[:3]

        def route(ckeys, cand, cvalid):
            return self._exchange(self._local, ckeys, cand, cvalid, R, B,
                                  SB)[:3]

        def mk_merge(strategy):
            def merge(seen, scounts, gk, gc, gs):
                return [self._merge(seen[d], scounts[d], gk[d], gc[d],
                                    gs[d], SC, R, VCp, merge=strategy)
                        for d in range(D)]
            return merge

        jexp = obs.prof_wrap("mesh.probe_expand", expand)
        jrt = obs.prof_wrap("mesh.probe_route", route)
        jmg = {m: obs.prof_wrap(f"mesh.probe_merge_{m}", mk_merge(m))
               for m in ("rank", "fullsort")}

        def timed(f, *a):
            self._sync()
            t0 = time.perf_counter()
            out = f(*a)
            self._sync()
            return out, time.perf_counter() - t0

        seen = self._shards_on_device(seen_np)
        frontier = self._shards_on_device(frontier_np)
        scounts = [int(x) for x in scount_np]
        fcounts = [int(x) for x in fcount_np]
        # the untimed warm-up pass of every phase
        o2 = jrt(*jexp(frontier, fcounts))
        for m in jmg.values():
            m(seen, scounts, *o2)
        del o2
        self._sync()

        walls = {"expand": 0.0, "exchange": 0.0,
                 "merge_rank": 0.0, "merge_fullsort": 0.0}
        lv = 0
        while lv < max_levels and sum(fcounts) > 0:
            o1, w_e = timed(jexp, frontier, fcounts)
            o2, w_x = timed(jrt, *o1)
            del o1
            outs, w_m = {}, {}
            for m in ("fullsort", "rank"):
                outs[m], w_m[m] = timed(jmg[m], seen, scounts, *o2)
            del o2
            walls["expand"] += w_e
            walls["exchange"] += w_x
            walls["merge_rank"] += w_m["rank"]
            walls["merge_fullsort"] += w_m["fullsort"]
            tel.event("mesh.phase_walls", level=lv,
                      expand_s=round(w_e, 6), exchange_s=round(w_x, 6),
                      merge_rank_s=round(w_m["rank"], 6),
                      merge_fullsort_s=round(w_m["fullsort"], 6))
            rk = outs["rank"]
            scounts2 = [int(mg["seen_count2"]) for mg in rk]
            fcounts2 = [int(mg["front_count"]) for mg in rk]
            vneed = [int(mg["v_need"]) for mg in rk]
            if max(scounts2) > SC or max(fcounts2) > FC or \
                    (VCp is not None and max(vneed) > VCp):
                break  # the probe's capacities are outgrown
            seen = [mg["seen2"] for mg in rk]
            frontier = [mg["front_rows"][:FC] for mg in rk]
            scounts, fcounts = scounts2, fcounts2
            lv += 1
        del outs

        # the denominator: the whole one-level step at the same
        # capacities over its own state, from the same initial shards
        step_wall = 0.0
        step_levels = 0
        VCe = VCp if self.merge == "rank" else None
        s_seen = self._shards_on_device(seen_np)
        s_front = self._shards_on_device(frontier_np)
        s_sc = [int(x) for x in scount_np]
        s_fc = [int(x) for x in fcount_np]
        flags = (_S_FOVF, _S_SOVF, _S_TOVF, _S_AOVF, _S_VOVF)
        warm = True
        por = isinstance(self._por_memo, dict)

        def step(seen, scounts, frontier, fcounts):
            # _mesh_level's body, outside its profiler site
            core = self._level_core(self._local, seen, scounts, frontier,
                                    fcounts, SC, FC, VCe, por=por,
                                    need_edges=False)
            return (self._scalars(core["part"], FC, SC, 0),
                    core["shards"])

        while step_levels < max_levels and sum(s_fc) > 0:
            (vec, shards), w_s = timed(step, s_seen, s_sc, s_front, s_fc)
            scal, _aux, part = split_vector(vec.cpu().tolist(), D)
            if any(scal[f] for f in flags) or (not warm and scal[_S_OVC]):
                break  # the step outgrew the probe's capacities
            s_seen = [mg["seen2"] for mg in shards]
            s_front = [mg["front_rows"][:FC] for mg in shards]
            s_sc = [int(x) for x in part[:, _P["seen"]]]
            s_fc = [int(x) for x in part[:, _P["front"]]]
            if warm:
                # the first call stands for the reference's compile
                # call: timed again from the level it produced
                warm = False
                continue
            step_wall += w_s
            step_levels += 1

        out = {"levels": lv,
               "expand_s": round(walls["expand"], 6),
               "exchange_s": round(walls["exchange"], 6),
               "merge_rank_s": round(walls["merge_rank"], 6),
               "merge_fullsort_s": round(walls["merge_fullsort"], 6)}
        out["merge_s"] = out["merge_rank_s"] if self.merge == "rank" \
            else out["merge_fullsort_s"]
        if step_levels:
            out["step_levels"] = step_levels
            out["step_s"] = round(step_wall, 6)
            # per level on both sides: the loops can stop at different
            # levels
            hot = (out["expand_s"] + out["merge_s"]) / max(lv, 1)
            out["hot_share"] = round(
                hot / max(step_wall / step_levels, 1e-9), 4)
        tel.gauge("mesh.phase_levels", lv)
        tel.gauge("mesh.phase_expand_s", out["expand_s"])
        tel.gauge("mesh.phase_exchange_s", out["exchange_s"])
        tel.gauge("mesh.phase_merge_s", out["merge_s"])
        tel.gauge("mesh.phase_merge_rank_s", out["merge_rank_s"])
        tel.gauge("mesh.phase_merge_fullsort_s", out["merge_fullsort_s"])
        if step_levels:
            tel.gauge("mesh.phase_step_s", out["step_s"])
            tel.gauge("mesh.phase_hot_share", out["hot_share"])
        return out

    # ------------------------------------------------------------------
    # the host loop (refinement/temporal PROPERTYs; JAXMC_MESH_RESIDENT=0)
    # ------------------------------------------------------------------

    def _fit_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The first n rows of t, SENTINEL-padded when t is shorter."""
        if t.shape[0] >= n:
            return t[:n]
        return self._pad(t, 0, n, _SENT)

    def _run_hostloop(self, need_edges: bool,
                      need_props: bool) -> CheckResult:
        t0 = time.time()
        tel = obs.current()
        model = self.model
        D = self.D
        warnings = ["mesh backend: dedup on 128-bit fingerprints; "
                    "collision probability < n^2 * 2^-129"]
        warnings.extend(self._temporal_warnings())
        if self.por and self._por_plan() is not None:
            # reachable only through JAXMC_MESH_RESIDENT=0 (PROPERTYs
            # already refuse in _por_plan): the ample mask lives in the
            # resident level, so name the refusal and run unreduced
            self._por_memo = None
            self.por_reason = ("mesh host loop active "
                               "(JAXMC_MESH_RESIDENT=0): the device "
                               "mask lives in the resident superstep")
            tel.gauge("por.disabled_reason", self.por_reason)
            tel.gauge("por.enabled", False)
            warnings.append(f"--por requested but reduction disabled: "
                            f"{self.por_reason} (running unreduced)")
        if need_props and not self.store_trace:
            raise ModeError(
                "mesh refinement/temporal checking needs the per-level "
                "row stream: run with store_trace=True (default)")
        if need_props and self.resume_from:
            raise ModeError(
                "mesh resume with refinement/temporal PROPERTYs is not "
                "supported - use the single-chip device modes")
        warnings.extend(self._symmetry_warnings())

        init_rows, explored_init, n_init, err = \
            self._prepare_init(t0, warnings)
        if err is not None:
            return err
        generated = n_init
        explored_mask = np.zeros(n_init, bool)
        explored_mask[explored_init] = True
        distinct = int(explored_mask.sum())
        self._levels = []
        graph = None   # behavior graph (temporal PROPERTYs)
        fsids = None   # flat (d*FC + slot) -> graph state id

        if self.resume_from:
            ck = self._load_ck("mesh")
            if ck["D"] != D:
                raise ValueError(
                    f"cannot resume: checkpoint has {ck['D']} devices, "
                    f"mesh has {D}")
            FC, SC = ck["FC"], ck["SC"]
            depth = ck["depth"]
            generated = ck["generated"]
            distinct = ck["distinct"]
            seen = self._shards_on_device(ck["seen"])
            scounts = [int(x) for x in ck["seen_counts"]]
            frontier = self._shards_on_device(ck["frontier"])
            fcounts = [int(x) for x in ck["fcount"]]
            if ck.get("levels") is not None:
                self._levels = list(ck["levels"])
            elif self.store_trace:
                raise ValueError(
                    "cannot resume with traces: the checkpoint was "
                    "written with --no-trace")
            self.log(f"Resuming mesh run at depth {depth} "
                     f"({distinct} distinct states)")
        else:
            init_keys, init_packed, init_povf = self._host_keys(init_rows)
            if init_povf:
                raise CompileError(self._pack_ovf_msg())
            owner = self._owner_from_keys(init_keys)
            per_dev = [int(((owner == d) & explored_mask).sum())
                       for d in range(D)]
            FC = _pow2_at_least(max(max(per_dev, default=1), 1), lo=64)
            SC = _pow2_at_least(4 * FC, lo=256)
            explored_idx = np.nonzero(explored_mask)[0]
            seen_np, frontier_np, fcount_np, scount_np = self._init_shards(
                init_rows, explored_idx, D, SC, FC, keys=init_keys,
                packed=init_packed, owner=owner)
            if self.live_obligations:
                graph = _LiveGraph(self.labels_flat, self.collect_edges)
                graph.add_inits(init_packed, explored_idx)
                fsids = np.full(D * FC, -1, np.int64)
                for d in range(D):
                    for i in range(int(fcount_np[d])):
                        fsids[d * FC + i] = graph.sid_by_key[
                            frontier_np[d, i].tobytes()]
            if self.store_trace:
                self._levels.append((frontier_np.copy(), None, FC))
            seen = self._shards_on_device(seen_np)
            frontier = self._shards_on_device(frontier_np)
            fcounts = [int(x) for x in fcount_np]
            scounts = [int(x) for x in scount_np]
            depth = 0

        last_progress = last_ck = time.time()
        lvl_frontier = sum(fcounts)
        while lvl_frontier > 0:
            lvl_t0 = time.time()
            lvl_gen0 = generated
            C = self.A * FC
            need = max(scounts, default=0) + D * C
            if need > SC:
                SC2 = _pow2_at_least(need, SC)
                seen = [self._pad(s, 0, SC2, _SENT, lane1=True)
                        for s in seen]
                SC = SC2
            expanding_FC = FC
            while True:
                vec, shards, R, B, SB, edges = self._mesh_step(
                    self._local, seen, scounts, frontier, fcounts, SC, FC,
                    need_edges=need_edges)
                scal, aux, part = split_vector(vec.cpu().tolist(), D)
                # each attempt pays a full exchange at its own gamma
                tel.counter("mesh.exchange_bytes",
                            self._exchange_bytes(C, B, SB))
                if self.exchange == "a2a" and scal[_S_AOVF]:
                    # hash skew exceeded the bucket AND the spill pass:
                    # rerun the level with a doubled capacity factor
                    self._a2a_gamma *= 2
                    self.log(f"-- mesh: a2a bucket+spill overflow, "
                             f"gamma -> {self._a2a_gamma}")
                    continue
                break
            seen = [mg["seen2"] for mg in shards]
            self._spill_rows += int(scal[_S_SPILL])

            ovc = int(scal[_S_OVC])
            if ovc:
                return self._mk(False, distinct, generated, depth, t0,
                                warnings, self._ovc_violation(ovc))
            if model.check_deadlock and scal[_S_DEAD]:
                dv = int(np.argmax(aux[:, _A_DEAD]))
                trace = self._mesh_trace_to(dv, int(aux[dv, _A_DEADSLOT]),
                                            depth)
                return self._mk(False, distinct, generated, depth, t0,
                                warnings,
                                self._viol("deadlock", "deadlock", trace))
            if scal[_S_ASSERT]:
                av = int(np.argmax(aux[:, _A_ASSERT]))
                aa = int(aux[av, _A_ASRTA])
                trace = self._mesh_trace_to(av, int(aux[av, _A_ASRTF]),
                                            depth)
                return self._mk(
                    False, distinct, generated, depth, t0, warnings,
                    self._viol("assert", "Assert", trace,
                               f"assertion in {self.labels_flat[aa]}"))

            ecand = eexp = esrc = None
            if need_edges:
                ecand, eexp, esrc = edges
                if self.refiners:
                    fr_np = np.stack([f.cpu().numpy() for f in frontier])
                    rv = self._mesh_refine_edges(fr_np, ecand, eexp, esrc,
                                                 expanding_FC, depth)
                    if rv is not None:
                        return self._mk(False, distinct, generated, depth,
                                        t0, warnings, rv)

            generated += int(scal[_S_GEN])
            distinct += int(scal[_S_NEW])
            scounts = [int(x) for x in part[:, _P["seen"]]]
            front_cnt = [int(x) for x in part[:, _P["front"]]]
            tel.level(depth, frontier=lvl_frontier,
                      generated=generated - lvl_gen0,
                      new=int(scal[_S_NEW]), distinct=distinct,
                      seen=sum(scounts), devices=D,
                      wall_s=round(time.time() - lvl_t0, 6))
            self._fp_occupancy = sum(scounts)
            if sum(scounts):
                self._shard_balance = float(max(scounts)
                                            / (sum(scounts) / D))
            max_front = max(front_cnt, default=0)
            which = int(scal[_S_INVMIN])
            need_host_rows = (self.store_trace or which != _BIG
                              or graph is not None)
            front_rows_np = np.stack([mg["front_rows"].cpu().numpy()
                                      for mg in shards]) \
                if need_host_rows else None
            front_src_np = np.stack([mg["front_src"].cpu().numpy()
                                     for mg in shards]) \
                if (self.store_trace or graph is not None) else None
            if self.store_trace:
                # trim to the occupied prefix
                keep = max(max_front, 1)
                self._levels.append((front_rows_np[:, :keep],
                                     front_src_np[:, :keep], expanding_FC))

            sids_per_dev = None
            if graph is not None:
                # kept new rows register with provenance
                # a*(D*FCprev) + (d_src*FCprev + f), then every explored
                # candidate edge (revisits included)
                Cprev = self.A * expanding_FC
                flat_rows, flat_prov = [], []
                for d in range(D):
                    for i in range(front_cnt[d]):
                        g = int(front_src_np[d, i])
                        d_src, cc = g // Cprev, g % Cprev
                        a, f = cc // expanding_FC, cc % expanding_FC
                        flat_rows.append(front_rows_np[d, i])
                        flat_prov.append(a * (D * expanding_FC)
                                         + d_src * expanding_FC + f)
                new_sids = graph.add_level(
                    np.asarray(flat_rows) if flat_rows
                    else np.zeros((0, self.PW), np.int32),
                    np.asarray(flat_prov, np.int64), D * expanding_FC,
                    fsids)
                if graph.collect_edges and ecand is not None:
                    eidx = np.nonzero(eexp)[0]
                    epar = np.empty(len(eidx), np.int64)
                    for k, c in enumerate(eidx):
                        g = int(esrc[c])
                        d_src, cc = g // Cprev, g % Cprev
                        epar[k] = d_src * expanding_FC + cc % expanding_FC
                    graph.add_edges(ecand[eidx], epar, fsids)
                sids_per_dev = []
                off = 0
                for d in range(D):
                    sids_per_dev.append(new_sids[off:off + front_cnt[d]])
                    off += front_cnt[d]

            if which != _BIG:
                nm = self.inv_fns[which][0]
                iv_dev = int(np.argmax(aux[:, _A_INVW] == which))
                trace = self._mesh_trace_to(
                    iv_dev, int(aux[iv_dev, _A_INVSLOT]), depth + 1)
                return self._mk(False, distinct, generated, depth + 1, t0,
                                warnings, self._viol("invariant", nm, trace))
            depth += 1

            # next frontier: capacity grows to the largest shard
            fcounts = front_cnt
            if max_front > FC:
                FC = _pow2_at_least(max_front, FC)
            frontier = [self._fit_rows(mg["front_rows"], FC)
                        for mg in shards]
            del shards
            if graph is not None:
                fsids = np.full(D * FC, -1, np.int64)
                for d in range(D):
                    for i, sid in enumerate(sids_per_dev[d]):
                        fsids[d * FC + i] = sid

            if self.max_states and distinct >= self.max_states:
                if self.checkpoint_path:
                    self._mesh_ck(seen, scounts, frontier, fcounts, FC, SC,
                                  depth, generated, distinct)
                self.log("-- state limit reached, search truncated")
                return self._mk(
                    True, distinct, generated, depth, t0, warnings,
                    truncated=True,
                    trunc_reason=f"max_states: distinct {distinct} >= "
                                 f"limit {self.max_states}")

            now = time.time()
            if now - last_progress >= self.progress_every:
                last_progress = now
                self.log(f"Progress({depth}): {generated} generated, "
                         f"{distinct} distinct, "
                         f"{int(scal[_S_FRONT])} on queue.")
            if self.checkpoint_path and \
                    now - last_ck >= self.checkpoint_every:
                last_ck = now
                self._mesh_ck(seen, scounts, frontier, fcounts, FC, SC,
                              depth, generated, distinct)
            lvl_frontier = sum(fcounts)

        if graph is not None:
            viol = self._check_live(graph, warnings)
            if viol is not None:
                return self._mk(False, distinct, generated, depth - 1, t0,
                                warnings, viol)
        self.log("Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {distinct} distinct "
                 f"states found, 0 states left on queue.")
        return self._mk(True, distinct, generated, depth - 1, t0, warnings)

    def _mk(self, ok, distinct, generated, diameter, t0, warnings,
            violation=None, truncated=False, drained=False,
            trunc_reason=None):
        tel = obs.current()
        self._por_finish(self._por_stats["ample"],
                         self._por_stats["expanded"],
                         self._por_stats["masked"], distinct)
        tel.high_water("device.mem_high_water_bytes",
                       obs.device_mem_high_water())
        occ = getattr(self, "_fp_occupancy", None)
        if occ is not None:
            tel.gauge("fingerprint.occupancy", occ)
        if self.exchange == "a2a":
            tel.gauge("mesh.a2a_gamma", round(self._a2a_gamma, 4))
            tel.gauge("mesh.a2a_spill", self._spill_rows)
            if self._max_bucket:
                tel.gauge("mesh.a2a_max_bucket", self._max_bucket)
        if self._shard_balance is not None:
            tel.gauge("mesh.shard_balance", round(self._shard_balance, 4))
        if self._supersteps:
            # one level per dispatch: supersteps == host syncs
            tel.gauge("mesh.supersteps", self._supersteps)
            tel.gauge("mesh.superstep_levels", 1)
        tiers_stats = None
        if self._tiers is not None and self._tiers.active:
            tiers_stats = self._tiers.stats()
            self._tiers.publish_gauges(occ or 0)
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
                           seen_mode="fingerprint",
                           collision_p=collision_p, tiers=tiers_stats)
