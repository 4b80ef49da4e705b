r"""Bit-packed lane plans: per-variable-width state rows.

The vspec layout spends one full int32 lane per value component, so a
row is W >= the number of scalar components even when almost every lane
holds a boolean, a tiny enum index, or a capacity-bounded count.  The
frontier, the seen table, and the 128-bit fingerprint loop all pay for
that padding in HBM traffic (and, for `fingerprint128`, in hash
iterations: one per lane).

A LanePlan maps each unpacked lane to a (word, shift, mask, bias) bit
field inside a packed row of `packed_width` int32 words.  Bit widths
come from two sources, combined per lane:

  structural bounds — GUARANTEED by the encoding itself, so packing
      them can never overflow at runtime:
        bool / set-membership / pfcn-present lanes    1 bit
        enum lanes                                    ceil(log2(|uni|))
        seq length / growset / kvtable count lanes    ceil(log2(cap+1))
        union tag lanes                               ceil(log2(#variants))
  observed ranges — raw int lanes are unbounded in principle; their
      range is profiled over the encoded layout-sample rows and widened
      by a margin.  Such lanes are GUARDED: a runtime value outside the
      profiled range raises the engine's packed-lane overflow (the
      engines abort exactly, naming JAXMC_PACK=0 as the escape hatch —
      never a silently wrong count).

Exactness: the lane -> field mapping is injective over the admissible
ranges and SENTINEL_LANE padding maps to a reserved per-lane code, so
packed-row equality == unpacked-row equality == TLA+ value equality.
Exact dedup and fingerprinting over packed rows therefore partition
states exactly as the unpacked rows do (the fp128 collision story is
unchanged).  Zero-padding contexts (sequence tails, absent pfcn values,
short union payloads) force 0 into every affected lane's range so
padding always packs cleanly.

JAXMC_PACK=0|off disables packing (identity plan: packed == unpacked).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .vspec import SENTINEL_LANE, VS

_PACK_OFF = ("0", "off", "none", "disabled")


def packing_enabled() -> bool:
    return os.environ.get("JAXMC_PACK", "1").strip().lower() \
        not in _PACK_OFF


@dataclass
class _LaneClass:
    """Admissible value range of one unpacked lane.

    lo/hi of None mean "no structural bound — profile from observed
    rows and guard at runtime".  `proven` marks a bound derived by the
    static analyzer (analyze/bounds.py): packed at the proven
    width with NO sampling margin, but keeping the runtime OV_PACK
    check as a soundness net — a fired check names the analyzer, and
    the recovery re-profile widens past it (observed ranges always
    extend the bound at plan time)."""
    lo: Optional[int]
    hi: Optional[int]
    guarded: bool
    sent_ok: bool      # the lane can hold SENTINEL_LANE padding
    zero_pad: bool     # the lane can hold 0 padding
    proven: bool = False

    def merge(self, other: "_LaneClass") -> "_LaneClass":
        lo = None if (self.lo is None or other.lo is None) \
            else min(self.lo, other.lo)
        hi = None if (self.hi is None or other.hi is None) \
            else max(self.hi, other.hi)
        return _LaneClass(lo, hi, self.guarded or other.guarded,
                          self.sent_ok or other.sent_ok,
                          self.zero_pad or other.zero_pad,
                          self.proven or other.proven)


def _sb_all(static) -> Optional[Tuple[int, int]]:
    """The covering interval of a static bound: a plain (lo, hi) tuple
    is itself; an analyze.bounds.EB contributes its `all` field."""
    if static is None or isinstance(static, tuple):
        return static
    return static.all


def _sb_child(static, role: str, key=None):
    """Descend a static bound alongside the vspec tree.

    A plain (lo, hi) tuple covers every int component, so it passes
    through unchanged (the earlier whole-variable behavior).  An
    EB picks the per-key bound when `key` matches a tracked record
    field, else the role child (rng/elem interchange: a tuple value
    abstracted as a sequence still covers function-encoded layouts and
    vice versa), else falls back to the covering `all` interval —
    every fallback is a superset, never a narrower guess."""
    if static is None or isinstance(static, tuple):
        return static
    if key is not None and static.keys and key in static.keys:
        c = static.keys[key]
        return c if c is not None else static.all
    alts = {"rng": ("rng", "elem"), "elem": ("elem", "rng"),
            "dom": ("dom",)}[role]
    for r in alts:
        c = getattr(static, r)
        if c is not None:
            return c
    return static.all


def _walk(spec: VS, uni_n: int, zero_pad: bool, sent_ok: bool,
          out: List[_LaneClass], static=None) -> None:
    """Emit one _LaneClass per lane, in exactly vspec.encode's order.

    `static` is the variable's analyzer-proven bound:
    either a plain (lo, hi) summary interval covering EVERY integer
    scalar component anywhere in the value, or a structured
    analyze.bounds.EB whose dom/rng/elem/per-key children bound each
    container side separately — element lanes then pack at their own
    proven widths (the EXCEPT-guard container win)."""
    k = spec.kind
    if k == "justempty":
        return
    if k == "int":
        b = _sb_all(static)
        if b is not None:
            out.append(_LaneClass(b[0], b[1], True, sent_ok,
                                  zero_pad, proven=True))
        else:
            out.append(_LaneClass(None, None, True, sent_ok, zero_pad))
    elif k == "bool":
        out.append(_LaneClass(0, 1, False, sent_ok, zero_pad))
    elif k == "enum":
        out.append(_LaneClass(0, max(uni_n - 1, 0), False, sent_ok,
                              zero_pad))
    elif k == "fcn":
        for kk, e in zip(spec.dom, spec.elems):
            _walk(e, uni_n, zero_pad, sent_ok, out,
                  _sb_child(static, "rng", key=kk))
    elif k == "seq":
        out.append(_LaneClass(0, spec.cap, False, sent_ok, zero_pad))
        for _ in range(spec.cap):
            # tail slots beyond the length are zero-padded
            _walk(spec.elem, uni_n, True, sent_ok, out,
                  _sb_child(static, "elem"))
    elif k == "set":
        for _ in spec.dom:
            out.append(_LaneClass(0, 1, False, sent_ok, zero_pad))
    elif k == "growset":
        out.append(_LaneClass(0, spec.cap, False, sent_ok, zero_pad))
        for _ in range(spec.cap):
            # slots beyond the cardinality are SENTINEL-padded
            _walk(spec.elem, uni_n, zero_pad, True, out,
                  _sb_child(static, "elem"))
    elif k == "pfcn":
        for kk, e in zip(spec.dom, spec.elems):
            out.append(_LaneClass(0, 1, False, sent_ok, zero_pad))
            # absent keys zero their value lanes
            _walk(e, uni_n, True, sent_ok, out,
                  _sb_child(static, "rng", key=kk))
    elif k == "union":
        out.append(_LaneClass(0, max(len(spec.variants) - 1, 0), False,
                              sent_ok, zero_pad))
        pay = spec.width - 1
        # payload lanes are OVERLAID across variants: merge the classes
        # positionally; lanes past a variant's width are zero-padded —
        # only the covering interval is sound across the overlay
        cover = _sb_all(static)
        lanes = [_LaneClass(0, 0, False, sent_ok, True)
                 for _ in range(pay)]
        for _names, fields in spec.variants:
            sub: List[_LaneClass] = []
            for f in fields:
                _walk(f, uni_n, True, sent_ok, sub, cover)
            for i, lc in enumerate(sub):
                lanes[i] = lanes[i].merge(lc)
        out.extend(lanes)
    elif k == "kvtable":
        out.append(_LaneClass(0, spec.cap, False, sent_ok, zero_pad))
        for _ in range(spec.cap):
            _walk(spec.elem, uni_n, zero_pad, True, out,
                  _sb_child(static, "dom"))
            _walk(spec.val, uni_n, zero_pad, True, out,
                  _sb_child(static, "rng"))
    else:
        raise AssertionError(k)


def _nbits(n_codes: int) -> int:
    """Bits to address n_codes distinct codes (>= 1 bit)."""
    b = 1
    while (1 << b) < n_codes:
        b += 1
    return b


class LanePlan:
    """The packed layout: per-lane field descriptors + packed width.

    Per-lane arrays (length W):
      word / shift / mask   bit-field placement inside the packed row
      bias                  code = value - bias
      allowed               largest VALID code (sentinel code included)
      sent_code             reserved code for SENTINEL_LANE, -1 if none
      guarded               True for observed-range (int) lanes AND for
                            analyzer-proven lanes: a code outside
                            [0, allowed] at pack time raises the
                            packed-lane overflow
      proven                True for lanes whose bound came from the
                            static analyzer (no sampling margin; the
                            guard is a soundness net that should never
                            fire)
      full                  True for 32-bit (unpacked) lanes: raw bitcast,
                            never guarded
    """

    def __init__(self, width: int, classes: List[_LaneClass],
                 obs_lo: np.ndarray, obs_hi: np.ndarray,
                 obs_seen: np.ndarray, force_identity: bool = False):
        self.width = width
        W = width
        bits = np.zeros(W, np.int64)
        bias = np.zeros(W, np.int64)
        allowed = np.zeros(W, np.int64)
        sent_code = np.full(W, -1, np.int64)
        guarded = np.zeros(W, bool)
        proven = np.zeros(W, bool)
        full = np.zeros(W, bool)
        for i, lc in enumerate(classes):
            lo, hi = lc.lo, lc.hi
            if lo is None or hi is None:
                # observed-range lane (raw int)
                if not obs_seen[i]:
                    # never observed holding a real value: keep the full
                    # word — there is no profile to pack against
                    full[i] = True
                    bits[i] = 32
                    continue
                olo, ohi = int(obs_lo[i]), int(obs_hi[i])
                # symmetric margin of one observed span (floor 4) on
                # both sides, then 4x the resulting code count (+2
                # bits): BFS-depth-growing counters routinely reach a
                # multiple of the sampled max, and a spurious OV_PACK
                # abort costs a whole run — two extra bits per guarded
                # lane is cheap insurance
                span = max(ohi - olo, 4)
                lo = olo - span
                hi = lo + (ohi + span - lo + 1) * 4 - 1
                guarded[i] = True
            else:
                # structural OR analyzer-proven bound; extend with the
                # observed range as a belt-and-braces guard against
                # walk-order/analyzer defects (an extension here means
                # wider lanes, never wrong ones)
                if obs_seen[i]:
                    lo = min(lo, int(obs_lo[i]))
                    hi = max(hi, int(obs_hi[i]))
                if lc.proven:
                    # proven-width lane: packed exactly (no sampling
                    # margin), runtime-checked as a soundness net — the
                    # check cannot fire unless the static inference was
                    # wrong, and then the engine aborts exactly and the
                    # re-profile recovery widens past the bad bound
                    proven[i] = True
                    guarded[i] = True
            if lc.zero_pad:
                lo = min(lo, 0)
                hi = max(hi, 0)
            codes = hi - lo + 1
            if lc.sent_ok:
                sent_code[i] = codes
                codes += 1
            b = _nbits(max(codes, 1))
            if b >= 32:
                full[i] = True
                bits[i] = 32
                sent_code[i] = -1
                guarded[i] = False
                proven[i] = False
                continue
            bits[i] = b
            bias[i] = lo
            allowed[i] = codes - 1
        # greedy sequential word assignment (no lane spans two words)
        word = np.zeros(W, np.int64)
        shift = np.zeros(W, np.int64)
        w = 0
        used = 0
        for i in range(W):
            b = int(bits[i])
            if used + b > 32:
                w += 1
                used = 0
            word[i] = w
            shift[i] = used
            used += b
        packed_width = (w + 1) if W else 0
        self.identity = bool(force_identity or packed_width >= W)
        if self.identity:
            packed_width = W
            word = np.arange(W, dtype=np.int64)
            shift = np.zeros(W, np.int64)
            bits = np.full(W, 32, np.int64)
            bias = np.zeros(W, np.int64)
            sent_code = np.full(W, -1, np.int64)
            guarded = np.zeros(W, bool)
            proven = np.zeros(W, bool)
            full = np.ones(W, bool)
            allowed = np.zeros(W, np.int64)
        self.packed_width = packed_width
        self.bits = bits
        self.word = word
        self.shift = shift
        self.mask = ((np.int64(1) << bits) - 1).astype(np.uint64) \
            .astype(np.uint32) if W else np.zeros(0, np.uint32)
        self.bias = bias
        self.allowed = allowed
        self.sent_code = sent_code
        self.guarded = guarded
        self.proven = proven
        self.full = full
        self.bits_per_state = int(bits.sum())
        # the two int-lane accounting gauges are disjoint: a lane is
        # either proven (static bound, no margin) or observed-range
        # guarded (sampled + margin + runtime abort)
        self.proven_lanes = int(proven.sum())
        self.guarded_lanes = int((guarded & ~proven).sum())

    # deterministic description for layout signatures (checkpoint/resume
    # compatibility: a resumed run must rebuild the identical plan)
    def signature(self) -> str:
        return repr((self.width, self.packed_width, self.identity,
                     self.word.tolist(), self.shift.tolist(),
                     self.bits.tolist(), self.bias.tolist(),
                     self.sent_code.tolist()))

    def batch_descriptor(self) -> Dict[str, int]:
        """The compat surface the cross-model batcher reports and
        verifies: the packed word width and lane accounting
        every member of a vmapped batch shares — per-model CONSTANT
        values are batch-axis lanes, so they are deliberately NOT in
        here."""
        return {"width": self.width, "packed_width": self.packed_width,
                "identity": int(self.identity),
                "bits_per_state": self.bits_per_state,
                "proven_lanes": self.proven_lanes,
                "guarded_lanes": self.guarded_lanes}

    # ---------------- host (numpy) pack/unpack ----------------

    def pack_np(self, rows: np.ndarray) -> np.ndarray:
        """[N, W] int32 -> [N, PW] int32.  Raises on an out-of-range
        guarded lane (host rows come from exact encodes, so an overflow
        here is an observation gap — same contract as vspec capacity
        errors)."""
        rows = np.ascontiguousarray(rows, np.int32)
        if self.identity:
            return rows
        from .vspec import CompileError
        v = rows.astype(np.int64)
        sent_l = (self.sent_code >= 0)[None, :]
        sent = (v == SENTINEL_LANE) & sent_l
        code = np.where(sent, self.sent_code[None, :],
                        v - self.bias[None, :])
        bad = (~self.full[None, :]) & \
            ((code < 0) | (code > self.allowed[None, :]))
        if bad.any():
            i = int(np.nonzero(bad.any(axis=0))[0][0])
            if self.proven[i]:
                raise CompileError(
                    f"packed lane {i} overflow: value outside the "
                    f"STATICALLY PROVEN range [{self.bias[i]}, "
                    f"{self.bias[i] + self.allowed[i]}] — the bounds "
                    f"analyzer derived a wrong interval (please report)"
                    f"; JAXMC_ANALYZE_BOUNDS=0 or JAXMC_PACK=0 works "
                    f"around it")
            raise CompileError(
                f"packed lane {i} overflow: value outside the profiled "
                f"range [{self.bias[i]}, {self.bias[i] + self.allowed[i]}]"
                f" — deepen layout sampling or set JAXMC_PACK=0")
        code_u = np.where(self.full[None, :], rows.view(np.uint32),
                          code.astype(np.uint32))
        packed = np.zeros((len(rows), self.packed_width), np.uint32)
        shifted = (code_u & self.mask[None, :]) << \
            self.shift.astype(np.uint32)[None, :]
        for i in range(self.width):
            packed[:, self.word[i]] |= shifted[:, i]
        return packed.view(np.int32)

    def unpack_np(self, packed: np.ndarray) -> np.ndarray:
        """[N, PW] int32 -> [N, W] int32 (total inverse of pack_np)."""
        packed = np.ascontiguousarray(packed, np.int32)
        if self.identity:
            return packed
        pu = packed.view(np.uint32)
        w = pu[:, self.word]                       # [N, W]
        raw = (w >> self.shift.astype(np.uint32)[None, :]) & \
            self.mask[None, :]
        v = raw.astype(np.int64) + self.bias[None, :]
        v = np.where(self.full[None, :],
                     raw.astype(np.uint32).view(np.int32).astype(np.int64),
                     v)
        sent = (self.sent_code >= 0)[None, :] & \
            (raw.astype(np.int64) == self.sent_code[None, :])
        v = np.where(sent, SENTINEL_LANE, v)
        return v.astype(np.int32)

    # ---------------- device (torch) pack/unpack ----------------
    #
    # Dispatchers over [N, *] int32 tensors: a CUDA tensor goes through
    # the hand-written kernels (kernels/csrc/unpack.cu, keys.cu), a CPU
    # tensor through their plain twins (kernels/ops.py).  twin=True runs
    # the twin on either device (the engine's `twins` argument).

    def unpack_rows(self, packed, twin: bool = False):
        """[N, PW] int32 tensor -> [N, W] int32 tensor."""
        if self.identity:
            return packed
        from ..kernels import ops
        f = ops.unpack_rows_twin if twin else ops.unpack_rows
        return f(packed, self.tensors(packed.device))

    def pack_rows(self, rows):
        """[N, W] int32 tensor -> (packed [N, PW] int32, ovf [N] bool).

        ovf marks rows with a guarded lane outside its profiled range —
        callers mask it by row validity and route it into the engine's
        overflow channel (OV_PACK): an abort, never a wrong count.  On
        CUDA this is K2 over rows that are all valid, with its per-row
        flags."""
        import torch
        if self.identity:
            return rows, torch.zeros(rows.shape[0], dtype=torch.bool,
                                     device=rows.device)
        from ..kernels import ops
        pt = self.tensors(rows.device)
        if rows.device.type == "cpu":
            return ops.pack_rows_twin(rows, pt)
        valid = torch.ones(rows.shape[0], dtype=torch.bool,
                           device=rows.device)
        _, packed, _, ovf = ops.keys_of(rows, valid, pt, False, False,
                                        row_ovf=True)
        return packed, ovf

    def tensors(self, device):
        """The plan's per-lane arrays as int32 tensors on `device`
        (cached per device): word, shift, mask (uint32 bits viewed as
        int32), bias, allowed, sent_code (-1 = none), full (0/1)."""
        import torch
        key = str(device)
        cache = self.__dict__.setdefault("_tensor_cache", {})
        hit = cache.get(key)
        if hit is None:
            def t(x):
                return torch.as_tensor(
                    np.ascontiguousarray(x), device=device)
            hit = {"word": t(self.word.astype(np.int32)),
                   "shift": t(self.shift.astype(np.int32)),
                   "mask": t(self.mask.astype(np.uint32).view(np.int32)),
                   "bias": t(self.bias.astype(np.int32)),
                   "allowed": t(self.allowed.astype(np.int32)),
                   "sent_code": t(self.sent_code.astype(np.int32)),
                   "full": t(self.full.astype(np.int32)),
                   "W": self.width, "PW": self.packed_width}
            cache[key] = hit
        return hit


def identity_plan(width: int) -> LanePlan:
    return LanePlan(width, [], np.zeros(0), np.zeros(0),
                    np.zeros(0, bool), force_identity=True) \
        if width == 0 else LanePlan(
            width,
            [_LaneClass(None, None, True, False, False)] * width,
            np.zeros(width, np.int64), np.zeros(width, np.int64),
            np.zeros(width, bool), force_identity=True)


def build_lane_plan(layout, sample_rows: List[np.ndarray],
                    static_bounds: Optional[Dict[str, Tuple[int, int]]]
                    = None) -> LanePlan:
    """Plan for a Layout2 from its specs + the encoded sample rows.

    static_bounds: per-variable PROVEN summary intervals from
    analyze/bounds.py — every raw-int lane under such a variable
    is packed at the proven width (no sampling margin, no re-profile
    cycle) instead of the guarded observed range."""
    classes: List[_LaneClass] = []
    uni_n = len(layout.uni)
    for v in layout.vars:
        _walk(layout.specs[v], uni_n, False, False, classes,
              (static_bounds or {}).get(v))
    W = layout.width
    if len(classes) != W:
        # a walk-order defect would corrupt every row: refuse to pack
        return identity_plan(W)
    if sample_rows:
        mat = np.asarray(np.stack(sample_rows), np.int64)
        sent_l = np.asarray([c.sent_ok for c in classes])
        is_sent = (mat == SENTINEL_LANE) & sent_l[None, :]
        real = ~is_sent
        big = np.int64(2 ** 62)
        obs_lo = np.where(real, mat, big).min(axis=0)
        obs_hi = np.where(real, mat, -big).max(axis=0)
        obs_seen = real.any(axis=0)
        obs_lo = np.where(obs_seen, obs_lo, 0)
        obs_hi = np.where(obs_seen, obs_hi, 0)
    else:
        obs_lo = np.zeros(W, np.int64)
        obs_hi = np.zeros(W, np.int64)
        obs_seen = np.zeros(W, bool)
    return LanePlan(W, classes, obs_lo, obs_hi, obs_seen,
                    force_identity=not packing_enabled())
