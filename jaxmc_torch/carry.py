"""State carried across from the reference: the lane plan and one
level's seen table and frontier, handed over as numpy arrays.

The model checker has no weights.  What the two packages must share to
run the same level step is the bit-packed lane plan (which fixes every
key bit) and the level state.  Both functions take plain numpy, so a
caller (the parity tests) moves data between the packages without
either importing the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .compile.pack import LanePlan

PLAN_FIELDS = ("bias", "allowed", "shift", "mask", "word", "full",
               "sent_code", "packed_width", "identity")


def plan_from_numpy(d: Dict[str, object]) -> LanePlan:
    """The port's LanePlan from a plan's arrays: `bias`, `allowed`,
    `shift`, `mask`, `word`, `full`, `sent_code` (per lane) and
    `packed_width`, `identity`.  Bit widths come from the masks; every
    non-full lane is guarded (pack_np raises on it when out of range)."""
    missing = [k for k in PLAN_FIELDS if k not in d]
    if missing:
        raise KeyError(f"plan arrays missing: {missing}")
    p = LanePlan.__new__(LanePlan)
    mask = np.asarray(d["mask"]).astype(np.uint32)
    W = len(mask)
    p.width = W
    p.packed_width = int(d["packed_width"])
    p.identity = bool(d["identity"])
    p.word = np.asarray(d["word"], np.int64)
    p.shift = np.asarray(d["shift"], np.int64)
    p.mask = mask
    p.bits = np.asarray([bin(int(m)).count("1") for m in mask], np.int64)
    p.bias = np.asarray(d["bias"], np.int64)
    p.allowed = np.asarray(d["allowed"], np.int64)
    p.sent_code = np.asarray(d["sent_code"], np.int64)
    p.full = np.asarray(d["full"], bool)
    p.guarded = ~p.full if not p.identity else np.zeros(W, bool)
    p.proven = np.zeros(W, bool)
    p.bits_per_state = int(p.bits.sum())
    p.proven_lanes = 0
    p.guarded_lanes = int(p.guarded.sum())
    return p


def level_state_from_numpy(seen: np.ndarray, seen_count: int,
                           frontier: np.ndarray, fcount: int,
                           device) -> Tuple[torch.Tensor, int,
                                            torch.Tensor, int]:
    """(seen [SC, K], seen_count, frontier [FC, PW], fcount) as the
    level engine takes them: int32 tensors on `device`."""
    seen = np.array(seen, np.int32)            # owned, writable copies
    frontier = np.array(frontier, np.int32)
    if not 0 <= int(seen_count) <= len(seen):
        raise ValueError(f"seen_count {seen_count} outside the table")
    if not 0 <= int(fcount) <= len(frontier):
        raise ValueError(f"fcount {fcount} outside the frontier")
    return (torch.as_tensor(seen, device=device), int(seen_count),
            torch.as_tensor(frontier, device=device), int(fcount))
