"""Inputs of K2 keys_of made with numpy from a seed, for the CPU model
(test_torch_keys_tiles.py) and the card tests (test_torch_cuda.py): a
lane plan of W lanes packed greedily into PW words (as pack.py places
them: lanes fill words in increasing order, a full lane takes a word of
its own), rows in the plan's ranges with SENTINEL codes, and validity
patterns that put valid rows where the kernel's tiles have edges:

  none     no valid row
  all      every row valid
  edges    only the first and last row of each tile of T rows
  sparse   about 18% valid (a level's candidate block)
  half     about half valid

No jax here: the card tests import this module."""

import numpy as np
import torch

SENT = 2**31 - 1
PATTERNS = ("none", "all", "edges", "sparse", "half")


def plan(W, seed, full_p=0.15):
    """The plan's per-lane arrays (numpy int64) and PW."""
    rng = np.random.default_rng(seed)
    word = np.zeros(W, np.int64)
    shift = np.zeros(W, np.int64)
    mask = np.zeros(W, np.int64)
    bias = np.zeros(W, np.int64)
    allowed = np.zeros(W, np.int64)
    full = np.zeros(W, np.int64)
    sent = np.full(W, -1, np.int64)
    cur, used = 0, 0
    for i in range(W):
        if rng.random() < full_p:
            if used:
                cur, used = cur + 1, 0
            word[i], mask[i], full[i] = cur, 0xFFFFFFFF, 1
            cur += 1
            continue
        bits = int(rng.integers(1, 13))
        if used + bits > 32:
            cur, used = cur + 1, 0
        word[i], shift[i], mask[i] = cur, used, (1 << bits) - 1
        used += bits
        allowed[i] = max(0, (1 << bits) - 2 - int(rng.integers(0, 2)))
        bias[i] = int(rng.integers(-50, 50))
        if rng.random() < 0.4 and allowed[i] + 1 < (1 << bits):
            sent[i] = allowed[i] + 1
    PW = cur + (1 if used else 0)
    return dict(word=word, shift=shift, mask=mask, bias=bias,
                allowed=allowed, full=full, sent_code=sent, W=W, PW=PW)


def plan_tensors(p, device):
    """The plan as LanePlan.tensors gives it (int32, mask as uint32 bits)."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x.astype(np.int32)),
                               device=device)
    return {"word": t(p["word"]), "shift": t(p["shift"]),
            "mask": t(p["mask"].astype(np.uint32).view(np.int32)),
            "bias": t(p["bias"]), "allowed": t(p["allowed"]),
            "sent_code": t(p["sent_code"]), "full": t(p["full"]),
            "W": p["W"], "PW": p["PW"]}


def rows_in_range(p, n, rng):
    """n rows whose every lane is in the plan's range (or SENTINEL where
    the lane has a sentinel code)."""
    W = p["W"]
    rows = np.zeros((n, W), np.int64)
    for i in range(W):
        if p["full"][i]:
            rows[:, i] = rng.integers(-2**31, 2**31, n)
        else:
            rows[:, i] = p["bias"][i] + rng.integers(0, p["allowed"][i] + 1, n)
            if p["sent_code"][i] >= 0:
                rows[rng.random(n) < 0.1, i] = SENT
    return rows.astype(np.int32)


def validity(pattern, n, T, rng):
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "all":
        return np.ones(n, bool)
    if pattern == "edges":
        v = np.zeros(n, bool)
        v[0::T] = True
        v[T - 1::T] = True
        v[n - 1:] = True
        return v
    return rng.random(n) < (0.18 if pattern == "sparse" else 0.5)


def keys_case(W, n, pattern, T, seed, bad=False):
    """(plan, rows [n, W], valid [n], other [n, W]: rows in range for a
    packed basis); with `bad`, one valid row of rows and one of other has
    a guarded lane out of range."""
    rng = np.random.default_rng(seed)
    p = plan(W, seed)
    rows = rows_in_range(p, n, rng)
    other = rows_in_range(p, n, rng)
    valid = validity(pattern, n, T, rng)
    rows[~valid] = SENT
    if bad and valid.any():
        guarded = np.nonzero(p["full"] == 0)[0]
        if len(guarded):
            lane = int(guarded[-1])
            hi = int(p["bias"][lane] + p["allowed"][lane]) + 3
            rows[int(np.nonzero(valid)[0][-1]), lane] = hi
            other[int(np.nonzero(valid)[0][0]), lane] = hi
    return p, rows, valid, other
