"""Wrappers of the level engine's four CUDA kernels, and their plain
PyTorch twins.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches its kernel on the current CUDA
stream and raises on a non-zero return.  It adds one to `LAUNCHES[name]`
per kernel launch and nowhere else.  A CPU tensor goes to the twin; a
CUDA tensor launches the kernel or raises — nothing falls back.

The twins are the CPU path and the kernels' parity oracle.  They do the
uint32 arithmetic of the JAX reference in int64 masked with 0xFFFFFFFF
and wrap back to int32 at the end (torch CPU implements no uint32
shifts, `scatter_add_` or `index_add_`), and they run on a CUDA tensor
too, which is how the kernels are compared with them on the card.

  unpack_rows   K1  compile/pack.py LanePlan.unpack_rows
  keys_of       K2  compile/pack.py LanePlan.pack_rows + the key build
                    of backend/bfs.py _keys_of, with fingerprint128
  seen_probe    K3  backend/bfs.py _lower_bound / _seen_probe
  merge_sorted  K4  backend/bfs.py _rank_merge after its sort and
                    probe (flags, compaction, rank histogram and
                    scatter; the two prefix sums stay torch calls);
                    rank_merge = LSD sort (torch.sort) + K3 + K4
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

SENTINEL = 2**31 - 1
M32 = 0xFFFFFFFF

FP_MIX = [(0x9E3779B1, 0x85EBCA6B), (0xC2B2AE35, 0x27D4EB2F),
          (0x165667B1, 0x9E3779B1), (0x85EBCA6B, 0xC2B2AE35)]

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"unpack_rows": 0, "keys_of": 0,
                            "seen_probe": 0, "rank_merge": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# uint32 helpers for the twins (int64 carriers)
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits as their uint32 value, in int64."""
    return x.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor, as int32 (two's complement)."""
    x = x & M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for a in [0, 2**32), exact in int64: m splits
    into 16-bit halves so no product exceeds 2**48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def fingerprint128_twin(rows: torch.Tensor) -> torch.Tensor:
    """rows [N, W] int32 -> [N, 4] int32: the four FNV-seeded
    multiply-xor mixes and avalanche of bfs.fingerprint128."""
    u = _u32(rows)
    out = []
    for j, (m1, m2) in enumerate(FP_MIX):
        h = torch.full((rows.shape[0],),
                       (2166136261 + j * 0x9E3779B1) & M32,
                       dtype=torch.int64, device=rows.device)
        for i in range(rows.shape[1]):
            h = _mul32(h ^ _mul32(u[:, i], m1), m2)
        h = h ^ (h >> 15)
        h = _mul32(h, 0x2C1B3C6D)
        h = h ^ (h >> 12)
        out.append(_i32(h))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# K1 unpack_rows
# ---------------------------------------------------------------------------

def unpack_rows_twin(packed: torch.Tensor, pt: dict) -> torch.Tensor:
    """[N, PW] int32 -> [N, W] int32: word gather, shift and mask, bias,
    sign restore on full lanes, SENTINEL code mapped to SENTINEL."""
    word = pt["word"].to(torch.int64)
    w = _u32(packed)[:, word]
    raw = (w >> pt["shift"].to(torch.int64)[None, :]) & \
        _u32(pt["mask"])[None, :]
    v = _i32(raw)
    full = pt["full"][None, :] != 0
    out = torch.where(full, v, _i32(v.to(torch.int64)
                                    + pt["bias"][None, :]))
    sc = pt["sent_code"][None, :]
    sent = (sc >= 0) & (v == sc)
    return torch.where(sent, torch.full_like(out, SENTINEL), out)


def _check(x: torch.Tensor, name: str, ndim: int, dtype=torch.int32):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(name: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError "
                           f"{rc} (cudaGetLastError after the launch)")
    LAUNCHES[name] += 1


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def unpack_rows(packed: torch.Tensor, pt: dict) -> torch.Tensor:
    """K1: [N, PW] int32 -> [N, W] int32 (see unpack_rows_twin)."""
    _check(packed, "unpack_rows.packed", 2)
    if packed.shape[1] != pt["PW"]:
        raise ValueError(f"unpack_rows: {packed.shape[1]} words, plan "
                         f"has {pt['PW']}")
    if packed.device.type == "cpu":
        return unpack_rows_twin(packed, pt)
    _same_device("unpack_rows", packed, pt["word"])
    from . import build
    lib = build.library("unpack")
    N, W = packed.shape[0], pt["W"]
    out = torch.empty((N, W), dtype=torch.int32, device=packed.device)
    if N == 0 or W == 0:
        return out
    rc = lib.jmc_unpack_rows(
        _ptr(packed), _ptr(pt["word"]), _ptr(pt["shift"]),
        _ptr(pt["mask"]), _ptr(pt["bias"]), _ptr(pt["full"]),
        _ptr(pt["sent_code"]), _ptr(out), ctypes.c_int64(N),
        ctypes.c_int(pt["PW"]), ctypes.c_int(W), _stream())
    _launch("unpack_rows", rc)
    return out


# ---------------------------------------------------------------------------
# K2 keys_of (pack_rows + SENTINEL fill + fingerprint + validity lane)
# ---------------------------------------------------------------------------

def pack_rows_twin(rows: torch.Tensor, pt: dict
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, W] int32 -> (packed [N, PW] int32, ovf [N] bool): bias, range
    guard, sentinel code, shift into word, OR of disjoint fields."""
    r64 = rows.to(torch.int64)
    sc = pt["sent_code"].to(torch.int64)[None, :]
    sent = (sc >= 0) & (r64 == SENTINEL)
    code = torch.where(sent, sc.clamp(min=0).expand_as(r64),
                       _i32(r64 - pt["bias"].to(torch.int64)[None, :])
                       .to(torch.int64))
    full = pt["full"][None, :] != 0
    allowed = pt["allowed"].to(torch.int64)[None, :]
    bad = (~full) & ((code < 0) | (code > allowed))
    ovf = bad.any(dim=1)
    code_u = torch.where(full, r64 & M32, code & M32)
    shifted = ((code_u & _u32(pt["mask"])[None, :])
               << pt["shift"].to(torch.int64)[None, :]) & M32
    word = pt["word"].cpu().numpy()
    cols = []
    for p in range(pt["PW"]):
        lanes = np.nonzero(word == p)[0]
        # fields of one word are disjoint bit ranges: their sum is
        # their OR, and stays below 2**32
        cols.append(shifted[:, lanes].sum(dim=1) if len(lanes) else
                    torch.zeros(rows.shape[0], dtype=torch.int64,
                                device=rows.device))
    packed = torch.stack(cols, dim=1) if cols else \
        torch.zeros((rows.shape[0], 0), dtype=torch.int64,
                    device=rows.device)
    return _i32(packed), ovf


def keys_of_twin(rows: torch.Tensor, valid: torch.Tensor, pt: dict,
                 fp_mode: bool, identity: bool):
    """(keys [N, K], packed [N, PW], pack_ovf scalar bool) of
    bfs._keys_of without SYMMETRY or VIEW: the packed row, SENTINEL
    where invalid, fingerprinted to four words in fp mode, behind a
    validity lane (0 valid, 1 invalid)."""
    if identity:
        packed = rows
        povf = torch.zeros(rows.shape[0], dtype=torch.bool,
                           device=rows.device)
    else:
        packed, povf = pack_rows_twin(rows, pt)
    pack_ovf = (povf & valid).any()
    packed = torch.where(valid[:, None], packed,
                         torch.full_like(packed, SENTINEL))
    k = fingerprint128_twin(packed) if fp_mode else packed
    k = torch.where(valid[:, None], k, torch.full_like(k, SENTINEL))
    vlane = torch.where(valid, 0, 1).to(torch.int32)
    return torch.cat([vlane[:, None], k], dim=1), packed, pack_ovf


def keys_of(rows: torch.Tensor, valid: torch.Tensor, pt: dict,
            fp_mode: bool, identity: bool, row_ovf: bool = False):
    """K2: (keys [N, K], packed [N, PW], pack_ovf 0-d bool tensor), and
    with row_ovf=True the per-row pack-overflow flags [N] as a fourth
    output (LanePlan.pack_rows reads them; the level step does not)."""
    _check(rows, "keys_of.rows", 2)
    _check(valid, "keys_of.valid", 1, torch.bool)
    if rows.shape[1] != pt["W"] or valid.shape[0] != rows.shape[0]:
        raise ValueError(f"keys_of: rows {tuple(rows.shape)}, valid "
                         f"{tuple(valid.shape)}, plan W={pt['W']}")
    if rows.device.type == "cpu":
        if row_ovf:
            packed, povf = pack_rows_twin(rows, pt)
            k, p, o = keys_of_twin(rows, valid, pt, fp_mode, identity)
            return k, p, o, povf & valid
        return keys_of_twin(rows, valid, pt, fp_mode, identity)
    _same_device("keys_of", rows, valid, pt["word"])
    from . import build
    lib = build.library("keys")
    N, PW = rows.shape[0], pt["PW"]
    K = (4 if fp_mode else PW) + 1
    keys = torch.empty((N, K), dtype=torch.int32, device=rows.device)
    packed = torch.empty((N, PW), dtype=torch.int32, device=rows.device)
    flag = torch.empty((1,), dtype=torch.int32, device=rows.device)
    rov = torch.empty((N,), dtype=torch.bool, device=rows.device) \
        if row_ovf else None
    rc = lib.jmc_keys_of(
        _ptr(rows), _ptr(valid), _ptr(pt["word"]), _ptr(pt["shift"]),
        _ptr(pt["mask"]), _ptr(pt["bias"]), _ptr(pt["allowed"]),
        _ptr(pt["full"]), _ptr(pt["sent_code"]), _ptr(keys),
        _ptr(packed), _ptr(flag),
        _ptr(rov) if rov is not None else ctypes.c_void_p(0),
        ctypes.c_int64(N), ctypes.c_int(pt["W"]), ctypes.c_int(PW),
        ctypes.c_int(int(fp_mode)), _stream())
    _launch("keys_of", rc)
    if row_ovf:
        return keys, packed, flag[0] != 0, rov
    return keys, packed, flag[0] != 0


# ---------------------------------------------------------------------------
# K3 seen_probe
# ---------------------------------------------------------------------------

def _probe_iters(cap: int) -> int:
    return max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)


def seen_probe_twin(seen: torch.Tensor, seen_count, keys: torch.Tensor):
    """(found [N] bool, lb [N] int32): lexicographic lower bound of each
    key's K-1 data words in the sorted prefix seen[0:seen_count), by a
    fixed-trip binary search (bfs._lower_bound), and equality at lb."""
    SC = seen.shape[0]
    n = keys.shape[0]
    words = keys[:, 1:]
    swords = seen[:, 1:]
    dev = keys.device
    cnt = torch.as_tensor(seen_count, dtype=torch.int32, device=dev)
    lo = torch.zeros(n, dtype=torch.int32, device=dev)
    hi = cnt.expand(n).clone()
    for _ in range(_probe_iters(SC)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        row = swords[mid.clamp(0, SC - 1).to(torch.int64)]
        lt = torch.zeros(n, dtype=torch.bool, device=dev)
        gt = torch.zeros(n, dtype=torch.bool, device=dev)
        for j in range(swords.shape[1]):
            undec = ~(lt | gt)
            lt = lt | (undec & (row[:, j] < words[:, j]))
            gt = gt | (undec & (row[:, j] > words[:, j]))
        go = lo < hi
        lo = torch.where(go & lt, mid + 1, lo)
        hi = torch.where(go & ~lt, mid, hi)
    at_lb = swords[lo.clamp(0, SC - 1).to(torch.int64)]
    found = (lo < cnt) & (at_lb == words).all(dim=1)
    return found, lo


def seen_probe(seen: torch.Tensor, seen_count: int, keys: torch.Tensor):
    """K3: (found [N] bool, lb [N] int32); seen_count a host int."""
    _check(seen, "seen_probe.seen", 2)
    _check(keys, "seen_probe.keys", 2)
    if seen.shape[1] != keys.shape[1]:
        raise ValueError("seen_probe: key widths differ")
    if not 0 <= int(seen_count) <= seen.shape[0]:
        raise ValueError(f"seen_probe: count {seen_count} outside "
                         f"[0, {seen.shape[0]}]")
    if keys.device.type == "cpu":
        return seen_probe_twin(seen, seen_count, keys)
    _same_device("seen_probe", seen, keys)
    from . import build
    lib = build.library("probe")
    N = keys.shape[0]
    found = torch.empty((N,), dtype=torch.bool, device=keys.device)
    lb = torch.empty((N,), dtype=torch.int32, device=keys.device)
    if N == 0:
        return found, lb
    rc = lib.jmc_seen_probe(
        _ptr(seen), _ptr(keys), _ptr(found), _ptr(lb),
        ctypes.c_int64(int(seen_count)), ctypes.c_int64(N),
        ctypes.c_int(keys.shape[1]), _stream())
    _launch("seen_probe", rc)
    return found, lb


# ---------------------------------------------------------------------------
# K4 rank_merge
# ---------------------------------------------------------------------------

def lsd_sort(keys: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts key rows lexicographically (signed int32
    words, column 0 most significant), stably: one stable single-key
    sort per column, least significant first — lax.sort(num_keys=K,
    is_stable=True) of the reference."""
    perm = torch.arange(keys.shape[0], device=keys.device)
    for j in range(keys.shape[1] - 1, -1, -1):
        o = torch.sort(keys[perm, j], stable=True).indices
        perm = perm[o]
    return perm


def _sort_keys(keys: torch.Tensor):
    """(sorted keys, their original row indices as int32)."""
    perm = lsd_sort(keys)
    return keys[perm].contiguous(), perm.to(torch.int32)


def merge_sorted_twin(seen: torch.Tensor, seen_count: int,
                      skeys: torch.Tensor, sidx: torch.Tensor,
                      found: torch.Tensor, lb: torch.Tensor) -> dict:
    """The body of bfs._rank_merge after its sort and probe: over the
    sorted candidate keys skeys (original indices sidx) and their probe
    (found, lb), flag the new keys (valid, not found, not equal to the
    previous key), compact their indices to nk_sidx, and scatter seen
    rows and new keys at their ranks into a fresh table.

    Returns new_count (0-d int32 tensor), nk_sidx [N] int32, seen2
    [SC, K] int32 and seen_count2 (0-d int32 tensor)."""
    SC, K = seen.shape
    N = skeys.shape[0]
    dev = skeys.device
    svalid = skeys[:, 0] == 0
    neq_prev = torch.ones(N, dtype=torch.bool, device=dev)
    if N > 1:
        neq_prev[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
    new = svalid & ~found & neq_prev
    npos = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32)
    new_count = npos[-1] if N else torch.zeros((), dtype=torch.int32,
                                               device=dev)
    sel = torch.nonzero(new).flatten()          # sorted positions, in order
    nk_sidx = torch.zeros(N, dtype=torch.int32, device=dev)
    nk_sidx[:len(sel)] = sidx[sel]
    nk_lb = lb[sel].to(torch.int64)
    hist = torch.bincount(nk_lb.clamp(0, SC), minlength=SC + 1)[:SC + 1]
    ranks = torch.cumsum(hist[:SC], 0)
    seen2 = torch.full((SC, K), SENTINEL, dtype=torch.int32, device=dev)
    seen2[:, 0] = 1
    i = torch.arange(int(seen_count), device=dev)
    pos_s = i + ranks[:int(seen_count)]
    ok = pos_s < SC
    seen2[pos_s[ok]] = seen[:int(seen_count)][ok]
    pos_n = nk_lb + torch.arange(len(sel), device=dev)
    ok = pos_n < SC
    seen2[pos_n[ok]] = skeys[sel][ok]
    return dict(new_count=new_count, nk_sidx=nk_sidx, seen2=seen2,
                seen_count2=new_count + int(seen_count))


def merge_sorted(seen: torch.Tensor, seen_count: int, skeys: torch.Tensor,
                 sidx: torch.Tensor, found: torch.Tensor,
                 lb: torch.Tensor) -> dict:
    """K4: merge_sorted_twin's function in three launches, with the two
    prefix sums as torch.cumsum between them."""
    _check(seen, "merge_sorted.seen", 2)
    _check(skeys, "merge_sorted.skeys", 2)
    _check(sidx, "merge_sorted.sidx", 1)
    _check(found, "merge_sorted.found", 1, torch.bool)
    _check(lb, "merge_sorted.lb", 1)
    SC, K = seen.shape
    N = skeys.shape[0]
    if skeys.shape[1] != K or not (sidx.shape[0] == found.shape[0]
                                   == lb.shape[0] == N):
        raise ValueError("merge_sorted: shapes disagree")
    if not 0 <= int(seen_count) <= SC:
        raise ValueError(f"merge_sorted: count {seen_count} outside "
                         f"[0, {SC}]")
    if skeys.device.type == "cpu":
        return merge_sorted_twin(seen, seen_count, skeys, sidx, found, lb)
    _same_device("merge_sorted", seen, skeys, sidx, found, lb)
    from . import build
    lib = build.library("merge")
    dev = skeys.device
    flags = torch.empty((N,), dtype=torch.int32, device=dev)
    nk_sidx = torch.empty((N,), dtype=torch.int32, device=dev)
    hist = torch.empty((SC + 1,), dtype=torch.int32, device=dev)
    seen2 = torch.empty((SC, K), dtype=torch.int32, device=dev)
    rc = lib.jmc_merge_flags(
        _ptr(skeys), _ptr(found), _ptr(flags), _ptr(nk_sidx), _ptr(hist),
        ctypes.c_int64(N), ctypes.c_int64(SC), ctypes.c_int(K), _stream())
    _launch("rank_merge", rc)
    npos = torch.cumsum(flags, 0, dtype=torch.int32)
    rc = lib.jmc_merge_compact(
        _ptr(flags), _ptr(npos), _ptr(sidx), _ptr(lb), _ptr(nk_sidx),
        _ptr(hist), ctypes.c_int64(N), ctypes.c_int64(SC), _stream())
    _launch("rank_merge", rc)
    ranks = torch.cumsum(hist, 0, dtype=torch.int32)
    rc = lib.jmc_merge_scatter(
        _ptr(seen), _ptr(skeys), _ptr(flags), _ptr(npos), _ptr(lb),
        _ptr(ranks), _ptr(seen2), ctypes.c_int64(int(seen_count)),
        ctypes.c_int64(N), ctypes.c_int64(SC), ctypes.c_int(K), _stream())
    _launch("rank_merge", rc)
    new_count = npos[-1] if N else torch.zeros((), dtype=torch.int32,
                                               device=dev)
    return dict(new_count=new_count, nk_sidx=nk_sidx, seen2=seen2,
                seen_count2=new_count + int(seen_count))


def rank_merge_twin(seen: torch.Tensor, seen_count: int,
                    keys: torch.Tensor) -> dict:
    """bfs._rank_merge(multikey=True) with the twins: sort the
    candidate keys, probe them against the sorted seen prefix, then
    merge_sorted_twin."""
    skeys, sidx = _sort_keys(keys)
    found, lb = seen_probe_twin(seen, seen_count, skeys)
    return merge_sorted_twin(seen, seen_count, skeys, sidx, found, lb)


def rank_merge(seen: torch.Tensor, seen_count: int,
               keys: torch.Tensor) -> dict:
    """bfs._rank_merge(multikey=True) on the kernels: the LSD sort
    (torch.sort), K3 for the probe, K4 for the merge."""
    _check(seen, "rank_merge.seen", 2)
    _check(keys, "rank_merge.keys", 2)
    if keys.shape[1] != seen.shape[1]:
        raise ValueError("rank_merge: key widths differ")
    if not 0 <= int(seen_count) <= seen.shape[0]:
        raise ValueError(f"rank_merge: count {seen_count} outside "
                         f"[0, {seen.shape[0]}]")
    skeys, sidx = _sort_keys(keys)
    found, lb = seen_probe(seen, seen_count, skeys)
    return merge_sorted(seen, seen_count, skeys, sidx, found, lb)
