"""Wrappers of the level engine's CUDA kernels, and their plain PyTorch
twins.

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
                    of backend/bfs.py _keys_of, with fingerprint128;
                    the key basis is the stored row, the SYMMETRY
                    canonical rows (counted as keys_of_canon) or the
                    VIEW lanes (keys_of_view)
  seen_probe    K3  backend/bfs.py _lower_bound / _seen_probe; the POR
                    probe site counts as seen_probe_por
  merge_sorted  K4  backend/bfs.py _rank_merge after its sort and
                    probe (flags, compaction, rank histogram and
                    scatter; the two prefix sums stay torch calls);
                    rank_merge = LSD sort (torch.sort) + K3 + K4
  canon_rows    K5  compile/symmetry2.py build_canon2 / canon_row
  por_mask      K6  backend/bfs.py _por_mask
  hstep_epilogue K7 backend/bfs.py _hstep_core's masks and reductions
                    and the host's compaction of the valid candidates
                    in _run_host_seen
  resident_compact K8 backend/bfs.py _get_resident_run: a chunk's
                    verdict partials and the stable-sort compaction of
                    its valid grid (capped at VC), the compaction of
                    the level's explore mask (capped at FCap), and the
                    level engine's edge stream (site `edges`: the kept
                    candidates of bfs's need_edges step, uncapped)
  resident_fold  K9 backend/bfs.py _get_resident_run: one chunk folded
                    into the level's device carry, guarded by its status
  batch_epilogue K10 backend/batch.py BatchDispatcher (vmap of
                    _hstep_core): K7's epilogue for B batch members in
                    one set of launches
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
                            "keys_of_canon": 0, "keys_of_view": 0,
                            "seen_probe": 0, "seen_probe_por": 0,
                            "rank_merge": 0, "canon_rows": 0,
                            "por_mask": 0, "hstep_epilogue": 0,
                            "resident_compact": 0,
                            "resident_compact_explore": 0,
                            "resident_compact_edges": 0,
                            "resident_fold": 0, "batch_epilogue": 0}
# arms the device POR filter takes (por.cu kMaxWords * 64)
POR_MAX_ARMS = 1024


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
                 fp_mode: bool, identity: bool, basis=None,
                 basis_packed: bool = False):
    """(keys [N, K], packed [N, PW], pack_ovf scalar bool) of
    bfs._keys_of: the packed row, SENTINEL where invalid, behind a
    validity lane (0 valid, 1 invalid).  The key basis is the packed
    row itself (basis None), `basis` [N, W] packed with the same plan
    (basis_packed: the SYMMETRY canonical rows, whose range guard ORs
    into pack_ovf) or `basis` [N, Vw] raw (the VIEW lanes);
    fingerprinted to four words in fp mode."""
    no_ovf = torch.zeros(rows.shape[0], dtype=torch.bool,
                         device=rows.device)
    if identity:
        packed, povf = rows, no_ovf
    else:
        packed, povf = pack_rows_twin(rows, pt)
    pack_ovf = (povf & valid).any()
    packed = torch.where(valid[:, None], packed,
                         torch.full_like(packed, SENTINEL))
    if basis is None:
        kb = packed
    elif basis_packed:
        kb, cpovf = (basis, no_ovf) if identity else \
            pack_rows_twin(basis, pt)
        pack_ovf = pack_ovf | (cpovf & valid).any()
    else:
        kb = basis.reshape(rows.shape[0], -1)
    k = fingerprint128_twin(kb) if fp_mode else kb
    k = torch.where(valid[:, None], k, torch.full_like(k, SENTINEL))
    vlane = torch.where(valid, 0, 1).to(torch.int32)
    return torch.cat([vlane[:, None], k], dim=1), packed, pack_ovf


def keys_of(rows: torch.Tensor, valid: torch.Tensor, pt: dict,
            fp_mode: bool, identity: bool, row_ovf: bool = False,
            basis=None, basis_packed: bool = False):
    """K2: (keys [N, K], packed [N, PW], pack_ovf 0-d bool tensor), and
    with row_ovf=True the per-row pack-overflow flags [N] of the stored
    rows as a fourth output (LanePlan.pack_rows reads them; the level
    step does not).  `basis`/`basis_packed` as in keys_of_twin."""
    _check(rows, "keys_of.rows", 2)
    _check(valid, "keys_of.valid", 1, torch.bool)
    if rows.shape[1] != pt["W"] or valid.shape[0] != rows.shape[0]:
        raise ValueError(f"keys_of: rows {tuple(rows.shape)}, valid "
                         f"{tuple(valid.shape)}, plan W={pt['W']}")
    if basis is not None:
        _check(basis, "keys_of.basis", 2)
        if basis.shape[0] != rows.shape[0] or (
                basis_packed and basis.shape[1] != pt["W"]):
            raise ValueError(f"keys_of: basis {tuple(basis.shape)} for "
                             f"rows {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        out = keys_of_twin(rows, valid, pt, fp_mode, identity, basis,
                           basis_packed)
        if row_ovf:
            return out + (pack_rows_twin(rows, pt)[1] & valid,)
        return out
    _same_device("keys_of", rows, valid, pt["word"])
    from . import build
    lib = build.library("keys")
    N, PW = rows.shape[0], pt["PW"]
    if basis is None:
        kind, bw, name = 0, PW, "keys_of"
    elif basis_packed:
        kind, bw, name = 1, PW, "keys_of_canon"
    else:
        kind, bw, name = 2, basis.shape[1], "keys_of_view"
    if basis is not None:
        _same_device("keys_of", rows, basis)
    K = (4 if fp_mode else bw) + 1
    keys = torch.empty((N, K), dtype=torch.int32, device=rows.device)
    packed = torch.empty((N, PW), dtype=torch.int32, device=rows.device)
    flag = torch.empty((1,), dtype=torch.int32, device=rows.device)
    rov = torch.empty((N,), dtype=torch.bool, device=rows.device) \
        if row_ovf else None
    rc = lib.jmc_keys_of(
        _ptr(rows), _ptr(valid), _ptr(pt["word"]), _ptr(pt["shift"]),
        _ptr(pt["mask"]), _ptr(pt["bias"]), _ptr(pt["allowed"]),
        _ptr(pt["full"]), _ptr(pt["sent_code"]),
        _ptr(basis) if basis is not None else ctypes.c_void_p(0),
        _ptr(keys), _ptr(packed), _ptr(flag),
        _ptr(rov) if rov is not None else ctypes.c_void_p(0),
        ctypes.c_int64(N), ctypes.c_int(pt["W"]), ctypes.c_int(PW),
        ctypes.c_int(int(fp_mode)), ctypes.c_int(kind), ctypes.c_int(bw),
        _stream())
    _launch(name, rc)
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


def seen_probe(seen: torch.Tensor, seen_count: int, keys: torch.Tensor,
               site: str = ""):
    """K3: (found [N] bool, lb [N] int32); seen_count a host int.  A
    launch counts under seen_probe, or seen_probe_<site>."""
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
    _launch("seen_probe_" + site if site else "seen_probe", rc)
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


# ---------------------------------------------------------------------------
# K5 canon_rows
# ---------------------------------------------------------------------------

def canon_rows_twin(rows: torch.Tensor, valid: torch.Tensor, canon
                    ) -> torch.Tensor:
    """[N, W] int32: each valid row's orbit minimum (canon.twin), the
    invalid rows unchanged."""
    return torch.where(valid[:, None], canon.twin(rows), rows)


def canon_rows(rows: torch.Tensor, valid: torch.Tensor, canon
               ) -> torch.Tensor:
    """K5: canon_rows_twin's function; `canon` is the layout's
    compile/symmetry2.Canon, whose program the kernel interprets."""
    _check(rows, "canon_rows.rows", 2)
    _check(valid, "canon_rows.valid", 1, torch.bool)
    if rows.shape[1] != canon.width or valid.shape[0] != rows.shape[0]:
        raise ValueError(f"canon_rows: rows {tuple(rows.shape)}, valid "
                         f"{tuple(valid.shape)}, layout W={canon.width}")
    if rows.device.type == "cpu":
        return canon_rows_twin(rows, valid, canon)
    _same_device("canon_rows", rows, valid)
    from . import build
    lib = build.library("canon")
    prog = canon.program_on(rows.device)
    N, W = rows.shape
    out = torch.empty_like(rows)
    if N == 0:
        return out
    threads = int(lib.jmc_canon_threads(ctypes.c_int64(N)))
    scratch = torch.empty((2 * W * threads,), dtype=torch.int32,
                          device=rows.device)
    rc = lib.jmc_canon_rows(
        _ptr(rows), _ptr(valid), _ptr(prog), ctypes.c_int(prog.numel()),
        _ptr(out), _ptr(scratch), ctypes.c_int64(N), ctypes.c_int(W),
        _stream())
    _launch("canon_rows", rc)
    return out


# ---------------------------------------------------------------------------
# K6 por_mask
# ---------------------------------------------------------------------------

def por_mask_twin(found: torch.Tensor, cvalid: torch.Tensor,
                  inst_arm: torch.Tensor, arm_safe: torch.Tensor, A: int,
                  FC: int):
    """bfs._por_mask: (keep [A*FC] bool, n_ample, n_expanded, masked),
    the counts as 0-d int64 tensors.  The one-hot [n_arms, A] @ [A, FC]
    products are int64 index_add_ over the instance rows (integer
    matmul has no CUDA kernel in torch)."""
    n_arms = arm_safe.shape[0]
    dev = cvalid.device
    cv = cvalid.reshape(A, FC)
    bad = (found & cvalid).reshape(A, FC)
    ia = inst_arm.to(torch.int64)
    zero = torch.zeros((n_arms, FC), dtype=torch.int64, device=dev)
    en_cnt = zero.index_add(0, ia, cv.to(torch.int64))
    bad_cnt = zero.index_add(0, ia, bad.to(torch.int64))
    elig = arm_safe[:, None] & (en_cnt > 0) & (bad_cnt == 0)
    has = elig.any(dim=0)
    # the lowest-indexed eligible arm (the reference's argmax over bool)
    arms = torch.arange(n_arms, device=dev)[:, None]
    chosen = torch.where(elig, arms, n_arms).min(dim=0).values
    keep_inst = (~has)[None, :] | (ia[:, None] == chosen[None, :])
    keep = keep_inst.reshape(A * FC) & cvalid
    slot_en = cv.any(dim=0)
    return (keep, (has & slot_en).sum(), slot_en.sum(),
            (cvalid & ~keep).sum())


def por_mask(found: torch.Tensor, cvalid: torch.Tensor,
             inst_arm: torch.Tensor, arm_safe: torch.Tensor, A: int,
             FC: int):
    """K6: por_mask_twin's function (counts as 0-d int64 tensors)."""
    _check(found, "por_mask.found", 1, torch.bool)
    _check(cvalid, "por_mask.cvalid", 1, torch.bool)
    _check(inst_arm, "por_mask.inst_arm", 1)
    _check(arm_safe, "por_mask.arm_safe", 1, torch.bool)
    if found.shape[0] != A * FC or cvalid.shape[0] != A * FC or \
            inst_arm.shape[0] != A:
        raise ValueError(f"por_mask: found {tuple(found.shape)}, cvalid "
                         f"{tuple(cvalid.shape)}, inst_arm "
                         f"{tuple(inst_arm.shape)} for A={A} FC={FC}")
    if arm_safe.shape[0] > POR_MAX_ARMS:
        raise ValueError(f"por_mask: {arm_safe.shape[0]} arms, the "
                         f"kernel takes at most {POR_MAX_ARMS}")
    if found.device.type == "cpu":
        return por_mask_twin(found, cvalid, inst_arm, arm_safe, A, FC)
    _same_device("por_mask", found, cvalid, inst_arm, arm_safe)
    from . import build
    lib = build.library("por")
    keep = torch.empty((A * FC,), dtype=torch.bool, device=found.device)
    counts = torch.empty((3,), dtype=torch.int64, device=found.device)
    rc = lib.jmc_por_mask(
        _ptr(found), _ptr(cvalid), _ptr(inst_arm), _ptr(arm_safe),
        _ptr(keep), _ptr(counts), ctypes.c_int(A), ctypes.c_int64(FC),
        ctypes.c_int(arm_safe.shape[0]), _stream())
    _launch("por_mask", rc)
    return keep, counts[0], counts[1], counts[2]


# ---------------------------------------------------------------------------
# K7 hstep_epilogue
# ---------------------------------------------------------------------------

# scalars of hstep_epilogue, in order
HSTEP_SCALARS = ("nv", "overflow", "assert_any", "assert_flat", "dead_any",
                 "dead_f")


def hstep_epilogue_twin(en: torch.Tensor, aok: torch.Tensor,
                        ov: torch.Tensor, fcount: int, keys: torch.Tensor,
                        cand: torch.Tensor, pack_ovf, ov_pack: int,
                        inv_ok: torch.Tensor, explore: torch.Tensor) -> dict:
    """The host-seen chunk epilogue of bfs._hstep_core and
    _run_host_seen: over en, aok [A, CH] bool, ov [A, CH] int32 with
    the first `fcount` frontier slots valid, keys [A*CH, 5], cand
    [A*CH, PW], K2's pack-overflow flag and the predicate bits inv_ok
    and explore [A*CH], returns

      scalars  int64 [6]: nv (the valid candidates, = gen), the
               overflow code (the largest kernel code, else ov_pack
               when pack_ovf, else 0), assert_any, the first assert-bad
               flat index a*CH+f (np.argmax order), dead_any, the first
               dead slot;
      dead     [CH] bool;
      idx      the valid candidates' flat indices a*CH+f, ascending,
               and their fingerprint words `fps` (keys[:, 1:5]),
               packed `rows`, `inv_ok` and `explore`.

    The compacted outputs have at least nv rows; rows past nv are
    unspecified (here there are none)."""
    A, CH = en.shape
    dev = en.device
    fvalid = torch.arange(CH, device=dev) < int(fcount)
    valid = en & fvalid[None, :]
    assert_bad = (~aok) & fvalid[None, :]
    dead = fvalid & ~en.any(dim=0) if A else fvalid
    idx = torch.nonzero(valid.reshape(-1)).flatten()
    base_ov = int(torch.where(fvalid[None, :], ov, 0).max()) \
        if ov.numel() else 0
    code = base_ov if base_ov != 0 else (int(ov_pack) if bool(pack_ovf)
                                         else 0)
    ab = assert_bad.reshape(-1)
    ab_any = bool(ab.any()) if ab.numel() else False
    ab_flat = int(torch.argmax(ab.to(torch.int32))) if ab_any else 0
    dead_any = bool(dead.any())
    dead_f = int(torch.argmax(dead.to(torch.int32))) if dead_any else 0
    scalars = torch.tensor([idx.numel(), code, int(ab_any), ab_flat,
                            int(dead_any), dead_f], dtype=torch.int64,
                           device=dev)
    out = dict(scalars=scalars, dead=dead, idx=idx.to(torch.int32),
               fps=keys.index_select(0, idx)[:, 1:5],
               rows=cand.index_select(0, idx),
               inv_ok=inv_ok.index_select(0, idx),
               explore=explore.index_select(0, idx))
    return out


def hstep_epilogue(en: torch.Tensor, aok: torch.Tensor, ov: torch.Tensor,
                   fcount: int, keys: torch.Tensor, cand: torch.Tensor,
                   pack_ovf, ov_pack: int, inv_ok: torch.Tensor,
                   explore: torch.Tensor) -> dict:
    """K7: hstep_epilogue_twin's function in three launches (block
    counts and reductions, one-block scan, scatter); pack_ovf is K2's
    0-d bool tensor.  Nothing is read back to the host here."""
    _check(en, "hstep_epilogue.en", 2, torch.bool)
    _check(aok, "hstep_epilogue.aok", 2, torch.bool)
    _check(ov, "hstep_epilogue.ov", 2)
    _check(keys, "hstep_epilogue.keys", 2)
    _check(cand, "hstep_epilogue.cand", 2)
    A, CH = en.shape
    C = A * CH
    if aok.shape != en.shape or ov.shape != en.shape or \
            keys.shape != (C, 5) or cand.shape[0] != C:
        raise ValueError(f"hstep_epilogue: en {tuple(en.shape)}, aok "
                         f"{tuple(aok.shape)}, ov {tuple(ov.shape)}, keys "
                         f"{tuple(keys.shape)}, cand {tuple(cand.shape)}")
    for nm, x in (("inv_ok", inv_ok), ("explore", explore)):
        _check(x, "hstep_epilogue." + nm, 1, torch.bool)
        if x.shape[0] != C:
            raise ValueError(f"hstep_epilogue: {nm} {tuple(x.shape)} "
                             f"for {C} candidates")
    if not 0 <= int(fcount) <= CH:
        raise ValueError(f"hstep_epilogue: fcount {fcount} outside "
                         f"[0, {CH}]")
    if max(C, CH) >= 2**31 - 256:
        raise ValueError(f"hstep_epilogue: {C} candidates, the kernel's "
                         f"indices are int32")
    if en.device.type == "cpu":
        return hstep_epilogue_twin(en, aok, ov, fcount, keys, cand,
                                   pack_ovf, ov_pack, inv_ok, explore)
    if not isinstance(pack_ovf, torch.Tensor):
        pack_ovf = torch.tensor(bool(pack_ovf), device=en.device)
    pack_ovf = pack_ovf.reshape(()).to(torch.bool).contiguous()
    _same_device("hstep_epilogue", en, aok, ov, keys, cand, pack_ovf,
                 inv_ok, explore)
    from . import build
    lib = build.library("hstep")
    dev = en.device
    PW = cand.shape[1]
    threads = int(lib.jmc_hstep_threads())
    nb = max(1, -(-max(C, CH) // threads))
    part = torch.empty((5, nb), dtype=torch.int32, device=dev)
    scalars = torch.empty((6,), dtype=torch.int64, device=dev)
    dead = torch.empty((CH,), dtype=torch.bool, device=dev)
    idx = torch.empty((C,), dtype=torch.int32, device=dev)
    fps = torch.empty((C, 4), dtype=torch.int32, device=dev)
    rows = torch.empty((C, PW), dtype=torch.int32, device=dev)
    inv_out = torch.empty((C,), dtype=torch.bool, device=dev)
    exp_out = torch.empty((C,), dtype=torch.bool, device=dev)
    rc = lib.jmc_hstep_count(
        _ptr(en), _ptr(aok), _ptr(ov), _ptr(dead), _ptr(part[0]),
        _ptr(part[1]), _ptr(part[2]), _ptr(part[3]), ctypes.c_int(A),
        ctypes.c_int(CH), ctypes.c_int(int(fcount)), _stream())
    _launch("hstep_epilogue", rc)
    rc = lib.jmc_hstep_scan(
        _ptr(part[0]), _ptr(part[1]), _ptr(part[2]), _ptr(part[3]),
        _ptr(pack_ovf), _ptr(part[4]), _ptr(scalars), ctypes.c_int(nb),
        ctypes.c_int(int(ov_pack)), _stream())
    _launch("hstep_epilogue", rc)
    if C:
        rc = lib.jmc_hstep_scatter(
            _ptr(en), _ptr(keys), _ptr(cand), _ptr(inv_ok), _ptr(explore),
            _ptr(part[4]), _ptr(idx), _ptr(fps), _ptr(rows), _ptr(inv_out),
            _ptr(exp_out),
            ctypes.c_int(A), ctypes.c_int(CH), ctypes.c_int(int(fcount)),
            ctypes.c_int(PW), _stream())
        _launch("hstep_epilogue", rc)
    return dict(scalars=scalars, dead=dead, idx=idx, fps=fps, rows=rows,
                inv_ok=inv_out, explore=exp_out)


# ---------------------------------------------------------------------------
# K8 resident_compact, K9 resident_fold
# ---------------------------------------------------------------------------

# the reference's ST_* status codes (jaxmc/backend/bfs.py:58-68)
ST_CONTINUE, ST_DONE, ST_INV, ST_DEADLOCK, ST_ASSERT, ST_TRUNC = range(6)
ST_OVF_SEEN, ST_OVF_FRONT, ST_OVF_ACC, ST_OVF_VC, ST_OVF_LANES = \
    range(6, 11)
# the resident level carry, int64: these names at these positions
CARRY = ("stat", "acc_n", "gen", "ovcode", "por_ample", "por_expanded",
         "por_masked")
# scalars of resident_compact, in order
COMPACT_SCALARS = ("count", "ovmax", "assert_any", "assert_flat",
                   "dead_any", "dead_f")


def _grid(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dim() == 2 else mask.reshape(1, -1)


def resident_compact_twin(mask: torch.Tensor, cap: int, flim=None,
                          aok=None, ov=None, site: str = ""):
    """(idx [cap] int32, scalars int64 [6]) over the grid mask [A, CH]
    (the chunk site: en, with the first `flim` slots of each row valid)
    or the mask [C] (the explore site).  idx is the first `cap` entries
    of the stable partition of the valid entries (valid first, each
    part in index order): bfs's lax.sort((1 - valid, arange))[:cap].
    scalars: the valid count (uncapped), and with aok and ov [A, CH]
    the largest ov over the valid slots, assert_any, the first
    assert-bad flat index (np.argmax order), dead_any and the first
    dead slot; zeros without them.  `site` only names the kernel's
    launch counter."""
    m = _grid(mask)
    A, CH = m.shape
    dev = m.device
    flim = CH if flim is None else int(flim)
    fv = torch.arange(CH, device=dev) < flim
    valid = (m & fv[None, :]).reshape(-1)
    idx = torch.argsort((~valid).to(torch.int32), stable=True)[:cap]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ovmax = ab_any = ab_flat = dead_any = dead_f = zero
    if aok is not None:
        if A * CH:
            ovmax = torch.where(fv[None, :], ov, 0).max().to(torch.int64)
            ab = ((~aok) & fv[None, :]).reshape(-1)
            ab_any = ab.any().to(torch.int64)
            ab_flat = torch.where(ab.any(), torch.argmax(ab.to(torch.int32)),
                                  0).to(torch.int64)
        dead = fv & ~m.any(dim=0) if A else fv
        if CH:
            dead_any = dead.any().to(torch.int64)
            dead_f = torch.where(dead.any(),
                                 torch.argmax(dead.to(torch.int32)),
                                 0).to(torch.int64)
    scalars = torch.stack([valid.sum().to(torch.int64), ovmax, ab_any,
                           ab_flat, dead_any, dead_f])
    return idx.to(torch.int32), scalars


def resident_compact(mask: torch.Tensor, cap: int, flim=None, aok=None,
                     ov=None, site: str = ""):
    """K8: resident_compact_twin's function in three launches (block
    counts and reductions, one-block scan, scatter).  Nothing is read
    back to the host.  A launch counts under resident_compact, or
    resident_compact_<site>."""
    _check(mask, "resident_compact.mask", mask.dim(), torch.bool)
    if mask.dim() not in (1, 2):
        raise ValueError("resident_compact: mask is [A, CH] or [C]")
    m = _grid(mask)
    A, CH = m.shape
    C = A * CH
    flim = CH if flim is None else int(flim)
    if not 0 <= flim <= CH:
        raise ValueError(f"resident_compact: flim {flim} outside [0, {CH}]")
    if not 0 <= cap <= C:
        raise ValueError(f"resident_compact: cap {cap} outside [0, {C}]")
    if (aok is None) != (ov is None):
        raise ValueError("resident_compact: aok and ov come together")
    if aok is not None:
        _check(aok, "resident_compact.aok", 2, torch.bool)
        _check(ov, "resident_compact.ov", 2)
        if aok.shape != m.shape or ov.shape != m.shape:
            raise ValueError(f"resident_compact: aok {tuple(aok.shape)}, "
                             f"ov {tuple(ov.shape)} for {tuple(m.shape)}")
    if max(C, CH) >= 2**31 - 256:
        raise ValueError(f"resident_compact: {C} entries, the kernel's "
                         f"indices are int32")
    if m.device.type == "cpu":
        return resident_compact_twin(mask, cap, flim, aok, ov)
    name = "resident_compact_" + site if site else "resident_compact"
    if aok is not None:
        _same_device("resident_compact", m, aok, ov)
    from . import build
    lib = build.library("resident")
    dev = m.device
    threads = int(lib.jmc_res_threads())
    nb = max(1, -(-max(C, CH) // threads))
    part = torch.empty((5, nb), dtype=torch.int32, device=dev)
    scalars = torch.empty((6,), dtype=torch.int64, device=dev)
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(0)
    rc = lib.jmc_res_compact_count(
        _ptr(m), _ptr(aok) if aok is not None else null,
        _ptr(ov) if ov is not None else null, _ptr(part[0]), _ptr(part[1]),
        _ptr(part[2]), _ptr(part[3]), ctypes.c_int(A), ctypes.c_int(CH),
        ctypes.c_int(flim), _stream())
    _launch(name, rc)
    rc = lib.jmc_res_compact_scan(
        _ptr(part[0]), _ptr(part[1]), _ptr(part[2]), _ptr(part[3]),
        _ptr(part[4]), _ptr(scalars), ctypes.c_int(nb), _stream())
    _launch(name, rc)
    if C and cap:
        rc = lib.jmc_res_compact_scatter(
            _ptr(m), _ptr(part[4]), _ptr(scalars), _ptr(idx),
            ctypes.c_int(A), ctypes.c_int(CH), ctypes.c_int(flim),
            ctypes.c_int(cap), _stream())
        _launch(name, rc)
    return idx, scalars


def resident_fold_twin(carry: torch.Tensor, bad_row: torch.Tensor,
                       part: torch.Tensor, pack_ovf, por, keys_c, rows_c,
                       acc_keys, acc_rows, frontier, base: int, CH: int,
                       check_deadlock: bool, ov_pack: int) -> None:
    """bfs._get_resident_run's chunk fold (:2396-2427), in place: when
    the carry's status is ST_CONTINUE, append the VC block (keys_c
    [VC, K], rows_c [VC, PW]) to the accumulators at clamp(acc_n, 0,
    AccCap - VC), add vcnt (resident_compact's count) to acc_n, set the
    status — ST_OVF_LANES (a kernel overflow code or K2's pack flag),
    ST_OVF_VC, ST_OVF_ACC, then ASSERT or DEADLOCK with bad_row =
    frontier[base + f] — and add gen (vcnt less the POR-masked
    candidates), the overflow code and the POR deltas int64 [3] (por,
    or None).  Otherwise change nothing."""
    c = [int(x) for x in carry.tolist()]
    if c[0] != ST_CONTINUE:
        return
    p = [int(x) for x in part.tolist()]
    VC, AccCap = keys_c.shape[0], acc_keys.shape[0]
    off = min(max(c[1], 0), AccCap - VC)
    acc_keys[off:off + VC] = keys_c
    acc_rows[off:off + VC] = rows_c
    vcnt = p[0]
    acc_n = c[1] + vcnt
    d = [int(x) for x in por.tolist()] if por is not None else [0, 0, 0]
    ovcode = max(c[3], p[1])
    povf = bool(pack_ovf)
    if ovcode == 0 and povf:
        ovcode = int(ov_pack)
    if p[1] != 0 or povf:
        stat = ST_OVF_LANES
    elif vcnt > VC:
        stat = ST_OVF_VC
    elif acc_n + VC > AccCap:
        stat = ST_OVF_ACC
    else:
        stat = ST_CONTINUE
    dead_any = bool(check_deadlock) and p[4] != 0
    if stat == ST_CONTINUE and (p[2] or dead_any):
        f = p[3] % CH if p[2] else p[5]
        bad_row.copy_(frontier[base + f])
        stat = ST_ASSERT if p[2] else ST_DEADLOCK
    carry.copy_(torch.tensor([stat, acc_n, c[2] + vcnt - d[2], ovcode,
                              c[4] + d[0], c[5] + d[1], c[6] + d[2]],
                             dtype=torch.int64))


def resident_fold(carry: torch.Tensor, bad_row: torch.Tensor,
                  part: torch.Tensor, pack_ovf, por, keys_c, rows_c,
                  acc_keys, acc_rows, frontier, base: int, CH: int,
                  check_deadlock: bool, ov_pack: int) -> None:
    """K9: resident_fold_twin's function in two launches (the block
    copy, one thread per word; the scalar fold, one thread), reading
    the status from device memory: nothing is read back to the host."""
    _check(carry, "resident_fold.carry", 1, torch.int64)
    _check(bad_row, "resident_fold.bad_row", 1)
    _check(part, "resident_fold.part", 1, torch.int64)
    for nm, x in (("keys_c", keys_c), ("rows_c", rows_c),
                  ("acc_keys", acc_keys), ("acc_rows", acc_rows),
                  ("frontier", frontier)):
        _check(x, "resident_fold." + nm, 2)
    VC, K = keys_c.shape
    AccCap, PW = acc_rows.shape
    if carry.shape[0] != len(CARRY) or part.shape[0] != 6 or \
            rows_c.shape != (VC, PW) or acc_keys.shape != (AccCap, K) or \
            frontier.shape[1] != PW or bad_row.shape[0] != PW:
        raise ValueError("resident_fold: shapes disagree")
    if VC > AccCap or not 0 <= base < max(frontier.shape[0], 1) or CH <= 0:
        raise ValueError(f"resident_fold: VC {VC}, AccCap {AccCap}, base "
                         f"{base}, CH {CH}")
    if por is not None:
        _check(por, "resident_fold.por", 1, torch.int64)
        if por.shape[0] != 3:
            raise ValueError("resident_fold: por holds three counts")
    if carry.device.type == "cpu":
        return resident_fold_twin(carry, bad_row, part, pack_ovf, por,
                                  keys_c, rows_c, acc_keys, acc_rows,
                                  frontier, base, CH, check_deadlock,
                                  ov_pack)
    if not isinstance(pack_ovf, torch.Tensor):
        pack_ovf = torch.tensor(bool(pack_ovf), device=carry.device)
    pack_ovf = pack_ovf.reshape(()).to(torch.bool).contiguous()
    _same_device("resident_fold", carry, bad_row, part, pack_ovf, keys_c,
                 rows_c, acc_keys, acc_rows, frontier,
                 *([por] if por is not None else []))
    from . import build
    lib = build.library("resident")
    rc = lib.jmc_res_fold_copy(
        _ptr(carry), _ptr(keys_c), _ptr(rows_c), _ptr(acc_keys),
        _ptr(acc_rows), ctypes.c_int(VC), ctypes.c_int64(AccCap),
        ctypes.c_int(K), ctypes.c_int(PW), _stream())
    _launch("resident_fold", rc)
    rc = lib.jmc_res_fold_scalar(
        _ptr(carry), _ptr(bad_row), _ptr(part), _ptr(pack_ovf),
        _ptr(por) if por is not None else ctypes.c_void_p(0),
        _ptr(frontier), ctypes.c_int64(int(base)), ctypes.c_int(int(CH)),
        ctypes.c_int(VC), ctypes.c_int64(AccCap), ctypes.c_int(PW),
        ctypes.c_int(int(bool(check_deadlock))), ctypes.c_int(int(ov_pack)),
        _stream())
    _launch("resident_fold", rc)


# ---------------------------------------------------------------------------
# K10 batch_epilogue
# ---------------------------------------------------------------------------

def batch_epilogue_twin(en: torch.Tensor, aok: torch.Tensor,
                        ov: torch.Tensor, fcount: torch.Tensor,
                        keys: torch.Tensor, cand: torch.Tensor,
                        pack_ovf: torch.Tensor, ov_pack: int,
                        inv_ok: torch.Tensor, explore: torch.Tensor) -> dict:
    """B members' hstep_epilogue_twin, one per member: over en, aok, ov
    [B, A, CH], fcount [B] int32, keys [B*A*CH, 5], cand [B*A*CH, PW],
    pack_ovf [B] bool and inv_ok, explore [B*A*CH] (member-major
    candidates), returns

      scalars  int64 [B, 6]: each member's HSTEP_SCALARS;
      dead     [B, CH] bool;
      offsets  int64 [B + 1]: member b's compacted candidates are rows
               offsets[b] .. offsets[b+1] of
      idx      the member's own flat indices a*CH+f, ascending, with
               `fps`, `rows`, `inv_ok` and `explore` as in K7.

    Rows past offsets[B] are unspecified (here there are none)."""
    B, A, CH = en.shape
    C = A * CH
    fc = [int(x) for x in fcount.tolist()]
    outs = [hstep_epilogue_twin(
        en[b], aok[b], ov[b], fc[b], keys[b * C:(b + 1) * C],
        cand[b * C:(b + 1) * C], pack_ovf[b], ov_pack,
        inv_ok[b * C:(b + 1) * C], explore[b * C:(b + 1) * C])
        for b in range(B)]
    nv = [int(o["scalars"][0]) for o in outs]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(nv)]),
                           dtype=torch.int64, device=en.device)
    out = dict(scalars=torch.stack([o["scalars"] for o in outs]),
               dead=torch.stack([o["dead"] for o in outs]),
               offsets=offsets)
    for k in ("idx", "fps", "rows", "inv_ok", "explore"):
        out[k] = torch.cat([o[k] for o in outs])
    return out


def batch_epilogue(en: torch.Tensor, aok: torch.Tensor, ov: torch.Tensor,
                   fcount: torch.Tensor, keys: torch.Tensor,
                   cand: torch.Tensor, pack_ovf: torch.Tensor, ov_pack: int,
                   inv_ok: torch.Tensor, explore: torch.Tensor) -> dict:
    """K10: batch_epilogue_twin's function in three launches for the
    whole cohort (per-(member, block) counts and reductions, one scan
    over all of them, the scatter), with the member as the grid's y
    dimension.  Nothing is read back to the host here."""
    _check(en, "batch_epilogue.en", 3, torch.bool)
    _check(aok, "batch_epilogue.aok", 3, torch.bool)
    _check(ov, "batch_epilogue.ov", 3)
    _check(fcount, "batch_epilogue.fcount", 1)
    _check(keys, "batch_epilogue.keys", 2)
    _check(cand, "batch_epilogue.cand", 2)
    _check(pack_ovf, "batch_epilogue.pack_ovf", 1, torch.bool)
    B, A, CH = en.shape
    C = A * CH
    if aok.shape != en.shape or ov.shape != en.shape or \
            fcount.shape[0] != B or pack_ovf.shape[0] != B or \
            keys.shape != (B * C, 5) or cand.shape[0] != B * C:
        raise ValueError(f"batch_epilogue: en {tuple(en.shape)}, aok "
                         f"{tuple(aok.shape)}, ov {tuple(ov.shape)}, "
                         f"fcount {tuple(fcount.shape)}, pack_ovf "
                         f"{tuple(pack_ovf.shape)}, keys "
                         f"{tuple(keys.shape)}, cand {tuple(cand.shape)}")
    for nm, x in (("inv_ok", inv_ok), ("explore", explore)):
        _check(x, "batch_epilogue." + nm, 1, torch.bool)
        if x.shape[0] != B * C:
            raise ValueError(f"batch_epilogue: {nm} {tuple(x.shape)} "
                             f"for {B * C} candidates")
    if B < 1 or B > 65535:
        raise ValueError(f"batch_epilogue: {B} members (1..65535)")
    if max(B * C, CH) >= 2**31 - 256:
        raise ValueError(f"batch_epilogue: {B * C} candidates, the "
                         f"kernel's indices are int32")
    if en.device.type == "cpu":
        return batch_epilogue_twin(en, aok, ov, fcount, keys, cand,
                                   pack_ovf, ov_pack, inv_ok, explore)
    _same_device("batch_epilogue", en, aok, ov, fcount, keys, cand,
                 pack_ovf, inv_ok, explore)
    from . import build
    lib = build.library("batch")
    dev = en.device
    PW = cand.shape[1]
    threads = int(lib.jmc_batch_threads())
    nb = max(1, -(-max(C, CH) // threads))
    part = torch.empty((5, B * nb), dtype=torch.int32, device=dev)
    scalars = torch.empty((B, 6), dtype=torch.int64, device=dev)
    offsets = torch.empty((B + 1,), dtype=torch.int64, device=dev)
    dead = torch.empty((B, CH), dtype=torch.bool, device=dev)
    idx = torch.empty((B * C,), dtype=torch.int32, device=dev)
    fps = torch.empty((B * C, 4), dtype=torch.int32, device=dev)
    rows = torch.empty((B * C, PW), dtype=torch.int32, device=dev)
    inv_out = torch.empty((B * C,), dtype=torch.bool, device=dev)
    exp_out = torch.empty((B * C,), dtype=torch.bool, device=dev)
    rc = lib.jmc_batch_count(
        _ptr(en), _ptr(aok), _ptr(ov), _ptr(fcount), _ptr(dead),
        _ptr(part[0]), _ptr(part[1]), _ptr(part[2]), _ptr(part[3]),
        ctypes.c_int(B), ctypes.c_int(A), ctypes.c_int(CH), _stream())
    _launch("batch_epilogue", rc)
    rc = lib.jmc_batch_scan(
        _ptr(part[0]), _ptr(part[1]), _ptr(part[2]), _ptr(part[3]),
        _ptr(pack_ovf), _ptr(part[4]), _ptr(scalars), _ptr(offsets),
        ctypes.c_int(B), ctypes.c_int(nb), ctypes.c_int(int(ov_pack)),
        _stream())
    _launch("batch_epilogue", rc)
    if C:
        rc = lib.jmc_batch_scatter(
            _ptr(en), _ptr(fcount), _ptr(keys), _ptr(cand), _ptr(inv_ok),
            _ptr(explore), _ptr(part[4]), _ptr(idx), _ptr(fps), _ptr(rows),
            _ptr(inv_out), _ptr(exp_out), ctypes.c_int(B), ctypes.c_int(A),
            ctypes.c_int(CH), ctypes.c_int(PW), _stream())
        _launch("batch_epilogue", rc)
    return dict(scalars=scalars, dead=dead, offsets=offsets, idx=idx,
                fps=fps, rows=rows, inv_ok=inv_out, explore=exp_out)
