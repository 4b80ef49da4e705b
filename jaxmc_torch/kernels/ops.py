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
                    scatter, in two launches with no prefix sum
                    between them); rank_merge = K18 + K3 + K4
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
  fullsort_dedup K11 backend/bfs.py _get_step's full-sort branch
                    (JAXMC_LEVEL_RANKMERGE=0) after its sort: the
                    first-of-run new mask and the two stable
                    compactions (new candidate indices, merged seen
                    table)
  oracle_probe  K12 backend/oracle.py `probe` after its sort: the rank
                    scatter, the 14-step lower bound and the wrapped
                    int32 checksum of the preflight probe
  mesh_route    K13 backend/mesh.py _route_fn: the a2a exchange's
                    owner buckets and spill buckets (counted as
                    mesh_route), or the gather exchange's ownership
                    mask (mesh_route_gather)
  mesh_scalars  K14 backend/mesh.py _mk_level_tail's psum / pmax /
                    pmin: the replicated scalar vector and the
                    localization vectors from the shards' partials
  gen_expand    K15 compile/kernel2.py compile_action2 under
                    backend/bfs.py _expand's vmap: every grounded
                    instance (slot by slot) over a row block, written
                    as CUDA C++ per engine by compile/cgen.py
  gen_pred      K16 compile/kernel2.py compile_predicate2: one
                    invariant or constraint over a row block
  gen_value     K17 compile/kernel2.py compile_value2: the VIEW lanes
  sort_keys     K18 backend/bfs.py _lsd_sort / the lax.sort of
                    _rank_merge, the full-sort step, the mesh's
                    full-sort merge and oracle.py's probe: a stable
                    K-word radix sort with its row-index payload; its
                    front_order site is the level step's next-frontier
                    order (bfs.py:1879-1883)

K15-K17 are generated, not written in csrc/: their twins are the
emitter calls the engine makes without them (compile/kernel2.py over
compile/lanes.py), with the lifted constants bound from the same
`cvals` the kernel reads.
"""

from __future__ import annotations

import ctypes
import threading
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
                            "resident_fold": 0, "batch_epilogue": 0,
                            "fullsort_dedup": 0, "oracle_probe": 0,
                            "resident_compact_mesh_block": 0,
                            "resident_compact_mesh_vc": 0,
                            "resident_compact_mesh_front": 0,
                            "mesh_route": 0, "mesh_route_gather": 0,
                            "mesh_scalars": 0, "gen_expand": 0,
                            "gen_pred": 0, "gen_value": 0,
                            "sort_keys": 0, "front_order": 0}
# arms the device POR filter takes (por.cu kMaxWords * 64)
POR_MAX_ARMS = 1024
# a kernel library's tile size, read from it once
_TILES: Dict[str, int] = {}


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


def _launch(name: str, rc: int, n: int = 1) -> None:
    """Count the n kernels one C entry point launched, or raise."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError "
                           f"{rc} (cudaGetLastError after the launch)")
    LAUNCHES[name] += n


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _ok(x, dtype, ndim: int) -> bool:
    """What _check demands, as one test (the wrappers whose host work
    is most of a call run _check only when this fails, for its error)."""
    return isinstance(x, torch.Tensor) and x.dtype is dtype and \
        x.dim() == ndim and x.is_contiguous()


def _raw_stream(index: int) -> int:
    """The current stream of card `index`, as the int a launch takes."""
    return torch._C._cuda_getCurrentRawStream(index)


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


# K2's shared memory: what a block aims at (the most a block can have
# on the card is SMEM_MAX, below)
KEYS_SMEM = 48 * 1024
# K2's geometry for each (W, PW, K, bw, kind, budget, fp)
_KEYS_GEOM: Dict[tuple, Tuple[int, int, int, int]] = {}
# K2's geometries, best first: (warps a block, rows a warp's tile, listed
# rows a pass); passes of 64 rows for a stored or raw key basis in exact
# keys, of 32 where a row's walk is longer (a canonical basis, fp128),
# as measured on the card (kernel_turns.py GEOMETRIES)
KEYS_SHAPES = ((8, 128, 32), (4, 128, 32), (2, 128, 32), (1, 128, 32),
               (1, 64, 32), (1, 32, 32), (1, 32, 16), (1, 32, 8),
               (1, 32, 4), (1, 32, 2), (1, 32, 1))
KEYS_SHAPES_64 = ((8, 128, 64),) + KEYS_SHAPES


def _pad4(x: int) -> int:
    return (x + 3) & ~3


def keys_smem(W: int, PW: int, K: int, bw: int, kind: int, warps: int,
              RW: int, P: int) -> int:
    """K2's shared bytes a block (keys.cu's layout, in words, each part
    from a 16-byte boundary): the plan (an int4 a lane, then the
    sentinel codes), then each warp's list of valid rows and flag bytes
    (RW bytes each), the lanes of P listed rows at stride W | 1 and
    their basis lanes at stride (W or bw) | 1 when the basis is not the
    stored row (kind 1 or 2), each with 3 words of room, and the tile's
    staged key and packed rows with 3 words of room for their 16-byte
    phase."""
    bl = 0 if kind == 0 else (bw if kind == 2 else W) | 1
    warp = (2 * _pad4(-(-RW // 4)) + _pad4(P * (W | 1) + 3)
            + (_pad4(P * bl + 3) if bl else 0)
            + _pad4(RW * K + 3) + _pad4(RW * PW + 3))
    return 4 * (4 * W + _pad4(W) + warps * warp)


def keys_geometry(W: int, PW: int, K: int, bw: int, kind: int,
                  budget=None, fp: bool = False) -> Tuple[int, int, int, int]:
    """(warps a block, rows a warp's tile RW, listed rows a pass P,
    shared bytes) of a K2 launch: the first of KEYS_SHAPES_64 (exact
    keys over the stored row or raw lanes) or KEYS_SHAPES (fp128, a
    canonical basis) whose shared memory fits `budget` (KEYS_SMEM),
    else SMEM_MAX; a row too wide for that raises."""
    if budget is None:
        budget = KEYS_SMEM
    shapes = KEYS_SHAPES if kind == 1 or fp else KEYS_SHAPES_64
    for b in (budget, max(budget, SMEM_MAX - 1024)):
        for warps, RW, P in shapes:
            smem = keys_smem(W, PW, K, bw, kind, warps, RW, P)
            if smem <= b:
                return warps, RW, P, smem
    raise ValueError(f"keys_of: a row of {W} lanes (basis {bw}) needs "
                     f"{keys_smem(W, PW, K, bw, kind, 1, 32, 1)} bytes of "
                     f"shared memory, more than a block's {SMEM_MAX}")


def _a16(x: int) -> int:
    return (x + 15) & ~15


class _ZeroWords:
    """Device words that are zero between calls, one block for each
    (device, stream): word 0 is K2's overflow accumulator and done count
    (two uint32), word 1 K4's ticket, words 2 .. 2 + tiles K4's tile
    status words.  Each kernel leaves the words it used at zero (K2's
    last block; K4's last tile and its second launch), so nothing is
    cleared between calls and a call keeps no state: it can be captured
    in a CUDA graph and replayed.  A block is made with zeros at its
    stream's first call, and again, twice as large, when K4 needs more
    tiles; the old one is kept, since a captured graph may hold its
    address.  Under capture nothing is made: a stream is warmed by one
    call first.  K4 holds `lock` while it enqueues its two launches, so
    calls from several threads on one stream do not interleave them."""

    def __init__(self):
        self._by_key: Dict[tuple, torch.Tensor] = {}
        self._old = []
        self.lock = threading.RLock()

    def take(self, device: torch.device, index: int, tiles: int) -> int:
        """The block's address for a call on `device` (card `index`) and
        its current stream with `tiles` status words."""
        key = (index, _raw_stream(index))
        ws = self._by_key.get(key)
        if ws is None or ws.numel() < 2 + tiles:
            with self.lock:
                ws = self._grow(device, key, tiles)
        return ws.data_ptr()

    def _grow(self, device, key, tiles):
        ws = self._by_key.get(key)
        if ws is not None and ws.numel() >= 2 + tiles:
            return ws
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("keys_of / merge_sorted: warm this stream "
                               "with one call of the same size before "
                               "capturing it in a CUDA graph (their zero "
                               "words are made outside capture)")
        if ws is not None:
            self._old.append(ws)
        cap = max(2 + tiles, 2 * ws.numel() if ws is not None else 64)
        ws = torch.zeros((cap,), dtype=torch.int64, device=device)
        self._by_key[key] = ws
        return ws

    def drop(self, index: int) -> None:
        """Forget the current stream's block (after a failed launch,
        whose words may not be zero)."""
        self._by_key.pop((index, _raw_stream(index)), None)


_ZERO_WORDS = _ZeroWords()


def keys_of(rows: torch.Tensor, valid: torch.Tensor, pt: dict,
            fp_mode: bool, identity: bool, row_ovf: bool = False,
            basis=None, basis_packed: bool = False):
    """K2: (keys [N, K], packed [N, PW], pack_ovf 0-d bool tensor), and
    with row_ovf=True the per-row pack-overflow flags [N] of the stored
    rows as a fourth output (LanePlan.pack_rows reads them; the level
    step does not).  `basis`/`basis_packed` as in keys_of_twin.  One
    launch a call, counted under keys_of, keys_of_canon (a packed
    basis) or keys_of_view (a raw basis); the outputs are views of one
    allocation, the kernel writes pack_ovf itself.  The checks run
    once, on a path kept short: at small sizes the host's work is most
    of a call."""
    if not (_ok(rows, torch.int32, 2) and _ok(valid, torch.bool, 1)):
        _check(rows, "keys_of.rows", 2)
        _check(valid, "keys_of.valid", 1, torch.bool)
    N, W = rows.shape
    if W != pt["W"] or valid.shape[0] != N:
        raise ValueError(f"keys_of: rows {tuple(rows.shape)}, valid "
                         f"{tuple(valid.shape)}, plan W={pt['W']}")
    if basis is not None:
        if not _ok(basis, torch.int32, 2):
            _check(basis, "keys_of.basis", 2)
        if basis.shape[0] != N or (basis_packed and basis.shape[1] != W):
            raise ValueError(f"keys_of: basis {tuple(basis.shape)} for "
                             f"rows {tuple(rows.shape)}")
    if rows.is_cpu:
        out = keys_of_twin(rows, valid, pt, fp_mode, identity, basis,
                           basis_packed)
        if row_ovf:
            return out + (pack_rows_twin(rows, pt)[1] & valid,)
        return out
    dev = rows.get_device()
    if not (valid.get_device() == pt["word"].get_device() == dev and
            (basis is None or basis.get_device() == dev)):
        _same_device("keys_of", rows, valid, pt["word"],
                     *(() if basis is None else (basis,)))
    PW = pt["PW"]
    if basis is None:
        kind, bw, name = 0, PW, "keys_of"
    elif basis_packed:
        kind, bw, name = 1, PW, "keys_of_canon"
    else:
        kind, bw, name = 2, basis.shape[1], "keys_of_view"
    K = (4 if fp_mode else bw) + 1
    gk = (W, PW, K, bw, kind, KEYS_SMEM, bool(fp_mode))
    geom = _KEYS_GEOM.get(gk)
    if geom is None:
        geom = _KEYS_GEOM[gk] = keys_geometry(W, PW, K, bw, kind,
                                              fp=bool(fp_mode))
    # keys, packed (each from a 16-byte boundary), the flag, row_ovf
    nk, npk = N * K * 4, N * PW * 4
    o_p = _a16(nk)
    o_f = _a16(o_p + npk)
    buf = torch.empty((o_f + 1 + (N if row_ovf else 0),), dtype=torch.uint8,
                      device=rows.device)
    keys = buf[:nk].view(torch.int32).view(N, K)
    packed = buf[o_p:o_p + npk].view(torch.int32).view(N, PW)
    flags = buf[o_f:].view(torch.bool)
    from . import build
    rc = build.library("keys").jmc_keys_of(
        rows.data_ptr(), valid.data_ptr(), pt["word"].data_ptr(),
        pt["shift"].data_ptr(), pt["mask"].data_ptr(),
        pt["bias"].data_ptr(), pt["allowed"].data_ptr(),
        pt["full"].data_ptr(), pt["sent_code"].data_ptr(),
        basis.data_ptr() if basis is not None else None, keys.data_ptr(),
        packed.data_ptr(), flags.data_ptr(),
        flags.data_ptr() + 1 if row_ovf else None,
        _ZERO_WORDS.take(rows.device, dev, 0), N, W, PW, int(fp_mode),
        kind, bw, *geom, _raw_stream(dev))
    _launch(name, rc)
    if row_ovf:
        return keys, packed, flags[0], flags[1:]
    return keys, packed, flags[0]


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
    """K3: (found [N] bool, lb [N] int32); seen_count a host int.  One
    launch a call, counted under seen_probe, or seen_probe_<site>;
    found and lb are views of one allocation of N * 5 bytes.  The rank
    sites (no site) probe sorted keys and take the tiled search; a site
    (the POR sites probe keys in candidate order) takes the search of
    one thread a query.  Either is right for keys in any order.  The
    checks run once, on a path kept short: at a level's sizes the
    host's work is most of a call."""
    if not (_ok(seen, torch.int32, 2) and _ok(keys, torch.int32, 2)):
        _check(seen, "seen_probe.seen", 2)
        _check(keys, "seen_probe.keys", 2)
    SC, K = seen.shape
    N = keys.shape[0]
    count = int(seen_count)
    if keys.shape[1] != K:
        raise ValueError("seen_probe: key widths differ")
    if not 0 <= count <= SC:
        raise ValueError(f"seen_probe: count {seen_count} outside "
                         f"[0, {SC}]")
    if keys.is_cpu:
        return seen_probe_twin(seen, count, keys)
    dev = keys.get_device()
    if seen.get_device() != dev:
        _same_device("seen_probe", seen, keys)
    if SC >= 2**31:
        raise ValueError(f"seen_probe: {SC} seen rows, the kernel's "
                         f"indices are int32")
    lb, found = torch.empty((N * 5,), dtype=torch.uint8,
                            device=keys.device).split_with_sizes([N * 4, N])
    lb, found = lb.view(torch.int32), found.view(torch.bool)
    if N:
        from . import build
        rc = build.library("probe").jmc_seen_probe(
            seen.data_ptr(), keys.data_ptr(), found.data_ptr(),
            lb.data_ptr(), count, N, K, 0 if site else 1, _raw_stream(dev))
        _launch("seen_probe_" + site if site else "seen_probe", rc)
    return found, lb


# ---------------------------------------------------------------------------
# K18 sort_keys and its front_order site
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


def sort_keys_twin(keys: torch.Tensor):
    """(skeys [N, K], sidx [N] int32): the rows of keys in lexicographic
    order (signed int32 words, word 0 most significant), equal rows in
    index order, and each sorted row's index: lax.sort(cols +
    (arange,), num_keys=K, is_stable=True) of the reference, as the
    lsd_sort chain and one gather."""
    perm = lsd_sort(keys)
    return keys[perm].contiguous(), perm.to(torch.int32)


# the most rows K18 takes (its status words count in 30 bits) and the
# most key words (4 KB of upsweep histograms a word in one block's
# shared memory: (SMEM_MAX - 1024) // 4096)
SORT_MAX_N = 2**30
SORT_MAX_K = 56


def _sort_run(name: str, device: torch.device, n: int, k: int, np_: int,
              sidx: torch.Tensor, mode: int, keys=None, skeys=None,
              explore=None, prov=None, a: int = 1, fc: int = 1,
              bits: int = 0) -> None:
    """One K18 call (sort.cu jmc_sort_keys: np_ digit positions, np_ + 2
    launches, counted under `name`): its word columns and tail bytes
    are one allocation, its workspace the zero words past K2's and K4's
    first two, taken and launched under the lock."""
    from . import build
    lib = build.library("sort")
    dev = device.index
    buf = torch.empty((2 * (k + 1) * n + (n + 3) // 4,), dtype=torch.int32,
                      device=device)
    words = lib.jmc_sort_workspace_words(n, np_)

    def ptr(x):
        return None if x is None else x.data_ptr()
    with _ZERO_WORDS.lock:
        ws = _ZERO_WORDS.take(device, dev, (words + 1) // 2) + 16
        rc = lib.jmc_sort_keys(ptr(keys), ptr(explore), ptr(prov),
                               ptr(skeys), sidx.data_ptr(), buf.data_ptr(),
                               ws, n, k, np_, mode, a, fc, bits,
                               _raw_stream(dev))
        if rc != 0:
            _ZERO_WORDS.drop(dev)
    _launch(name, rc, np_ + 2)


def sort_keys(keys: torch.Tensor):
    """K18: sort_keys_twin's function by a stable LSD radix sort over
    the words' bytes (csrc/sort.cu), exact on any int32 input: an
    upsweep, 4K digit passes (those whose digit is one value on every
    row exit on the card) and a clearing launch, 4K + 2 launches a
    call, counted under sort_keys.  The rows equal to the last row (the
    engines' filler keys) skip the digit passes.  skeys and sidx are views of one
    allocation.  Nothing is read back to the host; the workspace is
    the zero words, so a call may be captured in a CUDA graph.  A CPU
    tensor takes the twin; a shape the kernel does not take raises
    ValueError."""
    if not _ok(keys, torch.int32, 2):
        _check(keys, "sort_keys.keys", 2)
    if keys.is_cpu:
        return sort_keys_twin(keys)
    N, K = keys.shape
    if not 1 <= K <= SORT_MAX_K:
        raise ValueError(f"sort_keys: keys of {K} words; the kernel takes "
                         f"1 to {SORT_MAX_K}")
    if N >= SORT_MAX_N:
        raise ValueError(f"sort_keys: {N} rows; the kernel takes fewer "
                         f"than {SORT_MAX_N}")
    out = torch.empty((N * (K + 1),), dtype=torch.int32, device=keys.device)
    skeys, sidx = out[:N * K].view(N, K), out[N * K:]
    if N:
        _sort_run("sort_keys", keys.device, N, K, 4 * K, sidx, 0, keys=keys,
                  skeys=skeys)
    return skeys, sidx



def front_order_twin(explore: torch.Tensor, prov: torch.Tensor, A: int,
                     FC: int) -> torch.Tensor:
    """perm [C] int32: the stable order of the C new rows by (not
    explore, fmaj), fmaj = (prov % FC) * A + prov // FC, the frontier
    slot major and the action minor (bfs.py:1879-1883, comp4's perm4),
    as one int64 key and torch.sort.  prov lies in [0, C), C = A * FC."""
    fmaj = (prov % FC) * max(A, 1) + torch.div(prov, FC,
                                               rounding_mode="floor")
    key4 = (~explore).to(torch.int64) * (1 << 40) + fmaj
    return torch.sort(key4, stable=True).indices.to(torch.int32)


def front_order(explore: torch.Tensor, prov: torch.Tensor, A: int,
                FC: int) -> torch.Tensor:
    """K18's front_order site: front_order_twin's function as K18's
    launches over one word, (1 - explore) << b | fmaj with b =
    bit_length(C - 1), built in its first passes; the rows equal to the
    last row (most often those past the new count: provenance 0, not
    explored) skip the digit passes, and only the ceil((b + 1) / 8)
    digit positions of b + 1 bits are launched: that many + 2 launches
    a call, counted under front_order."""
    if not (_ok(explore, torch.bool, 1) and _ok(prov, torch.int64, 1)):
        _check(explore, "front_order.explore", 1, torch.bool)
        _check(prov, "front_order.prov", 1, torch.int64)
    C = explore.shape[0]
    if prov.shape[0] != C:
        raise ValueError(f"front_order: explore [{C}], prov "
                         f"[{prov.shape[0]}]")
    if explore.is_cpu:
        return front_order_twin(explore, prov, A, FC)
    if prov.get_device() != explore.get_device():
        _same_device("front_order", explore, prov)
    if C >= SORT_MAX_N or FC < 1:
        raise ValueError(f"front_order: {C} rows, FC {FC}; the kernel "
                         f"takes fewer than {SORT_MAX_N} rows and FC >= 1")
    sidx = torch.empty((C,), dtype=torch.int32, device=explore.device)
    if C:
        b = (C - 1).bit_length()
        _sort_run("front_order", explore.device, C, 1, b // 8 + 1, sidx, 1,
                  explore=explore, prov=prov, a=max(A, 1), fc=FC, bits=b)
    return sidx


# ---------------------------------------------------------------------------
# K4 rank_merge
# ---------------------------------------------------------------------------


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


# K4's output words a block in its second launch (at most; rounded down
# to a multiple of 32 rows)
MERGE_OUT_WORDS = 6144


def merge_geometry(K: int) -> Tuple[int, int, int]:
    """(sorted keys a thread, keys a tile, output rows a block) of a K4
    call at key width K.  Launch 1 stages a tile of 256 * items keys and
    the key before it, (tile + 1) * K words and 3 of room: items is the
    largest of 8, 4, 2, 1 that keeps this within 48 KB (1 beyond it, up
    to SMEM_MAX).  Launch 2's block writes MERGE_OUT_WORDS // K rows
    (a multiple of 32, at least 32)."""
    for items in (8, 4, 2, 1):
        smem = 4 * _pad4((256 * items + 1) * K + 3)
        if smem <= 48 * 1024:
            break
    rows = max(32, MERGE_OUT_WORDS // K // 32 * 32)
    if max(smem, 4 * (_pad4(rows * K + 3) + rows // 16)) > SMEM_MAX - 1024:
        raise ValueError(f"merge_sorted: keys of {K} words need more "
                         f"shared memory than a block's {SMEM_MAX}")
    return items, 256 * items, rows


_MERGE_GEOM: Dict[int, Tuple[int, int, int]] = {}


def merge_sorted(seen: torch.Tensor, seen_count: int, skeys: torch.Tensor,
                 sidx: torch.Tensor, found: torch.Tensor,
                 lb: torch.Tensor) -> dict:
    """K4: merge_sorted_twin's function in two launches (new flags,
    look-back and compaction; the merge), nothing between them.  lb is
    the lower bound of each sorted key (K3's), so nondecreasing.  seen2
    is one allocation; nk_sidx, the two scalars and the scratch pairs
    (each new key's sorted position and clamped lower bound) another;
    the tile words are the zero workspace.  Nothing is read back to the
    host.  The checks run once, on a path kept short."""
    if not (_ok(seen, torch.int32, 2) and _ok(skeys, torch.int32, 2) and
            _ok(sidx, torch.int32, 1) and _ok(found, torch.bool, 1) and
            _ok(lb, torch.int32, 1)):
        _check(seen, "merge_sorted.seen", 2)
        _check(skeys, "merge_sorted.skeys", 2)
        _check(sidx, "merge_sorted.sidx", 1)
        _check(found, "merge_sorted.found", 1, torch.bool)
        _check(lb, "merge_sorted.lb", 1)
    SC, K = seen.shape
    N = skeys.shape[0]
    count = int(seen_count)
    if skeys.shape[1] != K or not (sidx.shape[0] == found.shape[0]
                                   == lb.shape[0] == N):
        raise ValueError("merge_sorted: shapes disagree")
    if not 0 <= count <= SC:
        raise ValueError(f"merge_sorted: count {seen_count} outside "
                         f"[0, {SC}]")
    if skeys.is_cpu:
        return merge_sorted_twin(seen, count, skeys, sidx, found, lb)
    dev = skeys.get_device()
    if not (seen.get_device() == sidx.get_device() == found.get_device()
            == lb.get_device() == dev):
        _same_device("merge_sorted", seen, skeys, sidx, found, lb)
    if SC + N >= 2**31:
        raise ValueError(f"merge_sorted: {SC} seen rows and {N} keys, "
                         f"the kernel's positions are int32")
    geom = _MERGE_GEOM.get(K)
    if geom is None:
        geom = _MERGE_GEOM[K] = merge_geometry(K)
    items, tile, rows = geom
    tiles = -(-N // tile) if N else 1
    seen2 = torch.empty((SC, K), dtype=torch.int32, device=skeys.device)
    # nk_sidx [N], new_count, seen_count2, then the pairs [N] int2 (from
    # an 8-byte boundary)
    o_p = N + 2 + (N & 1)
    aux = torch.empty((o_p + 2 * N,), dtype=torch.int32,
                      device=skeys.device)
    from . import build
    lib = build.library("merge")
    with _ZERO_WORDS.lock:
        rc = lib.jmc_merge_sorted(
            seen.data_ptr(), skeys.data_ptr(), sidx.data_ptr(),
            found.data_ptr(), lb.data_ptr(), seen2.data_ptr(),
            aux.data_ptr(), aux.data_ptr() + 4 * o_p,
            aux.data_ptr() + 4 * N,
            _ZERO_WORDS.take(skeys.device, dev, tiles), count, N, SC, K,
            items, rows, tiles, _raw_stream(dev))
        if rc != 0:
            _ZERO_WORDS.drop(dev)
    _launch("rank_merge", rc, 2)
    return dict(new_count=aux[N], nk_sidx=aux[:N], seen2=seen2,
                seen_count2=aux[N + 1])


def rank_merge_twin(seen: torch.Tensor, seen_count: int,
                    keys: torch.Tensor) -> dict:
    """bfs._rank_merge(multikey=True) with the twins: sort the
    candidate keys, probe them against the sorted seen prefix, then
    merge_sorted_twin."""
    skeys, sidx = sort_keys_twin(keys)
    found, lb = seen_probe_twin(seen, seen_count, skeys)
    return merge_sorted_twin(seen, seen_count, skeys, sidx, found, lb)


def rank_merge(seen: torch.Tensor, seen_count: int,
               keys: torch.Tensor) -> dict:
    """bfs._rank_merge(multikey=True) on the kernels: K18 for the sort,
    K3 for the probe, K4 for the merge."""
    _check(seen, "rank_merge.seen", 2)
    _check(keys, "rank_merge.keys", 2)
    if keys.shape[1] != seen.shape[1]:
        raise ValueError("rank_merge: key widths differ")
    if not 0 <= int(seen_count) <= seen.shape[0]:
        raise ValueError(f"rank_merge: count {seen_count} outside "
                         f"[0, {seen.shape[0]}]")
    skeys, sidx = sort_keys(keys)
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


# K5's shared memory: what a block's tile, candidate, minimum and
# program aim at, and the most a block can have on the card (227 KB)
CANON_SMEM = 64 * 1024
SMEM_MAX = 232448


def canon_geometry(program, budget=None):
    """(rows a block T, program staged, shared bytes) of a K5 launch for
    the layout's program (W = program[2]).  Fixed: a 16-byte counter and
    the packed lane ops, one word each (padded to 16 bytes).  A row
    costs its staged copy at the odd stride W | 1, its index in the list
    of valid rows, its running minimum and, when the program has sort
    blocks, its candidate: 4 * (W | 1 + 1 + W * (2 or 1)) bytes.  The
    program (padded to 16 bytes) is staged when it fits beside 32 rows
    in `budget` (CANON_SMEM); T is what the rest holds, at most 256, a
    multiple of 32 from 32 up.  A row too wide for `budget` takes
    SMEM_MAX instead; one wider still raises."""
    if budget is None:
        budget = CANON_SMEM
    W = int(program[2])
    bufs = 2 if int(program[9]) > int(program[8]) else 1
    lops = (int(program[5]) - int(program[4])) // 3
    row = 4 * ((W | 1) + 1 + bufs * W)
    prog = 4 * (-(-len(program) // 4) * 4)
    fixed0 = 16 + 4 * (-(-lops // 4) * 4)
    for b in (budget, max(budget, SMEM_MAX)):
        staged = fixed0 + prog + 32 * row <= b
        fixed = fixed0 + (prog if staged else 0)
        T = min(256, (b - fixed) // row)
        if T >= 32:
            T -= T % 32
        if T >= 1:
            return T, staged, fixed + T * row
    raise ValueError(f"canon_rows: a row of {W} lanes needs {row} bytes "
                     f"of shared memory, more than a block's {SMEM_MAX}")


def canon_rows(rows: torch.Tensor, valid: torch.Tensor, canon
               ) -> torch.Tensor:
    """K5: canon_rows_twin's function; `canon` is the layout's
    compile/symmetry2.Canon, whose program the kernel interprets, in
    blocks of canon_geometry(program)."""
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
    T, staged, smem = canon_geometry(canon.program)
    rc = lib.jmc_canon_rows(
        _ptr(rows), _ptr(valid), _ptr(prog), ctypes.c_int(prog.numel()),
        ctypes.c_int(int(staged)), ctypes.c_int(T), ctypes.c_int(smem),
        _ptr(out), ctypes.c_int64(N), ctypes.c_int(W), _stream())
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
    """K7: hstep_epilogue_twin's function in one launch (a single pass
    with decoupled look-back); pack_ovf is K2's 0-d bool tensor on the
    card (a host bool is refused there).  The seven outputs are views of
    one allocation, the scratch is the cached workspace, the checks run
    once on a path kept short.  Nothing is read back to the host here."""
    B, I32 = torch.bool, torch.int32
    if not (_ok(en, B, 2) and _ok(aok, B, 2) and _ok(ov, I32, 2)
            and _ok(keys, I32, 2) and _ok(cand, I32, 2)
            and _ok(inv_ok, B, 1) and _ok(explore, B, 1)):
        _check(en, "hstep_epilogue.en", 2, B)
        _check(aok, "hstep_epilogue.aok", 2, B)
        _check(ov, "hstep_epilogue.ov", 2)
        _check(keys, "hstep_epilogue.keys", 2)
        _check(cand, "hstep_epilogue.cand", 2)
        _check(inv_ok, "hstep_epilogue.inv_ok", 1, B)
        _check(explore, "hstep_epilogue.explore", 1, B)
    A, CH = en.shape
    C = A * CH
    if aok.shape != en.shape or ov.shape != en.shape or \
            keys.shape != (C, 5) or cand.shape[0] != C:
        raise ValueError(f"hstep_epilogue: en {tuple(en.shape)}, aok "
                         f"{tuple(aok.shape)}, ov {tuple(ov.shape)}, keys "
                         f"{tuple(keys.shape)}, cand {tuple(cand.shape)}")
    if inv_ok.shape[0] != C or explore.shape[0] != C:
        raise ValueError(f"hstep_epilogue: inv_ok {tuple(inv_ok.shape)}, "
                         f"explore {tuple(explore.shape)} for {C} "
                         f"candidates")
    fcount = int(fcount)
    if not 0 <= fcount <= CH:
        raise ValueError(f"hstep_epilogue: fcount {fcount} outside "
                         f"[0, {CH}]")
    if max(C, CH) >= 2**31 - 256:
        raise ValueError(f"hstep_epilogue: {C} candidates, the kernel's "
                         f"indices are int32")
    if en.is_cpu:
        return hstep_epilogue_twin(en, aok, ov, fcount, keys, cand,
                                   pack_ovf, ov_pack, inv_ok, explore)
    if not (isinstance(pack_ovf, torch.Tensor) and pack_ovf.dim() == 0
            and pack_ovf.dtype is B):
        raise TypeError("hstep_epilogue: pack_ovf must be K2's 0-d bool "
                        "tensor on the card, got "
                        f"{getattr(pack_ovf, 'shape', type(pack_ovf))}")
    d = en.get_device()
    if not (aok.get_device() == ov.get_device() == keys.get_device()
            == cand.get_device() == pack_ovf.get_device()
            == inv_ok.get_device() == explore.get_device() == d):
        _same_device("hstep_epilogue", en, aok, ov, keys, cand, pack_ovf,
                     inv_ok, explore)
    from . import build
    lib = build.library("hstep")
    dev = en.device
    PW = cand.shape[1]
    stream = _Workspace.stream_for("hstep_epilogue", dev)
    tile = _TILES.get("hstep")
    if tile is None:
        tile = _TILES["hstep"] = int(lib.jmc_hstep_tile())
    tiles = max(1, -(-max(C, CH) // tile))
    # int64 scalars first, then the int32 outputs, then the bools, each
    # part a whole number of int64 words
    n32, nb = C * (5 + PW), CH + 2 * C
    w32, wb = -(-n32 // 2), -(-nb // 8)
    scalars, t32, tb = torch.empty(
        (6 + w32 + wb,), dtype=torch.int64, device=dev).split_with_sizes(
            [6, w32, wb])
    idx, fps, rows, _ = t32.view(I32).split_with_sizes(
        [C, 4 * C, PW * C, 2 * w32 - n32])
    dead, inv_out, exp_out, _ = tb.view(B).split_with_sizes(
        [CH, C, C, 8 * wb - nb])
    with _K7_WS.lock:
        ws, ws_tiles, epoch = _K7_WS.take(lib, dev, stream, tiles)
        rc = lib.jmc_hstep_epilogue(
            en.data_ptr(), aok.data_ptr(), ov.data_ptr(), keys.data_ptr(),
            cand.data_ptr(), inv_ok.data_ptr(), explore.data_ptr(),
            pack_ovf.data_ptr(), scalars.data_ptr(), dead.data_ptr(),
            idx.data_ptr(), fps.data_ptr(), rows.data_ptr(),
            inv_out.data_ptr(), exp_out.data_ptr(), ws, A, CH, fcount, PW,
            int(ov_pack), tiles, ws_tiles, epoch, stream)
        if rc != 0:
            _K7_WS.drop(dev, stream)
    _launch("hstep_epilogue", rc)
    return dict(scalars=scalars, dead=dead, idx=idx, fps=fps.view(C, 4),
                rows=rows.view(C, PW), inv_ok=inv_out, explore=exp_out)


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


class _Workspace:
    """The scratch of a single-pass compaction (K7, K8, K11), cached
    across calls for each (device, stream): the tiles' status words,
    their side arrays and the ticket counter, zeros when made.  Each
    call takes the next epoch (1 .. 2**30 - 1), which tags the status
    words it publishes, so a word of an earlier call reads as
    unpublished and nothing is cleared between calls; the kernels leave
    the ticket (and K7's and K8's reductions, K7's done-count) at 0.  A
    workspace is safe while its calls run one after another: a call
    holds `lock` from `take` until its launches are enqueued, so calls
    from several threads on one stream do not interleave their kernels,
    and another stream gets a workspace of its own.  Under CUDA graph
    capture the epoch would be a fixed argument of every replay, so the
    wrappers refuse it (`stream_for`).  A failed launch drops the
    workspace."""

    EPOCHS = 2**30

    def __init__(self, nbytes):
        self._nbytes = nbytes          # the kernel's layout: tiles -> bytes
        self._by_key: Dict[tuple, list] = {}
        self.lock = threading.Lock()

    def take(self, lib, dev: torch.device, stream: int, tiles: int):
        """(pointer, capacity in tiles, epoch) for a call of `tiles` on
        `stream`; the caller holds `lock`."""
        key = (str(dev), stream)
        ent = self._by_key.get(key)
        if ent is None or ent[1] < tiles:
            cap = max(tiles, 2 * ent[1] if ent else 0)
            nb = int(getattr(lib, self._nbytes)(cap))
            ent = [torch.zeros(-(-nb // 8), dtype=torch.int64, device=dev),
                   cap, 0]
            self._by_key[key] = ent
        elif ent[2] == self.EPOCHS - 1:
            ent[0].zero_()
            ent[2] = 0
        ent[2] += 1
        return ent[0].data_ptr(), ent[1], ent[2]

    def drop(self, dev: torch.device, stream: int) -> None:
        self._by_key.pop((str(dev), stream), None)

    @staticmethod
    def stream_for(name: str, dev: torch.device) -> int:
        """The current stream of dev, refused while it is captured."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: not capturable in a CUDA graph "
                               f"(each call takes a new epoch)")
        return _raw_stream(dev.index if dev.index is not None
                           else torch.cuda.current_device())


_K7_WS = _Workspace("jmc_hstep_workspace_bytes")
_K8_WS = _Workspace("jmc_res_workspace_bytes")
_K11_WS = _Workspace("jmc_fullsort_workspace_bytes")


def resident_compact(mask: torch.Tensor, cap: int, flim=None, aok=None,
                     ov=None, site: str = ""):
    """K8: resident_compact_twin's function in two launches (the single
    pass with decoupled look-back, the unset tail); idx and the scalars
    are views of one allocation, the scratch is the cached workspace.
    Nothing is read back to the host.  A launch counts under
    resident_compact, or resident_compact_<site>."""
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
    tiles = max(1, -(-C // int(lib.jmc_res_tile())))
    stream = _Workspace.stream_for(name, dev)
    out = torch.empty(6 + (cap + 1) // 2, dtype=torch.int64, device=dev)
    scalars, idx = out[:6], out[6:].view(torch.int32)[:cap]
    with _K8_WS.lock:
        ws, ws_tiles, epoch = _K8_WS.take(lib, dev, stream, tiles)
        rc = lib.jmc_res_compact(
            m.data_ptr(), aok.data_ptr() if aok is not None else None,
            ov.data_ptr() if ov is not None else None, idx.data_ptr(),
            scalars.data_ptr(), ws, A, CH, flim, cap, tiles, ws_tiles,
            epoch, stream)
        if rc != 0:
            _K8_WS.drop(dev, stream)
    _launch(name, rc, 2)
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


# ---------------------------------------------------------------------------
# K11 fullsort_dedup
# ---------------------------------------------------------------------------

def fullsort_dedup_twin(skeys: torch.Tensor, sflag: torch.Tensor,
                        perm: torch.Tensor, SC: int, C: int):
    """The reference's full-sort branch after its sort (bfs.py:1820-
    1851), in torch: over the sorted keys skeys [N, K] (N = SC + C),
    their flags sflag [N] (1: a candidate) and pre-sort indices perm
    [N], flag the first of each run of equal valid keys that is a
    candidate (`new`) and the rows the merged table keeps (valid seen
    rows and the new ones), then take the two stable partitions
    lax.sort(num_keys=1, is_stable=True) makes.

    Returns (new_cidx [C] int32: perm - SC of the new rows in key
    order, then the other rows'; seen2 [SC, K] int32: the kept keys in
    key order, then the others; counts int64 [2] = (new_count,
    seen_count2))."""
    N = skeys.shape[0]
    dev = skeys.device
    rvalid = skeys[:, 0] == 0
    neq_prev = torch.ones(N, dtype=torch.bool, device=dev)
    if N > 1:
        neq_prev[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
    cand = sflag != 0
    new = cand & rvalid & neq_prev
    keep = (~cand & rvalid) | new
    cidx = perm - SC
    o_new = torch.argsort((~new).to(torch.int32), stable=True)
    o_keep = torch.argsort((~keep).to(torch.int32), stable=True)
    counts = torch.stack([new.sum(), keep.sum()]).to(torch.int64)
    return (cidx[o_new][:C].to(torch.int32).contiguous(),
            skeys[o_keep][:SC].contiguous(), counts)


def fullsort_dedup(skeys: torch.Tensor, sflag: torch.Tensor,
                   perm: torch.Tensor, SC: int, C: int):
    """K11: fullsort_dedup_twin's function in one launch (a single pass
    with decoupled look-back over both counts; the scratch is the cached
    workspace); nothing is read back.  Equal to the twin over
    new_cidx[:new_count] and seen2[:seen_count2]; the kernel writes
    nothing past them (new_cidx starts as zeros, seen2 as torch.empty)
    and nothing reads them."""
    _check(skeys, "fullsort_dedup.skeys", 2)
    _check(sflag, "fullsort_dedup.sflag", 1)
    _check(perm, "fullsort_dedup.perm", 1)
    N, K = skeys.shape
    if not (sflag.shape[0] == perm.shape[0] == N == SC + C):
        raise ValueError(f"fullsort_dedup: {N} keys, {sflag.shape[0]} "
                         f"flags, {perm.shape[0]} indices for SC {SC} + "
                         f"C {C}")
    if N >= 2**31 - 256:
        raise ValueError(f"fullsort_dedup: {N} rows, the kernel's "
                         f"indices are int32")
    if skeys.device.type == "cpu":
        return fullsort_dedup_twin(skeys, sflag, perm, SC, C)
    _same_device("fullsort_dedup", skeys, sflag, perm)
    from . import build
    lib = build.library("fullsort")
    if not 1 <= K <= int(lib.jmc_fullsort_max_k()):
        raise ValueError(f"fullsort_dedup: key width {K} outside [1, "
                         f"{int(lib.jmc_fullsort_max_k())}]")
    dev = skeys.device
    tiles = max(1, -(-N // int(lib.jmc_fullsort_tile_rows(K))))
    stream = _Workspace.stream_for("fullsort_dedup", dev)
    counts = torch.empty((2,), dtype=torch.int64, device=dev)
    new_cidx = torch.zeros((C,), dtype=torch.int32, device=dev)
    seen2 = torch.empty((SC, K), dtype=torch.int32, device=dev)
    with _K11_WS.lock:
        ws, ws_tiles, epoch = _K11_WS.take(lib, dev, stream, tiles)
        rc = lib.jmc_fullsort_dedup(
            skeys.data_ptr(), sflag.data_ptr(), perm.data_ptr(),
            new_cidx.data_ptr(), seen2.data_ptr(), counts.data_ptr(), ws,
            N, K, SC, C, tiles, ws_tiles, epoch, stream)
        if rc != 0:
            _K11_WS.drop(dev, stream)
    _launch("fullsort_dedup", rc)
    return new_cidx, seen2, counts


# ---------------------------------------------------------------------------
# K12 oracle_probe
# ---------------------------------------------------------------------------

# the reference probe's fixed trip count (jaxmc/backend/oracle.py:87)
PROBE_STEPS = 14


def oracle_probe_twin(sk: torch.Tensor, perm: torch.Tensor,
                      keys: torch.Tensor, steps: int = PROBE_STEPS):
    """The reference probe after its sort, in torch: over the sorted
    keys sk [N, 4], their pre-sort row indices perm [N] and the unsorted
    keys [N, 4], `out = zeros.at[perm].set(sk)`, a `steps`-step lower
    bound of keys[:, 0] in sk[:, 0] with clip(mid, 0, N-1) and no
    lo < hi guard, and `out.sum() + lo.sum()` wrapped to int32.

    Returns (out [N, 4] int32, lo [N] int32, value 0-d int32)."""
    N = sk.shape[0]
    dev = sk.device
    out = torch.zeros_like(sk)
    out.index_copy_(0, perm.to(torch.int64), sk)
    col, key = sk[:, 0], keys[:, 0]
    lo = torch.zeros(N, dtype=torch.int32, device=dev)
    hi = torch.full((N,), N, dtype=torch.int32, device=dev)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        lt = col[mid.clamp(0, max(N - 1, 0)).to(torch.int64)] < key
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    value = _i32(out.to(torch.int64).sum() + lo.to(torch.int64).sum())
    return out, lo, value


def oracle_probe(sk: torch.Tensor, perm: torch.Tensor, keys: torch.Tensor,
                 steps: int = PROBE_STEPS):
    """K12: oracle_probe_twin's function in one launch; perm int32.
    Bit-equal to the twin on out, lo and value."""
    _check(sk, "oracle_probe.sk", 2)
    _check(perm, "oracle_probe.perm", 1)
    _check(keys, "oracle_probe.keys", 2)
    N = sk.shape[0]
    if sk.shape[1] != 4 or tuple(keys.shape) != (N, 4) \
            or perm.shape[0] != N:
        raise ValueError(f"oracle_probe: sk {tuple(sk.shape)}, keys "
                         f"{tuple(keys.shape)}, perm {tuple(perm.shape)}: "
                         f"expected [N, 4], [N, 4] and [N]")
    if N >= 2**30:
        raise ValueError(f"oracle_probe: {N} rows, the kernel's indices "
                         f"are int32")
    if sk.device.type == "cpu":
        return oracle_probe_twin(sk, perm, keys, steps)
    _same_device("oracle_probe", sk, perm, keys)
    from . import build
    lib = build.library("oracle")
    dev = sk.device
    # zeros, as the reference's scatter target: rows no perm entry
    # names stay 0
    out = torch.zeros_like(sk)
    lo = torch.empty((N,), dtype=torch.int32, device=dev)
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    if N:
        rc = lib.jmc_oracle_probe(_ptr(sk), _ptr(perm), _ptr(keys),
                                  _ptr(out), _ptr(lo), _ptr(acc),
                                  ctypes.c_int(N), ctypes.c_int(int(steps)),
                                  _stream())
        _launch("oracle_probe", rc)
    return out, lo, acc


# ---------------------------------------------------------------------------
# K13 mesh_route
# ---------------------------------------------------------------------------

# destinations the kernel's shared ballot table holds (mesh.cu kMaxDest)
MESH_MAX_DEST = 64


def _invalid_key(K: int, device) -> torch.Tensor:
    """The invalid key row [1, SENTINEL, ...] (validity lane 1)."""
    inv = torch.full((K,), SENTINEL, dtype=torch.int32, device=device)
    inv[0] = 1
    return inv


def mesh_owner_twin(lane1: torch.Tensor, D: int, skew: bool) -> torch.Tensor:
    """The ownership formula on the device (mesh._owner_jnp): key lane 1
    as uint32 mod D, or shard 0 under the mesh_skew fault; int64 [N]."""
    if skew:
        return torch.zeros(lane1.shape[0], dtype=torch.int64,
                           device=lane1.device)
    return _u32(lane1) % D


def mesh_route_twin(keys: torch.Tensor, cand: torch.Tensor,
                    valid: torch.Tensor, D: int, B: int, SB: int,
                    skew: bool = False, src_lo: int = 0, send: bool = False):
    """The a2a exchange of mesh._route_fn (route_a2a, mesh.py:481-537)
    for S source shards keys [S, C, K], cand [S, C, PW], valid [S, C]:
    each source stable-sorts its valid rows by owner, and the row at
    position p of destination d goes to d's main bucket (p < B), its
    spill bucket (p < B + SB) or nowhere.  The payload's source index is
    (src_lo + s) * C + row.

    Returns (okeys [O, R, K], ocand [O, R, PW], osrc [O, R], stats
    [S, 3]) with R = D * (B + SB), all int32; stats = (spill rows,
    bucket+spill overflow, largest destination count) per source.
    send=False (S == D) lays the rows out as the reference's receive
    block of each destination (every source's main bucket, then every
    source's spill bucket); send=True as each source's send block
    (destination-major main buckets, then spill buckets), O = S.
    Unfilled slots hold [1, SENTINEL, ...]."""
    S, C, K = keys.shape
    PW = cand.shape[2]
    R = D * (B + SB)
    O = S if send else D
    dev = keys.device
    okeys = torch.full((O * R, K), SENTINEL, dtype=torch.int32, device=dev)
    okeys[:, 0] = 1
    ocand = torch.full((O * R, PW), SENTINEL, dtype=torch.int32, device=dev)
    osrc = torch.full((O * R,), SENTINEL, dtype=torch.int32, device=dev)
    stats = torch.zeros((S, 3), dtype=torch.int32, device=dev)
    ar = torch.arange(C, device=dev)
    for s in range(S):
        owner = mesh_owner_twin(keys[s, :, 1], D, skew)
        dest = torch.where(valid[s], owner, D)
        counts = torch.bincount(dest, minlength=D + 1)
        sperm = torch.argsort(dest, stable=True)
        sdest = dest[sperm]
        excl = torch.cumsum(counts, 0) - counts
        pos = ar - excl[sdest]
        sg = src_lo + s
        live = sdest < D
        main = live & (pos < B)
        spill = live & (pos >= B) & (pos < B + SB)
        if send:
            slot_m = s * R + sdest * B + pos
            slot_s = s * R + D * B + sdest * SB + (pos - B)
        else:
            slot_m = sdest * R + sg * B + pos
            slot_s = sdest * R + D * B + sg * SB + (pos - B)
        ok = main | spill
        slot = torch.where(main, slot_m, slot_s)[ok]
        rows = sperm[ok]
        okeys[slot] = keys[s][rows]
        ocand[slot] = cand[s][rows]
        osrc[slot] = (sg * C + rows).to(torch.int32)
        c = counts[:D]
        stats[s, 0] = (c - B).clamp(0, SB).sum().to(torch.int32)
        stats[s, 1] = (c > B + SB).any().to(torch.int32)
        stats[s, 2] = c.max().to(torch.int32) if D else 0
    return (okeys.reshape(O, R, K), ocand.reshape(O, R, PW),
            osrc.reshape(O, R), stats)


def mesh_route(keys: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
               D: int, B: int, SB: int, skew: bool = False, src_lo: int = 0,
               send: bool = False):
    """K13 (a2a): mesh_route_twin's function in four launches (fill,
    per-block destination counts, per-destination scan, ballot-ranked
    scatter).  Bit-equal to the twin."""
    _check(keys, "mesh_route.keys", 3)
    _check(cand, "mesh_route.cand", 3)
    _check(valid, "mesh_route.valid", 2, torch.bool)
    S, C, K = keys.shape
    PW = cand.shape[2]
    if tuple(cand.shape[:2]) != (S, C) or tuple(valid.shape) != (S, C):
        raise ValueError(f"mesh_route: keys {tuple(keys.shape)}, cand "
                         f"{tuple(cand.shape)}, valid {tuple(valid.shape)}")
    if not 1 <= D <= MESH_MAX_DEST:
        raise ValueError(f"mesh_route: {D} destinations, the kernel takes "
                         f"1 to {MESH_MAX_DEST}")
    if not send and (S != D or src_lo != 0):
        raise ValueError("mesh_route: the receive layout needs every "
                         "source shard (S == D, src_lo 0)")
    R = D * (B + SB)
    O = S if send else D
    if max(O * R, S * C) >= 2**31 - 256:
        raise ValueError(f"mesh_route: {O * R} slots, {S * C} candidates: "
                         f"the kernel's source indices are int32")
    if keys.device.type == "cpu":
        return mesh_route_twin(keys, cand, valid, D, B, SB, skew, src_lo,
                               send)
    _same_device("mesh_route", keys, cand, valid)
    from . import build
    lib = build.library("mesh")
    dev = keys.device
    threads = int(lib.jmc_mesh_threads())
    nb = max(1, -(-C // threads))
    okeys = torch.empty((O, R, K), dtype=torch.int32, device=dev)
    ocand = torch.empty((O, R, PW), dtype=torch.int32, device=dev)
    osrc = torch.empty((O, R), dtype=torch.int32, device=dev)
    stats = torch.empty((S, 3), dtype=torch.int32, device=dev)
    if S == 0:
        return okeys, ocand, osrc, stats
    bcnt = torch.empty((S * D * nb,), dtype=torch.int32, device=dev)
    boff = torch.empty((S * D * nb,), dtype=torch.int64, device=dev)
    totals = torch.empty((S * D,), dtype=torch.int64, device=dev)
    rc = lib.jmc_mesh_route_fill(_ptr(okeys), _ptr(ocand), _ptr(osrc),
                                 ctypes.c_int64(O * R), ctypes.c_int(K),
                                 ctypes.c_int(PW), _stream())
    _launch("mesh_route", rc)
    rc = lib.jmc_mesh_route_count(_ptr(keys), _ptr(valid), _ptr(bcnt),
                                  ctypes.c_int64(C), ctypes.c_int(K),
                                  ctypes.c_int(D), ctypes.c_int(int(skew)),
                                  ctypes.c_int(S), ctypes.c_int(nb),
                                  _stream())
    _launch("mesh_route", rc)
    rc = lib.jmc_mesh_route_scan(_ptr(bcnt), _ptr(boff), _ptr(totals),
                                 ctypes.c_int(S * D), ctypes.c_int(nb),
                                 _stream())
    _launch("mesh_route", rc)
    rc = lib.jmc_mesh_route_scatter(
        _ptr(keys), _ptr(cand), _ptr(valid), _ptr(boff), _ptr(totals),
        _ptr(okeys), _ptr(ocand), _ptr(osrc), _ptr(stats), ctypes.c_int64(C),
        ctypes.c_int(K), ctypes.c_int(PW), ctypes.c_int(D),
        ctypes.c_int64(B), ctypes.c_int64(SB), ctypes.c_int(int(skew)),
        ctypes.c_int64(src_lo), ctypes.c_int(int(send)), ctypes.c_int(S),
        ctypes.c_int(nb), _stream())
    _launch("mesh_route", rc)
    return okeys, ocand, osrc, stats


def mesh_route_gather_twin(keys: torch.Tensor, D: int, me_lo: int = 0,
                           n_me=None, skew: bool = False):
    """The gather exchange of mesh._route_fn (route_gather, mesh.py:
    453-469) after its all_gather: over the gathered keys [N, K], shard
    me_lo + m keeps the valid rows it owns and sees every other row as
    the invalid key.  Returns (okeys [n_me, N, K] int32, evalid [N]
    bool: the validity lane before the mask)."""
    n_me = D if n_me is None else n_me
    v = keys[:, 0] == 0
    owner = mesh_owner_twin(keys[:, 1], D, skew)
    inv = _invalid_key(keys.shape[1], keys.device)
    out = torch.stack([torch.where((v & (owner == me_lo + m))[:, None],
                                   keys, inv) for m in range(n_me)]) \
        if n_me else keys.new_empty((0,) + tuple(keys.shape))
    return out, v


def mesh_route_gather(keys: torch.Tensor, D: int, me_lo: int = 0,
                      n_me=None, skew: bool = False):
    """K13 (gather): mesh_route_gather_twin's function in one launch."""
    _check(keys, "mesh_route_gather.keys", 2)
    n_me = D if n_me is None else n_me
    N, K = keys.shape
    if not (D >= 1 and 0 <= me_lo and me_lo + n_me <= D):
        raise ValueError(f"mesh_route_gather: shards {me_lo}..{me_lo + n_me}"
                         f" of {D}")
    if keys.device.type == "cpu":
        return mesh_route_gather_twin(keys, D, me_lo, n_me, skew)
    from . import build
    lib = build.library("mesh")
    okeys = torch.empty((n_me, N, K), dtype=torch.int32, device=keys.device)
    evalid = torch.empty((N,), dtype=torch.bool, device=keys.device)
    if N and n_me:
        rc = lib.jmc_mesh_route_gather(
            _ptr(keys), _ptr(okeys), _ptr(evalid), ctypes.c_int64(N),
            ctypes.c_int(K), ctypes.c_int(D), ctypes.c_int(me_lo),
            ctypes.c_int(n_me), ctypes.c_int(int(skew)), _stream())
        _launch("mesh_route_gather", rc)
    return okeys, evalid


# ---------------------------------------------------------------------------
# K14 mesh_scalars
# ---------------------------------------------------------------------------

# the columns of a shard's partial row (mesh.cu P_*)
MESH_PARTIALS = ("gen", "front", "seen", "spill", "maxdest", "vneed", "ovc",
                 "dead", "dead_slot", "assert", "asrt_a", "asrt_f",
                 "inv_which", "inv_slot", "por_ample", "por_expanded",
                 "por_masked", "a2a_ovf", "v_ovf")
# the reference's scalar vector (mesh.py:121-142), each entry as (partial
# column, reduction over the shards); ">FC" and ">SC" are any(column >
# capacity), "tovf" the trace-ring flag the host passes in
MESH_REDUCE = (("gen", "sum"), ("front", "sum"), ("front", "sum"),
               ("front", "max"), ("seen", "max"), ("seen", "sum"),
               ("ovc", "max"), ("dead", "sum"), ("assert", "sum"),
               ("inv_which", "min"), ("front", ">FC"), ("seen", ">SC"),
               (None, "tovf"), ("a2a_ovf", "any"), ("spill", "sum"),
               ("maxdest", "max"), ("v_ovf", "any"), ("vneed", "max"),
               ("por_ample", "sum"), ("por_expanded", "sum"),
               ("por_masked", "sum"))
# the reference's localization vector (mesh.py:145-152)
MESH_AUX = ("inv_which", "inv_slot", "dead", "dead_slot", "assert",
            "asrt_a", "asrt_f")


def mesh_scalars_twin(part: torch.Tensor, FC: int, SC: int,
                      t_ovf: int) -> torch.Tensor:
    """The reductions of mesh._mk_level_tail over the shard axis, in
    torch: part [D, NP] int32 (MESH_PARTIALS columns) -> int32
    [NS + D*NA + D*NP]: the MESH_REDUCE vector (sums wrap as int32),
    each shard's MESH_AUX entries, then part itself."""
    p = part.to(torch.int64)
    col = {n: p[:, i] for i, n in enumerate(MESH_PARTIALS)}
    out = []
    for name, how in MESH_REDUCE:
        if how == "tovf":
            out.append(torch.tensor(int(t_ovf), device=part.device))
            continue
        x = col[name]
        if how == "sum":
            out.append(x.sum())
        elif how == "max":
            out.append(x.max())
        elif how == "min":
            out.append(x.min())
        elif how == "any":
            out.append((x != 0).any().to(torch.int64))
        else:
            cap = FC if how == ">FC" else SC
            out.append((x > cap).any().to(torch.int64))
    aux = torch.stack([col[n] for n in MESH_AUX], dim=1)
    return _i32(torch.cat([torch.stack(out), aux.reshape(-1),
                           p.reshape(-1)]))


def mesh_scalars(part: torch.Tensor, FC: int, SC: int,
                 t_ovf: int) -> torch.Tensor:
    """K14: mesh_scalars_twin's function in one launch."""
    _check(part, "mesh_scalars.part", 2)
    D, NP = part.shape
    if NP != len(MESH_PARTIALS) or D < 1:
        raise ValueError(f"mesh_scalars: partials {tuple(part.shape)}, "
                         f"expected [D >= 1, {len(MESH_PARTIALS)}]")
    if part.device.type == "cpu":
        return mesh_scalars_twin(part, FC, SC, t_ovf)
    from . import build
    lib = build.library("mesh")
    out = torch.empty((len(MESH_REDUCE) + D * (len(MESH_AUX) + NP),),
                      dtype=torch.int32, device=part.device)
    rc = lib.jmc_mesh_scalars(_ptr(part), _ptr(out), ctypes.c_int(D),
                              ctypes.c_int(int(FC)), ctypes.c_int(int(SC)),
                              ctypes.c_int(int(t_ovf)), _stream())
    _launch("mesh_scalars", rc)
    return out


# ---------------------------------------------------------------------------
# K15-K17 the generated transition kernels (compile/cgen.py)
# ---------------------------------------------------------------------------

# the 1-element table a module that lifts no constant passes, one per
# device (the kernels never read it)
_NO_CONSTS: Dict[torch.device, torch.Tensor] = {}


def _cvals(gm, cvals, N: int, dev):
    """(table, rows per table row) of the lifted constants for a launch
    over N > 0 rows: cvals [M, L] int32 with M dividing N (one row per
    batch member, M = 1 for all rows alike), or a 1-element dummy when
    the module lifts none."""
    if not gm.L:
        dummy = _NO_CONSTS.get(dev)
        if dummy is None:
            dummy = _NO_CONSTS[dev] = torch.zeros((1,), dtype=torch.int32,
                                                 device=dev)
        return dummy, 1
    if cvals is None:
        raise ValueError(f"generated kernels: {gm.L} lifted constants and no "
                         f"cvals")
    _check(cvals, "cvals", 2)
    if cvals.device != dev:
        raise ValueError(f"cvals on {cvals.device}, rows on "
                         f"{dev}")
    M = cvals.shape[0]
    if cvals.shape[1] != gm.L or M < 1 or N % M:
        raise ValueError(f"cvals {tuple(cvals.shape)}, expected [M, "
                         f"{gm.L}] with M dividing {N}")
    return cvals, N // M


def gen_expand_twin(gm, rows: torch.Tensor, units: torch.Tensor,
                    cvals=None):
    """The emitter loop of backend/bfs.py _expand over the instances
    `units` (indices into gm.actions): (en, aok [A, N] bool, ov [A, N]
    int32, succ [A, N, W] int32)."""
    A, N = units.shape[0], rows.shape[0]
    dev = rows.device
    en = torch.empty((A, N), dtype=torch.bool, device=dev)
    aok = torch.empty((A, N), dtype=torch.bool, device=dev)
    ov = torch.empty((A, N), dtype=torch.int32, device=dev)
    succ = torch.empty((A, N, gm.W), dtype=torch.int32, device=dev)
    acts = gm.actions
    with gm.consts(cvals, N):
        for i, u in enumerate(units.tolist()):
            a = acts[u]
            out = a.fn(rows) if a.slot is None else a.fn(rows, a.slot)
            en[i], aok[i], ov[i], succ[i] = out
    return en, aok, ov, succ


# K15's blocks a launch aims at (132 SMs, 8 blocks each): below it a
# frontier's tiles are shared by several instance groups
GEN_BLOCKS = 132 * 8


def gen_groups(A: int, tiles: int) -> int:
    """K15's instances a block (G) for A instances over `tiles` tiles:
    all of them when the tiles alone fill GEN_BLOCKS (each tile is then
    read once), else ceil(A / groups) with tiles * groups reaching it.
    The groups of a tile are neighbouring blocks, so its later reads
    hit L2."""
    groups = min(max(A, 1), max(1, -(-GEN_BLOCKS // max(tiles, 1))))
    return max(1, -(-A // groups))


def gen_expand(gm, rows: torch.Tensor, units: torch.Tensor, cvals=None):
    """K15: gen_expand_twin's function in one launch: a block stages a
    tile of gm.meta["tile"] rows and runs gen_groups' instances over it
    (one thread per (instance, row) when the rows are too wide to
    stage); `units` int32 [A] on the rows' device.  succ and ov are
    views of one allocation, en and aok of another; the checks run on
    a short path (at a small level the host's work is the call)."""
    if not (_ok(rows, torch.int32, 2) and _ok(units, torch.int32, 1)):
        _check(rows, "gen_expand.rows", 2)
        _check(units, "gen_expand.units", 1)
    if rows.shape[1] != gm.W:
        raise ValueError(f"gen_expand: rows of {rows.shape[1]} lanes, "
                         f"module has W={gm.W}")
    if rows.is_cpu:
        return gen_expand_twin(gm, rows, units, cvals)
    _same_device("gen_expand", rows, units)
    lib = gm.load()
    A, N, W = units.shape[0], rows.shape[0], gm.W
    dev = rows.device
    words = torch.empty((A * N * (W + 1),), dtype=torch.int32, device=dev)
    succ, ov = words.split_with_sizes([A * N * W, A * N])
    flags = torch.empty((2 * A * N,), dtype=torch.bool, device=dev)
    en, aok = flags.split_with_sizes([A * N, A * N])
    en, aok = en.view(A, N), aok.view(A, N)
    ov, succ = ov.view(A, N), succ.view(A, N, W)
    if A == 0 or N == 0:
        return en, aok, ov, succ
    cv, per = _cvals(gm, cvals, N, dev)
    T = gm.meta["tile"]
    G = gen_groups(A, -(-N // T)) if T else A
    rc = lib.jmc_gen_expand(rows.data_ptr(), cv.data_ptr(), per,
                            units.data_ptr(), A, N, G, en.data_ptr(),
                            aok.data_ptr(), ov.data_ptr(), succ.data_ptr(),
                            _raw_stream(rows.get_device()))
    _launch("gen_expand", rc)
    return en, aok, ov, succ


def gen_pred_twin(gm, which: int, rows: torch.Tensor, cvals=None):
    """The emitter's predicate `which` (index into gm.preds) over rows:
    ok [N] bool."""
    with gm.consts(cvals, rows.shape[0]):
        return gm.preds[which].fn(rows)


def gen_pred(gm, which: int, rows: torch.Tensor, cvals=None):
    """K16: gen_pred_twin's function in one launch."""
    _check(rows, "gen_pred.rows", 2)
    if rows.shape[1] != gm.W:
        raise ValueError(f"gen_pred: rows of {rows.shape[1]} lanes, "
                         f"module has W={gm.W}")
    if rows.device.type == "cpu":
        return gen_pred_twin(gm, which, rows, cvals)
    lib = gm.load()
    N = rows.shape[0]
    out = torch.empty((N,), dtype=torch.bool, device=rows.device)
    if N == 0:
        return out
    cv, per = _cvals(gm, cvals, N, rows.device)
    rc = lib.jmc_gen_pred(ctypes.c_int(which), _ptr(rows), _ptr(cv),
                          ctypes.c_int64(per), ctypes.c_int64(N), _ptr(out),
                          _stream())
    _launch("gen_pred", rc)
    return out


def gen_value_twin(gm, rows: torch.Tensor, cvals=None):
    """The emitter's VIEW over rows: [N, VW] int32."""
    with gm.consts(cvals, rows.shape[0]):
        return gm.value.fn(rows).reshape(rows.shape[0], -1)


def gen_value(gm, rows: torch.Tensor, cvals=None):
    """K17: gen_value_twin's function in one launch."""
    _check(rows, "gen_value.rows", 2)
    if gm.value is None or rows.shape[1] != gm.W:
        raise ValueError(f"gen_value: no VIEW unit for rows of "
                         f"{rows.shape[1]} lanes")
    if rows.device.type == "cpu":
        return gen_value_twin(gm, rows, cvals)
    lib = gm.load()
    N = rows.shape[0]
    out = torch.empty((N, gm.VW), dtype=torch.int32, device=rows.device)
    if N == 0:
        return out
    cv, per = _cvals(gm, cvals, N, rows.device)
    rc = lib.jmc_gen_value(_ptr(rows), _ptr(cv), ctypes.c_int64(per),
                           ctypes.c_int64(N), _ptr(out), _stream())
    _launch("gen_value", rc)
    return out
