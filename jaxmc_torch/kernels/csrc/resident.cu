// K8 resident_compact and K9 resident_fold: the resident engine's chunk
// compaction with its verdict partials, and the fold of one chunk into
// the level's device carry.
//
// Replaces: jaxmc/backend/bfs.py:2275 _get_resident_run, inside its
// level() program:
//   K8 (chunk site)   :2320-2355 the valid grid, gen, the maximum
//                     overflow code over fvalid, the first assert-bad
//                     flat index (argmax), the first dead slot, vcnt and
//                     the stable-sort compaction lax.sort((1 - cvalid,
//                     arange)) whose first VC indices pick the block;
//   K8 (explore site) :2483-2489 the same stable partition of the
//                     level's explore mask, its first FCap indices;
//   K9                :2396-2427 the block append at clamp(acc_n), the
//                     status priority and the first ASSERT / DEADLOCK
//                     row, guarded by the status as the reference's
//                     chunk_cond (:2429-2434) guards the whole chunk.
//
// K8 inputs: a bool mask [A*CH] read as mask[a*CH + f] && f < flim (the
// chunk: en with flim = fcount - base; the explore site: A = 1, CH =
// flim = C), a cap <= A*CH and, at the chunk site, aok [A, CH] bool and
// ov [A, CH] int32.  Outputs: idx [cap] int32, the first cap entries of
// the stable partition (set indices in index order, then the unset ones
// in index order) — exactly lax.sort's first cap indices, every one in
// [0, A*CH), since callers gather with all cap of them; scalars int64[6]
// = (count of set entries, uncapped; maximum ov over f < flim;
// assert_any; first assert-bad flat index; dead_any; first dead slot).
// Bound on the card: bytes.  Each candidate's en, aok and ov read once
// (6 bytes; 1 byte a mask entry at the explore site), 4 bytes written
// per index.
// Design: a single-pass stable compaction with decoupled look-back
// (lookback.cuh), then a launch for the unset tail: 2 launches a call.
//   a  (res_compact_pass)  one block a tile of kTile = 4,096 entries
//        (256 threads x 16: one 16-byte load of the mask a thread; at the
//        chunk site also aok, 16 bytes, and ov, 64 bytes; the slot f =
//        i % CH is taken once a thread and then walked).  A thread's set
//        entries are ranked by a block scan of its popcount and staged in
//        shared memory; the tile publishes its set count, its first warp
//        looks back over earlier tiles a warp's width at a time, then
//        publishes the inclusive prefix and keeps the exclusive one in
//        toff; the warps write the staged indices idx[excl + j], j <
//        count, as contiguous runs.  Tiles are ordered by a ticket from
//        an atomic counter, not by blockIdx: a tile with a smaller ticket
//        has started, so the look-back never waits on a tile that is not
//        resident.  The reductions (ovmax, the first assert-bad index,
//        the first dead slot) are folded per tile with atomicMax on three
//        int32 words (the two "first" indices as kNone - i), which are
//        order-free; the dead-slot test reads the A rows of slot f, the
//        slots spread evenly over the tiles.  The tile with the last
//        ticket writes the count.
//   b  (res_compact_tail)  one block a tile below cap / kTile (a later
//        tile has at least cap - count unset entries before it): the
//        unset entry u (its rank
//        among the unset ones) belongs at idx[count + u] for u < cap -
//        count.  A tile's unset entries before it number tile * kTile -
//        toff[tile]; a tile whose range reaches below cap - count loads
//        its mask again, ranks its unset entries the same way and writes
//        them as contiguous runs.  Block 0 writes the five reductions into
//        scalars and sets their words back to 0.
// Bytes besides the bound: a second read of the mask over the tiles that
// hold the first cap - count unset entries (at most C bytes), 16 bytes a
// tile of status and offset.  Scratch: a workspace the wrapper caches
// for each device and stream (status words, toff, the ticket, the
// reductions); the status words carry the call's epoch, so nothing is
// cleared between calls, and the ticket and the reductions are left at 0
// by the pass and the tail.  A call's two launches must not interleave
// with another call's on its workspace: the wrapper enqueues them under
// a lock and refuses CUDA graph capture (a replay would reuse one epoch
// and read the previous replay's words as this one's).  Every output element is written by one thread, the
// look-back's sums do not depend on timing and the only atomics are max,
// so the result is the same on every run.
//
// K9 inputs: the level carry int64[7] = (stat, acc_n, gen, ovcode,
// por_ample, por_expanded, por_masked) and bad_row [PW] in device memory,
// K8's scalars, K2's pack-overflow flag, the POR deltas int64[3] (or
// null), the VC block keys_c [VC, 5] and rows_c [VC, PW], the
// accumulators acc_keys [AccCap, 5] and acc_rows [AccCap, PW], the
// packed frontier and the chunk's base row.  When stat is ST_CONTINUE on
// entry, and only then, it writes the block at clamp(acc_n, 0, AccCap -
// VC), adds vcnt to acc_n, sets the status (ST_OVF_LANES, then ST_OVF_VC,
// then ST_OVF_ACC, then ASSERT / DEADLOCK with bad_row = frontier[base +
// f]) and adds gen, the overflow code and the POR counters.  Otherwise
// it writes nothing, so the host enqueues a level's chunks without
// reading anything between them.
// Bound on the card: bytes, VC * (5 + PW) words read and written.
// Design: two launches.  a (jmc_res_fold_copy), one thread per word,
// reads stat and acc_n and copies; b (jmc_res_fold_scalar), one thread,
// runs after a in stream order and folds the scalars.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
// K8's tile (lookback.cuh): 16 entries a thread, 256 threads, 4,096
// entries
using jmc_lb::Entries;
using jmc_lb::block_scan;
using jmc_lb::kNone;
using jmc_lb::kTile;
using jmc_lb::kTileThreads;
using jmc_lb::kTileWarps;
using jmc_lb::low_bits;
using jmc_lb::stage;
using jmc_lb::tile_entries;
using jmc_lb::warp_max;

// the reference's ST_* codes (jaxmc/backend/bfs.py:58-68)
constexpr int64_t kContinue = 0;
constexpr int64_t kDeadlock = 3;
constexpr int64_t kAssert = 4;
constexpr int64_t kOvfAcc = 8;
constexpr int64_t kOvfVc = 9;
constexpr int64_t kOvfLanes = 10;

__global__ void __launch_bounds__(kTileThreads) res_compact_pass_kernel(
    const bool* __restrict__ mask, const bool* __restrict__ aok,
    const int32_t* __restrict__ ov, int32_t* __restrict__ idx,
    int64_t* __restrict__ scalars, uint64_t* __restrict__ status,
    int32_t* __restrict__ toff, uint32_t* __restrict__ ticket,
    int32_t* __restrict__ red, int a_n, int32_t ch, int32_t flim,
    int32_t cap, int ntiles, int32_t spt, uint32_t epoch) {
  __shared__ int32_t s_idx[kTile];
  __shared__ int s_warp[kTileWarps];
  __shared__ int32_t s_red[3][kTileWarps];
  __shared__ int s_tile;
  __shared__ uint32_t s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = jmc_lb::take_ticket(ticket, ntiles, &s_tile);
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const Entries e = tile_entries(mask, tile, c, ch, flim);
  // the chunk site's reductions, each as a maximum with identity 0
  int32_t r_ov = 0, r_ab = 0, r_dead = 0;
  if (aok != nullptr) {
    jmc_lb::verdict_partials(e, aok, ov, &r_ov, &r_ab);
    // dead slots: this tile's share of [0, flim), a slot dead when no
    // row of the grid sets it; f rises in a thread, so its first is its
    // least
    const int64_t f_lo = static_cast<int64_t>(tile) * spt;
    const int64_t f_hi = f_lo + spt < flim ? f_lo + spt : flim;
    for (int64_t f = f_lo + tid; f < f_hi; f += kTileThreads) {
      bool any = false;
      for (int a = 0; a < a_n && !any; ++a)
        any = mask[static_cast<int64_t>(a) * ch + f];
      if (!any) {
        r_dead = kNone - static_cast<int32_t>(f);
        break;
      }
    }
  }
  int nset;
  const int rank = block_scan(__popc(e.set), s_warp, &nset);
  stage(s_idx, rank, e.set, e.i0);
  if (aok != nullptr) {
    r_ov = warp_max(r_ov);
    r_ab = warp_max(r_ab);
    r_dead = warp_max(r_dead);
    if (lane == 0) {
      s_red[0][warp] = r_ov;
      s_red[1][warp] = r_ab;
      s_red[2][warp] = r_dead;
    }
  }
  __syncthreads();
  if (warp == 0) {
    if (aok != nullptr && lane < 3) {
      int32_t m = 0;
      for (int w = 0; w < kTileWarps; ++w) m = max(m, s_red[lane][w]);
      if (m > 0) atomicMax(red + lane, m);
    }
    const uint32_t excl = jmc_lb::look_back(status, tile, epoch,
                                            static_cast<uint32_t>(nset));
    if (lane == 0) {
      s_excl = excl;
      toff[tile] = static_cast<int32_t>(excl);
      if (tile == ntiles - 1) scalars[0] = static_cast<int64_t>(excl) + nset;
    }
  }
  __syncthreads();
  const int64_t ex = s_excl;
  for (int j = tid; j < nset; j += kTileThreads) {
    const int64_t pos = ex + j;
    if (pos < cap) idx[pos] = s_idx[j];
  }
}

__global__ void __launch_bounds__(kTileThreads) res_compact_tail_kernel(
    const bool* __restrict__ mask, int32_t* __restrict__ idx,
    int64_t* __restrict__ scalars, const int32_t* __restrict__ toff,
    int32_t* __restrict__ red, int a_n, int32_t ch, int32_t flim,
    int32_t cap) {
  __shared__ int32_t s_idx[kTile];
  __shared__ int s_warp[kTileWarps];
  const int tile = blockIdx.x, tid = threadIdx.x;
  if (tile == 0 && tid == 0) {
    const int32_t m = red[0], b = red[1], d = red[2];
    scalars[1] = m;
    scalars[2] = b != 0;
    scalars[3] = b != 0 ? kNone - b : 0;
    scalars[4] = d != 0;
    scalars[5] = d != 0 ? kNone - d : 0;
    red[0] = red[1] = red[2] = 0;
  }
  const int64_t total = scalars[0];
  const int64_t need = cap - total;
  const int64_t ub = static_cast<int64_t>(tile) * kTile - toff[tile];
  if (ub >= need) return;
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const Entries e = tile_entries(mask, tile, c, ch, flim);
  const uint32_t unset = low_bits(e.n) & ~e.set;
  int nun;
  const int rank = block_scan(__popc(unset), s_warp, &nun);
  stage(s_idx, rank, unset, e.i0);
  __syncthreads();
  for (int j = tid; j < nun; j += kTileThreads) {
    const int64_t u = ub + j;
    if (u < need) idx[total + u] = s_idx[j];
  }
}

__global__ void fold_copy_kernel(const int64_t* __restrict__ carry,
                                 const int32_t* __restrict__ keys_c,
                                 const int32_t* __restrict__ rows_c,
                                 int32_t* __restrict__ acc_keys,
                                 int32_t* __restrict__ acc_rows, int32_t vc,
                                 int64_t acc_cap, int kw, int pw) {
  if (carry[0] != kContinue) return;
  int64_t off = carry[1];
  off = off < 0 ? 0 : (off > acc_cap - vc ? acc_cap - vc : off);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int64_t nk = static_cast<int64_t>(vc) * kw;
  if (t < nk) {
    const int64_t r = t / kw, j = t % kw;
    acc_keys[(off + r) * kw + j] = keys_c[t];
  } else if (t < nk + static_cast<int64_t>(vc) * pw) {
    const int64_t u = t - nk, r = u / pw, j = u % pw;
    acc_rows[(off + r) * pw + j] = rows_c[u];
  }
}

__global__ void fold_scalar_kernel(int64_t* __restrict__ carry,
                                   int32_t* __restrict__ bad_row,
                                   const int64_t* __restrict__ part,
                                   const bool* __restrict__ pack_ovf,
                                   const int64_t* __restrict__ por,
                                   const int32_t* __restrict__ frontier,
                                   int64_t base, int32_t ch, int32_t vc,
                                   int64_t acc_cap, int pw,
                                   int check_deadlock, int32_t ov_pack) {
  if (carry[0] != kContinue) return;
  const int64_t vcnt = part[0];
  const int64_t acc_n = carry[1] + vcnt;
  const int64_t masked = por != nullptr ? por[2] : 0;
  int64_t ovcode = carry[3] > part[1] ? carry[3] : part[1];
  const bool povf = *pack_ovf;
  // kernel overflow codes outrank the pack guard
  if (ovcode == 0 && povf) ovcode = ov_pack;
  const bool lanes = part[1] != 0 || povf;
  int64_t stat = lanes ? kOvfLanes
                       : (vcnt > vc ? kOvfVc
                                    : (acc_n + vc > acc_cap ? kOvfAcc
                                                            : kContinue));
  const bool ab_any = part[2] != 0;
  const bool dead_any = check_deadlock && part[4] != 0;
  if (stat == kContinue && (ab_any || dead_any)) {
    const int64_t f = ab_any ? part[3] % ch : part[5];
    const int64_t src = (base + f) * pw;
    for (int j = 0; j < pw; ++j) bad_row[j] = frontier[src + j];
    stat = ab_any ? kAssert : kDeadlock;
  }
  carry[0] = stat;
  carry[1] = acc_n;
  carry[2] += vcnt - masked;
  carry[3] = ovcode;
  if (por != nullptr) {
    carry[4] += por[0];
    carry[5] += por[1];
    carry[6] += masked;
  }
}

inline int32_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : b);
}


}  // namespace

extern "C" int jmc_res_tile() { return kTile; }

// K8's workspace for `tiles` tiles: status words [tiles] uint64, toff
// [tiles] int32, the ticket, the three reductions; zeros when made
extern "C" int64_t jmc_res_workspace_bytes(int tiles) {
  return static_cast<int64_t>(tiles) * 12 + 16;
}

extern "C" cudaError_t jmc_res_compact(const bool* mask, const bool* aok,
                                       const int32_t* ov, int32_t* idx,
                                       int64_t* scalars, void* ws, int a_n,
                                       int32_t ch, int32_t flim, int32_t cap,
                                       int ntiles, int ws_tiles, int epoch,
                                       cudaStream_t stream) {
  uint64_t* status = static_cast<uint64_t*>(ws);
  int32_t* toff = reinterpret_cast<int32_t*>(status + ws_tiles);
  uint32_t* ticket = reinterpret_cast<uint32_t*>(toff + ws_tiles);
  int32_t* red = reinterpret_cast<int32_t*>(ticket + 1);
  const int32_t spt = ch > 0 ? (ch + ntiles - 1) / ntiles : 0;
  res_compact_pass_kernel<<<ntiles, kTileThreads, 0, stream>>>(
      mask, aok, ov, idx, scalars, status, toff, ticket, red, a_n, ch, flim,
      cap, ntiles, spt, static_cast<uint32_t>(epoch));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // tile t's unset entries before it, t * kTile - toff[t], are at least
  // t * kTile - count, so only tiles below cap / kTile reach idx
  const int64_t reach = (static_cast<int64_t>(cap) + kTile - 1) / kTile;
  const int tail = reach < 1 ? 1 : (reach < ntiles ? static_cast<int>(reach)
                                                   : ntiles);
  res_compact_tail_kernel<<<tail, kTileThreads, 0, stream>>>(
      mask, idx, scalars, toff, red, a_n, ch, flim, cap);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_fold_copy(const int64_t* carry,
                                         const int32_t* keys_c,
                                         const int32_t* rows_c,
                                         int32_t* acc_keys, int32_t* acc_rows,
                                         int32_t vc, int64_t acc_cap, int kw,
                                         int pw, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(vc) * (kw + pw);
  if (n <= 0) return cudaSuccess;
  fold_copy_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      carry, keys_c, rows_c, acc_keys, acc_rows, vc, acc_cap, kw, pw);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_fold_scalar(
    int64_t* carry, int32_t* bad_row, const int64_t* part,
    const bool* pack_ovf, const int64_t* por, const int32_t* frontier,
    int64_t base, int32_t ch, int32_t vc, int64_t acc_cap, int pw,
    int check_deadlock, int32_t ov_pack, cudaStream_t stream) {
  fold_scalar_kernel<<<1, 1, 0, stream>>>(carry, bad_row, part, pack_ovf, por,
                                          frontier, base, ch, vc, acc_cap, pw,
                                          check_deadlock, ov_pack);
  return cudaGetLastError();
}
